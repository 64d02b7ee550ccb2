"""WMT-16 translation reader (reference: python/paddle/dataset/wmt16.py).

Reference API: ``train(src_dict_size, trg_dict_size)`` → reader of
(src_ids, trg_ids, trg_next_ids) with <s>=0, <e>=1, <unk>=2 framing.
Synthetic stand-in: the "translation" of a source sentence is its reverse
passed through a fixed affine vocabulary map — a real seq2seq task that an
encoder-decoder with attention or beam search can learn and the MT book
test can assert convergence on.
"""

import numpy as np

BOS, EOS, UNK = 0, 1, 2
_RESERVED = 3


def _translate(src, trg_dict_size):
    body = [(int(w) * 5 + 3) % (trg_dict_size - _RESERVED) + _RESERVED
            for w in reversed(src)]
    return body


def _reader(n_samples, src_dict_size, trg_dict_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            n = rng.randint(3, 8)
            src = rng.randint(_RESERVED, src_dict_size, n).tolist()
            trg_body = _translate(src, trg_dict_size)
            trg = [BOS] + trg_body
            trg_next = trg_body + [EOS]
            yield src, trg, trg_next
    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader(3000, src_dict_size, trg_dict_size, seed=0)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader(300, src_dict_size, trg_dict_size, seed=1)


def get_dict(lang, dict_size, reverse=False):
    d = {"tok%d" % i: i for i in range(dict_size)}
    return {v: k for k, v in d.items()} if reverse else d
