"""CoNLL-2005 SRL reader (reference: python/paddle/dataset/conll05.py).

Reference API: ``get_dict()`` → (word_dict, verb_dict, label_dict);
``test()`` → reader of 9-tuples of equal-length id sequences
(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark, label).
Synthetic stand-in: the label at each position is a deterministic function
of the word id and whether the position precedes or follows the predicate
(a bit the LSTM must carry from the mark feature) — structured enough that
a BiLSTM-CRF tagger fits it, which is what the book test
(tests/book/test_label_semantic_roles.py) asserts.
"""

import numpy as np

WORD_DICT_LEN = 150
LABEL_DICT_LEN = 8
PRED_DICT_LEN = 20
MARK_DICT_LEN = 2


def get_dict():
    word_dict = {"w%d" % i: i for i in range(WORD_DICT_LEN)}
    verb_dict = {"v%d" % i: i for i in range(PRED_DICT_LEN)}
    label_dict = {"l%d" % i: i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    return None   # the reference downloads a pretrained table; none here


def _reader(n_samples, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            n = rng.randint(4, 12)
            words = rng.randint(0, WORD_DICT_LEN, n).astype(np.int64)
            pred_pos = rng.randint(0, n)
            pred = np.full(n, words[pred_pos] % PRED_DICT_LEN, np.int64)
            mark = (np.arange(n) == pred_pos).astype(np.int64)
            after = (np.arange(n) > pred_pos).astype(np.int64)
            label = (words % 3) * 2 + after + 1
            label[pred_pos] = 0
            pad = np.pad(words, 2, constant_values=0)
            yield (words, pad[0:n], pad[1:n + 1], pad[2:n + 2],
                   pad[3:n + 3], pad[4:n + 4], pred, mark, label)
    return reader


def train():
    return _reader(2000, seed=0)


def test():
    return _reader(200, seed=1)
