"""IMDB sentiment reader (reference: python/paddle/dataset/imdb.py).

Samples ``(word_id_list, label)``.  Synthetic: two vocab distributions, one
per class, so a bag-of-words model is learnable.
"""

import numpy as np

VOCAB_SIZE = 5149  # reference vocab size for imdb


def word_dict():
    return {("w%d" % i).encode(): i for i in range(VOCAB_SIZE)}


def _reader(n, seed):
    rng = np.random.RandomState(seed)

    def reader():
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(16, 64))
            if label:
                ids = rng.randint(0, VOCAB_SIZE // 2, length)
            else:
                ids = rng.randint(VOCAB_SIZE // 2, VOCAB_SIZE, length)
            yield ids.astype(np.int64).tolist(), label
    return reader


def train(word_idx=None):
    return _reader(2048, seed=4)


def test(word_idx=None):
    return _reader(512, seed=5)
