"""imikolov (PTB) n-gram reader (reference: python/paddle/dataset/imikolov.py).

Reference API: ``build_dict()`` → {word: id}, ``train(word_dict, n)`` /
``test(word_dict, n)`` → reader of n-tuples of word ids (n-gram mode).
No network egress here, so the corpus is a synthetic Markov text:
next ≡ (3*prev + 7) mod V, 10% uniform noise — predictable from context
(optimal CE ≈ 0.9 nats), so an n-gram language model trained on it
converges the way the reference book test expects.
"""

import numpy as np

VOCAB = 200
TRAIN_WORDS = 60000
TEST_WORDS = 6000


def build_dict(min_word_freq=50):
    return {"w%d" % i: i for i in range(VOCAB)}


def _corpus(n_words, seed):
    rng = np.random.RandomState(seed)
    words = np.empty(n_words, np.int64)
    words[0], words[1] = rng.randint(0, VOCAB, 2)
    for i in range(2, n_words):
        clean = (3 * words[i - 1] + 7) % VOCAB
        words[i] = clean if rng.rand() < 0.9 else rng.randint(0, VOCAB)
    return words


def _ngram_reader(words, n):
    def reader():
        for i in range(len(words) - n + 1):
            yield tuple(int(w) for w in words[i:i + n])
    return reader


def train(word_dict, n):
    return _ngram_reader(_corpus(TRAIN_WORDS, seed=0), n)


def test(word_dict, n):
    return _ngram_reader(_corpus(TEST_WORDS, seed=1), n)
