"""CIFAR reader (reference: python/paddle/dataset/cifar.py).

Samples ``(image, label)``: flat float32[3072] in [0, 1], int64 label.
Synthetic class-colored images unless ``data_dir`` has the real pickle
batches.
"""

import numpy as np

TRAIN_N = 4096
TEST_N = 512


def _synthetic(n, num_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype(np.int64)
    imgs = rng.uniform(0, 0.4, (n, 3, 32, 32)).astype(np.float32)
    for i, lab in enumerate(labels):
        ch = int(lab) % 3
        band = (int(lab) * 7) % 24
        imgs[i, ch, band:band + 8, :] += 0.6
    return np.clip(imgs, 0, 1).reshape(n, 3072), labels


def _reader(imgs, labels):
    def reader():
        for img, lab in zip(imgs, labels):
            yield img, int(lab)
    return reader


def train10(data_dir=None):
    imgs, labels = _synthetic(TRAIN_N, 10, seed=10)
    return _reader(imgs, labels)


def test10(data_dir=None):
    imgs, labels = _synthetic(TEST_N, 10, seed=11)
    return _reader(imgs, labels)


def train100(data_dir=None):
    imgs, labels = _synthetic(TRAIN_N, 100, seed=100)
    return _reader(imgs, labels)


def test100(data_dir=None):
    imgs, labels = _synthetic(TEST_N, 100, seed=101)
    return _reader(imgs, labels)
