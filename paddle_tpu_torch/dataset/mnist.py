"""MNIST reader (reference: python/paddle/dataset/mnist.py).

Samples are ``(image, label)`` with image a flat float32[784] in [-1, 1]
and label int64 — identical to the reference contract.  Data is a
deterministic synthetic digit-like distribution (class-dependent spatial
blocks + noise) unless ``data_dir`` points at the real idx files.
"""

import gzip
import os
import struct

import numpy as np

TRAIN_N = 8192
TEST_N = 1024


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.int64)
    imgs = rng.normal(0, 0.3, (n, 28, 28)).astype(np.float32)
    for i, lab in enumerate(labels):
        r, c = divmod(int(lab), 5)
        imgs[i, 4 + r * 12:12 + r * 12, 2 + c * 5:6 + c * 5] += 2.0
    imgs = np.clip(imgs, -1.0, 1.0).reshape(n, 784)
    return imgs, labels


def _idx_reader(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(label_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
    imgs = imgs.astype(np.float32) / 127.5 - 1.0
    return imgs, labels


def _reader(imgs, labels):
    def reader():
        for img, lab in zip(imgs, labels):
            yield img, int(lab)
    return reader


def train(data_dir=None):
    if data_dir and os.path.exists(os.path.join(data_dir,
                                                "train-images-idx3-ubyte.gz")):
        imgs, labels = _idx_reader(
            os.path.join(data_dir, "train-images-idx3-ubyte.gz"),
            os.path.join(data_dir, "train-labels-idx1-ubyte.gz"))
    else:
        imgs, labels = _synthetic(TRAIN_N, seed=0)
    return _reader(imgs, labels)


def test(data_dir=None):
    if data_dir and os.path.exists(os.path.join(data_dir,
                                                "t10k-images-idx3-ubyte.gz")):
        imgs, labels = _idx_reader(
            os.path.join(data_dir, "t10k-images-idx3-ubyte.gz"),
            os.path.join(data_dir, "t10k-labels-idx1-ubyte.gz"))
    else:
        imgs, labels = _synthetic(TEST_N, seed=1)
    return _reader(imgs, labels)
