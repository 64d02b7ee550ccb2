"""UCI housing reader (reference: python/paddle/dataset/uci_housing.py).

Samples ``(features, price)``: float32[13], float32[1].  Synthetic linear
ground truth + noise (the fit-a-line book test only needs a learnable
linear signal).
"""

import numpy as np

_W = np.array([0.8, -0.5, 0.3, 1.2, -0.9, 0.4, 0.1, -0.3, 0.7, -0.2,
               0.5, -0.6, 0.9], np.float32)


def _make(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, 13)).astype(np.float32)
    y = (x @ _W + 2.0 + 0.1 * rng.normal(0, 1, n)).astype(np.float32)
    return x, y.reshape(-1, 1)


def train():
    x, y = _make(404, seed=2)

    def reader():
        for xi, yi in zip(x, y):
            yield xi, yi
    return reader


def test():
    x, y = _make(102, seed=3)

    def reader():
        for xi, yi in zip(x, y):
            yield xi, yi
    return reader
