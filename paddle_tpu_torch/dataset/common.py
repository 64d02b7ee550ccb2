"""Dataset helpers (reference: python/paddle/dataset/common.py)."""


def synthetic_note(name):
    return ("%s: serving deterministic synthetic data (the reference "
            "downloads the real corpus)" % name)
