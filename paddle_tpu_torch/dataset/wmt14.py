"""WMT-14 translation reader (reference: python/paddle/dataset/wmt14.py).

Reference API: ``train(dict_size)/test(dict_size)`` yield
``(src_ids, trg_ids, trg_next_ids)``; ``get_dict(dict_size, reverse)``
returns the shared-size src/trg vocabularies.  Same synthetic
reverse-and-remap task as the wmt16 module so seq2seq models converge.
"""

from . import wmt16 as _w

START, END, UNK = "<s>", "<e>", "<unk>"


def train(dict_size):
    return _w._reader(3000, dict_size, dict_size, seed=14)


def test(dict_size):
    return _w._reader(300, dict_size, dict_size, seed=15)


def gen(dict_size):
    return _w._reader(300, dict_size, dict_size, seed=16)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict), id→word when ``reverse`` (the reference
    default) else word→id."""
    src = _w.get_dict("en", dict_size, reverse)
    trg = _w.get_dict("de", dict_size, reverse)
    return src, trg


def fetch():
    """No-op in the synthetic stand-in."""
