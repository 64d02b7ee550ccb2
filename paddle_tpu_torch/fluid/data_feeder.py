"""DataFeeder: python samples → feed dict (reference: data_feeder.py;
counterpart ``paddle_tpu/fluid/data_feeder.py``).

The reference converts sample lists to LoDTensors per place; here samples
become batched numpy arrays keyed by feed var name, which the executor or
the input pipeline moves to the device.
"""

import numpy as np

from .framework import Variable
from .data_types import np_dtype


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = [v if isinstance(v, Variable) else None
                          for v in feed_list]
        self.feed_names = [v.name if isinstance(v, Variable) else v
                           for v in feed_list]
        self.place = place

    def feed(self, iterable):
        """iterable: list of samples, each a tuple aligned with feed_list."""
        columns = list(zip(*iterable))
        out = {}
        for i, name in enumerate(self.feed_names):
            var = self.feed_vars[i]
            dtype = np_dtype(var.dtype) if var is not None else None
            col = columns[i]
            arr = np.asarray(col, dtype=dtype)
            if var is not None and var.shape is not None:
                want = [s for s in var.shape]
                # reshape flat samples to the declared trailing shape
                trailing = [s for s in want[1:] if s and s > 0]
                if trailing and arr.ndim >= 1:
                    expected = int(np.prod(trailing))
                    flat = arr.reshape(len(col), -1)
                    if flat.shape[1] == expected:
                        arr = flat.reshape([len(col)] + trailing)
            out[name] = arr
        return out
