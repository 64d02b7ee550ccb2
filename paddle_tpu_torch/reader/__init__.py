"""paddle_tpu_torch.reader — reader (data-source generator) composition
(counterpart ``paddle_tpu.reader``; reference
``python/paddle/reader/decorator.py``): a *reader creator* is a zero-arg
callable returning a generator of samples, and these decorators compose
them.
"""

from .decorator import (cache, map_readers, shuffle, chain, compose,
                        buffered, firstn, xmap_readers, multiprocess_reader)
from . import creator

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "multiprocess_reader",
           "creator"]
