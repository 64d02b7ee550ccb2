"""paddle_tpu_torch.dataset — the dataset reader creators the book models
read (counterpart ``paddle_tpu.dataset``; reference
``python/paddle/dataset/*``).

The reference downloads real corpora.  Each module here is the port's own
copy of the JAX package's deterministic synthetic stand-in, with the
reference's reader API and sample shapes and dtypes: the same seeds give
the same samples in both packages.  ``mnist`` and ``cifar`` read real
files from a ``data_dir`` where one is given.
"""

from . import common
from . import mnist
from . import cifar
from . import uci_housing
from . import imdb
from . import imikolov
from . import conll05
from . import wmt16
from . import movielens
from . import wmt14
