"""Layer namespace (reference: python/paddle/fluid/layers/__init__.py).

Exports only what the port has ported: the layers BERT pretraining
calls.
"""

from . import io
from . import nn
from . import tensor
from . import rnn
from . import math_op_patch

from .io import data                                         # noqa: F401
from .nn import (fc, embedding, layer_norm, dropout, softmax,  # noqa: F401
                 matmul, scale, reshape, transpose, unsqueeze, slice,
                 gather, mean, softmax_with_cross_entropy)
from .tensor import assign, create_parameter                 # noqa: F401
from .rnn import fused_attention                             # noqa: F401
