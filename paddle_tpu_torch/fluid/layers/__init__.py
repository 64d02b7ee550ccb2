"""Layer namespace (reference: python/paddle/fluid/layers/__init__.py).

Exports only what the port has ported: the layers that BERT, ResNet,
LeNet, Transformer NMT and DeepFM training call, the unary layers of
``ops.py``, the clips, and the learning-rate schedules.
"""

from . import io
from . import nn
from . import ops
from . import tensor
from . import rnn
from . import math_op_patch
from . import metric_op
from . import learning_rate_scheduler

from .io import data                                         # noqa: F401
from .nn import (fc, embedding, layer_norm, dropout, softmax,  # noqa: F401
                 matmul, scale, reshape, transpose, unsqueeze, slice,
                 gather, mean, softmax_with_cross_entropy, conv2d,
                 pool2d, batch_norm, topk, elementwise_add,
                 elementwise_mul, elementwise_div, elementwise_max,
                 elementwise_min, elementwise_pow,
                 reduce_sum, one_hot, label_smooth,
                 sigmoid_cross_entropy_with_logits, clip, clip_by_norm)
from .ops import *                                           # noqa: F401,F403
from .metric_op import accuracy                              # noqa: F401
from .tensor import (assign, create_parameter, fill_constant,  # noqa: F401
                     cast, concat, sums)
from .rnn import fused_attention                             # noqa: F401
from .learning_rate_scheduler import *                       # noqa: F401,F403
