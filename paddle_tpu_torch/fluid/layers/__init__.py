"""Layer namespace (reference: python/paddle/fluid/layers/__init__.py).

Exports only what the port has ported: the layers that BERT, ResNet,
LeNet, Transformer NMT and DeepFM training call, the unary layers of
``ops.py``, the clips, the learning-rate schedules, the in-program
readers of ``io.py``, and the book models' losses, sequence, RNN, CRF
and beam-search layers with ``StaticRNN``/``DynamicRNN``, and the
comparison, logical and modulo layers with ``increment`` and
``isfinite``, and the control flow: ``While``, ``cond``, ``Switch``,
``IfElse``, the tensor arrays and ``Print``, and the sequence, RNN and
CTC layers (``sequence.py``, ``rnn.py``, ``nn_extras.py``,
``nn_extras2.py``), and the detection layers (``detection.py``), and the
core layers of ROADMAP item 13c.3a (the reductions, shape, scatter and
gather layers, ``conv2d_transpose``, ``mul``, the attribute-carrying
activations, ``argsort``, the fills, ``auc``), and the first half of
item 13c.3b (``nn_extras.py``'s activations, losses, norms, image and
shape layers; ``nn_extras2.py``'s 3-D vision, ``lrn``, CTR and shape
layers).
"""

from . import io
from . import nn
from . import ops
from . import tensor
from . import rnn
from . import math_op_patch
from . import metric_op
from . import learning_rate_scheduler
from . import sequence
from . import control_flow
from . import nn_extras
from . import nn_extras2
from . import detection

from .io import (data, py_reader, create_py_reader_by_data,  # noqa: F401
                 double_buffer, read_file)
from .nn import (fc, embedding, layer_norm, dropout, softmax,  # noqa: F401
                 matmul, scale, reshape, transpose, unsqueeze, slice,
                 gather, mean, softmax_with_cross_entropy, conv2d,
                 pool2d, batch_norm, topk, elementwise_add,
                 elementwise_sub, elementwise_mul, elementwise_div,
                 elementwise_max, elementwise_min, elementwise_pow,
                 elementwise_mod, elementwise_floordiv, logical_and,
                 logical_or, logical_xor, logical_not,
                 reduce_sum, reduce_mean, one_hot, label_smooth,
                 sigmoid_cross_entropy_with_logits, clip, clip_by_norm,
                 cross_entropy, square_error_cost, squeeze, stack,
                 expand, where, split, conv2d_transpose, flatten,
                 gather_nd, gaussian_random, huber_loss, l2_normalize, mul,
                 pad, reduce_max, reduce_min, reduce_prod, scatter,
                 uniform_random, uniform_random_batch_size_like)
from .ops import *                                           # noqa: F401,F403
from .metric_op import accuracy, auc                         # noqa: F401
from .tensor import (assign, create_parameter, fill_constant,  # noqa: F401
                     cast, concat, sums, fill_constant_batch_size_like,
                     zeros_like, range, isfinite, create_tensor,
                     create_global_var, zeros, ones, ones_like, argmax,
                     argmin, argsort, reverse, has_nan, has_inf,
                     tensor_array_to_tensor)
from .rnn import (fused_attention, switch_moe, dynamic_lstm,  # noqa: F401
                  dynamic_gru, linear_chain_crf, crf_decoding, cos_sim,
                  nce, hsigmoid, beam_search, beam_search_decode)
from .sequence import *                                      # noqa: F401,F403
from .nn_extras import *                                     # noqa: F401,F403
from .nn_extras2 import *                                    # noqa: F401,F403
from .detection import *                                     # noqa: F401,F403
from .control_flow import (increment, less_than,  # noqa: F401
                           less_equal, greater_than, greater_equal,
                           equal, not_equal, BlockGuard, StaticRNN,
                           DynamicRNN, While, Switch, IfElse, cond,
                           create_array, array_write, array_read,
                           array_length, Print, reorder_lod_tensor_by_rank,
                           is_empty)
from .learning_rate_scheduler import *                       # noqa: F401,F403
