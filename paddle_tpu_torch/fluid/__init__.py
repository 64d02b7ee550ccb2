"""paddle_tpu_torch.fluid — the user-facing API of the port.

Mirrors ``paddle_tpu.fluid``: a Program IR built from Python layers, run
by ``Executor(CUDAPlace(0))`` op by op on torch tensors.  Ported so far:
BERT-base serving, BERT-base pretraining with Adam, ResNet-50 training
with Momentum, L2Decay and pure-bf16 AMP, LeNet, Transformer NMT
training with a Noam-scheduled Adam, and DeepFM CTR training; the
eleven update-rule optimizers, gradient clipping (``fluid.clip``),
per-parameter learning rates and the eight LR schedules (see
ROADMAP.md's port queue).
"""

# op registrations must load before anything runs programs
from . import ops  # noqa: F401

from . import flags
from . import framework
from .framework import (Program, Variable, Parameter, OpRole,
                        default_main_program, default_startup_program,
                        program_guard, name_scope, cpu_places, cuda_places,
                        is_compiled_with_cuda)
from . import unique_name
from .executor import (Executor, Scope, global_scope, scope_guard,
                       CPUPlace, CUDAPlace)
from . import layers
from . import initializer
from .initializer import Constant, Uniform, Normal, TruncatedNormal, Xavier
from .param_attr import ParamAttr
from . import backward
from .backward import append_backward, gradients
from . import regularizer
from . import clip
from . import optimizer
from .optimizer import (SGDOptimizer, MomentumOptimizer,  # noqa: F401
                        LarsMomentumOptimizer, AdamOptimizer,
                        AdamaxOptimizer, AdagradOptimizer,
                        DecayedAdagradOptimizer, AdadeltaOptimizer,
                        RMSPropOptimizer, FtrlOptimizer, LambOptimizer)
from . import contrib
from . import convert
from .convert import load_numpy_params
from . import serving
from .serving import ServingExecutor

name = "paddle_tpu_torch.fluid"
