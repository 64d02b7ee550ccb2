"""paddle_tpu_torch.fluid — the user-facing API of the port.

Mirrors ``paddle_tpu.fluid``: a Program IR built from Python layers, run
by ``Executor(CUDAPlace(0))`` op by op on torch tensors.  Ported so far:
BERT-base serving, BERT-base pretraining with Adam, ResNet-50 training
with Momentum, L2Decay and pure-bf16 AMP, LeNet, Transformer NMT
training with a Noam-scheduled Adam, and DeepFM CTR training; the
eleven update-rule optimizers, gradient clipping (``fluid.clip``),
per-parameter learning rates and the eight LR schedules; checkpoints
(``fluid.io``, ``CheckpointManager`` over ``storage``), model export
and the inference predictor (``fluid.inference``, ``ir``), in the JAX
package's file formats; the training-loop runtime (``run_window``,
``DataLoader``/``PyReader`` over the feed ring, ``DatasetFactory`` and
``train_from_dataset``, ``telemetry``, ``profiler``, ``preemption``,
``watchdog``); synchronous data parallel over ``torch.distributed``, one
process per rank (``distributed``, the c_* collective ops,
``transpiler.GradAllReduce``/``LocalSGD``, ``CompiledProgram.
with_data_parallel`` with sync batch norm, ``ParallelExecutor``, the
collective ``incubate.fleet`` and ``python -m paddle_tpu_torch.
distributed.launch``) (see ROADMAP.md's port queue).
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
from . import proto_compat
from . import io
from .io import (save_vars, save_params, save_persistables, load_vars,
                 load_params, load_persistables, save_inference_model,
                 load_inference_model)
from . import storage
from .storage import LocalStorage, ObjectStoreStorage
from . import checkpoint
from .checkpoint import CheckpointManager
from . import ir
from . import inference
from . import core
from . import telemetry
from . import profiler
from . import preemption
from . import watchdog
from .data_feeder import DataFeeder
from . import reader
from .reader import DataLoader, PyReader
from . import dataset
from .dataset import DatasetFactory
from . import distributed
from . import mesh_utils
from . import transpiler
from . import compiler
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy
from .parallel_executor import ParallelExecutor
from . import incubate

name = "paddle_tpu_torch.fluid"
