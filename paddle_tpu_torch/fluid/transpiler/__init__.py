"""Program transpilers (counterpart ``paddle_tpu/fluid/transpiler``):
the collective family for synchronous data parallel, and the
parameter-server family (``DistributeTranspiler`` with sliced and
pserver-resident sparse tables, ``GeoSgdTranspiler``, the RoundRobin and
HashName placements), and the model-parallel family: tensor, sequence
and expert parallelism (``TensorParallelTranspiler``,
``SequenceParallelTranspiler``, ``ExpertParallelTranspiler``)."""

from .collective import Collective, GradAllReduce, LocalSGD  # noqa: F401
from .distribute_transpiler import (DistributeTranspiler,  # noqa: F401
                                    DistributeTranspilerConfig)
from .geo_sgd_transpiler import GeoSgdTranspiler  # noqa: F401
from .ps_dispatcher import HashName, RoundRobin  # noqa: F401
from .tensor_parallel import TensorParallelTranspiler  # noqa: F401
from .sequence_parallel import SequenceParallelTranspiler  # noqa: F401
from .expert_parallel import ExpertParallelTranspiler  # noqa: F401


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """Reference memory_optimization_transpiler: variable reuse by
    liveness.  The executor already drops each temporary after the last
    op that names it (``lowering.plan_release``), so this is a no-op kept
    for scripts that call it."""


def release_memory(input_program, skip_opt_set=None):
    """Reference early-delete pass; ``lowering.plan_release`` does it."""
