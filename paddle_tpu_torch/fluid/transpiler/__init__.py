"""Program transpilers (counterpart ``paddle_tpu/fluid/transpiler``):
the collective family for synchronous data parallel.  The model-parallel
transpilers are ROADMAP queue 1 item 11, the parameter-server ones item
13b."""

from .collective import Collective, GradAllReduce, LocalSGD  # noqa: F401


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """Reference memory_optimization_transpiler: variable reuse by
    liveness.  The executor already drops each temporary after the last
    op that names it (``lowering.plan_release``), so this is a no-op kept
    for scripts that call it."""


def release_memory(input_program, skip_opt_set=None):
    """Reference early-delete pass; ``lowering.plan_release`` does it."""
