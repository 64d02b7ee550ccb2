"""Learning-rate schedules built as ops of the program (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py; counterpart
paddle_tpu/fluid/layers/learning_rate_scheduler.py).

A schedule reads the persistable float32 global step counter
``@LR_DECAY_COUNTER@``, which one ``increment`` op advances on every run
of the main program, and computes the rate with ``OpRole.LRSched`` ops
in float32 (AMP casts only conv/mul/matmul operands).  The port has
``noam_decay``; the other schedules need op types it lacks (``floor``,
``exp``, ``cos``, comparisons) and raise.
"""

from ..framework import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper
from .. import unique_name
from . import nn
from . import tensor

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]

_STEP_VAR_NAME = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The persistable float32 global step counter, initialised to
    ``begin - 1`` and incremented once per run (learning_rate_scheduler.py
    :28-43); one per program."""
    helper = LayerHelper("global_step_counter")
    prog = default_main_program()
    gb = prog.global_block()
    if gb.has_var_local(_STEP_VAR_NAME):
        return gb.vars[_STEP_VAR_NAME]
    counter = helper.create_global_variable(
        name=_STEP_VAR_NAME, shape=(1,), dtype="float32", persistable=True)
    counter.stop_gradient = True
    helper.set_variable_initializer(counter, Constant(float(begin - 1)))
    with prog._lr_schedule_guard():
        helper.append_op("increment", inputs={"X": [counter]},
                         outputs={"Out": [counter]}, attrs={"step": 1.0})
    return counter


def _lr_var(value, name_hint="learning_rate"):
    helper = LayerHelper(name_hint)
    var = helper.create_global_variable(
        name=unique_name.generate(name_hint), shape=(1,), dtype="float32",
        persistable=False)
    var.stop_gradient = True
    if not isinstance(value, (int, float)):
        tensor.assign(value, var)
    return var


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """``lr0 · d_model^-0.5 · min(step^-0.5, step · warmup^-1.5)``
    (Vaswani et al.), with step 1 on the first run."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter(begin=1)
        a = nn.elementwise_pow(
            step, tensor.fill_constant((1,), "float32", -0.5))
        b = nn.scale(step, float(warmup_steps) ** -1.5)
        lr = nn.scale(nn.elementwise_min(a, b),
                      float(learning_rate) * (d_model ** -0.5))
    return lr


def _not_ported(name):
    def schedule(*args, **kwargs):
        raise NotImplementedError(
            "%s is not ported yet: it needs op types the port lacks "
            "(ROADMAP.md, port queue 1: 'the other optimizers', LR "
            "schedules and clipping)" % name)
    schedule.__name__ = name
    return schedule


exponential_decay = _not_ported("exponential_decay")
natural_exp_decay = _not_ported("natural_exp_decay")
inverse_time_decay = _not_ported("inverse_time_decay")
polynomial_decay = _not_ported("polynomial_decay")
piecewise_decay = _not_ported("piecewise_decay")
cosine_decay = _not_ported("cosine_decay")
linear_lr_warmup = _not_ported("linear_lr_warmup")
