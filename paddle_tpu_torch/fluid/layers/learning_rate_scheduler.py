"""Learning-rate schedules built as ops of the program (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py; counterpart
paddle_tpu/fluid/layers/learning_rate_scheduler.py).

A schedule reads the persistable float32 global step counter
``@LR_DECAY_COUNTER@``, which one ``increment`` op advances on every run
of the main program, and computes the rate with ``OpRole.LRSched`` ops
in float32 (AMP casts only conv/mul/matmul operands).  Every schedule
appends the JAX package's ops in its order (``floor``, ``ceil``, ``exp``,
``cos``, ``reciprocal``, ``sign``, ``clip``, the elementwise ops and the
Variable operators), so both packages list the same program;
``piecewise_decay`` and ``linear_lr_warmup`` gate with
``clip(sign(step − b) + 1, 0, 1)`` rather than control flow.
"""

import math

from ..framework import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper
from .. import unique_name
from . import nn
from . import ops as _ops
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


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """``lr0 · rate^(step / decay_steps)`` (the exponent floored with
    ``staircase``), step 0 on the first run."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        div = nn.scale(step, 1.0 / float(decay_steps))
        if staircase:
            div = _ops.floor(div)
        lr = nn.scale(nn.elementwise_pow(
            tensor.fill_constant((1,), "float32", float(decay_rate)), div),
            float(learning_rate))
    return lr


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """``lr0 · exp(−rate · step / decay_steps)``."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        div = nn.scale(step, 1.0 / float(decay_steps))
        if staircase:
            div = _ops.floor(div)
        lr = nn.scale(_ops.exp(nn.scale(div, -float(decay_rate))),
                      float(learning_rate))
    return lr


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """``lr0 / (1 + rate · step / decay_steps)``."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        div = nn.scale(step, 1.0 / float(decay_steps))
        if staircase:
            div = _ops.floor(div)
        denom = nn.scale(div, float(decay_rate), bias=1.0)
        lr = nn.scale(_ops.reciprocal(denom), float(learning_rate))
    return lr


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """``(lr0 − end) · (1 − step / decay)^power + end``: decay is
    ``decay_steps``, the step held there; with ``cycle`` decay is
    ``decay_steps · max(ceil(step / decay_steps), 1)``."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        if cycle:
            div = _ops.ceil(nn.scale(step, 1.0 / float(decay_steps)))
            one = tensor.fill_constant((1,), "float32", 1.0)
            div = nn.elementwise_max(div, one)
            decay = nn.scale(div, float(decay_steps))
        else:
            decay = tensor.fill_constant((1,), "float32", float(decay_steps))
            step = nn.elementwise_min(step, decay)
        frac = nn.elementwise_pow(
            1.0 - (step / decay),
            tensor.fill_constant((1,), "float32", float(power)))
        lr = nn.scale(frac, float(learning_rate) - float(end_learning_rate),
                      bias=float(end_learning_rate))
    return lr


def piecewise_decay(boundaries, values):
    """``values[i]`` from step ``boundaries[i - 1]`` on: ``values[0]``
    plus one gated step ``values[i] − values[i − 1]`` per boundary."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        lr = tensor.fill_constant((1,), "float32", float(values[0]))
        for b, v_next, v_prev in zip(boundaries, values[1:], values[:-1]):
            bval = tensor.fill_constant((1,), "float32", float(b))
            # gate = 1[step >= b]
            gate = nn.clip(_ops.sign(step - bval) + 1.0, 0.0, 1.0)
            lr = lr + nn.scale(gate, float(v_next) - float(v_prev))
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """``lr0 / 2 · (cos(π · epoch / epochs) + 1)``, epoch =
    ``floor(step / step_each_epoch)``."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        epoch = _ops.floor(nn.scale(step, 1.0 / float(step_each_epoch)))
        theta = nn.scale(epoch, math.pi / float(epochs))
        lr = nn.scale(_ops.cos(theta) + 1.0, 0.5 * float(learning_rate))
    return lr


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """``start_lr → end_lr`` linearly over ``warmup_steps``, then
    ``learning_rate`` (a float or a schedule's Variable)."""
    prog = default_main_program()
    with prog._lr_schedule_guard():
        step = _decay_step_counter()
        ws = tensor.fill_constant((1,), "float32", float(warmup_steps))
        frac = nn.clip(step / ws, 0.0, 1.0)
        warm = nn.scale(frac, float(end_lr) - float(start_lr),
                        bias=float(start_lr))
        if isinstance(learning_rate, (int, float)):
            learning_rate = tensor.fill_constant((1,), "float32",
                                                 float(learning_rate))
        # gate = 1[step >= warmup_steps], clipped twice as in the JAX
        # package (the second clip is the identity, kept for the same ops)
        gate = nn.clip(_ops.sign(step - ws) + 1.0, 0.0, 1.0)
        gate = nn.clip(gate, 0.0, 1.0)
        lr = warm * (1.0 - gate) + learning_rate * gate
    return lr
