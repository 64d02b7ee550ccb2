"""Gradient clipping (reference: python/paddle/fluid/clip.py; counterpart
paddle_tpu/fluid/clip.py:12-98, the same classes and ops).

A clip strategy rewrites (param, grad) pairs with ops appended to the
program; ``Optimizer.apply_gradients`` calls
:func:`append_gradient_clip_ops` before regularization, under the
Optimize role.  ``set_gradient_clip`` stores the strategy on the program
(not in a process global, which would leak into every later program);
without one, a parameter's ``ParamAttr(gradient_clip=...)`` clips that
parameter alone.
"""

from .framework import OpRole, OP_ROLE_KEY, default_main_program
from . import layers


class BaseGradientClipAttr:
    def process(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clipped to [min, max] (min defaults to -max): one
    ``clip`` op per gradient."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def process(self, params_grads):
        return [(p, layers.clip(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to L2 norm ``clip_norm`` where its norm is
    larger: one ``clip_by_norm`` op per gradient."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        return [(p, layers.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient times ``clip_norm / max(‖G‖, clip_norm)``, ‖G‖ the
    L2 norm of all of them together: a ``squared_l2_norm`` per gradient,
    one ``sum``, ``sqrt``, ``elementwise_max``, ``elementwise_div``, then
    an ``elementwise_mul`` per gradient."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        if not params_grads:
            return params_grads
        sq_sums = []
        for _, g in params_grads:
            block = g.block
            sq = block.create_var(name=g.name + "@SQNORM", shape=(1,),
                                  dtype=g.dtype)
            block.append_op("squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]},
                            attrs={OP_ROLE_KEY: OpRole.Optimize})
            sq_sums.append(sq)
        global_norm = layers.sqrt(layers.sums(sq_sums))
        max_norm = layers.fill_constant((1,), global_norm.dtype,
                                        self.clip_norm)
        scale = layers.elementwise_div(
            max_norm, layers.elementwise_max(global_norm, max_norm))
        return [(p, layers.elementwise_mul(g, scale, axis=-1))
                for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    """Clip every gradient of ``program`` (the default main program) with
    ``clip``; with ``param_list``, also mark those parameters."""
    program = program or default_main_program()
    program._clip_strategy = clip
    if param_list is not None:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    """The program's strategy over every pair, else each parameter's own
    ``gradient_clip_attr`` over its pair; unchanged when neither is
    set."""
    strategy = getattr(default_main_program(), "_clip_strategy", None)
    if strategy is not None:
        return strategy.process(params_grads)
    result = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None)
        if clip is None:
            result.append((p, g))
        else:
            result.extend(clip.process([(p, g)]))
    return result


ErrorClipByValue = GradientClipByValue
