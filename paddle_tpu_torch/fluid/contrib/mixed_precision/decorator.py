"""AMP optimizer decorator (counterpart ``paddle_tpu/fluid/contrib/
mixed_precision/decorator.py``; reference contract
``contrib/mixed_precision/decorator.py:27``).

The program is tagged with an AMP compute dtype (``_amp_dtype``, bf16)
and, with ``use_pure_bf16``, ``_amp_keep``: the conv and matmul rules
then run on bf16 operands (``lowering.amp_operands``) and, in pure bf16,
keep their outputs bf16.  Parameters, optimizer state, BN statistics and
the loss stay float32.

Loss scaling (``init_loss_scaling != 1`` or dynamic scaling; JAX
decorator.py:47-141): the loss is multiplied by the ``loss_scaling``
variable before the backward; one ``isfinite`` over every gradient
gates them, ``where(finite, g / scale, 0)`` (a select, since inf · 0 is
NaN), so a step with a non-finite gradient hands the optimizer zeros
(Adam's moments and beta powers still move, as in JAX); the dynamic
update counts good and bad steps (``amp_good_steps``,
``amp_bad_steps``) and multiplies the scale by ``incr_ratio`` or
``decr_ratio`` at their thresholds, never below 1, all by arithmetic
gating on the device (no host read).  bf16 keeps float32's exponent
range, so bf16 training does not need scaling; it is there for the
reference's contract and for float16.
"""

from ... import layers
from ...framework import OpRole, default_main_program
from ...initializer import ConstantInitializer
from ...layer_helper import LayerHelper
from ... import unique_name
from .fp16_lists import AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    """Wraps an optimizer; reference decorator.py:27."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
                 amp_dtype="bfloat16", use_pure_bf16=False):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._amp_dtype = amp_dtype
        self._use_pure_bf16 = use_pure_bf16
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def _need_scaling(self):
        return (self._use_dynamic_loss_scaling
                or self._init_loss_scaling != 1.0)

    def _make_state_var(self, name, value):
        helper = LayerHelper("amp_state")
        var = helper.create_global_variable(
            name=unique_name.generate(name), shape=(1,), dtype="float32",
            persistable=True)
        var.stop_gradient = True
        helper.set_variable_initializer(var, ConstantInitializer(value))
        return var

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        program._amp_dtype = self._amp_dtype
        program._amp_keep = self._use_pure_bf16
        program._bump_version()
        if self._need_scaling():
            self._loss_scaling = self._make_state_var(
                "loss_scaling", self._init_loss_scaling)
            loss = loss * self._loss_scaling
        return self._optimizer.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            callbacks=callbacks)

    def apply_gradients(self, params_grads):
        if not self._need_scaling():
            return self._optimizer.apply_gradients(params_grads)
        program = default_main_program()
        with program._role_guard(OpRole.Backward):
            grads = [g for _, g in params_grads if g is not None]
            helper = LayerHelper("isfinite")
            finite = helper.create_variable_for_type_inference(
                "bool", stop_gradient=True)
            finite.shape = (1,)
            helper.append_op("isfinite", inputs={"X": grads},
                             outputs={"Out": [finite]})
            gate = layers.cast(finite, "float32")          # 1.0 if finite
            inv_scale = layers.elementwise_div(gate, self._loss_scaling)
            new_pg = []
            for p, g in params_grads:
                if g is None:
                    new_pg.append((p, g))
                    continue
                clean = layers.where(finite, g * inv_scale,
                                     layers.zeros_like(g))
                new_pg.append((p, clean))
            if self._use_dynamic_loss_scaling:
                self._update_loss_scaling(gate)
        return self._optimizer.apply_gradients(new_pg)

    def _update_loss_scaling(self, gate):
        """The reference's update_loss_scaling (decorator.py:61) by
        arithmetic gating, as JAX decorator.py:113 builds it: a hit is
        ``clip(sign(count − n + 0.5), 0, 1)``, the factor
        ``(1 + incr_hit·(incr − 1)) · (1 − decr_hit·(1 − decr))``, the
        new scale ``max(scale · factor, 1)``."""
        good = self._make_state_var("amp_good_steps", 0.0)
        bad = self._make_state_var("amp_bad_steps", 0.0)
        scale = self._loss_scaling
        one = layers.fill_constant((1,), "float32", 1.0)
        bad_gate = one - gate
        new_good = (good + one) * gate
        new_bad = (bad + one) * bad_gate
        incr_hit = layers.clip(
            layers.sign(new_good - float(self._incr_every_n_steps) + 0.5),
            0.0, 1.0)
        decr_hit = layers.clip(
            layers.sign(new_bad - float(self._decr_every_n_nan_or_inf) + 0.5),
            0.0, 1.0)
        factor = (one + incr_hit * (self._incr_ratio - 1.0)) \
            * (one - decr_hit * (1.0 - self._decr_ratio))
        new_scale = layers.elementwise_max(scale * factor, one)
        new_good = new_good * (one - incr_hit)
        new_bad = new_bad * (one - decr_hit)
        layers.assign(new_scale, scale)
        layers.assign(new_good, good)
        layers.assign(new_bad, bad)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program=startup_program,
                                     parameter_list=parameter_list,
                                     no_grad_set=no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, amp_dtype="bfloat16",
             use_pure_bf16=False):
    """Reference ``fluid.contrib.mixed_precision.decorate``.
    ``use_pure_bf16``: conv/matmul outputs stay bf16 instead of
    returning to float32; parameters, optimizer state, BN statistics and
    the loss stay float32."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio, amp_dtype=amp_dtype,
        use_pure_bf16=use_pure_bf16)
