"""AMP optimizer decorator (counterpart ``paddle_tpu/fluid/contrib/
mixed_precision/decorator.py``; reference contract
``contrib/mixed_precision/decorator.py:27``).

The program is tagged with an AMP compute dtype (``_amp_dtype``, bf16)
and, with ``use_pure_bf16``, ``_amp_keep``: the conv and matmul rules
then run on bf16 operands (``lowering.amp_operands``) and, in pure bf16,
keep their outputs bf16.  Parameters, optimizer state, BN statistics and
the loss stay float32.

Loss scaling (``init_loss_scaling != 1`` or dynamic scaling) needs ops
the port does not have yet (``isfinite``, ``where``, ``clip``, ...); asking
for it raises ``NotImplementedError`` naming its ROADMAP item.  bf16 keeps
float32's exponent range, so bf16 training does not need it.
"""

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

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if self._need_scaling():
            raise NotImplementedError(
                "AMP loss scaling is not ported yet (ROADMAP.md, port queue "
                "1: 'the loss-scaling branch of contrib.mixed_precision'); "
                "bf16 trains without it: leave "
                "init_loss_scaling=1.0 and use_dynamic_loss_scaling=False")
        program = loss.block.program
        program._amp_dtype = self._amp_dtype
        program._amp_keep = self._use_pure_bf16
        program._bump_version()
        return self._optimizer.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set,
            callbacks=callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

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
