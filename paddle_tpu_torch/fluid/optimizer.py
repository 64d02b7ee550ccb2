"""Optimizers (counterpart ``paddle_tpu/fluid/optimizer.py``; reference
``python/paddle/fluid/optimizer.py:50``): the ``Optimizer`` base,
``SGDOptimizer``, ``MomentumOptimizer`` and ``AdamOptimizer``.

``minimize`` = ``append_backward`` + the regularization ops
(``regularizer.py``) + one optimizer op per parameter +
``_finish_update``.  The global learning-rate variable and the
accumulators (``velocity``, ``moment1``, ``moment2``, ``beta1_pow_acc``,
``beta2_pow_acc``) get the JAX package's names, so
``convert.load_numpy_params`` carries every persistable of a JAX scope
across.  The learning rate is a float, or a Variable such as
``layers.noam_decay``'s, which the optimizer ops then read on every run.
Gradient clipping, per-parameter learning rates and the other optimizers
are not ported yet (ROADMAP.md, port queue 1); asking for them raises.
"""

from .framework import OpRole, Variable, default_main_program
from .backward import append_backward
from .regularizer import append_regularization_ops
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from . import unique_name


def _not_ported(what):
    return NotImplementedError(
        "%s is not ported yet (ROADMAP.md, port queue 1: 'the other "
        "optimizers')" % what)


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        if callable(learning_rate):
            # a dygraph LearningRateDecay object (JAX optimizer.py:86)
            raise _not_ported("a dygraph learning-rate schedule")
        if not isinstance(learning_rate, (int, float, Variable)):
            raise TypeError("learning_rate must be a float or a Variable, "
                            "got %r" % (learning_rate,))
        self._name = name
        self._learning_rate = learning_rate if \
            isinstance(learning_rate, Variable) else float(learning_rate)
        self._learning_rate_map = {}
        self._accumulators = {}

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        """The program's learning-rate variable: the Variable given (a
        schedule's output), else a persistable one initialised to the
        float (JAX optimizer.py:69)."""
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        lr_var = helper.create_global_variable(
            name=unique_name.generate("learning_rate"), shape=(1,),
            dtype="float32", persistable=True)
        lr_var.stop_gradient = True
        helper.set_variable_initializer(
            lr_var, ConstantInitializer(self._learning_rate))
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        if param.optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise _not_ported("a per-parameter learning rate")
        return self._global_learning_rate()

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if self._name is not None:
            name = self._name + "_" + name
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate(param.name + "_" + name),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        var.stop_gradient = True
        helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[key] = var
        return var

    def _get_accumulator(self, name, param):
        if self._name is not None:
            name = self._name + "_" + name
        return self._accumulators[(name, param.name)]

    # -- main entry points -------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        for p, _ in params_grads:
            if getattr(p, "gradient_clip_attr", None) is not None:
                raise _not_ported("gradient clipping")
        program = default_main_program()
        with program._role_guard(OpRole.Optimize):
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        program = default_main_program()
        self._create_accumulators(program.global_block(),
                                  [p for p, g in params_grads if g is not None])
        self._create_global_learning_rate()
        optimize_ops = []
        for param_and_grad in params_grads:
            if param_and_grad[1] is None:
                continue
            with program._role_guard(OpRole.Optimize):
                optimize_ops.append(self._append_optimize_op(
                    program.current_block(), param_and_grad))
        with program._role_guard(OpRole.Optimize):
            self._finish_update(program.current_block(), params_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    # -- per-optimizer hooks ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """operators/optimizers/sgd_op (reference optimizer.py:609)."""

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    """operators/optimizers/momentum_op (reference optimizer.py:679;
    JAX optimizer.py:304)."""

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    """operators/optimizers/adam_op (reference optimizer.py:1249)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        # advance the beta^t accumulators with scale ops, as the reference
        # AdamOptimizer._finish_update does
        for param, grad in params_grads:
            if grad is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", param)
            b2p = self._get_accumulator("beta2_pow_acc", param)
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})
            block.append_op("scale", inputs={"X": [b2p]},
                            outputs={"Out": [b2p]},
                            attrs={"scale": self._beta2})


# reference-compatible aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
