"""Optimizers (counterpart ``paddle_tpu/fluid/optimizer.py``; reference
``python/paddle/fluid/optimizer.py:50``): the ``Optimizer`` base and the
update rules SGD, Momentum, LarsMomentum, Adam, Adamax, Adagrad,
DecayedAdagrad, Adadelta, RMSProp, Ftrl and Lamb.

``minimize`` = ``append_backward`` + the gradient clips (``clip.py``) +
the regularization ops (``regularizer.py``), both under the Optimize
role + one optimizer op per parameter + ``_finish_update`` (the
beta-power ``scale`` ops of Adam, Adamax and Lamb).  The global
learning-rate variable and the accumulators get the JAX package's names
and fill values, so ``convert.load_numpy_params`` carries every
persistable of a JAX scope across.  The learning rate is a float, or a
Variable such as a schedule's (``layers.learning_rate_scheduler``),
which the optimizer ops then read on every run; a parameter whose
``ParamAttr(learning_rate=r)`` is not 1 reads ``scale(lr, r)``, one
``LRSched`` op per parameter.  A dygraph schedule (a callable rate) and
the wrapper optimizers (``ModelAverage`` and the rest, at the end of
this file) are not ported yet and raise, naming their ROADMAP item.
"""

from .framework import OpRole, Variable, default_main_program
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .regularizer import append_regularization_ops
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from . import unique_name


# vector-state slots (input -> output) of the optimizer ops whose update
# is elementwise, so that a 1/N shard of a coalesced parameter bucket can
# be updated alone (weight-update sharding, transpiler/collective.py;
# JAX optimizer.py:35).  Lamb and LarsMomentum need the whole parameter.
ELEMENTWISE_OPTIMIZER_STATE = {
    "sgd": {},
    "momentum": {"Velocity": "VelocityOut"},
    "adam": {"Moment1": "Moment1Out", "Moment2": "Moment2Out"},
    "adamax": {"Moment": "MomentOut", "InfNorm": "InfNormOut"},
    "adagrad": {"Moment": "MomentOut"},
    "decayed_adagrad": {"Moment": "MomentOut"},
    "adadelta": {"AvgSquaredGrad": "AvgSquaredGradOut",
                 "AvgSquaredUpdate": "AvgSquaredUpdateOut"},
    "rmsprop": {"Moment": "MomentOut", "MeanSquare": "MeanSquareOut",
                "MeanGrad": "MeanGradOut"},
    "ftrl": {"SquaredAccumulator": "SquaredAccumOut",
             "LinearAccumulator": "LinearAccumOut"},
}


def elementwise_state_slots(op_type):
    """The vector-state slot map of an optimizer op whose update shards
    elementwise, or None when the op cannot update a shard."""
    return ELEMENTWISE_OPTIMIZER_STATE.get(op_type)


def _not_ported(what, item):
    return NotImplementedError(
        "%s is not ported yet (ROADMAP.md, port queue 1: %s)" % (what, item))


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        if callable(learning_rate):
            # a dygraph LearningRateDecay object (JAX optimizer.py:86)
            raise _not_ported("a dygraph learning-rate schedule",
                              "'dygraph'")
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
        """The global rate, or for a parameter whose ParamAttr sets a
        ``learning_rate`` other than 1 the global rate scaled by it, one
        ``scale`` op under the LRSched role (JAX optimizer.py:104)."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        if param_lr == 1.0:
            return base
        from . import layers
        with default_main_program()._lr_schedule_guard():
            return layers.scale(base, float(param_lr))

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
        # the state -> parameter link, on both programs (JAX
        # optimizer.py:131): the step event's optimizer_state_bytes and
        # weight-update sharding read it
        for prog in (helper.main_program, helper.startup_program):
            links = dict(prog._opt_state_of)
            links[var.name] = param.name
            prog._opt_state_of = links
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
        """Clip, regularize, then update: the clip and regularization ops
        carry the Optimize role, as JAX optimizer.py:161 appends them."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        program = default_main_program()
        with program._role_guard(OpRole.Optimize):
            params_grads = append_gradient_clip_ops(params_grads)
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


class LarsMomentumOptimizer(Optimizer):
    """operators/optimizers/lars_momentum_op (reference optimizer.py:1046;
    JAX optimizer.py:331)."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator("velocity", param)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [param], "Grad": [grad],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdamaxOptimizer(Optimizer):
    """operators/optimizers/adamax_op (reference optimizer.py:1430; JAX
    optimizer.py:413)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        inf_norm = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        return block.append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "InfNorm": [inf_norm], "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for param, grad in params_grads:
            if grad is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", param)
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})


class AdagradOptimizer(Optimizer):
    """operators/optimizers/adagrad_op (reference optimizer.py:1146; JAX
    optimizer.py:457)."""

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p,
                                  fill_value=self._initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    """operators/optimizers/decayed_adagrad_op (reference
    optimizer.py:1584; JAX optimizer.py:484)."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator("moment", param)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """operators/optimizers/adadelta_op (reference optimizer.py:1676; JAX
    optimizer.py:509).  The update reads no learning rate; the op has no
    LearningRate input, as in the JAX package."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", param)
        asu = self._get_accumulator("__avg_squared_update", param)
        return block.append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """operators/optimizers/rmsprop_op (reference optimizer.py:1774; JAX
    optimizer.py:537)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        momentum = self._get_accumulator("momentum", param)
        mean_square = self._get_accumulator("mean_square", param)
        mean_grad = self._get_accumulator("mean_grad", param)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [param], "Grad": [grad],
                    "Moment": [momentum], "MeanSquare": [mean_square],
                    "MeanGrad": [mean_grad],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "MomentOut": [momentum],
                     "MeanSquareOut": [mean_square],
                     "MeanGradOut": [mean_grad]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    """operators/optimizers/ftrl_op (reference optimizer.py:1947; JAX
    optimizer.py:574)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return block.append_op(
            "ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(Optimizer):
    """operators/optimizers/lamb_op (reference optimizer.py:2091; JAX
    optimizer.py:606)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    _create_accumulators = AdamOptimizer._create_accumulators

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow_acc", param)
        b2p = self._get_accumulator("beta2_pow_acc", param)
        return block.append_op(
            "lamb",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay})

    _finish_update = AdamOptimizer._finish_update


def _wrapper_not_ported(name):
    """A class of the JAX package's optimizer.py:675-1145 that the port
    has not ported yet: building one raises, naming its ROADMAP item."""
    def __init__(self, *args, **kwargs):
        raise _not_ported(name, "'the wrapper optimizers'")
    return type(name, (), {"__init__": __init__, "__doc__":
                           "Not ported yet (ROADMAP.md, port queue 1)."})


ModelAverage = _wrapper_not_ported("ModelAverage")
ExponentialMovingAverage = _wrapper_not_ported("ExponentialMovingAverage")
LookaheadOptimizer = _wrapper_not_ported("LookaheadOptimizer")
DGCMomentumOptimizer = _wrapper_not_ported("DGCMomentumOptimizer")
GradientMergeOptimizer = _wrapper_not_ported("GradientMergeOptimizer")
RecomputeOptimizer = _wrapper_not_ported("RecomputeOptimizer")


# reference-compatible aliases (JAX optimizer.py:1070-1080)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
