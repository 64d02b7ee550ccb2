"""Optimizers (counterpart ``paddle_tpu/fluid/optimizer.py``; reference
``python/paddle/fluid/optimizer.py:50``): the ``Optimizer`` base, the
update rules SGD, Momentum, LarsMomentum, Adam, Adamax, Adagrad,
DecayedAdagrad, Adadelta, RMSProp, Ftrl, Lamb and DGCMomentum, and the
wrappers ModelAverage, ExponentialMovingAverage, LookaheadOptimizer,
GradientMergeOptimizer and RecomputeOptimizer.

``minimize`` = ``append_backward`` + the gradient clips (``clip.py``) +
the regularization ops (``regularizer.py``), both under the Optimize
role + one optimizer op per parameter + ``_finish_update`` (the
beta-power ``scale`` ops of Adam, Adamax and Lamb).  The global
learning-rate variable and the accumulators get the JAX package's names
and fill values, so ``convert.load_numpy_params`` carries every
persistable of a JAX scope across; so do the wrappers' state
(``*_gm_acc``, ``*_la_slow``, ``*_ma_sum``, ``ma_count``, ``*_ema``,
``ema_step``, ``dgc_u``, ``dgc_v``).  The learning rate is a float, or a
Variable such as a schedule's (``layers.learning_rate_scheduler``),
which the optimizer ops then read on every run; a parameter whose
``ParamAttr(learning_rate=r)`` is not 1 reads ``scale(lr, r)``, one
``LRSched`` op per parameter.

GradientMerge, Lookahead and ModelAverage's window reset run their
updates in a ``conditional_block`` (one host read of the predicate per
run); the inner optimizer's accumulators and learning rate are created
in the global block all the same.  RecomputeOptimizer packs the forward
spans between checkpoints into ``recompute`` ops.  A dygraph schedule (a
callable rate) is not ported yet and raises, naming its ROADMAP item.
"""

import contextlib

import numpy as np

from . import framework
from .framework import (OpRole, OP_ROLE_KEY, Variable, default_main_program,
                        default_startup_program, program_guard)
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


# ---------------------------------------------------------------------------
# the wrappers around an optimizer (JAX optimizer.py:648-1229)
# ---------------------------------------------------------------------------

def _swap_programs(param_infos, source_of):
    """(apply program, restore program) that swap each parameter with a
    substitute value through the scope (JAX optimizer.py:648): apply
    copies it to ``<name>@BACKUP`` and installs what
    ``source_of(name, block, param var)`` appends; restore copies the
    backup back.  ``param_infos``: [(name, shape, dtype)]."""
    apply_prog, restore_prog = framework.Program(), framework.Program()
    for prog, is_apply in ((apply_prog, True), (restore_prog, False)):
        blk = prog.global_block()
        for name, shape, dtype in param_infos:
            p = blk.create_var(name=name, shape=shape, dtype=dtype,
                               persistable=True)
            bak = blk.create_var(name=name + "@BACKUP", shape=shape,
                                 dtype=dtype, persistable=True)
            with program_guard(prog, framework.Program()):
                if is_apply:
                    blk.append_op("assign", inputs={"X": [p]},
                                  outputs={"Out": [bak]})
                    sub = source_of(name, blk, p)
                    blk.append_op("assign", inputs={"X": [sub]},
                                  outputs={"Out": [p]})
                else:
                    blk.append_op("assign", inputs={"X": [bak]},
                                  outputs={"Out": [p]})
    return apply_prog, restore_prog


class _SwapMixin:
    """``apply``/``restore`` over the programs ``_swap_programs`` built."""

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        assert self._programs is not None, \
            "build the averaging ops inside the program first"
        executor.run(self._programs[0])
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self._programs[1])


class ModelAverage(_SwapMixin, Optimizer):
    """Parameter averaging (reference optimizer.py:2244; JAX
    optimizer.py:675): a running sum of each parameter and a count
    ``ma_count``, both reset (sum = the parameter, count = 1) in a
    ``conditional_block`` once the count passes ``max_average_window``;
    ``apply`` installs sum / count, ``restore`` the trained values.  The
    ops are appended when it is built, after the inner optimizer's
    ``minimize``, as in the reference."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._param_infos = []
        self._programs = None
        self.build()

    def _build(self, program):
        from . import layers
        from .layers.control_flow import ConditionalBlock
        block = program.global_block()
        helper = LayerHelper("model_average")
        with program._role_guard(OpRole.Optimize):
            cnt = helper.create_global_variable(
                name=unique_name.generate("ma_count"), shape=(1,),
                dtype="float32", persistable=True)
            helper.set_variable_initializer(cnt, ConstantInitializer(0.0))
            layers.increment(cnt, 1.0, in_place=True)
            self._count_name = cnt.name
            for p in block.all_parameters():
                s = helper.create_global_variable(
                    name=p.name + "_ma_sum", shape=p.shape, dtype=p.dtype,
                    persistable=True)
                helper.set_variable_initializer(s, ConstantInitializer(0.0))
                block.append_op("elementwise_add",
                                inputs={"X": [s], "Y": [p]},
                                outputs={"Out": [s]},
                                attrs={"axis": -1,
                                       OP_ROLE_KEY: OpRole.Optimize})
                self._param_infos.append((p.name, tuple(p.shape), p.dtype))
            # the window reset: count > max_window -> sum = param, count = 1
            mx = layers.fill_constant(shape=[1], dtype="float32",
                                      value=float(self.max_average_window))
            over = layers.greater_than(cnt, mx)
            cb = ConditionalBlock([over])
            with cb.block():
                one = layers.fill_constant(shape=[1], dtype="float32",
                                           value=1.0)
                cur = program.current_block()
                cur.append_op("assign", inputs={"X": [one]},
                              outputs={"Out": [cnt]})
                for pname, _sh, _dt in self._param_infos:
                    cur.append_op("assign", inputs={"X": [pname]},
                                  outputs={"Out": [pname + "_ma_sum"]})

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        raise TypeError(
            "ModelAverage wraps an already-optimized program: build your "
            "optimizer, call its minimize, then ModelAverage(...) — "
            "matching the reference usage")

    def build(self, program=None):
        """Append the averaging ops (after the inner optimizer's
        minimize, inside the program build)."""
        program = program or default_main_program()
        self._build(program)

        def avg_of(name, blk, pvar):
            s = blk.create_var(name=name + "_ma_sum", shape=pvar.shape,
                               dtype=pvar.dtype, persistable=True)
            c = blk.create_var(name=self._count_name, shape=(1,),
                               dtype="float32", persistable=True)
            out = blk.create_var(name=unique_name.generate(name + "_ma"))
            blk.append_op("elementwise_div", inputs={"X": [s], "Y": [c]},
                          outputs={"Out": [out]}, attrs={"axis": -1})
            return out

        self._programs = _swap_programs(self._param_infos, avg_of)
        return self


class ExponentialMovingAverage(_SwapMixin):
    """EMA of the parameters (JAX optimizer.py:775): ``shadow = decay ·
    shadow + (1 − decay) · param`` every step, and a step count
    ``ema_step``; ``apply`` installs the bias-corrected shadow
    ``shadow / (1 − decay^t)``, with ``decay^t = exp(t · ln decay)``,
    ``restore`` the trained values."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._name = name or "ema"
        self._param_infos = []
        self._programs = None

    def update(self):
        """Append the EMA update ops; call inside the training program's
        build, after the optimizer's minimize."""
        from . import layers
        program = default_main_program()
        block = program.global_block()
        helper = LayerHelper(self._name)
        with program._role_guard(OpRole.Optimize):
            step = helper.create_global_variable(
                name=unique_name.generate("ema_step"), shape=(1,),
                dtype="float32", persistable=True)
            helper.set_variable_initializer(step, ConstantInitializer(0.0))
            layers.increment(step, 1.0, in_place=True)
            self._step_name = step.name
            for p in block.all_parameters():
                ema = helper.create_global_variable(
                    name=p.name + "_" + self._name, shape=p.shape,
                    dtype=p.dtype, persistable=True)
                helper.set_variable_initializer(ema,
                                                ConstantInitializer(0.0))
                scaled_e = layers.scale(ema, scale=self._decay)
                scaled_p = layers.scale(p, scale=1.0 - self._decay)
                block.append_op("elementwise_add",
                                inputs={"X": [scaled_e], "Y": [scaled_p]},
                                outputs={"Out": [ema]},
                                attrs={"axis": -1,
                                       OP_ROLE_KEY: OpRole.Optimize})
                self._param_infos.append((p.name, tuple(p.shape), p.dtype))

        def ema_of(name, blk, pvar):
            ema = blk.create_var(name=name + "_" + self._name,
                                 shape=pvar.shape, dtype=pvar.dtype,
                                 persistable=True)
            st = blk.create_var(name=self._step_name, shape=(1,),
                                dtype="float32", persistable=True)
            ln_d = float(np.log(self._decay)) if self._decay > 0 else -80.0
            decay_pow = layers.exp(layers.scale(st, scale=ln_d))
            denom = layers.scale(decay_pow, scale=-1.0, bias=1.0)
            out = blk.create_var(name=unique_name.generate(name + "_emac"))
            blk.append_op("elementwise_div",
                          inputs={"X": [ema], "Y": [denom]},
                          outputs={"Out": [out]}, attrs={"axis": -1})
            return out

        self._programs = _swap_programs(self._param_infos, ema_of)


class LookaheadOptimizer:
    """Lookahead (JAX optimizer.py:849): the inner (fast) optimizer
    steps every run; on every k-th run (``la_step mod k == 0``, one
    ``conditional_block``) the slow weights move ``alpha`` of the way to
    the fast ones and the fast weights are set to them.  The startup
    program starts the slow weights at the initial fast ones."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert 0.0 <= alpha <= 1.0
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers
        from .layers.control_flow import ConditionalBlock
        result = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = default_main_program()
        startup = startup_program or default_startup_program()
        block = program.global_block()
        helper = LayerHelper("lookahead")
        with program._role_guard(OpRole.Optimize):
            cnt = helper.create_global_variable(
                name=unique_name.generate("la_step"), shape=(1,),
                dtype="float32", persistable=True)
            helper.set_variable_initializer(cnt, ConstantInitializer(0.0))
            layers.increment(cnt, 1.0, in_place=True)
            slows = []
            sb = startup.global_block()
            for p in block.all_parameters():
                slow = helper.create_global_variable(
                    name=p.name + "_la_slow", shape=p.shape, dtype=p.dtype,
                    persistable=True)
                if not sb.has_var_local(slow.name):
                    sb.create_var(name=slow.name, shape=p.shape,
                                  dtype=p.dtype, persistable=True)
                    sb.append_op("assign", inputs={"X": [p.name]},
                                 outputs={"Out": [slow.name]})
                slows.append((p, slow))
            kconst = layers.fill_constant(shape=[1], dtype="float32",
                                          value=float(self.k))
            rem = block.create_var(name=unique_name.generate("la_rem"),
                                   dtype="float32", stop_gradient=True)
            rem.shape = (1,)
            block.append_op("elementwise_mod",
                            inputs={"X": [cnt], "Y": [kconst]},
                            outputs={"Out": [rem]},
                            attrs={"axis": -1, OP_ROLE_KEY: OpRole.Optimize})
            half = layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.5)
            is_sync = layers.less_than(rem, half, force_cpu=False)
            is_sync.stop_gradient = True
        cb = ConditionalBlock([is_sync])
        with cb.block():
            cur = program.current_block()
            for p, slow in slows:
                # slow += alpha * (fast - slow); fast = slow
                diff = layers.elementwise_sub(p, slow)
                step_v = layers.scale(diff, scale=self.alpha)
                cur.append_op("elementwise_add",
                              inputs={"X": [slow], "Y": [step_v]},
                              outputs={"Out": [slow]},
                              attrs={"axis": -1,
                                     OP_ROLE_KEY: OpRole.Optimize})
                cur.append_op("assign", inputs={"X": [slow]},
                              outputs={"Out": [p]})
        return result


class DGCMomentumOptimizer(Optimizer):
    """DGC momentum in its convergence mode (reference optimizer.py:787;
    JAX optimizer.py:921): one ``dgc_momentum`` op per parameter, with
    the residual accumulators ``dgc_u`` and ``dgc_v``.  The op exchanges
    its own masked gradient, so ``minimize`` records the parameters in
    ``program._dgc_param_names`` and ``GradAllReduce`` adds no
    all-reduce for them.  The exchange is a dense all-reduce of the
    masked values: DGC's convergence, not its wire savings."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1,
                 sparsity=(0.75, 0.9375, 0.984375, 0.996, 0.999),
                 use_nesterov=False, num_trainers=None, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._rampup_begin_step = int(rampup_begin_step)
        self._rampup_step = int(rampup_step)
        self._sparsity = [float(s) for s in sparsity]

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        u = self._get_accumulator("dgc_u", param)
        v = self._get_accumulator("dgc_v", param)
        prog = block.program
        if not hasattr(prog, "_dgc_param_names"):
            prog._dgc_param_names = set()
        prog._dgc_param_names.add(param.name)
        return block.append_op(
            "dgc_momentum",
            inputs={"Param": [param], "Grad": [grad], "U": [u], "V": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "UOut": [u], "VOut": [v]},
            attrs={"momentum": self._momentum,
                   "rampup_begin_step": self._rampup_begin_step,
                   "rampup_step": self._rampup_step,
                   "sparsity": self._sparsity})


class GradientMergeOptimizer:
    """k-micro-batch gradient accumulation (JAX optimizer.py:978; the
    reference's multi_batch_merge_pass contract): a ``*_gm_acc``
    accumulator per parameter gathers the gradient every run, and a
    ``conditional_block`` on ``gm_step mod k == 0`` runs the inner
    optimizer on the averaged accumulation and zeroes the accumulators.
    The inner optimizer's accumulators and learning rate land in the
    global block although its ops are appended in the sub-block."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers
        from .layers.control_flow import ConditionalBlock
        assert self.k_steps >= 1
        if self.k_steps == 1:
            return self.inner_optimizer.minimize(
                loss, startup_program, parameter_list, no_grad_set)
        params_grads = self.inner_optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        program = default_main_program()
        block = program.global_block()
        helper = LayerHelper("gradient_merge")

        with program._role_guard(OpRole.Optimize):
            counter = helper.create_global_variable(
                name=unique_name.generate("gm_step"), shape=(1,),
                dtype="float32", persistable=True)
            counter.stop_gradient = True
            helper.set_variable_initializer(counter,
                                            ConstantInitializer(0.0))
            layers.increment(counter, value=1.0, in_place=True)

            merged = []
            for p, g in params_grads:
                if g is None:
                    continue
                acc = helper.create_global_variable(
                    name=unique_name.generate(p.name + "_gm_acc"),
                    shape=p.shape, dtype=p.dtype, persistable=True)
                acc.stop_gradient = True
                helper.set_variable_initializer(acc,
                                                ConstantInitializer(0.0))
                block.append_op("elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]},
                                attrs={"axis": -1,
                                       OP_ROLE_KEY: OpRole.Backward})
                merged.append((p, g, acc))

            # the apply predicate step % k == 0: the remainder is >= 0,
            # so "== 0" is "< 0.5" exactly in float
            kconst = layers.fill_constant(shape=[1], dtype="float32",
                                          value=float(self.k_steps))
            rem = block.create_var(
                name=unique_name.generate("gm_rem"), dtype="float32",
                stop_gradient=True)
            rem.shape = (1,)
            block.append_op("elementwise_mod",
                            inputs={"X": [counter], "Y": [kconst]},
                            outputs={"Out": [rem]},
                            attrs={"axis": -1, OP_ROLE_KEY: OpRole.Optimize})
            half = layers.fill_constant(shape=[1], dtype="float32",
                                        value=0.5)
            is_apply = layers.less_than(rem, half, force_cpu=False)
            is_apply.stop_gradient = True

        cond_blk = ConditionalBlock([is_apply])
        with cond_blk.block():
            apply_pg = []
            for p, g, acc in merged:
                eff = layers.scale(
                    acc, scale=1.0 / self.k_steps if self.avg else 1.0)
                apply_pg.append((p, eff))
            optimize_ops = self.inner_optimizer.apply_gradients(apply_pg)
            cur = program.current_block()
            for _p, _g, acc in merged:
                cur.append_op("scale", inputs={"X": [acc]},
                              outputs={"Out": [acc]},
                              attrs={"scale": 0.0,
                                     OP_ROLE_KEY: OpRole.Optimize})
        return optimize_ops, params_grads


# PipelineOptimizer lives in pipeline.py with device_guard (the GPipe
# schedule is executor-level machinery); re-exported here to match the
# reference namespace (optimizer.py:2664).
from .pipeline import PipelineOptimizer  # noqa: E402,F401


class RecomputeOptimizer:
    """Gradient checkpointing (JAX optimizer.py:1089; the reference's
    RecomputeOptimizer contract): ``_set_checkpoints([...])`` names the
    activations to keep, and every forward span that ends at one is
    packed into a ``recompute`` op whose grad op replays the span
    instead of keeping its intermediates.  A variable inside a span
    cannot be fetched; fetch the checkpoints or the span outputs."""

    def __init__(self, optimizer):
        self.inner_optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = [c.name if isinstance(c, Variable) else c
                             for c in checkpoints]
        return self

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """Segment the forward, then the inner optimizer's backward (so
        an AMP decorator or fleet can wrap this optimizer)."""
        self._apply_segmentation(loss, no_grad_set)
        return self.inner_optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self.inner_optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.inner_optimizer.apply_gradients(params_grads)

    def _apply_segmentation(self, loss, no_grad_set):
        if not self._checkpoints:
            raise ValueError(
                "call _set_checkpoints([...]) before minimize — recompute "
                "needs segment boundaries")
        if not getattr(loss.block.program, "_recompute_segmented", False):
            _segment_for_recompute(loss.block.program, self._checkpoints,
                                   loss.name, no_grad_set or ())
            loss.block.program._recompute_segmented = True

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._apply_segmentation(loss, no_grad_set)
        return self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)


def _segment_for_recompute(program, checkpoints, loss_name, no_grad_set=()):
    """Rewrite the forward-only main block (JAX optimizer.py:1145): each
    span of ops that ends at a checkpoint becomes one ``recompute`` op
    over a new sub-block.  A control-flow or feed/fetch op ends a span
    and is never packed; the tail span (the loss) stays as it is.  A
    span's outputs are what later ops read, the checkpoints, the loss
    and every persistable it writes; its ``stop_gradient_vars`` are the
    names ``append_backward`` would cut the gradient at."""
    block = program.global_block()
    ck = set(checkpoints)
    segments, cur = [], []
    for op in block.ops:
        if framework.op_sub_block_indices(op) or op.type in ("feed",
                                                             "fetch"):
            if cur:
                segments.append(("wrap", cur))
                cur = []
            segments.append(("keep", [op]))
            continue
        cur.append(op)
        writes = {n for names in op.outputs.values() for n in names}
        if writes & ck:
            segments.append(("wrap", cur))
            cur = []
    if cur:
        segments.append(("keep", cur))

    # later_reads[i]: the names read by the segments after i
    later_reads = [set() for _ in segments]
    acc = set()
    for i in range(len(segments) - 1, -1, -1):
        later_reads[i] = set(acc)
        for op in segments[i][1]:
            for names in op.inputs.values():
                acc.update(n for n in names if n)

    def _is_persistable(name):
        v = block._find_var_recursive(name)
        return v is not None and getattr(v, "persistable", False)

    def _stops_gradient(name):
        if name in no_grad_set:
            return True
        v = block._find_var_recursive(name)
        return v is not None and getattr(v, "stop_gradient", False) \
            and not getattr(v, "is_data", False)

    new_ops = []
    for i, (kind, ops) in enumerate(segments):
        if kind == "keep" or len(ops) < 2:
            new_ops.extend(ops)
            continue
        reads, writes = [], set()
        for op in ops:
            for names in op.inputs.values():
                for n in names:
                    if n and n not in writes and n not in reads:
                        reads.append(n)
            for names in op.outputs.values():
                writes.update(n for n in names if n)
        later = later_reads[i] | ck | {loss_name}
        later |= {n for n in writes if _is_persistable(n)}
        outs = sorted(writes & later)
        if not outs:
            new_ops.extend(ops)
            continue
        stop_vars = sorted(n for n in (writes | set(reads))
                           if _stops_gradient(n))
        sub = framework.Block(program, len(program.blocks),
                              parent_idx=block.idx)
        sub.ops = list(ops)
        program.blocks.append(sub)
        rec = framework.Operator(block, "recompute",
                                 inputs={"X": list(reads)},
                                 outputs={"Out": outs},
                                 attrs={"sub_block": sub.idx,
                                        "input_vars": list(reads),
                                        "output_vars": outs,
                                        "stop_gradient_vars": stop_vars})
        new_ops.append(rec)
    block.ops = new_ops
    program._bump_version()


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
