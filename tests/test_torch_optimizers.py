"""The training surface this port adds, each piece against paddle_tpu on
the CPU:

- the eight update rules ``lars_momentum``, ``adamax``, ``adagrad``,
  ``decayed_adagrad``, ``adadelta``, ``rmsprop`` (plain and centered),
  ``ftrl`` and ``lamb``, one op on the same seeded numpy parameter,
  gradient and state in both packages (also at the guards: a zero
  gradient for Lars, a zero parameter for Lamb, Ftrl's first step from
  zero accumulators): every output ``rtol 1e-6, atol 1e-7``;
- each of the eight optimizer classes, and Adam with each gradient clip,
  for three steps of tiny DeepFM (``deepfm.tiny_config()``, batch 16)
  from the reference's startup state: the same main and startup ops
  (types, slots, attributes), variables and accumulators; per-step
  losses ``rtol 1e-4``; every persistable after step 3 ``atol 1e-5``;
- ``GradientClipByValue``, ``GradientClipByNorm``,
  ``GradientClipByGlobalNorm``, through ``set_gradient_clip`` and per
  parameter through ``ParamAttr(gradient_clip=...)``, and per-parameter
  learning rates (``ParamAttr(learning_rate=...)``): the same ops, the
  clipped gradients ``rtol 1e-6, atol 1e-7``, the steps as above;
- the seven schedules of ``layers.learning_rate_scheduler`` besides
  ``noam_decay``, with their ``staircase`` and ``cycle`` variants: the
  reference's ops, all with ``OpRole.LRSched``, and the fetched rate of
  each of 12 runs ``rtol 1e-6`` against paddle_tpu and against the
  closed form in float64;
- the reverse operators ``1.0 - v``, ``2.0 / v``, ``-v``, and a scalar
  beside an integer Variable: the reference's op sequence and values.
"""

import math

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.framework import OpRole
from paddle_tpu_torch.models import deepfm
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
BATCH, STEPS = 16, 3
PKGS = (("jax", jfluid, jdeepfm), ("port", fluid, deepfm))


def _set_state(pkg, scope, arrays):
    if pkg is fluid:
        fluid.load_numpy_params(scope, arrays, fluid.CPUPlace())
    else:
        for n, a in arrays.items():
            scope.set_var(n, a)


# ---------------------------------------------------------------------------
# one optimizer op on numpy inputs
# ---------------------------------------------------------------------------

# op type -> ({state input slot: output slot}, {scalar input: value},
#             reads a learning rate, attrs)
RULES = {
    "lars_momentum": ({"Velocity": "VelocityOut"}, {}, True,
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "adamax": ({"Moment": "MomentOut", "InfNorm": "InfNormOut"},
               {"Beta1Pow": 0.9 ** 3}, True,
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ({"Moment": "MomentOut"}, {}, True, {"epsilon": 1e-6}),
    "decayed_adagrad": ({"Moment": "MomentOut"}, {}, True,
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ({"AvgSquaredGrad": "AvgSquaredGradOut",
                  "AvgSquaredUpdate": "AvgSquaredUpdateOut"}, {}, False,
                 {"epsilon": 1e-6, "rho": 0.95}),
    "rmsprop": ({"Moment": "MomentOut", "MeanSquare": "MeanSquareOut",
                 "MeanGrad": "MeanGradOut"}, {}, True,
                {"epsilon": 1e-6, "decay": 0.95, "momentum": 0.9,
                 "centered": False}),
    "ftrl": ({"SquaredAccumulator": "SquaredAccumOut",
              "LinearAccumulator": "LinearAccumOut"}, {}, True,
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "lamb": ({"Moment1": "Moment1Out", "Moment2": "Moment2Out"},
             {"Beta1Pow": 0.9 ** 2, "Beta2Pow": 0.999 ** 2}, True,
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
}
# (case id, op type, attr overrides, what to zero)
RULE_CASES = [(op, op, {}, None) for op in RULES] + [
    ("rmsprop-centered", "rmsprop", {"centered": True}, None),
    ("rmsprop-no-momentum", "rmsprop", {"momentum": 0.0}, None),
    ("ftrl-first-step", "ftrl", {}, "state"),
    ("ftrl-lr-power-0.7", "ftrl", {"lr_power": -0.7, "l1": 0.0}, None),
    ("lars-zero-grad", "lars_momentum", {}, "Grad"),
    ("lamb-zero-param", "lamb", {}, "Param"),
    ("adagrad-zero-grad-rows", "adagrad", {}, "grad-rows"),
]


def _rule_inputs(op_type, zero, rng):
    state_slots, scalars, _, _ = RULES[op_type]
    shape = (6, 5)
    arrays = {"Param": rng.randn(*shape).astype(np.float32),
              "Grad": rng.randn(*shape).astype(np.float32),
              "LearningRate": np.array([0.01], np.float32)}
    for slot in state_slots:
        if slot in ("Moment1", "MeanGrad", "LinearAccumulator", "Velocity") \
                or (op_type == "adamax" and slot == "Moment") \
                or (op_type == "rmsprop" and slot == "Moment"):
            arrays[slot] = (0.1 * rng.randn(*shape)).astype(np.float32)
        else:   # accumulators of squares, an infinity norm: positive
            arrays[slot] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    for slot, v in scalars.items():
        arrays[slot] = np.array([v], np.float32)
    if zero == "state":
        for slot in state_slots:
            arrays[slot][:] = 0
    elif zero == "grad-rows":
        arrays["Grad"][::2] = 0
    elif zero is not None:
        arrays[zero][:] = 0
    return arrays


def _run_rule(pkg, op_type, attrs, arrays):
    state_slots, _, _, _ = RULES[op_type]
    main = pkg.Program()
    block = main.global_block()
    for n, a in arrays.items():
        block.create_var(name=n, shape=a.shape, dtype="float32",
                         persistable=True)
    outputs = {"ParamOut": ["Param"]}
    outputs.update({out: [slot] for slot, out in state_slots.items()})
    block.append_op(op_type, inputs={n: [n] for n in arrays},
                    outputs=outputs, attrs=attrs)
    scope = pkg.Scope()
    _set_state(pkg, scope, arrays)
    names = ["Param"] + list(state_slots)
    got = pkg.Executor(pkg.CPUPlace()).run(main, fetch_list=names,
                                           scope=scope)
    return dict(zip(names, (np.asarray(g) for g in got)))


@pytest.mark.parametrize("case,op_type,over,zero", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_update_rule_matches_the_reference(case, op_type, over, zero):
    attrs = dict(RULES[op_type][3], **over)
    rng = np.random.RandomState(sum(map(ord, case)))
    arrays = _rule_inputs(op_type, zero, rng)
    if not RULES[op_type][2]:
        del arrays["LearningRate"]
    want = _run_rule(jfluid, op_type, attrs, arrays)
    got = _run_rule(fluid, op_type, attrs, arrays)
    for n in want:
        assert np.isfinite(got[n]).all(), n
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    assert np.abs(got["Param"] - arrays["Param"]).max() > 0 or \
        zero == "Param"


# ---------------------------------------------------------------------------
# optimizer classes, clips and per-parameter rates on tiny DeepFM
# ---------------------------------------------------------------------------

def _feed(cfg, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.sparse_feature_dim,
                      (BATCH, cfg.num_fields, 1)).astype(np.int64)
    ids[1] = ids[0]
    return {"sparse_ids": ids,
            "dense_value": rng.rand(BATCH, cfg.dense_dim).astype(np.float32),
            "label": rng.randint(0, 2, (BATCH, 1)).astype(np.int64)}


def build_deepfm(pkg, mod, make_opt, tweak=None):
    """Tiny DeepFM's forward as ``build_train`` builds it, then
    ``tweak(pkg, main)`` (clip or rate attributes on the parameters) and
    ``make_opt(pkg).minimize``."""
    cfg = mod.tiny_config()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data(name="sparse_ids", shape=[cfg.num_fields, 1],
                              dtype="int64")
        dense = pkg.layers.data(name="dense_value", shape=[cfg.dense_dim],
                                dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = mod.deepfm(ids, dense, label, cfg)
        if tweak is not None:
            tweak(pkg, main)
        opt = make_opt(pkg)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, opt, params_grads


def _op_list(prog):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in prog.global_block().ops]


def _var_map(prog):
    return {n: (v.shape, v.dtype, v.persistable)
            for n, v in prog.global_block().vars.items()}


def train_both(make_opt, tweak=None, fetch=()):
    """The program in both packages, JAX's startup state carried into the
    port, STEPS steps each; fetches ``fetch(main)`` names at step 1."""
    out = {}
    init = None
    for key, pkg, mod in PKGS:
        main, startup, loss, opt, pg = build_deepfm(pkg, mod, make_opt,
                                                    tweak)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        if init is None:
            exe.run(startup, scope=scope)
            init = {n: np.array(scope.find_var(n)) for n in names}
        else:
            _set_state(pkg, scope, init)
        extra = list(fetch(main)) if fetch else []
        losses, first = [], None
        feed = _feed(mod.tiny_config())
        for i in range(STEPS):
            got = exe.run(main, feed=feed, fetch_list=[loss] +
                          (extra if i == 0 else []), scope=scope)
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            if i == 0:
                first = [np.asarray(g) for g in got[1:]]
        after = {n: np.asarray(scope.find_var(n)) if pkg is jfluid else
                 scope.find_var_numpy(n) for n in names}
        out[key] = dict(main=main, startup=startup, losses=losses,
                        first=first, after=after, names=names, opt=opt,
                        params_grads=pg)
    return out["jax"], out["port"]


def _check_training(j, p):
    assert _op_list(p["main"]) == _op_list(j["main"])
    assert _op_list(p["startup"]) == _op_list(j["startup"])
    assert _var_map(p["main"]) == _var_map(j["main"])
    assert p["names"] == j["names"]
    assert np.isfinite(p["losses"]).all()
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-4)
    for n in j["names"]:
        np.testing.assert_allclose(p["after"][n], j["after"][n], atol=1e-5,
                                   rtol=0, err_msg=n)


# name -> (constructor on a package, accumulators each parameter gets)
OPTIMIZERS = {
    "LarsMomentum": (lambda pkg: pkg.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9), ("velocity",)),
    "Adamax": (lambda pkg: pkg.optimizer.AdamaxOptimizer(1e-3),
               ("moment", "inf_norm", "beta1_pow_acc")),
    "Adagrad": (lambda pkg: pkg.optimizer.AdagradOptimizer(
        1e-2, initial_accumulator_value=0.1), ("moment",)),
    "DecayedAdagrad": (lambda pkg: pkg.optimizer.DecayedAdagradOptimizer(
        1e-2), ("moment",)),
    "Adadelta": (lambda pkg: pkg.optimizer.AdadeltaOptimizer(1.0),
                 ("__avg_squared_grad", "__avg_squared_update")),
    "RMSProp": (lambda pkg: pkg.optimizer.RMSPropOptimizer(
        1e-3, momentum=0.9, centered=True),
        ("momentum", "mean_square", "mean_grad")),
    "Ftrl": (lambda pkg: pkg.optimizer.FtrlOptimizer(
        1e-2, l1=1e-4, l2=1e-4), ("squared", "linear")),
    "Lamb": (lambda pkg: pkg.optimizer.LambOptimizer(1e-3),
             ("moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc")),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_trains_tiny_deepfm_as_the_reference(name):
    make_opt, accs = OPTIMIZERS[name]
    j, p = train_both(make_opt)
    _check_training(j, p)
    types = [op.type for op in p["main"].global_block().ops]
    op_type = {"LarsMomentum": "lars_momentum",
               "DecayedAdagrad": "decayed_adagrad"}.get(name, name.lower())
    assert types.count(op_type) == 8
    for param, _ in p["params_grads"]:
        for acc in accs:
            var = p["opt"]._get_accumulator(acc, param)
            assert var.persistable and var.name.startswith(param.name)
    # the short alias is the class
    assert getattr(fluid.optimizer, name) is \
        type(make_opt(fluid))


def _tower(main):
    return [v for v in main.global_block().all_parameters()
            if v.name.startswith("fc_")]


def _clip_tower_by_value(pkg, main):
    for v in _tower(main):
        v.gradient_clip_attr = pkg.clip.GradientClipByValue(0.01)


def _clip_all(strategy):
    def tweak(pkg, main):
        pkg.clip.set_gradient_clip(strategy(pkg), program=main)
    return tweak


def _emb_rate(pkg, main):
    main.global_block().var("fm_emb").optimize_attr["learning_rate"] = 0.5


CLIPS = {
    "by_value_per_param": _clip_tower_by_value,
    "by_value": _clip_all(lambda pkg: pkg.clip.GradientClipByValue(
        0.02, min=-0.01)),
    "by_norm": _clip_all(lambda pkg: pkg.clip.GradientClipByNorm(0.05)),
    "by_global_norm": _clip_all(
        lambda pkg: pkg.clip.GradientClipByGlobalNorm(0.1)),
    "by_global_norm_loose": _clip_all(
        lambda pkg: pkg.clip.GradientClipByGlobalNorm(1e3)),
}


def _clipped(main):
    """The gradients the optimizer ops read."""
    return [op.input("Grad")[0] for op in main.global_block().ops
            if op.type in ("sgd", "adam")]


@pytest.mark.parametrize("clip", list(CLIPS))
def test_gradient_clip_matches_the_reference(clip):
    j, p = train_both(lambda pkg: pkg.optimizer.AdamOptimizer(1e-3),
                      CLIPS[clip], fetch=_clipped)
    _check_training(j, p)
    for a, b in zip(p["first"], j["first"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    ops = p["main"].global_block().ops
    clip_types = {"clip", "clip_by_norm", "squared_l2_norm", "sqrt",
                  "elementwise_max"}
    clip_ops = [op for op in ops if op.type in clip_types]
    assert clip_ops and all(op.attr("op_role") == OpRole.Optimize
                            for op in clip_ops)
    if clip == "by_value_per_param":
        assert [op.type for op in ops].count("clip") == 6
    grads = dict(zip(_clipped(p["main"]), p["first"]))
    if clip == "by_value":
        assert max(g.max() for g in grads.values()) <= 0.02
        assert min(g.min() for g in grads.values()) >= -0.01
    if clip == "by_global_norm":
        norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads.values()))
        assert norm == pytest.approx(0.1, rel=1e-5)


def test_per_parameter_learning_rate_and_clip_with_sgd():
    """SGD with GradientClipByValue on the tower and fm_emb's rate at 0.5:
    one LRSched ``scale`` of the global rate, read by fm_emb's ``sgd``."""
    def tweak(pkg, main):
        _clip_tower_by_value(pkg, main)
        _emb_rate(pkg, main)
    j, p = train_both(lambda pkg: pkg.optimizer.SGDOptimizer(0.5), tweak)
    _check_training(j, p)
    ops = p["main"].global_block().ops
    lr = p["opt"]._global_learning_rate(p["main"])
    scales = [op for op in ops if op.type == "scale" and
              op.input("X") == [lr.name]]
    assert len(scales) == 1
    assert scales[0].attr("scale") == 0.5
    assert scales[0].attr("op_role") == OpRole.LRSched
    sgd = {op.input("Param")[0]: op.input("LearningRate")[0]
           for op in ops if op.type == "sgd"}
    assert sgd.pop("fm_emb") == scales[0].output("Out")[0]
    assert set(sgd.values()) == {lr.name}


def test_unported_wrappers_and_proximal_ops_raise_naming_the_roadmap():
    """The wrappers and the proximal rules raised until they were ported
    (ROADMAP item 6); now each wrapper builds on tiny DeepFM as JAX's
    does, and each proximal rule runs a hand-built program as JAX's does
    (``rtol 1e-6, atol 1e-7``).  tests/test_torch_wrapper_optimizers.py
    trains them."""
    def wrappers(pkg):
        return {
            "LookaheadOptimizer": lambda: pkg.optimizer.LookaheadOptimizer(
                pkg.optimizer.SGDOptimizer(0.1), k=2),
            "DGCMomentumOptimizer": lambda: pkg.optimizer.DGCMomentumOptimizer(
                0.1, momentum=0.9, rampup_begin_step=1),
            "GradientMergeOptimizer": lambda: pkg.optimizer
            .GradientMergeOptimizer(pkg.optimizer.SGDOptimizer(0.1), 2),
            "RecomputeOptimizer": lambda: pkg.optimizer.RecomputeOptimizer(
                pkg.optimizer.SGDOptimizer(0.1))._set_checkpoints(
                    ["fc_0.tmp_2"])}
    for name in wrappers(fluid):
        ops = {}
        for key, pkg, mod in PKGS:
            main = build_deepfm(pkg, mod, lambda pkg: wrappers(pkg)[name]())[0]
            ops[key] = [(op.type, op.inputs, op.outputs, op.attrs)
                        for b in main.blocks for op in b.ops]
        assert ops["port"] == ops["jax"], name
        if name == "RecomputeOptimizer":
            assert ops["port"][0][0] == "recompute"
    for name in ("ModelAverage", "ExponentialMovingAverage"):
        assert callable(getattr(fluid.optimizer, name))
    for op_type in ("proximal_gd", "proximal_adagrad"):
        got = {}
        for key, pkg, _mod in PKGS:
            main = pkg.Program()
            block = main.global_block()
            arrays = {"Param": np.array([0.5, -0.02], np.float32),
                      "Grad": np.array([1.0, 0.1], np.float32),
                      "LearningRate": np.array([0.1], np.float32)}
            outputs = {"ParamOut": ["Param"]}
            if op_type == "proximal_adagrad":
                arrays["Moment"] = np.array([1.0, 2.0], np.float32)
                outputs["MomentOut"] = ["Moment"]
            for n in arrays:
                block.create_var(name=n, shape=(2,), persistable=True)
            block.append_op(op_type, inputs={n: [n] for n in arrays},
                            outputs=outputs, attrs={"l1": 0.1, "l2": 0.01})
            scope = pkg.Scope()
            _set_state(pkg, scope, arrays)
            got[key] = np.asarray(pkg.Executor(pkg.CPUPlace()).run(
                main, fetch_list=["Param"], scope=scope)[0])
        np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------

RUNS = 12


def _exp_closed(t, lr0, ds, rate, stair):
    d = np.floor(t / ds) if stair else t / ds
    return lr0 * rate ** d


def _poly_closed(t, lr0, ds, end, power, cycle):
    if cycle:
        decay = ds * np.maximum(np.ceil(t / ds), 1.0)
        frac = 1.0 - t / decay
    else:
        frac = 1.0 - np.minimum(t, ds) / ds
    return (lr0 - end) * frac ** power + end


def _piecewise_closed(t, boundaries, values):
    return np.array(values)[np.searchsorted(boundaries, t, side="right")]


def _warmup_closed(t, after, ws, start, end):
    return np.where(t < ws, start + (end - start) * np.minimum(t / ws, 1.0),
                    after)


# id -> (build on a package's layers, closed form of the step t = 0, 1, ...)
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 4, 0.5),
                    lambda t: _exp_closed(t, 0.1, 4, 0.5, False)),
    "exponential-staircase": (
        lambda L: L.exponential_decay(0.1, 4, 0.5, staircase=True),
        lambda t: _exp_closed(t, 0.1, 4, 0.5, True)),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 4, 0.3),
                    lambda t: 0.1 * np.exp(-0.3 * t / 4)),
    "natural_exp-staircase": (
        lambda L: L.natural_exp_decay(0.1, 4, 0.3, staircase=True),
        lambda t: 0.1 * np.exp(-0.3 * np.floor(t / 4))),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 4, 0.5),
                     lambda t: 0.1 / (1 + 0.5 * t / 4)),
    "inverse_time-staircase": (
        lambda L: L.inverse_time_decay(0.1, 4, 0.5, staircase=True),
        lambda t: 0.1 / (1 + 0.5 * np.floor(t / 4))),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 8, 1e-3, power=2.0),
                   lambda t: _poly_closed(t, 0.1, 8, 1e-3, 2.0, False)),
    "polynomial-cycle": (
        lambda L: L.polynomial_decay(0.1, 4, 1e-3, power=1.0, cycle=True),
        lambda t: _poly_closed(t, 0.1, 4, 1e-3, 1.0, True)),
    "piecewise": (lambda L: L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
                  lambda t: _piecewise_closed(t, [3, 7], [0.1, 0.05, 0.01])),
    "cosine": (lambda L: L.cosine_decay(0.1, 2, 10),
               lambda t: 0.05 * (np.cos(np.pi * np.floor(t / 2) / 10) + 1)),
    "linear_lr_warmup": (
        lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
        lambda t: _warmup_closed(t, 0.1, 4, 0.0, 0.1)),
    "linear_lr_warmup-of-a-schedule": (
        lambda L: L.linear_lr_warmup(L.exponential_decay(0.1, 4, 0.5), 4,
                                     0.01, 0.1),
        lambda t: _warmup_closed(t, _exp_closed(t, 0.1, 4, 0.5, False), 4,
                                 0.01, 0.1)),
}


def _schedule(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        lr = build(pkg.layers)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    rates = [float(np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0])
                   .reshape(-1)[0]) for _ in range(RUNS)]
    return main, startup, rates


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_rate_per_step_matches_the_reference(name):
    build, closed = SCHEDULES[name]
    jmain, jstart, jrates = _schedule(jfluid, build)
    pmain, pstart, prates = _schedule(fluid, build)
    assert _op_list(pmain) == _op_list(jmain)
    assert _op_list(pstart) == _op_list(jstart)
    assert all(op.attr("op_role") == OpRole.LRSched
               for op in pmain.global_block().ops)
    np.testing.assert_allclose(prates, jrates, rtol=1e-6)
    t = np.arange(RUNS, dtype=np.float64)
    np.testing.assert_allclose(prates, closed(t), rtol=1e-6)


def test_schedule_drives_an_optimizer():
    """A schedule's Variable as Adagrad's rate on tiny DeepFM: the same
    steps as the reference's, and the rate fetched from the optimizer."""
    def make_opt(pkg):
        return pkg.optimizer.AdagradOptimizer(
            pkg.layers.piecewise_decay([1, 2], [0.05, 0.02, 0.01]))
    j, p = train_both(make_opt)
    _check_training(j, p)
    assert p["after"]["@LR_DECAY_COUNTER@"].reshape(-1)[0] == STEPS - 1


# ---------------------------------------------------------------------------
# reverse operators
# ---------------------------------------------------------------------------

OPERATOR_CASES = {
    "scalar-minus-var": (lambda v, iv: 1.0 - v,
                         ["fill_constant_batch_size_like",
                          "elementwise_sub"]),
    "scalar-over-var": (lambda v, iv: 2.0 / v,
                        ["fill_constant_batch_size_like",
                         "elementwise_div"]),
    "neg": (lambda v, iv: -v, ["scale"]),
    "var-minus-scalar": (lambda v, iv: v - 1.0, ["scale"]),
    "int-var-plus-scalar": (lambda v, iv: iv + 3,
                            ["fill_constant_batch_size_like",
                             "elementwise_add"]),
    "scalar-times-int-var": (lambda v, iv: 2 * iv,
                             ["fill_constant_batch_size_like",
                              "elementwise_mul"]),
}


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_reverse_operators_emit_the_reference_ops(case):
    expr, want_types = OPERATOR_CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.uniform(0.5, 2.0, (4, 3)).astype(np.float32)
    ix = rng.randint(-5, 5, (4, 3)).astype(np.int32)
    got = {}
    for key, pkg, _ in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            v = pkg.layers.data("x", [4, 3], append_batch_size=False)
            iv = pkg.layers.data("ix", [4, 3], dtype="int32",
                                 append_batch_size=False)
            out = expr(v, iv)
        res, = pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x, "ix": ix}, fetch_list=[out],
            scope=pkg.Scope())
        got[key] = (main, np.asarray(res), out)
    (jmain, jres, jout), (pmain, pres, pout) = got["jax"], got["port"]
    assert [op.type for op in pmain.global_block().ops] == want_types
    assert _op_list(pmain) == _op_list(jmain)
    assert (pout.shape, pout.dtype) == (jout.shape, jout.dtype)
    assert pres.dtype == jres.dtype
    np.testing.assert_allclose(pres, jres, rtol=RTOL, atol=ATOL)
