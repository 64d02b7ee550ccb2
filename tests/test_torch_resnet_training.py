"""ResNet training in the port (paddle_tpu_torch) against paddle_tpu on the
CPU: the same program (``models.resnet.build_train``: Momentum 0.9 with
L2Decay 1e-4, top-1/top-5 accuracy) built in both packages, JAX's
startup persistables (parameters, BN running statistics, learning rate,
velocities) carried into the port's scope with ``load_numpy_params``,
then three steps on one numpy batch.  With ``FLAGS_conv_pallas`` on, JAX
runs K1 (``conv_pallas.py``) in Pallas interpret mode and the port runs
``Conv3x3Function`` with K1's plain version.

ResNet-18 at 32 x 32, 10 classes, batch 8, learning rate 0.01.  A
smaller batch or the model's default rate 0.1 makes the three steps
chaotic on their own: batch norm over 4 images at the last stage's 1 x 1
maps amplifies rounding, so that the port against itself with another
convolution summation order (``FLAGS_conv_im2col=all``) already differs
by 1e-4 in the step-2 loss.  At batch 8 and rate 0.01 that self-spread is
below 1e-6.

Tolerances:
- float32 (flag off and on): per-step losses ``rtol 1e-4``; step-1
  gradients within ``1e-3`` of each tensor's largest entry; parameters,
  velocities and BN running statistics after step 3 within ``1e-3`` of
  each tensor's largest entry (float32 convolutions summed in other
  orders by XLA and by PyTorch, through three steps);
- pure bf16 (flag on, and off): each per-step loss within
  ``max(2e-2·|loss|, 2·spread)``, where ``spread`` is how far JAX's own
  two conv routes (flag on against flag off) are apart there (6.5% in
  the step-3 loss).  Each step-1 gradient points within twice the angle
  that lies between JAX's two routes' gradients, and that limit is at
  most 60 degrees, so a zero, random or reversed gradient fails.  bf16
  rounds at other points in each route and each framework, and at this
  size most gradients are mostly that rounding: JAX's two routes differ
  by 15-69% of the largest entry of every conv and batch-norm gradient
  (angles up to 29 degrees), and only fc_0's by less than 5%.  Where
  the reference's own entries agree within 25% of its largest (fc_0's
  two, batch_norm_18.w_0, conv2d_7.w_0 and, with the flag on,
  batch_norm_11.w_0 at this size), the gradient is also held entry by
  entry within ``max(5e-2, 2·spread)`` of its largest entry, at most 50%;
- one float32 ResNet-50 step (bottleneck blocks) at 64 x 64, batch 4,
  flag on: loss ``rtol 1e-4``; gradients within 10% in relative L2 norm
  and at cosine >= 0.99 per tensor (see that test for why).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import flags as pflags
from paddle_tpu_torch.fluid.ops import conv_ops
from paddle_tpu_torch.models import resnet

STEPS, LR, CLASSES = 3, 0.01, 10


def build(pkg, mod, bf16=False, **kw):
    """build_train in ``pkg``; with ``bf16`` the Momentum optimizer is
    decorated for pure bf16, as bench.py's bench_resnet does."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if not bf16:
            return (main, startup) + (mod.build_train(**kw),)
        img = pkg.layers.data(name="img", shape=[3, kw["image_size"],
                                                 kw["image_size"]],
                              dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        logits = mod.resnet(img, class_dim=kw["class_dim"],
                            depth=kw["depth"])
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        opt = pkg.optimizer.MomentumOptimizer(
            learning_rate=kw["lr"], momentum=0.9,
            regularization=pkg.regularizer.L2Decay(1e-4))
        pkg.contrib.mixed_precision.decorate(
            opt, use_pure_bf16=True).minimize(loss)
    return main, startup, {"loss": loss}


def make_feed(batch, size, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, CLASSES, (batch, 1)).astype(np.int64)}


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def train(exe, main, scope, feed, loss, grads, steps):
    losses, step1 = [], None
    for i in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss] +
                      (grads if i == 0 else []), scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if i == 0:
            step1 = [np.asarray(g, dtype=np.float32) for g in out[1:]]
    return losses, step1


def compare_run(conv_pallas, bf16=False, depth=18, size=32, batch=8,
                steps=STEPS):
    """Build, start (JAX), carry across, train both; everything the tests
    compare."""
    jflags.set_flag("conv_pallas", conv_pallas)
    pflags.set_flag("conv_pallas", conv_pallas)
    try:
        kw = dict(depth=depth, image_size=size, class_dim=CLASSES, lr=LR)
        jmain, jstartup, jout = build(jfluid, jresnet, bf16, **kw)
        pmain, pstartup, pout = build(fluid, resnet, bf16, **kw)
        feed = make_feed(batch, size)
        jscope = jfluid.Scope()
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup, scope=jscope)
        names = persistables(jmain)
        init = {n: np.array(jscope.find_var(n)) for n in names}
        params = [p.name for p in pmain.global_block().all_parameters()]
        grads = [pmain._grad_name_map[p] for p in params]
        jlosses, jgrads = train(jexe, jmain, jscope, feed,
                                jout["loss"].name, grads, steps)
        jafter = {n: np.array(jscope.find_var(n)) for n in names}
        pscope = fluid.Scope()
        fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
        calls = [0]
        real = conv_ops.conv3x3_bn_relu_reference

        def counted(*a, **k):
            calls[0] += 1
            return real(*a, **k)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(conv_ops, "conv3x3_bn_relu_reference", counted)
            plosses, pgrads = train(fluid.Executor(fluid.CPUPlace()), pmain,
                                    pscope, feed, pout["loss"], grads, steps)
        pafter = {n: pscope.find_var_numpy(n) for n in names}
    finally:
        jflags.set_flag("conv_pallas", False)
        pflags.set_flag("conv_pallas", False)
    return dict(jprogs=(jmain, jstartup), pprogs=(pmain, pstartup),
                names=names, init=init, grads=grads, jlosses=jlosses,
                plosses=plosses, jgrads=jgrads, pgrads=pgrads,
                jafter=jafter, pafter=pafter, k1_calls=calls[0])


RUNS = {"fp32_flag_off": dict(conv_pallas=False),
        "fp32_flag_on": dict(conv_pallas=True),
        "bf16_flag_on": dict(conv_pallas=True, bf16=True),
        "bf16_flag_off": dict(conv_pallas=False, bf16=True)}
# the run whose JAX side gives a bf16 run its reference spread
OTHER_ROUTE = {"bf16_flag_on": "bf16_flag_off",
               "bf16_flag_off": "bf16_flag_on"}
LOSS_RTOL = {"fp32_flag_off": 1e-4, "fp32_flag_on": 1e-4,
             "bf16_flag_on": 2e-2, "bf16_flag_off": 2e-2}
GRAD_TOL = {"fp32_flag_off": 1e-3, "fp32_flag_on": 1e-3,
            "bf16_flag_on": 5e-2, "bf16_flag_off": 5e-2}
# bf16: entries are compared where the reference's own spread is at most
# this share of its largest entry; every gradient's direction is compared
BF16_ENTRY_SPREAD = 0.25
MAX_ANGLE_DEG = 60.0


@pytest.fixture(scope="module")
def runs():
    return {name: compare_run(**kw) for name, kw in RUNS.items()}


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _angle_deg(a, b):
    """The angle between two gradients; 90 degrees when either is 0."""
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    norms = np.linalg.norm(a) * np.linalg.norm(b)
    if norms == 0:
        return 90.0
    return float(np.degrees(np.arccos(np.clip(a @ b / norms, -1.0, 1.0))))


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_have_the_same_ops_and_vars(runs, which):
    for name, r in runs.items():
        jprog, pprog = r["jprogs"][which], r["pprogs"][which]
        assert [op.type for op in pprog.global_block().ops] == \
            [op.type for op in jprog.global_block().ops], name
        assert {n: (v.shape, v.dtype, v.persistable)
                for n, v in pprog.global_block().vars.items()} == \
            {n: (v.shape, v.dtype, v.persistable)
             for n, v in jprog.global_block().vars.items()}, name
        assert getattr(pprog, "_amp_keep", False) == \
            getattr(jprog, "_amp_keep", False)


def test_every_persistable_is_carried_across(runs):
    """Parameters, BN running mean/variance, velocities and the learning
    rate: the port's program reads exactly the JAX scope's persistables."""
    r = runs["fp32_flag_off"]
    assert persistables(r["pprogs"][0]) == r["names"]
    for kind in ("velocity", ".mean", ".variance", "learning_rate", ".w_0",
                 ".b_0"):
        assert any(kind in n for n in r["names"]), kind
    for n in r["names"]:
        assert r["init"][n].shape == r["pafter"][n].shape, n


@pytest.mark.parametrize("name", sorted(RUNS))
def test_per_step_losses_match(runs, name):
    r = runs[name]
    want = np.array(r["jlosses"])
    bound = LOSS_RTOL[name] * np.abs(want)
    if name in OTHER_ROUTE:
        spread = np.abs(want - runs[OTHER_ROUTE[name]]["jlosses"])
        bound = np.maximum(bound, 2 * spread)
    assert len(r["plosses"]) == STEPS
    assert np.isfinite(r["plosses"]).all()
    err = np.abs(np.array(r["plosses"]) - want)
    assert (err <= bound).all(), (r["plosses"], r["jlosses"], bound)
    assert r["plosses"][-1] < r["plosses"][0]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_step1_gradients_match(runs, name):
    r = runs[name]
    other = runs[OTHER_ROUTE[name]] if name in OTHER_ROUTE else None
    assert len(r["pgrads"]) == len(r["grads"]) == 62
    entries = 0
    for i, (g, j, p) in enumerate(zip(r["grads"], r["jgrads"],
                                      r["pgrads"])):
        assert p.shape == j.shape, g
        if other is None:
            assert _rel_err(p, j) <= GRAD_TOL[name], (g, _rel_err(p, j))
            continue
        limit = 2 * _angle_deg(other["jgrads"][i], j)
        assert limit <= MAX_ANGLE_DEG, (g, limit)
        assert _angle_deg(p, j) <= limit, (g, _angle_deg(p, j), limit)
        spread = _rel_err(other["jgrads"][i], j)
        if spread <= BF16_ENTRY_SPREAD:
            entries += 1
            bound = max(GRAD_TOL[name], 2 * spread)
            assert bound <= 0.5
            assert _rel_err(p, j) <= bound, (g, _rel_err(p, j), bound)
    if other is not None:
        assert entries >= 4, entries       # fc_0's two among them


@pytest.mark.parametrize("name", ["fp32_flag_off", "fp32_flag_on"])
def test_state_after_three_steps_matches(runs, name):
    """Parameters, velocities and the BN running statistics (which the
    batch_norm op updates in place) after three steps, within 1e-3 of
    each tensor's largest entry, against JAX's XLA conv route (flag off)
    for both routes of the port.  Both routes compute the same function,
    and the reference's own K1 route is not a usable yardstick here: from
    the same weights its step-3 gradients differ from its XLA route's by
    up to 28% of a tensor's largest entry (conv2d_19.w_0, the last 3x3
    conv), after agreeing within 3e-5 on steps 1 and 2, while the port's
    two routes agree within 3e-5 on all three (ROADMAP.md, queue 3)."""
    r, ref = runs[name], runs["fp32_flag_off"]
    moved = 0
    for n in r["names"]:
        assert _rel_err(r["pafter"][n], ref["jafter"][n]) <= 1e-3, n
        moved += not np.array_equal(r["pafter"][n], r["init"][n])
    stats = [n for n in r["names"] if n.endswith((".mean", ".variance"))]
    assert len(stats) == 40
    assert all(not np.array_equal(r["pafter"][n], r["init"][n])
               for n in stats)
    assert moved > 100


def test_flag_routes_the_stride1_3x3_convs_through_k1(runs):
    """ResNet-18 has two 3x3 convs per basic block, 16 in all; the first
    of stages 2-4 has stride 2, so 13 pass K1's gate.  With the flag on
    the port ran K1 (its plain version, on CPU tensors) 13 times per step,
    with it off never."""
    assert runs["fp32_flag_off"]["k1_calls"] == 0
    assert runs["fp32_flag_on"]["k1_calls"] == 13 * STEPS
    assert runs["bf16_flag_on"]["k1_calls"] == 13 * STEPS
    assert runs["bf16_flag_off"]["k1_calls"] == 0


def _k1_gate_count(depth, size, itemsize):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        resnet.build_train(depth=depth, image_size=size)
    block = main.global_block()
    convs = [op for op in block.ops if op.type == "conv2d"]
    gated = sum(conv_ops.k1_applies(
        (256,) + tuple(block.var(op.input("Input")[0]).shape[1:]), itemsize,
        block.var(op.input("Filter")[0]).shape, op.attr("strides"),
        op.attr("paddings"), op.attr("dilations"), op.attr("groups"))
        for op in convs)
    ops = [op.type for op in block.ops]
    return len(convs), ops.count("batch_norm"), \
        len(block.all_parameters()), gated


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
def test_resnet50_at_224_builds_with_13_k1_convs(itemsize):
    """The chip's main path, built only: ResNet-50 v1.5 at 224 x 224 has
    53 conv2d, 53 batch_norm and 161 parameters, and 13 of its convs pass
    K1's gate (the 3x3 conv of every bottleneck block but the first of
    stages 2-4) in bf16 and in float32."""
    assert _k1_gate_count(50, 224, itemsize) == (53, 53, 161, 13)


def test_resnet50_one_step_with_the_flag():
    """Bottleneck blocks: one float32 ResNet-50 step at 64 x 64, batch 4,
    flag on.  The loss within rtol 1e-4; the gradients within 10% in
    relative L2 norm over all 161 tensors together, and each tensor's
    gradient at cosine >= 0.99 with JAX's.  ResNet-50's gradients at this
    size are ill-conditioned in float32: JAX against itself with another
    conv summation order (``FLAGS_conv_im2col=all``) differs by 4.1% in
    that norm (the port against itself by 1.3%), so a per-entry bound
    of 1e-3 would hold rounding to a precision the reference itself does
    not have."""
    r = compare_run(True, depth=50, size=64, batch=4, steps=1)
    np.testing.assert_allclose(r["plosses"], r["jlosses"], rtol=1e-4)
    assert len(r["grads"]) == 161 and r["k1_calls"] == 13
    j = np.concatenate([g.ravel() for g in r["jgrads"]])
    p = np.concatenate([g.ravel() for g in r["pgrads"]])
    assert np.linalg.norm(p - j) <= 0.1 * np.linalg.norm(j)
    for g, jg, pg in zip(r["grads"], r["jgrads"], r["pgrads"]):
        cos = float((jg * pg).sum() / np.sqrt((jg * jg).sum() *
                                               (pg * pg).sum()))
        assert cos >= 0.99, (g, cos)
