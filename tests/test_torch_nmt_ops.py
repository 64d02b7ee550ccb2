"""The op types Transformer NMT training adds to the port
(paddle_tpu_torch), each against paddle_tpu on the CPU on the same
seeded numpy inputs: ``elementwise_mul``/``_div``/``_min``/``_pow``
with Paddle's ``axis`` broadcasting, ``-``, ``*`` and ``/`` between two
Variables (``elementwise_sub`` among them), ``reduce_sum`` over
``dim`` lists, with ``keep_dim`` and ``reduce_all``, ``one_hot`` on
int64 ids, ``increment``, and ``noam_decay`` over ten runs against its
closed form.

Each case builds the same small program in both packages: the op on
data inputs, then ``mean(out * c)`` with a fixed random ``c`` so every
gradient entry differs, and ``fluid.gradients`` for the differentiable
inputs.  Tolerances, float32: forward and gradients ``rtol 1e-6,
atol 1e-7``; the learning rate ``rtol 1e-6`` against the closed form in
float64.
"""

import operator

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as port_executor
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.fluid.framework import OpRole
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7


def _run(pkg, build, feed, steps=1):
    """Build ``build(pkg) -> fetch list`` under fresh programs, run it
    ``steps`` times on the CPU; the last run's fetches."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = build(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return [np.asarray(o) for o in out], main, scope


def _both(build, feed, steps=1):
    jout = _run(jfluid, build, feed, steps)[0]
    pout, main, scope = _run(fluid, build, feed, steps)
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    return pout, main, scope


def _data(pkg, name, arr, grad=True):
    v = pkg.layers.data(name, list(arr.shape), dtype=str(arr.dtype),
                        append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _weighted_loss(pkg, out, c):
    return pkg.layers.mean(pkg.layers.elementwise_mul(out, c))


# (op, x shape, y shape, axis): Paddle aligns Y to X at ``axis``
# (-1: to X's trailing dims)
ELEMENTWISE = [
    ("elementwise_mul", (2, 3, 4, 5), (3, 4), 1),
    ("elementwise_mul", (6, 1), (6, 1), -1),         # loss * w
    ("elementwise_div", (2, 3, 4, 5), (4, 5), -1),
    ("elementwise_div", (1,), (1,), -1),             # sum(loss) / sum(w)
    ("elementwise_div", (2, 3, 4), (2,), 0),
    ("elementwise_min", (2, 3, 4), (2, 3), 0),
    ("elementwise_min", (4, 5), (5,), -1),
    ("elementwise_pow", (3, 4), (4,), -1),
    ("elementwise_pow", (2, 3, 4), (3,), 1),
]


@pytest.mark.parametrize("op,xs,ys,axis", ELEMENTWISE,
                         ids=["%s-%s-%s-axis%d" % (o, "x".join(map(str, a)),
                                                   "x".join(map(str, b)), c)
                              for o, a, b, c in ELEMENTWISE])
def test_elementwise_forward_and_gradients(op, xs, ys, axis):
    rng = np.random.RandomState(len(xs) * 10 + len(ys) + axis)
    if op == "elementwise_pow":
        # a positive base, so dOut/dY = x^y log x is defined
        x = rng.uniform(0.5, 2.0, xs).astype(np.float32)
    else:
        x = rng.randn(*xs).astype(np.float32)
    y = rng.uniform(0.5, 2.0, ys).astype(np.float32) * \
        np.where(rng.rand(*ys) < 0.5, -1, 1).astype(np.float32)
    c = rng.randn(*xs).astype(np.float32)

    def build(pkg):
        xv, yv = _data(pkg, "x", x), _data(pkg, "y", y)
        out = getattr(pkg.layers, op)(xv, yv, axis=axis)
        loss = _weighted_loss(pkg, out, _data(pkg, "c", c, grad=False))
        return [out] + pkg.gradients(loss, [xv, yv])

    (out, gx, gy), _, _ = _both(build, {"x": x, "y": y, "c": c})
    assert out.shape == xs and gx.shape == xs and gy.shape == ys
    assert np.abs(gy).max() > 0


OPERATORS = ["+", "-", "*", "/"]


@pytest.mark.parametrize("shapes", [((6, 1), (6, 1)), ((4, 5), (5,))],
                         ids=["6x1-6x1", "4x5-5"])
@pytest.mark.parametrize("sym", OPERATORS)
def test_operators_between_variables(sym, shapes):
    """``x <sym> y`` on two Variables appends the elementwise op with
    ``axis=-1`` and declares the reference's shapes (``loss * w`` is
    [N, 1]·[N, 1]); forward and gradients against paddle_tpu."""
    rng = np.random.RandomState(OPERATORS.index(sym))
    x = rng.randn(*shapes[0]).astype(np.float32)
    y = rng.uniform(0.5, 2.0, shapes[1]).astype(np.float32)
    c = rng.randn(*shapes[0]).astype(np.float32)

    def build(pkg):
        xv, yv = _data(pkg, "x", x), _data(pkg, "y", y)
        out = {"+": operator.add, "-": operator.sub, "*": operator.mul,
               "/": operator.truediv}[sym](xv, yv)
        assert out.shape == shapes[0]
        loss = _weighted_loss(pkg, out, _data(pkg, "c", c, grad=False))
        return [out] + pkg.gradients(loss, [xv, yv])

    (out, gx, gy), main, _ = _both(build, {"x": x, "y": y, "c": c})
    op = main.global_block().ops[0]
    assert op.type == {"+": "elementwise_add", "-": "elementwise_sub",
                       "*": "elementwise_mul", "/": "elementwise_div"}[sym]
    assert op.attr("axis") == -1 and gy.shape == shapes[1]


# (dim, keep_dim); None reduces every axis (reduce_all)
REDUCE = [(None, False), (None, True), (1, False), ([0, 2], False),
          (-1, True), ([-1, 0], True)]


@pytest.mark.parametrize("dim,keep", REDUCE,
                         ids=["dim%s-keep%d" % (d, k) for d, k in REDUCE])
def test_reduce_sum_forward_and_gradient(dim, keep):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4).astype(np.float32)
    axes = None if dim is None else tuple(
        np.atleast_1d(dim) % x.ndim)
    want_shape = np.sum(x, axis=axes, keepdims=keep).shape
    c = rng.randn(*(want_shape or (1,))).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        out = pkg.layers.reduce_sum(xv, dim=dim, keep_dim=keep)
        loss = _weighted_loss(pkg, out, _data(pkg, "c", c, grad=False))
        return [out] + pkg.gradients(loss, [xv])

    (out, gx), main, _ = _both(build, {"x": x, "c": c})
    # the reference's shapes: 0-d when every axis goes without keep_dim
    assert out.shape == want_shape and gx.shape == x.shape
    op = [o for o in main.global_block().ops if o.type == "reduce_sum"][0]
    assert op.attr("reduce_all") == (dim is None)


def test_one_hot_int64_ids_and_out_of_range_rows():
    """int64 [N, 1] ids → float32 [N, depth]; an id outside [0, depth)
    gives a row of zeros in both packages."""
    ids = np.array([[0], [3], [7], [2], [-1], [8], [5]], np.int64)

    def build(pkg):
        return [pkg.layers.one_hot(_data(pkg, "ids", ids, grad=False), 8)]

    (out,), main, _ = _both(build, {"ids": ids})
    assert out.dtype == np.float32 and out.shape == (7, 8)
    np.testing.assert_array_equal(out.sum(1), [1, 1, 1, 1, 0, 0, 1])
    assert main.global_block().var(
        main.global_block().ops[-1].output("Out")[0]).shape == (7, 8)


def test_one_hot_stops_the_gradient():
    """one_hot is registered stop_gradient, as in the JAX package: a
    label-smoothed loss appends no one_hot_grad."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        logits = fluid.layers.fc(fluid.layers.data("x", [4]), 8)
        label = fluid.layers.data("label", [1], dtype="int64")
        soft = fluid.layers.label_smooth(fluid.layers.one_hot(label, 8),
                                         epsilon=0.1)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, soft, soft_label=True))
        fluid.append_backward(loss)
    types = [op.type for op in main.global_block().ops]
    assert "one_hot" in types and "one_hot_grad" not in types
    assert types.count("scale") == 1        # label_smooth is one scale op


@pytest.mark.parametrize("step", [1.0, 2.5])
def test_increment(step):
    x = np.array([3.25], np.float32)

    def build(pkg):
        helper = pkg.layer_helper.LayerHelper("increment")
        xv = _data(pkg, "x", x, grad=False)
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("increment", inputs={"X": [xv]},
                         outputs={"Out": [out]}, attrs={"step": step})
        return [out]

    (out,), _, _ = _both(build, {"x": x})
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, x + step)


D_MODEL, WARMUP, LR0, RUNS = 512, 4, 2.0, 10


def _noam(pkg):
    return [pkg.layers.noam_decay(D_MODEL, WARMUP, learning_rate=LR0)]


def test_noam_decay_matches_the_closed_form_for_ten_runs():
    """lr_t = lr0·d^-0.5·min(t^-0.5, t·warmup^-1.5) at t = 1..10 (the
    warm-up ramp and the decay after it), run by run, in both packages;
    the counter reads 10 after ten runs."""
    got = {"jax": [], "port": []}
    for key, pkg in (("jax", jfluid), ("port", fluid)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            lr = _noam(pkg)[0]
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        for _ in range(RUNS):
            got[key].append(float(np.asarray(exe.run(
                main, fetch_list=[lr], scope=scope)[0]).reshape(-1)[0]))
        counter = np.asarray(scope.find_var("@LR_DECAY_COUNTER@"))
        np.testing.assert_array_equal(counter.reshape(-1), [RUNS])
    t = np.arange(1, RUNS + 1, dtype=np.float64)
    want = LR0 * D_MODEL ** -0.5 * np.minimum(t ** -0.5, t * WARMUP ** -1.5)
    np.testing.assert_allclose(got["port"], want, rtol=1e-6)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-6)


def test_noam_decay_ops_carry_the_lr_schedule_role():
    """The reference's op sequence and op_role attrs; the counter is one
    persistable float32 variable, initialised to 0 (begin - 1)."""
    progs = {}
    for key, pkg in (("jax", jfluid), ("port", fluid)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            _noam(pkg)
        progs[key] = (main, startup)
    (jmain, jstart), (pmain, pstart) = progs["jax"], progs["port"]
    ops = pmain.global_block().ops
    assert [o.type for o in ops] == [o.type for o in jmain.global_block().ops]
    assert [o.type for o in ops] == ["increment", "fill_constant",
                                     "elementwise_pow", "scale",
                                     "elementwise_min", "scale"]
    assert all(o.attr("op_role") == OpRole.LRSched for o in ops)
    assert [o.attr("op_role") for o in ops] == \
        [o.attr("op_role") for o in jmain.global_block().ops]
    counter = pmain.global_block().var("@LR_DECAY_COUNTER@")
    assert counter.persistable and counter.dtype == "float32"
    assert [(o.type, o.attr("value")) for o in pstart.global_block().ops] \
        == [(o.type, o.attr("value")) for o in jstart.global_block().ops] \
        == [("fill_constant", 0.0)]


def test_other_schedules_raise_naming_the_roadmap():
    """The two schedules this test once saw raise now build the
    reference's ops (exponential_decay: the counter, scale, the
    rate's fill, elementwise_pow, scale; cosine_decay: floor and cos),
    all LRSched, and give its rate run by run (every schedule:
    tests/test_torch_optimizers.py)."""
    for build in (lambda L: L.exponential_decay(0.1, 100, 0.9),
                  lambda L: L.cosine_decay(0.1, 100, 10)):
        progs, rates = {}, {}
        for key, pkg in (("jax", jfluid), ("port", fluid)):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup), pkg.unique_name.guard():
                lr = build(pkg.layers)
            scope = pkg.Scope()
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup, scope=scope)
            rates[key] = [float(np.asarray(exe.run(
                main, fetch_list=[lr], scope=scope)[0]).reshape(-1)[0])
                for _ in range(3)]
            progs[key] = main
        ops = progs["port"].global_block().ops
        assert [(o.type, o.attrs) for o in ops] == \
            [(o.type, o.attrs) for o in progs["jax"].global_block().ops]
        assert all(o.attr("op_role") == OpRole.LRSched for o in ops)
        np.testing.assert_allclose(rates["port"], rates["jax"], rtol=1e-6)


def test_grad_ops_of_the_new_types_pop_their_tape_entries(monkeypatch):
    """elementwise_div_grad, elementwise_mul_grad and reduce_sum_grad each
    pop their forward's tape entry, so the tape is empty when the block
    ends, before the executor clears it."""
    popped, ends = [], []
    real_grad = lowering.tape_grad_lower

    def grad(ctx, op):
        real_grad(ctx, op)
        key = lowering.tape_key(op.attr("__fwd_outputs__"))
        popped.append((op.type, key not in ctx.state.tape))
    monkeypatch.setattr(lowering, "tape_grad_lower", grad)
    real_block = port_executor.run_block

    def run_block(block, env, state, *a):
        real_block(block, env, state, *a)
        ends.append(dict(state.tape))
    monkeypatch.setattr(port_executor, "run_block", run_block)
    rng = np.random.RandomState(0)
    x = rng.randn(6, 1).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (6, 1)).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xv, wv = _data(fluid, "x", x), _data(fluid, "w", w)
        loss = fluid.layers.reduce_sum(xv * wv) / fluid.layers.reduce_sum(wv)
        fluid.append_backward(loss)
    out, gx = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": x, "w": w}, fetch_list=[loss, "x@GRAD"],
        scope=fluid.Scope())
    np.testing.assert_allclose(out, (x * w).sum() / w.sum(), rtol=1e-6)
    np.testing.assert_allclose(gx, w / w.sum(), rtol=1e-6)
    types = sorted(t for t, _ in popped)
    assert types == ["elementwise_div_grad", "elementwise_mul_grad",
                     "reduce_sum_grad", "reduce_sum_grad"]
    assert all(ok for _, ok in popped)
    assert ends == [{}]
