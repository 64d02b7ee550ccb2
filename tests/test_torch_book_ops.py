"""The 21 op types the reference's book models add to the port
(paddle_tpu_torch), each against paddle_tpu on the CPU on the same
seeded numpy inputs: cross_entropy, square_error_cost, cos_sim, nce,
reduce_mean, fill_zeros_like, squeeze2, stack, expand, range,
less_than, where, sequence_mask, sequence_pool, sequence_conv, lstm,
linear_chain_crf, crf_decoding, recurrent, beam_search and
beam_search_decode.

Each case builds the same small program in both packages: the op on
data inputs, then ``mean(out * c)`` with a fixed random ``c`` so every
gradient entry differs, and ``fluid.gradients`` for the float inputs the
op differentiates.  The integer and bool outputs are held exactly.

Tolerances, float32: forward and gradients ``rtol 1e-5, atol 1e-6``
(the recurrences, lstm, linear_chain_crf and recurrent, sum over steps
in another order than ``lax.scan``: ``rtol 1e-4, atol 1e-5``).

``nce`` draws its noise classes from each framework's own RNG, so no
draw matches across them: its Cost is held at ``rtol 1e-5`` to the JAX
rule's formula restated in numpy on the port's own SampleLabels, each
sampler's frequencies over 20,000 draws within 5 standard errors of its
distribution, and its gradient within ``2e-3`` relative of a central
finite difference in float64 over the same samples.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5


def _run(pkg, build, feed):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = build(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    return [np.asarray(o) for o in
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope)], main


def _both(build, feed, rtol=RTOL, atol=ATOL, init=None):
    """Run ``build`` in both packages; with ``init`` ({name: array}) the
    startup's persistables are overwritten in both scopes first."""
    if init is None:
        jout, _ = _run(jfluid, build, feed)
        pout, main = _run(fluid, build, feed)
    else:
        jout, pout, main = _run_with(build, feed, init)
    assert len(pout) == len(jout)
    for i, (p, j) in enumerate(zip(pout, jout)):
        assert p.shape == j.shape, (i, p.shape, j.shape)
        if p.dtype.kind in "biu":
            np.testing.assert_array_equal(p, j, err_msg=str(i))
        else:
            np.testing.assert_allclose(p, j, rtol=rtol, atol=atol,
                                       err_msg=str(i))
    return pout, main


def _run_with(build, feed, init):
    outs = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        if pkg is jfluid:
            arrays = {n: np.array(scope.find_var(n)) for n in names}
            arrays.update(init)
            import jax.numpy as jnp
            for n, v in arrays.items():
                scope.set_var(n, jnp.asarray(v))
        else:
            arrays = {n: scope.find_var_numpy(n) for n in names}
            arrays.update(init)
            fluid.load_numpy_params(scope, arrays, fluid.CPUPlace())
        outs.append([np.asarray(o) for o in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)])
    return outs[0], outs[1], main


def _data(pkg, name, arr, grad=True):
    v = pkg.layers.data(name, list(arr.shape), dtype=str(arr.dtype),
                        append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _loss(pkg, out, c):
    return pkg.layers.mean(pkg.layers.elementwise_mul(out, c))


def _grads(pkg, out, wrt, c):
    return [out] + pkg.gradients(_loss(pkg, out, _data(pkg, "c", c, False)),
                                 wrt)


def _probs(rng, shape):
    e = np.exp(rng.randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# -- the losses ------------------------------------------------------------

@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy(soft):
    """Hard and soft labels; one hard label picks an exact 0, whose log
    the 1e-20 clamp bounds (its gradient is 0 in both)."""
    rng = np.random.RandomState(1)
    x = _probs(rng, (6, 5))
    lab = _probs(rng, (6, 5)) if soft else \
        rng.randint(0, 5, (6, 1)).astype(np.int64)
    if not soft:
        x[2, lab[2, 0]] = 0.0
    c = rng.randn(6, 1).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        out = pkg.layers.cross_entropy(xv, _data(pkg, "lab", lab, False),
                                       soft_label=soft)
        return _grads(pkg, out, [xv], c)

    (out, gx), _ = _both(build, {"x": x, "lab": lab, "c": c})
    assert out.shape == (6, 1)
    if not soft:
        assert out[2, 0] == pytest.approx(-np.log(np.float32(1e-20)))


def test_square_error_cost():
    rng = np.random.RandomState(2)
    x, y, c = (rng.randn(8, 1).astype(np.float32) for _ in range(3))

    def build(pkg):
        xv, yv = _data(pkg, "x", x), _data(pkg, "y", y)
        return _grads(pkg, pkg.layers.square_error_cost(xv, yv), [xv, yv], c)

    _both(build, {"x": x, "y": y, "c": c})


@pytest.mark.parametrize("yrows", [6, 1], ids=["rows", "broadcast_row"])
def test_cos_sim(yrows):
    rng = np.random.RandomState(3)
    x = rng.randn(6, 7).astype(np.float32)
    y = rng.randn(yrows, 7).astype(np.float32)
    c = rng.randn(6, 1).astype(np.float32)

    def build(pkg):
        xv, yv = _data(pkg, "x", x), _data(pkg, "y", y)
        return _grads(pkg, pkg.layers.cos_sim(xv, yv), [xv, yv], c)

    _both(build, {"x": x, "y": y, "c": c})


# -- nce ---------------------------------------------------------------------

def _nce_program(pkg, x, lab, classes, k, sampler, custom=None):
    xv = _data(pkg, "x", x)
    kw = {}
    if custom is not None:
        kw["custom_dist"] = _data(pkg, "dist", custom, False)
    cost = pkg.layers.nce(xv, _data(pkg, "lab", lab, False),
                          num_total_classes=classes, num_neg_samples=k,
                          sampler=sampler, **kw)
    op = [o for o in pkg.default_main_program().global_block().ops
          if o.type == "nce"][0]
    return xv, cost, op


def _nce_cost_numpy(x, lab, w, b, samples, q):
    """The JAX rule's cost (nn_ops.py:531-537) in float64 numpy."""
    k = samples.shape[1]
    lt = (w[lab] * x).sum(-1) + b[lab]
    ln = (w[samples] * x[:, None, :]).sum(-1) + b[samples]
    sp = np.logaddexp
    return sp(0, -(lt - np.log(k * q(lab)))) + \
        sp(0, ln - np.log(k * q(samples))).sum(-1)


NCE_SAMPLERS = {
    "uniform": lambda C: (lambda c: np.full(np.shape(c), 1.0 / C)),
    "log_uniform": lambda C: (lambda c: np.log((np.asarray(c) + 2.0) /
                                               (np.asarray(c) + 1.0))
                              / np.log(C + 1.0)),
}


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform",
                                     "custom_dist"])
def test_nce_cost_is_the_jax_formula_on_the_port_samples(sampler):
    rng = np.random.RandomState(4)
    B, D, C, k = 8, 6, 12, 5
    x = rng.randn(B, D).astype(np.float32)
    lab = rng.randint(0, C, (B, 1)).astype(np.int64)
    custom = _probs(rng, (C,)) if sampler == "custom_dist" else None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xv, cost, op = _nce_program(fluid, x, lab, C, k,
                                    "uniform" if custom is not None
                                    else sampler, custom)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w_name, b_name = op.input("Weight")[0], op.input("Bias")[0]
    w = rng.randn(C, D).astype(np.float32) * 0.5
    b = rng.randn(C, 1).astype(np.float32) * 0.5
    fluid.load_numpy_params(scope, {w_name: w, b_name: b}, fluid.CPUPlace())
    feed = {"x": x, "lab": lab}
    if custom is not None:
        feed["dist"] = custom
    got, samples = exe.run(main, feed=feed, scope=scope,
                           fetch_list=[cost, op.output("SampleLabels")[0]])
    samples = np.asarray(samples)
    assert samples.shape == (B, k) and samples.dtype == np.int64
    assert samples.min() >= 0 and samples.max() < C
    q = (lambda c: custom.astype(np.float64)[c]) if custom is not None \
        else NCE_SAMPLERS[sampler](C)
    want = _nce_cost_numpy(x.astype(np.float64), lab[:, 0], w.astype(
        np.float64), b[:, 0].astype(np.float64), samples, q)
    np.testing.assert_allclose(np.asarray(got)[:, 0], want, rtol=1e-5)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform",
                                     "custom_dist"])
def test_nce_sampler_frequencies(sampler):
    """20,000 draws (B=4000, k=5) from the op's sampler: each class's
    count within 5 standard errors of ``n·q(c)``."""
    rng = np.random.RandomState(5)
    B, D, C, k = 4000, 2, 10, 5
    x = rng.randn(B, D).astype(np.float32)
    lab = rng.randint(0, C, (B, 1)).astype(np.int64)
    custom = _probs(rng, (C,)) if sampler == "custom_dist" else None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, cost, op = _nce_program(fluid, x, lab, C, k,
                                   "uniform" if custom is not None
                                   else sampler, custom)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": x, "lab": lab}
    if custom is not None:
        feed["dist"] = custom
    samples = np.asarray(exe.run(main, feed=feed, scope=scope, fetch_list=[
        op.output("SampleLabels")[0]])[0])
    n = samples.size
    counts = np.bincount(samples.reshape(-1), minlength=C)
    q = custom.astype(np.float64) if custom is not None else \
        NCE_SAMPLERS[sampler](C)(np.arange(C))
    assert q.sum() == pytest.approx(1.0, abs=1e-6)
    se = np.sqrt(n * q * (1 - q))
    assert (np.abs(counts - n * q) <= 5 * se).all(), (counts, n * q, se)


def test_nce_gradient_sees_the_forward_samples():
    """d Cost / d Input and d Cost / d Weight from the grad op against a
    central finite difference of the numpy cost over the samples the
    forward drew (the grad op differentiates the taped forward)."""
    rng = np.random.RandomState(6)
    B, D, C, k = 4, 3, 9, 4
    x = rng.randn(B, D).astype(np.float32)
    lab = rng.randint(0, C, (B, 1)).astype(np.int64)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xv, cost, op = _nce_program(fluid, x, lab, C, k, "uniform")
        loss = fluid.layers.reduce_sum(cost)
        w_name, b_name = op.input("Weight")[0], op.input("Bias")[0]
        main_block = main.global_block()
        gx, gw = fluid.gradients(loss, [xv, main_block.var(w_name)])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = rng.randn(C, D).astype(np.float32) * 0.5
    b = rng.randn(C, 1).astype(np.float32) * 0.5
    fluid.load_numpy_params(scope, {w_name: w, b_name: b}, fluid.CPUPlace())
    got = exe.run(main, feed={"x": x, "lab": lab}, scope=scope,
                  fetch_list=[gx, gw, op.output("SampleLabels")[0]])
    gx_got, gw_got, samples = (np.asarray(g) for g in got)
    q = NCE_SAMPLERS["uniform"](C)
    x64, w64, b64 = (a.astype(np.float64) for a in (x, w, b[:, 0]))

    def f(xx, ww):
        return _nce_cost_numpy(xx, lab[:, 0], ww, b64, samples, q).sum()

    eps = 1e-6
    for got_g, base, fn in ((gx_got, x64, lambda v: f(v, w64)),
                            (gw_got, w64, lambda v: f(x64, v))):
        fd = np.zeros_like(base)
        for idx in np.ndindex(base.shape):
            up, dn = base.copy(), base.copy()
            up[idx] += eps
            dn[idx] -= eps
            fd[idx] = (fn(up) - fn(dn)) / (2 * eps)
        np.testing.assert_allclose(got_g, fd, rtol=2e-3,
                                   atol=2e-3 * np.abs(fd).max())


# -- reduce_mean and the tensor ops ----------------------------------------

@pytest.mark.parametrize("dim,keep", [([1], False), ([0, 2], True),
                                      (None, False)],
                         ids=["dim1", "dims02_keep", "all"])
def test_reduce_mean(dim, keep):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 5).astype(np.float32)
    shape = np.mean(x, axis=None if dim is None else tuple(dim),
                    keepdims=keep).shape
    c = rng.randn(*(shape or (1,))).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        out = pkg.layers.reduce_mean(xv, dim=dim, keep_dim=keep)
        return _grads(pkg, out, [xv], c)

    (out, _), _ = _both(build, {"x": x, "c": c})
    assert out.shape == shape


TENSOR_CASES = ["fill_zeros_like", "squeeze2", "stack", "expand", "where"]


@pytest.mark.parametrize("case", TENSOR_CASES)
def test_tensor_ops_forward_and_gradients(case):
    rng = np.random.RandomState(TENSOR_CASES.index(case))
    x = rng.randn(3, 1, 4).astype(np.float32)
    y = rng.randn(3, 1, 4).astype(np.float32)
    cond = rng.rand(3, 1, 4) < 0.5

    def build(pkg):
        L = pkg.layers
        xv, yv = _data(pkg, "x", x), _data(pkg, "y", y)
        if case == "fill_zeros_like":
            return [L.zeros_like(xv)]
        if case == "squeeze2":
            out = L.squeeze(xv, [1])
            wrt = [xv]
        elif case == "stack":
            out = L.stack([xv, yv], axis=1)
            wrt = [xv, yv]
        elif case == "expand":
            out = L.expand(xv, [2, 3, 1])
            wrt = [xv]
        else:
            out = L.where(_data(pkg, "cond", cond, False), xv, yv)
            wrt = [xv, yv]
        return _grads(pkg, out, wrt, c)

    shape = {"fill_zeros_like": (3, 1, 4), "squeeze2": (3, 4),
             "stack": (3, 2, 1, 4), "expand": (6, 3, 4),
             "where": (3, 1, 4)}[case]
    c = rng.randn(*shape).astype(np.float32)
    outs, main = _both(build, {"x": x, "y": y, "cond": cond, "c": c})
    assert outs[0].shape == shape
    assert case in [op.type for op in main.global_block().ops]


@pytest.mark.parametrize("bounds", [(0, 7, 1), (2, 11, 3)],
                         ids=["0_7_1", "2_11_3"])
def test_range_and_less_than(bounds):
    """``range`` with static bounds (int64 in the port; the JAX package
    runs without x64 and gives int32: the values are held) and
    ``less_than`` against lengths, broadcast."""
    lens = np.array([[3], [0], [9]], np.int64)

    def build(pkg):
        t = pkg.layers.range(*bounds)
        return [t, pkg.layers.less_than(t, _data(pkg, "lens", lens, False))]

    (t, m), _ = _both(build, {"lens": lens})
    np.testing.assert_array_equal(t, np.arange(*bounds))
    assert m.dtype == np.bool_
    np.testing.assert_array_equal(m, np.arange(*bounds)[None, :] < lens)


# -- the sequence ops --------------------------------------------------------

LENS = np.array([5, 1, 3, 0], np.int64)


def test_sequence_mask():
    def build(pkg):
        lens = _data(pkg, "lens", LENS, False)
        return [pkg.layers.sequence_mask(lens, maxlen=6, dtype=dt)
                for dt in ("float32", "int64")]

    (f, i), _ = _both(build, {"lens": LENS})
    np.testing.assert_array_equal(f, np.arange(6)[None, :] < LENS[:, None])


POOLS = ["SUM", "AVERAGE", "SQRT", "MAX", "FIRST", "LAST"]


@pytest.mark.parametrize("pooltype", POOLS)
def test_sequence_pool(pooltype):
    """Every pool type over ragged lengths (one row empty); row 0's
    first feature column holds a tie of two maxima inside its length,
    whose MAX gradient is split evenly, as ``jnp.max`` splits it."""
    rng = np.random.RandomState(POOLS.index(pooltype))
    x = rng.randn(4, 6, 3).astype(np.float32)
    x[0, 1, 0] = x[0, 3, 0] = 5.0
    c = rng.randn(4, 3).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        out = pkg.layers.sequence_pool(xv, pooltype,
                                       length=_data(pkg, "lens", LENS, False))
        return _grads(pkg, out, [xv], c)

    (out, gx), _ = _both(build, {"x": x, "lens": LENS, "c": c})
    if pooltype == "MAX":
        assert out[0, 0] == 5.0
        assert gx[0, 1, 0] == gx[0, 3, 0] == pytest.approx(
            c[0, 0] / c.size / 2)


@pytest.mark.parametrize("filter_size", [3, 4])
def test_sequence_conv(filter_size):
    rng = np.random.RandomState(filter_size)
    x = rng.randn(4, 6, 5).astype(np.float32)
    c = rng.randn(4, 6, 7).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        out = pkg.layers.sequence_conv(
            xv, num_filters=7, filter_size=filter_size,
            length=_data(pkg, "lens", LENS, False), act="tanh")
        params = pkg.default_main_program().global_block().all_parameters()
        return _grads(pkg, out, [xv] + params, c)

    w = rng.randn(filter_size * 5, 7).astype(np.float32) * 0.3
    b = rng.randn(7).astype(np.float32)
    _both(build, {"x": x, "lens": LENS, "c": c},
          init={"sequence_conv_0.w_0": w, "sequence_conv_0.b_0": b})


# -- lstm, the CRF -------------------------------------------------------------

@pytest.mark.parametrize("is_reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("peepholes", [True, False],
                         ids=["peepholes", "no_peepholes"])
def test_lstm(is_reverse, peepholes):
    """dynamic_lstm over ragged lengths, with H0/C0, forward and
    reverse (within each length), bias [1, 7D] with the peepholes:
    Hidden, Cell and the gradients of Input, Weight, Bias, H0 and C0."""
    rng = np.random.RandomState(8 + is_reverse)
    B, T, D = 4, 6, 3
    x = rng.randn(B, T, 4 * D).astype(np.float32)
    h0 = rng.randn(B, D).astype(np.float32)
    c0 = rng.randn(B, D).astype(np.float32)
    c = rng.randn(B, T, D).astype(np.float32)
    w = (rng.randn(D, 4 * D) * 0.5).astype(np.float32)
    b = (rng.randn(1, (7 if peepholes else 4) * D) * 0.5).astype(np.float32)

    def build(pkg):
        xv, hv, cv = _data(pkg, "x", x), _data(pkg, "h0", h0), \
            _data(pkg, "c0", c0)
        hidden, cell = pkg.layers.dynamic_lstm(
            xv, size=4 * D, length=_data(pkg, "lens", LENS, False), h_0=hv,
            c_0=cv, is_reverse=is_reverse, use_peepholes=peepholes)
        params = pkg.default_main_program().global_block().all_parameters()
        loss = pkg.layers.elementwise_add(
            _loss(pkg, hidden, _data(pkg, "c", c, False)),
            pkg.layers.mean(cell))
        return [hidden, cell] + pkg.gradients(loss, [xv, hv, cv] + params)

    outs, _ = _both(build, {"x": x, "h0": h0, "c0": c0, "lens": LENS,
                            "c": c}, SCAN_RTOL, SCAN_ATOL,
                    init={"lstm_0.w_0": w, "lstm_0.b_0": b})
    hidden = outs[0]
    assert (hidden[1, 1:] == 0).all() and (hidden[3] == 0).all()


def _crf_inputs(seed):
    rng = np.random.RandomState(seed)
    B, T, C = 4, 6, 5
    em = rng.randn(B, T, C).astype(np.float32)
    lab = rng.randint(0, C, (B, T)).astype(np.int64)
    trans = (rng.randn(C + 2, C) * 0.5).astype(np.float32)
    return em, lab, trans


def test_linear_chain_crf():
    em, lab, trans = _crf_inputs(9)
    c = np.random.RandomState(10).randn(4, 1).astype(np.float32)
    lens = np.array([6, 1, 4, 2], np.int64)

    def build(pkg):
        ev = _data(pkg, "em", em)
        nll = pkg.layers.linear_chain_crf(
            ev, _data(pkg, "lab", lab, False),
            length=_data(pkg, "lens", lens, False),
            param_attr=pkg.ParamAttr(name="crfw"))
        tv = pkg.default_main_program().global_block().var("crfw")
        return _grads(pkg, nll, [ev, tv], c)

    (nll, _, _), _ = _both(build, {"em": em, "lab": lab, "lens": lens,
                                   "c": c}, SCAN_RTOL, SCAN_ATOL,
                           init={"crfw": trans})
    assert (nll > 0).all()


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["path", "indicator"])
def test_crf_decoding(with_label):
    """The Viterbi path (0 past each length), or with Label the 0/1
    indicator of the positions it gets right; one row of equal
    emissions makes argmax break ties (first maximum in both)."""
    em, lab, trans = _crf_inputs(11)
    em[2] = 0.0
    lens = np.array([6, 1, 4, 0], np.int64)

    def build(pkg):
        kw = {"label": _data(pkg, "lab", lab, False)} if with_label else {}
        return [pkg.layers.crf_decoding(
            _data(pkg, "em", em, False), length=_data(pkg, "lens", lens,
                                                      False),
            param_attr=pkg.ParamAttr(name="crfw"), **kw)]

    (path,), _ = _both(build, {"em": em, "lab": lab, "lens": lens},
                       init={"crfw": trans})
    assert path.shape == (4, 6, 1)
    assert (path[3] == 0).all() and (path[1, 1:] == 0).all()


# -- recurrent -----------------------------------------------------------------

def _static_rnn(pkg, xv, h0v, reverse_input=False):
    """A StaticRNN: h_t = tanh(fc([x_t, h_{t-1}])) with a second memory
    carrying a running sum; outputs both memories' new values."""
    L = pkg.layers
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(xv)
        h = rnn.memory(init=h0v)
        s = rnn.memory(shape=[3], batch_ref=x_t, init_value=0.5)
        nh = L.fc(L.concat([x_t, h], axis=-1), size=3, act="tanh",
                  param_attr="rnn_w", bias_attr="rnn_b")
        ns = L.elementwise_add(s, L.scale(nh, scale=0.5))
        rnn.update_memory(h, nh)
        rnn.update_memory(s, ns)
        rnn.output(nh, ns)
    return rnn()


def test_recurrent_gradients_wrt_inputs_initials_and_params():
    """One ``recurrent`` op (StaticRNN, T=5): its Outputs, and the
    gradients of Inputs (x), Initials (h0) and Params (the step fc's
    weight and bias), against JAX's ``lax.scan`` replay."""
    rng = np.random.RandomState(12)
    x = rng.randn(5, 4, 2).astype(np.float32)
    h0 = rng.randn(4, 3).astype(np.float32)
    c = rng.randn(5, 4, 3).astype(np.float32)
    w = (rng.randn(5, 3) * 0.5).astype(np.float32)
    b = (rng.randn(3) * 0.5).astype(np.float32)

    def build(pkg):
        xv, hv = _data(pkg, "x", x), _data(pkg, "h0", h0)
        out_h, out_s = _static_rnn(pkg, xv, hv)
        block = pkg.default_main_program().global_block()
        loss = pkg.layers.elementwise_add(
            _loss(pkg, out_h, _data(pkg, "c", c, False)),
            pkg.layers.mean(out_s))
        return [out_h, out_s] + pkg.gradients(
            loss, [xv, hv, block.var("rnn_w"), block.var("rnn_b")])

    outs, main = _both(build, {"x": x, "h0": h0, "c": c}, SCAN_RTOL,
                       SCAN_ATOL, init={"rnn_w": w, "rnn_b": b})
    rec = [op for op in main.global_block().ops if op.type == "recurrent"]
    assert len(rec) == 1 and len(main.blocks) == 2
    assert {"rnn_w", "rnn_b"} <= set(rec[0].input("Params"))
    assert "recurrent_grad" in [op.type for op in main.global_block().ops]
    assert all(np.abs(g).max() > 0 for g in outs[2:])


# -- beam search -----------------------------------------------------------------

def test_beam_search_tied_candidates():
    """One step on [B=3, K=3, C=3]: row 0 has two finished beams (their
    other candidates score -1e9, ties the selection must break by the
    lower flat index, as ``lax.top_k`` does), row 1 ties among live
    candidates, row 2 is ordinary."""
    rng = np.random.RandomState(13)
    B, K, C, END = 3, 3, 3, 1
    pre_ids = np.array([[1, 1, 4], [5, 6, 7], [2, 3, 4]], np.int64)
    pre_scores = np.array([[-0.5, -0.7, -1.0], [-1.0, -1.0, -1.0],
                           [-0.1, -0.2, -0.3]], np.float32)
    ids = rng.randint(2, 20, (B, K, C)).astype(np.int64)
    scores = (pre_scores[:, :, None] - rng.rand(B, K, C)).astype(np.float32)
    scores[1] = -2.0
    scores[0, 2] = -1e9

    def build(pkg):
        return list(pkg.layers.beam_search(
            _data(pkg, "pre_ids", pre_ids, False),
            _data(pkg, "pre_scores", pre_scores, False),
            _data(pkg, "ids", ids, False), _data(pkg, "scores", scores, False),
            beam_size=K, end_id=END))

    (sel_ids, sel_scores, parent), _ = _both(
        build, {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
                "scores": scores}, rtol=0, atol=0)
    np.testing.assert_array_equal(sel_ids[0, :2], [END, END])
    np.testing.assert_array_equal(parent[1], [0, 0, 0])
    assert sel_scores[0, 2] == np.float32(-1e9)


def test_top_k_tied_entries_keep_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0] * 5], np.float32)

    def build(pkg):
        return list(pkg.layers.topk(_data(pkg, "x", x, False), k=3))

    (vals, idx), _ = _both(build, {"x": x})
    np.testing.assert_array_equal(idx, [[1, 2, 4], [0, 1, 2]])


def test_beam_search_decode():
    """Backtracking [T=4, B=2, K=2] steps by their parent pointers, held
    also to a numpy walk; every token from a sentence's second end id on
    reads the end id (generation_ops.py:97-100)."""
    END = 1
    ids = np.array([[[3, 4], [5, 6]], [[1, 7], [8, 9]],
                    [[1, 2], [1, 4]], [[5, 1], [6, 7]]], np.int64)
    parents = np.array([[[0, 0], [0, 0]], [[0, 1], [1, 0]],
                        [[0, 1], [0, 1]], [[1, 0], [0, 1]]], np.int64)
    scores = np.random.RandomState(14).randn(4, 2, 2).astype(np.float32)

    def build(pkg):
        return list(pkg.layers.beam_search_decode(
            _data(pkg, "ids", ids, False), _data(pkg, "scores", scores,
                                                 False),
            _data(pkg, "parents", parents, False), beam_size=2, end_id=END))

    (sent, sc), _ = _both(build, {"ids": ids, "scores": scores,
                                  "parents": parents}, rtol=0, atol=0)
    assert sent.shape == (2, 2, 4)
    np.testing.assert_array_equal(sc, scores[-1])
    want = np.zeros((2, 2, 4), np.int64)
    for b in range(2):
        for k in range(2):
            beam = k
            for t in range(3, -1, -1):
                want[b, k, t] = ids[t, b, beam]
                beam = parents[t, b, beam]
    ended = np.cumsum(want == END, axis=-1)
    np.testing.assert_array_equal(sent, np.where(ended > 1, END, want))
