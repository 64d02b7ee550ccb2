"""The 34 core op types of ROADMAP item 13c.3a in the port
(paddle_tpu_torch), each against paddle_tpu on the CPU on the same
seeded numpy inputs: reduce_max, reduce_min, reduce_prod, relu6,
leaky_relu, hard_sigmoid, swish, stanh, pow, log_softmax, cumsum,
transpose, flatten2, flatten, squeeze, unsqueeze, unstack, expand_as,
gather_nd, scatter, lookup_table_v2, shape, arg_max, arg_min, argsort,
pad, reverse, has_nan, has_inf, uniform_random_batch_size_like,
conv2d_transpose, depthwise_conv2d_transpose, huber_loss and auc; and
``fill_any_like``, the op behind ``layers.ones_like``.  Then the layers
of the slice that compose ops already held here or elsewhere
(``dice_loss``, ``npair_loss``, ``l2_normalize``,
``image_resize_short``, ``zeros``, ``ones``, ``sum``) with their
gradients, ``autoincreased_step_counter`` over three runs, and
``gaussian_random`` / ``uniform_random`` by statistics.

The programs are ``chip_smoke.core_programs()``, which the card's
``core_ops`` phase runs too: each builds its op in both packages through
the layer a user calls (a hand-built op for the v1 shape types,
``expand_as``, ``lookup_table_v2`` and the depthwise transpose conv,
which have none), the JAX package's own test inputs with the points
where the two could part fed exactly, every mode side by side, then the
gradients over the float inputs the op differentiates and its
parameters.  ``test_op_against_jax`` holds every fetch of each program;
the tests after it pin those points by hand: the gradient at exact
kinks (relu6 0.5 at 0 and at the threshold, leaky_relu 1 at 0,
hard_sigmoid half the slope at its bounds), shared among tied maxima,
the first extremum of a tie, argsort's stable order in both axes,
scatter's sum over duplicate ids and its dropped out-of-range id,
gather_nd's clamped index, auc's state over three runs, and the
uniform draws by statistics.

Tolerances (``chip_smoke.CORE_TOL``): float32 rules and the composed
layers ``rtol 1e-5, atol 1e-6``; integer outputs and the shape,
selection and fill ops exactly; ``uniform_random_batch_size_like``,
``gaussian_random`` and ``uniform_random`` (whose random streams differ
across packages and devices) by their shape, dtype, range and their mean
and variance within 5 standard errors (``chip_smoke.URBSL_SIGMAS``).
"""

import functools

import numpy as np
import pytest

from chip_smoke import (CORE_TOL, URBSL_SIGMAS, _seq_data, _seq_with_grads,
                        _stats_ok, core_programs, seq_run, seq_weights,
                        urbsl_ok)
from test_torch_book_ops import _both
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

import paddle_tpu_torch.fluid as fluid

PROGRAMS = core_programs()
TYPES = sorted(PROGRAMS)
COMPARED = sorted(k for k, v in PROGRAMS.items() if v[3] != "stats")


@functools.lru_cache(maxsize=None)
def _check(name):
    """Both packages' fetches of program ``name`` held at its tolerance;
    returns the port's fetches."""
    build, feed, seed, tol = PROGRAMS[name]
    rtol, atol = CORE_TOL[tol]
    init = seq_weights(build, seed) if seed is not None else None
    out, _ = _both(build, feed, rtol, atol, init=init)
    return tuple(out)


def _feed(name):
    return PROGRAMS[name][1]


def test_every_op_type_has_a_program():
    """35 programs (the 34 types and ``fill_any_like``), one a type, all
    registered."""
    assert len(PROGRAMS) == 35
    assert set(PROGRAMS) <= set(fluid.registry.OP_DEFS)


@pytest.mark.parametrize("name", TYPES)
def test_registration_flags_are_the_jax_ones(name):
    """``nondiff_inputs`` and ``stop_gradient`` as JAX registers them."""
    from paddle_tpu.fluid.registry import OP_DEFS as JAX_DEFS
    mine, jax_def = fluid.registry.OP_DEFS[name], JAX_DEFS[name]
    assert mine.nondiff_inputs == jax_def.nondiff_inputs
    assert mine.stop_gradient == jax_def.stop_gradient


@pytest.mark.parametrize("name", COMPARED)
def test_op_against_jax(name):
    """Every fetch (outputs and gradients) of the op's program, the port
    against JAX: floats within CORE_TOL, integers equal."""
    out = _check(name)
    assert len(out) >= 1
    assert all(np.isfinite(o).all() for o in out if o.dtype.kind == "f")


# -- values by hand -----------------------------------------------------------

def _kink_grad(name, x, c0, c1):
    """The input gradient of the two-output activation programs in
    numpy, ``sum_i mean(out_i · c_i)``, with JAX's rules at the kinks:
    ``clip`` (a max, then a min) gives each side of a tie half the
    slope, ``where(x >= 0, x, alpha x)`` the whole slope at 0."""
    def clip_slope(y, hi):
        return np.where((y > 0) & (y < hi), 1.0,
                        np.where((y == 0) | (y == hi), 0.5, 0.0))
    if name == "relu6":
        d0, d1 = clip_slope(x, 6.0), clip_slope(x, 4.0)
    elif name == "leaky_relu":
        d0, d1 = np.where(x >= 0, 1.0, 0.1), np.where(x >= 0, 1.0, 0.02)
    else:
        d0, d1 = (s * clip_slope(x * np.float32(s) + np.float32(0.5), 1.0)
                  for s in (0.2, 0.25))
    return (c0 * d0 + c1 * d1) / x.size


@pytest.mark.parametrize("name", ["relu6", "leaky_relu", "hard_sigmoid"])
def test_gradient_at_the_kinks(name):
    """The whole input gradient against its numpy rule, at inputs that
    hold the kinks exactly: relu6 at 0 and 6 (and 4 for threshold 4),
    leaky_relu at 0, hard_sigmoid at its bounds ±2 for slope 0.25."""
    f = _feed(name)
    g = _check(name)[2]
    np.testing.assert_allclose(g, _kink_grad(name, f["x"], f["c0"],
                                             f["c1"]), rtol=1e-5, atol=0)
    at = {"relu6": [0.0, 6.0, 4.0], "leaky_relu": [0.0],
          "hard_sigmoid": [2.0, -2.0]}[name]
    assert all((f["x"] == v).any() for v in at)


def _extremum_grad(x, cs, fn):
    """The input gradient of reduce_max/min over dim 1, dims (0, 2) with
    keep_dim, all, and none, in numpy: each output's ``c`` shared
    equally among the tied extrema it took."""
    g = np.zeros_like(x)
    for axes, c in zip([(1,), (0, 2), (0, 1, 2)], cs):
        m = fn(x, axis=axes, keepdims=True)
        tie = (x == m).astype(np.float64)
        share = tie / tie.sum(axis=axes, keepdims=True)
        g += np.broadcast_to(c.reshape(m.shape) if c.size == m.size else
                             np.expand_dims(c, axes), x.shape) * share / \
            c.size
    return g + cs[3] / x.size


@pytest.mark.parametrize("name", ["reduce_max", "reduce_min"])
def test_tied_extrema_share_the_gradient(name):
    """The input gradient against its numpy rule: ties of two (``[0, :,
    2]`` over dim 1), three (``[1, :, 1]``) and more (the reduce over
    every axis) each take an equal share."""
    f = _feed(name)
    g = _check(name)[4]
    fn = np.max if name == "reduce_max" else np.min
    want = _extremum_grad(f["x"].astype(np.float64),
                          [f["c%d" % i] for i in range(4)], fn)
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-7)


def test_first_extremum_and_stable_argsort():
    """arg_max / arg_min take the first of tied extrema; argsort keeps
    tied entries in their order, along the last axis and along axis 0."""
    x = _feed("arg_max")["x"]
    amax = _check("arg_max")
    np.testing.assert_array_equal(amax[0], np.argmax(x, -1))
    np.testing.assert_array_equal(amax[1], np.argmax(x, 0))
    amin = _check("arg_min")
    np.testing.assert_array_equal(amin[1], np.argmin(x, 0))
    assert amax[0][2] == 1 and amin[0][1] == 0       # the tied rows
    out, idx, out0, idx0 = _check("argsort")
    np.testing.assert_array_equal(idx, np.argsort(x, -1, kind="stable"))
    np.testing.assert_array_equal(idx0, np.argsort(x, 0, kind="stable"))
    np.testing.assert_array_equal(out, np.sort(x, -1))
    np.testing.assert_array_equal(idx[1], np.arange(6))


def test_scatter_duplicates_and_dropped_ids():
    """Overwrite with unique ids, -2 meaning row 4 and 9 dropped; add
    with duplicate ids summed, -1 meaning row 5 and -8 dropped; the
    Updates gradient of the dropped ids is 0."""
    f = _feed("scatter")
    out = _check("scatter")
    x, u, d = f["x"], f["u"], f["d"]
    want = x.copy()
    want[[3, 0, 4]] = u[:3]
    np.testing.assert_allclose(out[0], want, rtol=1e-6)
    want = x.copy()
    for i, r in zip([1, 1, 4, 1, 5], d[:5]):
        want[i] += r
    np.testing.assert_allclose(out[1], want, rtol=1e-5, atol=1e-6)
    gx, gu, gd = out[2:5]
    c0, c1 = f["c0"], f["c1"]
    # overwritten rows pass nothing back to X, their updates take c0's
    # rows; the add passes c1 to X and to every duplicate update
    np.testing.assert_allclose(gu[:3], c0[[3, 0, 4]] / c0.size, rtol=1e-6)
    assert (gu[3] == 0).all() and (gd[5] == 0).all()
    np.testing.assert_allclose(gd[:5], c1[[1, 1, 4, 1, 5]] / c1.size,
                               rtol=1e-6)
    keep = np.ones(6, bool)
    keep[[3, 0, 4]] = False
    np.testing.assert_allclose(gx, (c0 * keep[:, None]) / c0.size +
                               c1 / c1.size, rtol=1e-5, atol=1e-7)


def test_gather_nd_wraps_and_clamps():
    """``[-1, 0]`` reads row 2 (from the end), ``[5, -9]`` the clamped
    ``[2, 0]``, whose gradient is dropped: ``x[2, 0]`` takes only the
    first read's and the two whole-slab reads of ``x[2]``."""
    f = _feed("gather_nd")
    out, _, g = _check("gather_nd")
    x, c0, c1 = f["x"], f["c0"], f["c1"]
    np.testing.assert_array_equal(out[3], x[2, 0])
    np.testing.assert_array_equal(out[4], x[2, 0])
    np.testing.assert_allclose(
        g[2, 0], c0[3] / c0.size + (c1[1, 0, 0] + c1[1, 1, 0]) / c1.size,
        rtol=1e-5)


def test_lookup_table_v2_padding_and_nan_row():
    """An id past the table reads a NaN row (``has_nan`` true), as JAX's
    ``jnp.take`` gives it; ``padding_idx`` 3 reads zeros."""
    out = _check("lookup_table_v2")
    assert out[0].tolist() == [True]
    b = out[2]
    assert b.shape == (3, 4) and (b[1] == 0).all() and (b[0] != 0).all()


def test_has_nan_has_inf():
    assert [o.tolist() for o in _check("has_nan")] == \
        [[False], [True], [False]]
    assert [o.tolist() for o in _check("has_inf")] == \
        [[False], [False], [True]]


def test_fill_any_like_keeps_shape_and_dtype():
    """``ones_like`` of a float input holding a NaN and of an int64 one,
    ``fill_any_like`` by hand with -2.5: the input's shape, its dtype's
    kind, every entry the value."""
    one, ids, by_hand = _check("fill_any_like")
    assert one.dtype == np.float32 and (one == 1).all() and one.shape == \
        (3, 3)
    assert ids.dtype.kind == "i" and (ids == 1).all() and ids.shape == (2, 2)
    assert (by_hand == -2.5).all()


def test_shape_is_int32():
    a, b = _check("shape")
    assert a.dtype == b.dtype == np.int32
    assert a.tolist() == [3, 4, 5] and b.tolist() == [4, 6]


def _runs(pkg, build, feed, n):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fetch = build(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    return [[np.asarray(v) for v in exe.run(main, feed=feed,
                                            fetch_list=fetch, scope=scope)]
            for _ in range(n)]


def test_auc_state_over_three_runs():
    """Three runs of the auc program in one scope: the persistable
    StatPos/StatNeg histograms grow by the same counts in both packages
    (equal after every run) and the AUCs agree; the bins of predictions
    on and beside the edges ``k / num_thresholds`` are JAX's."""
    import paddle_tpu.fluid as jfluid
    build, feed, _, _ = PROGRAMS["auc"]
    jr = _runs(jfluid, build, feed, 3)
    pr = _runs(fluid, build, feed, 3)
    for k, (j, p) in enumerate(zip(jr, pr)):
        for a, b in zip(p, j):
            if a.ndim:                           # the stat histograms
                np.testing.assert_array_equal(a, b, err_msg=str(k))
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6)
    pos, neg = pr[2][2], pr[2][3]
    assert pos.sum() + neg.sum() == 3 * 40
    assert pos.sum() == 3 * feed["lab"].sum()


@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_uniform_random_batch_size_like_by_statistics(pkg_name):
    """Each package's draws: ``[500, 300]`` in [-1, 1) from the batch
    dim and ``[7, 3]`` in [2, 5) from dim 1, float32, mean and variance
    within URBSL_SIGMAS standard errors of the uniform's."""
    build, feed, _, _ = PROGRAMS["uniform_random_batch_size_like"]
    if pkg_name == "port":
        outs, _, _ = seq_run(build, feed, {}, fluid.CPUPlace(), ())
    else:
        import paddle_tpu.fluid as jfluid
        from test_torch_book_ops import _run
        outs, _ = _run(jfluid, build, feed)
    assert urbsl_ok(outs)


# -- the composed layers ------------------------------------------------------

def _layer_programs():
    """{layer: (build(pkg) -> fetch list, feed)}: each layer of the slice
    that composes ops, every mode side by side, then the gradients of
    ``sum_i mean(out_i * c_i)`` over its float inputs."""
    D = _seq_data
    progs = {}
    rng = np.random.RandomState(41)

    def cs(*shapes):
        return {"c%d" % i: rng.randn(*s).astype(np.float32)
                for i, s in enumerate(shapes)}

    def grads(pkg, outs, wrt, feed):
        return _seq_with_grads(pkg, outs, wrt, sorted(
            (k, v) for k, v in feed.items() if k.startswith("c")))

    prob = rng.uniform(0.05, 0.95, (4, 6)).astype(np.float32)
    hit = (rng.rand(4, 6) < 0.5).astype(np.int64)
    f = dict(cs((1,), (1,)), p=prob, lab=hit)

    def dice(pkg, f=f):
        p, lab = D(pkg, "p", prob), D(pkg, "lab", hit, False)
        L = pkg.layers
        return grads(pkg, [L.dice_loss(p, lab),
                           L.dice_loss(p, lab, epsilon=0.5)], [p], f)
    progs["dice_loss"] = (dice, f)

    anchor = rng.randn(6, 5).astype(np.float32)
    positive = rng.randn(6, 5).astype(np.float32)
    ids = np.array([0, 2, 0, 1, 2, 0], np.int64)      # repeated labels
    f = dict(cs((1,), (1,)), a=anchor, b=positive, ids=ids)

    def npair(pkg, f=f):
        a, b = D(pkg, "a", anchor), D(pkg, "b", positive)
        i = D(pkg, "ids", ids, False)
        L = pkg.layers
        return grads(pkg, [L.npair_loss(a, b, i),
                           L.npair_loss(a, b, i, l2_reg=0.5)], [a, b], f)
    progs["npair_loss"] = (npair, f)

    x2, x3 = rng.randn(3, 5).astype(np.float32), \
        rng.randn(2, 3, 4).astype(np.float32)
    x2[1] = 0.0                                        # a zero row: epsilon
    f = dict(cs((3, 5), (3, 5), (2, 3, 4), (2, 3, 4)), x=x2, y=x3)

    def l2(pkg, f=f):
        x, y = D(pkg, "x", x2), D(pkg, "y", x3)
        L = pkg.layers
        return grads(pkg, [L.l2_normalize(x, axis=1),
                           L.l2_normalize(x, axis=0, epsilon=1e-4),
                           L.l2_normalize(y, axis=1),
                           L.l2_normalize(y, axis=-1)], [x, y], f)
    progs["l2_normalize"] = (l2, f)

    img = rng.randn(1, 2, 6, 9).astype(np.float32)
    f = dict(cs((1, 2, 4, 6), (1, 2, 8, 12)), img=img)

    def resize_short(pkg, f=f):
        x = D(pkg, "img", img)
        L = pkg.layers
        return grads(pkg, [L.image_resize_short(x, 4),
                           L.image_resize_short(x, 8, resample="NEAREST")],
                     [x], f)
    progs["image_resize_short"] = (resize_short, f)

    def fills(pkg):
        L = pkg.layers
        return [L.zeros([2, 3], "float32"), L.ones([3], "float32"),
                L.ones([2, 2], "int32", force_cpu=True)]
    progs["zeros_ones"] = (fills, {})

    terms = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    f = dict(cs((3, 4), (3, 4)), **{"t%d" % k: t for k, t in
                                    enumerate(terms)})

    def sums(pkg, f=f):
        ts = [D(pkg, "t%d" % k, t) for k, t in enumerate(terms)]
        return grads(pkg, [pkg.layers.sum(ts), pkg.layers.sum(ts[0])], ts, f)
    progs["sum"] = (sums, f)
    return progs


LAYER_PROGRAMS = _layer_programs()


@pytest.mark.parametrize("name", sorted(LAYER_PROGRAMS))
def test_layer_against_jax(name):
    """Every fetch of the composed layer's program (outputs and input
    gradients), the port against JAX within CORE_TOL's float32 rule."""
    build, feed = LAYER_PROGRAMS[name]
    out, _ = _both(build, feed, *CORE_TOL["plain"])
    assert all(np.isfinite(o).all() for o in out)


def test_fills_hold_their_values():
    out, _ = _both(*LAYER_PROGRAMS["zeros_ones"])
    assert [o.tolist() for o in out] == [[[0.0] * 3] * 2, [1.0] * 3,
                                         [[1, 1], [1, 1]]]


def test_step_counter_over_three_runs():
    """``autoincreased_step_counter``: the default counter reads 1, 2, 3
    and one named, from 5 by 2, reads 5, 7, 9 over three runs of the
    program in one scope, in both packages."""
    import paddle_tpu.fluid as jfluid

    def build(pkg):
        L = pkg.layers
        return [L.autoincreased_step_counter(),
                L.autoincreased_step_counter("@EPOCH@", begin=5, step=2)]
    for pkg in (jfluid, fluid):
        got = [[int(v.reshape(-1)[0]) for v in r]
               for r in _runs(pkg, build, {}, 3)]
        assert got == [[1, 5], [2, 7], [3, 9]], pkg.__name__


def _normal_ok(a, mean, std):
    """A normal draw: its mean and variance within URBSL_SIGMAS standard
    errors of ``mean`` and ``std²`` (the sample variance's standard
    error is ``std² sqrt(2 / n)``)."""
    n = a.size
    return bool(abs(a.mean() - mean) <= URBSL_SIGMAS * std / np.sqrt(n) and
                abs(a.var() - std * std) <=
                URBSL_SIGMAS * std * std * np.sqrt(2.0 / n))


@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_random_layers_by_statistics(pkg_name):
    """Each package's ``gaussian_random`` ([400, 300], mean 1, std 2) and
    ``uniform_random`` ([300, 200] in [-3, 2)): shape, float32 and their
    statistics; two draws of one program differ."""
    if pkg_name == "port":
        pkg = fluid
    else:
        import paddle_tpu.fluid as pkg

    def build(pkg):
        L = pkg.layers
        return [L.gaussian_random([400, 300], mean=1.0, std=2.0),
                L.uniform_random([300, 200], min=-3.0, max=2.0),
                L.uniform_random([300, 200], min=-3.0, max=2.0)]
    g, u, u2 = _runs(pkg, build, {}, 1)[0]
    assert g.shape == (400, 300) and u.shape == (300, 200)
    assert g.dtype == u.dtype == np.float32
    assert _normal_ok(g, 1.0, 2.0)
    assert _stats_ok(u, -3.0, 2.0) and _stats_ok(u2, -3.0, 2.0)
    assert not np.array_equal(u, u2)
