"""The 49 op types of ``misc_ops.py`` and ``misc_ops2.py`` (the first half
of ROADMAP item 13c.3b) in the port (paddle_tpu_torch), each against
paddle_tpu on the CPU on the same seeded numpy inputs: the attribute
activations (elu, softshrink, hard_shrink, tanh_shrink,
thresholded_relu, brelu, soft_relu), prelu, maxout, kldiv_loss,
log_loss, rank_loss, margin_rank_loss, bpr_loss, group_norm,
instance_norm, spectral_norm, pad2d, pixel_shuffle, space_to_depth,
shuffle_channel, affine_channel, temporal_shift, grid_sampler,
sampling_id, shard_index, linspace, diag, roll; conv3d,
conv3d_transpose, pool3d, lrn, selu, hinge_loss, modified_huber_loss,
squared_l2_distance, l1_norm, norm, bilinear_tensor_product,
teacher_student_sigmoid_loss, cvm, label_smooth, crop,
pad_constant_like, unfold, size, minus and mean_iou.

The programs are ``chip_smoke.misc_programs()``, which the card's
``misc_ops`` phase runs too: each builds its op in both packages through
the layer a user calls (the op by hand where there is none), every mode
side by side, the points where the two could part fed exactly, then the
gradients over the float inputs the op differentiates and its parameters
(prelu's Alpha, the norms' Scale and Bias, the 3-D convolutions' and
the bilinear product's weights).  ``test_op_against_jax`` holds every
fetch of each program; the tests after it pin those points by hand, in
numpy: the gradient at exact thresholds and clip bounds, the negative
branch at 0, JAX's grid sampler outside ``[-1, 1]`` (not
``F.grid_sample``), lrn's alpha not divided by n, the norms' statistics
as the variance itself, temporal_shift's truncated split points, crop's
clamped offsets, unfold's padding order, linspace bit for bit with
``jnp.linspace`` where ``torch.linspace`` differs, pool3d's padding and
its max gradient among ties, and sampling_id by statistics.

Tolerances (``chip_smoke.MISC_TOL``): float32 rules ``rtol 1e-5, atol
1e-6``; integer outputs, the index and shape ops and linspace's points
exactly; ``sampling_id`` (whose random streams differ across packages
and devices) by its shape, range, its certain row and the frequency of
each class within 5 standard errors (``chip_smoke.sampling_ok``).
"""

import functools

import numpy as np
import pytest

from chip_smoke import (MISC_TOL, _seq_data, misc_programs,
                        sampling_ok, seq_run, seq_weights)
from test_torch_book_ops import _both, _run
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid

PROGRAMS = misc_programs()
TYPES = sorted(PROGRAMS)
COMPARED = sorted(k for k, v in PROGRAMS.items() if v[3] != "stats")


@functools.lru_cache(maxsize=None)
def _check(name):
    """Both packages' fetches of program ``name`` held at its tolerance;
    returns the port's fetches."""
    build, feed, seed, tol = PROGRAMS[name]
    rtol, atol = MISC_TOL[tol]
    init = seq_weights(build, seed) if seed is not None else None
    out, _ = _both(build, feed, rtol, atol, init=init)
    return tuple(out)


def _feed(name):
    return PROGRAMS[name][1]


def test_every_op_type_has_a_program():
    """49 programs, one a type, all registered."""
    assert len(PROGRAMS) == 49
    assert set(PROGRAMS) <= set(fluid.registry.OP_DEFS)


@pytest.mark.parametrize("name", TYPES)
def test_registration_flags_are_the_jax_ones(name):
    """``nondiff_inputs`` and ``stop_gradient`` as JAX registers them."""
    mine, jax_def = fluid.registry.OP_DEFS[name], jfluid.registry.OP_DEFS[name]
    assert mine.nondiff_inputs == jax_def.nondiff_inputs
    assert mine.stop_gradient == jax_def.stop_gradient


@pytest.mark.parametrize("name", COMPARED)
def test_op_against_jax(name):
    """Every fetch (outputs and gradients) of the op's program, the port
    against JAX: floats within MISC_TOL, integers equal."""
    out = _check(name)
    assert len(out) >= 1
    assert all(np.isfinite(o).all() for o in out if o.dtype.kind == "f")


# -- values by hand -----------------------------------------------------------

def _act_grads(name, x, c0, c1):
    """The input gradient of the two-output activation programs in numpy
    (``sum_i mean(out_i · c_i)``) with JAX's rules: ``where`` gives the
    whole slope to the branch it took (strict comparisons: 0 at a
    threshold; ``x > 0``: the negative branch at 0), ``clip`` half the
    slope to each side of a bound."""
    def clip_slope(lo, hi):
        return np.where((x > lo) & (x < hi), 1.0,
                        np.where((x == lo) | (x == hi), 0.5, 0.0))
    e = np.exp(np.minimum(x, 0.0))
    t = {"elu": (np.where(x > 0, 1.0, e), np.where(x > 0, 1.0, 0.5 * e)),
         "softshrink": (np.abs(x) > 0.5, np.abs(x) > np.float32(0.3)),
         "hard_shrink": (np.abs(x) > 0.5, np.abs(x) > np.float32(0.3)),
         "thresholded_relu": (x > 1.0, x > np.float32(0.3)),
         "brelu": (clip_slope(0.0, 24.0), clip_slope(-1.0, 1.0))}[name]
    return (c0 * t[0] + c1 * t[1]) / x.size


@pytest.mark.parametrize("name", ["elu", "softshrink", "hard_shrink",
                                  "thresholded_relu", "brelu"])
def test_activation_gradient_at_the_thresholds(name):
    """The input gradient against its numpy rule, at inputs that hold the
    thresholds (0.5, 0.3, 1), the clip bounds (0, ±1, past 24) and 0
    exactly."""
    f = _feed(name)
    g = _check(name)[2]
    np.testing.assert_allclose(g, _act_grads(name, f["x"], f["c0"],
                                             f["c1"]), rtol=1e-5, atol=1e-7)
    assert all((f["x"] == v).any() for v in (0.0, 0.5, -0.5, 1.0, -1.0,
                                             np.float32(0.3)))


def test_soft_relu_clip_at_its_threshold():
    """``log1p(exp(clip(x, -t, t)))``: at ``x = ±t`` the slope of the
    softplus is halved (the clip's tie), outside it 0."""
    f = _feed("soft_relu")
    x = f["x"].astype(np.float64)
    sig = 1 / (1 + np.exp(-np.clip(x, -1, 1)))
    slope = np.where(np.abs(x) < 1, 1.0, np.where(np.abs(x) == 1, 0.5, 0.0))
    want = (f["c0"] / (1 + np.exp(-x)) + f["c1"] * sig * slope) / x.size
    np.testing.assert_allclose(_check("soft_relu")[2], want, rtol=1e-5,
                               atol=1e-7)


def test_prelu_modes_and_alpha_gradients():
    """``all``, ``channel`` and ``element`` Alpha; at 0 the negative
    branch: the gradient there is the alpha, and each Alpha's gradient
    the sum of ``x · g`` where ``x <= 0``."""
    build, f, seed, _ = PROGRAMS["prelu"]
    w = seq_weights(build, seed)
    names = sorted(w)
    out = _check("prelu")
    x = f["x"]
    for k, (name, mode) in enumerate(zip(names, ("all", "channel",
                                                 "element"))):
        a = w[name].reshape({"all": (), "channel": (1, 3, 1, 1),
                             "element": (1, 3, 2, 2)}[mode])
        np.testing.assert_allclose(out[k], np.where(x > 0, x, a * x),
                                   rtol=1e-6)
        g = f["c%d" % k] / x.size
        ga = np.where(x > 0, 0.0, x * g)
        want = {"all": ga.sum().reshape(1), "channel": ga.sum((0, 2, 3)),
                "element": ga.sum(0)}[mode]
        np.testing.assert_allclose(out[4 + k], want.reshape(w[name].shape),
                                   rtol=1e-5, atol=1e-7)
    assert (x[0, :, 0, 0] == 0).all()


def test_margin_rank_loss_activated_and_its_tie():
    """Activated is 1 exactly where the loss is above 0; with margin 0 a
    pair of equal scores sits on the hinge and takes half the slope."""
    f = _feed("margin_rank_loss")
    out = _check("margin_rank_loss")
    a, act = out[0], out[-1]
    np.testing.assert_array_equal(act, (a > 0).astype(np.float32))
    assert f["l"][0] == f["r"][0]
    gl = out[2]
    s, c0, c1 = f["s"], f["c0"], f["c1"]
    v0 = -s * (f["l"] - f["r"]) + np.float32(0.1)
    v1 = -s * (f["l"] - f["r"])
    slope = lambda v: np.where(v > 0, 1.0, np.where(v == 0, 0.5, 0.0))
    np.testing.assert_allclose(gl, -s * (c0 * slope(v0) + c1 * slope(v1)) /
                               6, rtol=1e-5, atol=1e-7)


def test_kldiv_reductions():
    """``t·(log(max(t, 1e-10)) − x)``: a zero target gives 0, and the
    four reductions are the mean, the sum, the sum over the batch size
    and the entries."""
    f = _feed("kldiv_loss")
    out = _check("kldiv_loss")
    t, x = f["t"].astype(np.float64), f["x"].astype(np.float64)
    loss = t * (np.log(np.maximum(t, 1e-10)) - x)
    np.testing.assert_allclose([out[0][0], out[1][0], out[2][0]],
                               [loss.mean(), loss.sum(), loss.sum() / 4],
                               rtol=1e-5)
    np.testing.assert_allclose(out[3], loss, rtol=1e-5, atol=1e-7)
    assert out[3][0, 2] == 0.0


def test_bpr_loss_averages_the_negatives():
    f = _feed("bpr_loss")
    s, lab = f["s"].astype(np.float64), f["lab"].reshape(-1)
    want = [np.mean([np.logaddexp(0, s[i, j] - s[i, lab[i]])
                     for j in range(5) if j != lab[i]]) for i in range(4)]
    np.testing.assert_allclose(_check("bpr_loss")[0].reshape(-1), want,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["group_norm", "instance_norm"])
def test_norm_statistics_are_the_variance(name):
    """Mean and Variance (SavedMean, SavedVariance) are ``[N, groups]``
    (``[N, C]``) and hold the population variance itself, not
    ``1/sqrt(var + eps)``."""
    x = _feed(name)["x"].astype(np.float64)
    out = _check(name)
    mean, var = out[-2], out[-1]
    g = x.reshape(2, 2, -1) if name == "group_norm" else x.reshape(2, 4, -1)
    np.testing.assert_allclose(mean, g.mean(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, g.var(-1), rtol=1e-5, atol=1e-6)


def test_spectral_norm_zero_iterations_run_one():
    """``power_iters=0`` runs one iteration from U and V, as the JAX rule's
    ``max(power_iters, 1)``: the output is W over ``u·W·v`` after one."""
    build, f, seed, _ = PROGRAMS["spectral_norm"]
    w0 = seq_weights(build, seed)
    u, v = w0[sorted(w0)[0]], w0[sorted(w0)[1]]
    if u.size != 6:
        u, v = v, u
    W = f["w"].astype(np.float64)
    v = W.T @ u
    v /= np.linalg.norm(v)
    u = W @ v
    u /= np.linalg.norm(u)
    np.testing.assert_allclose(_check("spectral_norm")[0], W / (u @ W @ v),
                               rtol=1e-5, atol=1e-6)


def test_pad2d_modes():
    """``[top, bottom, left, right]``; reflect mirrors without the edge,
    edge repeats it; the reflect gradient folds back onto the input."""
    x = _feed("pad2d")["x"]
    out = _check("pad2d")
    widths = ((0, 0), (0, 0), (1, 2), (2, 1))
    np.testing.assert_array_equal(out[0], np.pad(x, widths,
                                                 constant_values=7.0))
    np.testing.assert_array_equal(out[1], np.pad(x, widths, mode="reflect"))
    np.testing.assert_array_equal(out[2], np.pad(x, widths, mode="edge"))


def test_temporal_shift_split_points():
    """C = 10 at ratio 1/4: channels 0-1 (``int(2.5)``) read frame t − 1,
    channels 2-4 (``int(5.0)``) frame t + 1, zero past the clip's ends;
    C = 8 at TSM's 1/8: one channel each way."""
    f = _feed("temporal_shift")
    out = _check("temporal_shift")
    for x, T, c1, c2, got in ((f["x"], 4, 2, 5, out[0]),
                              (f["x8"], 2, 1, 2, out[1])):
        v = x.reshape(-1, T, *x.shape[1:])
        want = v.copy()
        want[:, :, :c2] = 0
        want[:, 1:, :c1] = v[:, :-1, :c1]
        want[:, :-1, c1:c2] = v[:, 1:, c1:c2]
        np.testing.assert_array_equal(got, want.reshape(x.shape))


def _grid_sample_np(x, grid):
    """The JAX rule's bilinear sampler in float64: ``(g + 1)(size − 1) /
    2``, corners clamped into the map, weights not."""
    N, C, H, W = x.shape
    gx = (grid[..., 0] + 1) * (W - 1) / 2
    gy = (grid[..., 1] + 1) * (H - 1) / 2
    x0 = np.clip(np.floor(gx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(gy).astype(int), 0, H - 1)
    x1, y1 = np.clip(x0 + 1, 0, W - 1), np.clip(y0 + 1, 0, H - 1)
    lx, ly = (gx - x0)[:, None], (gy - y0)[:, None]
    n = np.arange(N)[:, None, None]

    def at(yy, xx):
        return np.moveaxis(x[n, :, yy, xx], -1, 1)
    return (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx +
            at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)


def test_grid_sampler_is_the_jax_formula():
    """The sampler against its numpy formula, the grid holding ±1 and
    points outside ``[-1, 1]``; on a row of pixels 0..3 at g = −1.5 it
    extrapolates to −0.75, where ``F.grid_sample`` gives 0 (zeros,
    border) or 0.75 (reflection)."""
    f = _feed("grid_sampler")
    np.testing.assert_allclose(
        _check("grid_sampler")[0],
        _grid_sample_np(f["x"].astype(np.float64), f["g"].astype(np.float64)),
        rtol=1e-5, atol=1e-6)
    row = np.arange(4, dtype=np.float64).reshape(1, 1, 1, 4)
    g = np.array([[[[-1.5, 0.0], [1.5, 0.0], [-1.0, 0.0]]]])
    np.testing.assert_allclose(_grid_sample_np(row, g).reshape(-1),
                               [-0.75, 3.0, 0.0])


def test_lrn_alpha_is_not_divided_by_n():
    """``x / (k + alpha·Σ x²)^beta`` over 5 (the layer, k = 1) and 3 (the
    op by hand, its default k = 2) channels; MidOut is the base."""
    x = _feed("lrn")["x"].astype(np.float64)
    out = _check("lrn")

    def lrn(n, k, alpha, beta):
        pad = np.pad(x * x, ((0, 0), (n // 2, n // 2), (0, 0), (0, 0)))
        mid = k + alpha * sum(pad[:, i:i + 6] for i in range(n))
        return x / mid ** beta, mid
    np.testing.assert_allclose(out[0], lrn(5, 1.0, 1e-4, 0.75)[0], rtol=1e-5)
    want, mid = lrn(3, 2.0, 0.1, 0.6)
    np.testing.assert_allclose(out[1], want, rtol=1e-5)
    np.testing.assert_allclose(out[-1], mid, rtol=1e-5)


def test_crop_clamps_its_offsets():
    """Offsets past the edge are clamped so that the block stays inside,
    as ``lax.dynamic_slice`` does; the default offsets are 0."""
    x = _feed("crop")["x"]
    out = _check("crop")
    np.testing.assert_array_equal(out[0], x[1:3, 1:4, 2:4])
    np.testing.assert_array_equal(out[1], x[1:3, 3:5, 2:4])
    np.testing.assert_array_equal(out[2], x)


def test_unfold_padding_order():
    """``paddings`` ``[top, left, bottom, right]``: H takes ``(1, 2)``, W
    ``(0, 1)``; rows in ``(C, kh, kw)`` order."""
    x = _feed("unfold")["x"]
    xp = np.pad(x, ((0, 0), (0, 0), (1, 2), (0, 1)))
    cols = [xp[:, :, i:i + 2, j:j + 5:2].reshape(2, -1)
            for i in range(7) for j in range(0, 3, 2)]
    np.testing.assert_array_equal(_check("unfold")[0],
                                  np.stack(cols, axis=-1))


def test_linspace_is_the_jax_programs_bit_for_bit():
    """Every point equal to JAX's (``test_op_against_jax`` holds them
    exactly), which is XLA's ``fma(i, stop·r, start·(1 − i·r))`` with
    ``r = float32(1/(n − 1))``, not the formula as written (at 0.1 to 3.7
    it differs at 7 and at 100 points) nor ``torch.linspace``; one point
    is Start."""
    import torch
    f = _feed("linspace")
    out = _check("linspace")
    a, b = f["e0"][0], f["e1"][0]
    for n, got in ((7, out[0]), (100, out[1])):
        i = np.arange(n - 1, dtype=np.float32)
        r = np.float32(1.0 / (n - 1))
        head = a * (np.float32(1) - i * r)
        want = (i.astype(np.float64) * np.float64(b * r) + head).astype(
            np.float32)
        np.testing.assert_array_equal(got, np.append(want, b))
        s = i / np.float32(n - 1)
        assert not np.array_equal(got[:-1], a * (np.float32(1) - s) + b * s)
        assert not np.array_equal(got, torch.linspace(float(a), float(b), n)
                                  .numpy())
    assert out[2].tolist() == [-2.0]


def test_linspace_refuses_a_count_below_one():
    def build(pkg):
        s = _seq_data(pkg, "s", np.zeros(1, np.float32), False)
        return [pkg.layers.linspace(s, s, 0)]
    with pytest.raises(ValueError):
        seq_run(build, {"s": np.zeros(1, np.float32)}, {}, fluid.CPUPlace(),
                ())


def test_shard_index_floor_division():
    """``size = ceil(index_num / nshards)``; an id of the shard becomes
    ``id % size``, others the ignore value, negative ids by floor
    division and Python's modulo."""
    i = _feed("shard_index")["i"]
    out = _check("shard_index")
    for got, n, s, k, ign in ((out[0], 20, 3, 1, -1), (out[1], 20, 3, 0, -2),
                              (out[2], 19, 2, 1, -1)):
        size = (n + s - 1) // s
        np.testing.assert_array_equal(got, np.where(i // size == k, i % size,
                                                    ign))


def test_pool3d_padding_and_global():
    """Max pads with ``-inf``, the average divides by the whole window
    with its zero padding; global pooling takes the whole map."""
    x = _feed("pool3d")["x"].astype(np.float64)
    out = _check("pool3d")
    xp = np.pad(x, ((0, 0), (0, 0)) + ((1, 1),) * 3)
    avg = np.zeros((2, 2, 3, 3, 3))
    for d in range(3):
        for h in range(3):
            for w in range(3):
                avg[..., d, h, w] = xp[..., 2 * d:2 * d + 2, 2 * h:2 * h + 2,
                                       2 * w:2 * w + 2].sum((-3, -2, -1)) / 8
    np.testing.assert_allclose(out[1], avg, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out[2].reshape(2, 2),
                                  x.max((-3, -2, -1)))
    np.testing.assert_allclose(out[3].reshape(2, 2), x.mean((-3, -2, -1)),
                               rtol=1e-5)


def _tied_pool(pkg):
    x = _seq_data(pkg, "x", TIED)
    out = pkg.layers.pool3d(x, 2, "max", 1)
    c = _seq_data(pkg, "c", np.ones((1, 1, 2, 2, 2), np.float32), False)
    loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, c))
    return [out] + pkg.gradients(loss, [x])


TIED = np.zeros((1, 1, 3, 3, 3), np.float32)
TIED[0, 0, 1, 1, 1] = TIED[0, 0, 0, 0, 0] = 1.0     # ties in every window


def test_pool3d_max_gradient_among_ties():
    """Overlapping 2³ windows of an input full of ties: each package sends
    a window's gradient to one of its maxima, the first in scan order
    (depth, then row, then column), and the two packages agree."""
    feed = {"x": TIED, "c": np.ones((1, 1, 2, 2, 2), np.float32)}
    (jo, jg), _ = _run(jfluid, _tied_pool, feed)
    po, pg = seq_run(_tied_pool, feed, {}, fluid.CPUPlace(), ())[0]
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pg, jg)
    assert pg.sum() == 8                     # one entry a window
    assert pg[0, 0, 0, 0, 0] == 1 and pg[0, 0, 1, 1, 1] == 7


def test_mean_iou_counts():
    """Per class: correct = the hits, wrong = predicted but missed; the
    mean over the classes with a union (class 3 has none)."""
    miou, wrong, correct = _check("mean_iou")
    assert correct.tolist() == [2, 2, 1, 0, 0]
    assert wrong.tolist() == [1, 0, 1, 0, 1]
    np.testing.assert_allclose(miou, np.mean([2 / 4, 2 / 3, 1 / 3, 0.0]),
                               rtol=1e-6)


def test_size_dtypes():
    """The element counts; the port's int64 (the op's declared dtype),
    JAX's int32 (its int64 with x64 off)."""
    out = _check("size")
    assert [int(o) for o in out] == [60, 7]
    assert all(o.shape == () and o.dtype == np.int64 for o in out)


def test_label_smooth_with_and_without_prior():
    x = _feed("label_smooth")["x"]
    prior = _feed("label_smooth")["prior"]
    out = _check("label_smooth")
    np.testing.assert_allclose(out[0], 0.9 * x + 0.1 / 4, rtol=1e-6)
    np.testing.assert_allclose(out[1], 0.75 * x + 0.25 * prior, rtol=1e-6)


def test_cvm_log_of_show_and_click():
    """``use_cvm``: ``log(max(show, 0) + 1)`` and ``log(max(click, 0) +
    1)`` minus it; without, the two columns dropped."""
    x = _feed("cvm")["x"].astype(np.float64)
    a, b = _check("cvm")[:2]
    show = np.log(np.maximum(x[:, :1], 0) + 1)
    click = np.log(np.maximum(x[:, 1:2], 0) + 1) - show
    np.testing.assert_allclose(a, np.hstack([show, click, x[:, 2:]]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b, _feed("cvm")["x"][:, 2:])


@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_sampling_id_by_statistics(pkg_name):
    """Each package's draws over 20,000 rows: one a row, in range, the
    certain row's class, never the class of probability 0, and each
    class's frequency within 5 standard errors; int64 in the port, int32
    in JAX (x64 off)."""
    build, feed, _, _ = PROGRAMS["sampling_id"]
    if pkg_name == "port":
        outs, _, _ = seq_run(build, feed, {}, fluid.CPUPlace(), ())
        assert outs[0].dtype == np.int64
    else:
        outs, _ = _run(jfluid, build, feed)
        assert outs[0].dtype == np.int32
    assert sampling_ok(outs[0])
