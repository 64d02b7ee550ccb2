"""The op zoo's first batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops.py``): the attribute activations, ``prelu`` and ``maxout``,
the losses, ``group_norm``, ``instance_norm`` and ``spectral_norm``, the
image and shape ops (``pad2d``, ``pixel_shuffle``, ``space_to_depth``,
``shuffle_channel``, ``affine_channel``, ``temporal_shift``,
``grid_sampler``), ``sampling_id``, ``shard_index``, ``linspace``,
``diag``, ``roll``, ``im2sequence`` and ``smooth_l1_loss``.

Each rule writes the JAX rule's formula in torch, so that autograd
takes the gradient ``jax.vjp`` takes of it: ``where`` routes the whole
gradient to the branch it picked (so strict comparisons give 0 at a
threshold, and ``x > 0`` puts 0 on the negative branch), ``jnp.clip``
and ``jnp.maximum`` split it at a tie (``detection_ops.clip``,
``torch.maximum``), ``jax.nn.softplus`` is ``logaddexp(x, 0)``.
Attributes are rounded to float32 first (``_f32``), as a weakly typed
Python float is in the JAX rules, and a number a tensor is compared
with, or divided by, is a 0-d tensor filled on the tensor's device
(``_full``): no host copy, and a true division on the card too.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op
from .detection_ops import clip
from .math_ops import _full, _matmul_p, _softplus


def _f32(v):
    """A Python number rounded to float32, as the JAX rules' weakly typed
    attributes are on float32 tensors."""
    return float(np.float32(v))


def _attr_unary(name, fn, **defaults):
    """An op ``Out = fn(X, **attrs)``, each attribute read with its
    default (misc_ops.py:24)."""
    def lower(ctx, op):
        kw = {k: _f32(ctx.attr(k, v)) for k, v in defaults.items()}
        ctx.set("Out", fn(ctx.i("X"), **kw))
    register_op(name)(lower)


_attr_unary("elu", lambda x, alpha: torch.where(
    x > 0, x, alpha * (torch.exp(x) - 1)), alpha=1.0)
_attr_unary("softshrink", lambda x, lambda_: torch.where(
    x > lambda_, x - lambda_,
    torch.where(x < -lambda_, x + lambda_, 0.0)), lambda_=0.5)
_attr_unary("hard_shrink", lambda x, threshold: torch.where(
    torch.abs(x) > threshold, x, 0.0), threshold=0.5)
_attr_unary("tanh_shrink", lambda x: x - torch.tanh(x))
_attr_unary("thresholded_relu", lambda x, threshold: torch.where(
    x > threshold, x, 0.0), threshold=1.0)
_attr_unary("brelu", lambda x, t_min, t_max: clip(x, t_min, t_max),
            t_min=0.0, t_max=24.0)
_attr_unary("soft_relu", lambda x, threshold: torch.log1p(torch.exp(
    clip(x, -threshold, threshold))), threshold=40.0)


@register_op("prelu")
def _prelu(ctx, op):
    """misc_ops.py:51: ``where(x > 0, x, a·x)``, Alpha one value
    (``all``), one a channel (``channel``) or one an entry of a sample
    (``element``)."""
    x = ctx.i("X")
    alpha = ctx.i("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    else:
        a = alpha.reshape(())
    ctx.set("Out", torch.where(x > 0, x, a * x))


@register_op("maxout")
def _maxout(ctx, op):
    """misc_ops.py:65: the largest of each ``groups`` consecutive
    channels of ``[N, C, H, W]`` (a tie shares the gradient, as
    ``jnp.max``'s)."""
    x = ctx.i("X")
    groups = ctx.attr("groups")
    N, C, H, W = x.shape
    ctx.set("Out", torch.amax(x.reshape(N, C // groups, groups, H, W),
                              dim=2))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@register_op("smooth_l1_loss", nondiff_inputs=("InsideWeight",
                                               "OutsideWeight"))
def _smooth_l1(ctx, op):
    """misc_ops.py:77: ``d = (X - Y)·InsideWeight``, the Huber term at
    ``1 / sigma²`` times OutsideWeight, summed over each row: Out ``[N,
    1]``, and Diff."""
    x, y = ctx.i("X"), ctx.i("Y")
    sigma = ctx.attr("sigma", 1.0)
    iw, ow = ctx.i_opt("InsideWeight"), ctx.i_opt("OutsideWeight")
    d = x - y
    if iw is not None:
        d = d * iw
    s2 = sigma * sigma
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ow is not None:
        loss = loss * ow
    ctx.set("Diff", d)
    ctx.set("Out", loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True))


@register_op("kldiv_loss", nondiff_inputs=("Target",))
def _kldiv_loss(ctx, op):
    """misc_ops.py:97: ``t·(log(max(t, 1e-10)) − x)`` of log-probabilities
    X against Target, reduced by ``mean``, ``sum``, ``batchmean`` (the sum
    over the batch size) or ``none``."""
    x, t = ctx.i("X"), ctx.i("Target")
    red = ctx.attr("reduction", "mean")
    loss = t * (torch.log(torch.clamp_min(t, 1e-10)) - x)
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / _full(x.shape[0], loss)
    ctx.set("Loss", loss)


@register_op("log_loss", nondiff_inputs=("Labels",))
def _log_loss(ctx, op):
    """misc_ops.py:114: ``−y·log(p + eps) − (1 − y)·log(1 − p + eps)``."""
    p, y = ctx.i("Predicted"), ctx.i("Labels")
    eps = _f32(ctx.attr("epsilon", 1e-4))
    ctx.set("Loss", -y * torch.log(p + eps) - (1 - y) * torch.log(1 - p + eps))


@register_op("rank_loss", nondiff_inputs=("Label",))
def _rank_loss(ctx, op):
    """misc_ops.py:123: ``softplus(l − r) − label·(l − r)``."""
    d = ctx.i("Left") - ctx.i("Right")
    ctx.set("Out", _softplus(d) - ctx.i("Label") * d)


@register_op("margin_rank_loss", nondiff_inputs=("Label",))
def _margin_rank_loss(ctx, op):
    """misc_ops.py:132: ``max(0, −label·(x1 − x2) + margin)`` (label ±1)
    and Activated, 1 where that is above 0."""
    lab, x1, x2 = ctx.i("Label"), ctx.i("X1"), ctx.i("X2")
    v = -lab * (x1 - x2) + _f32(ctx.attr("margin", 0.0))
    out = torch.maximum(torch.zeros_like(v), v)
    ctx.set("Out", out)
    ctx.set("Activated", (out > 0).to(x1.dtype))


@register_op("bpr_loss", nondiff_inputs=("Label",))
def _bpr_loss(ctx, op):
    """misc_ops.py:143: for scores X ``[N, C]``, the mean over the C − 1
    negatives of ``softplus(x_neg − x_pos)``: Y ``[N, 1]``."""
    x = ctx.i("X")
    lab = ctx.i("Label").reshape(-1).long()
    pos = torch.gather(x, 1, lab[:, None])
    mask = (torch.arange(x.shape[1], device=x.device)[None, :] !=
            lab[:, None]).to(x.dtype)
    loss = (_softplus(x - pos) * mask).sum(dim=1) / _full(x.shape[1] - 1, x)
    ctx.set("Y", loss[:, None])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _scale_shift(y, scale, bias):
    bshape = (1, y.shape[1]) + (1,) * (y.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


@register_op("group_norm")
def _group_norm(ctx, op):
    """misc_ops.py:159: each sample's ``groups`` channel groups
    normalised by their mean and population variance, then Scale and
    Bias a channel; Mean and Variance ``[N, groups]`` hold the statistics
    themselves."""
    x = ctx.i("X")
    groups = ctx.attr("groups")
    eps = _f32(ctx.attr("epsilon", 1e-5))
    N, C = x.shape[0], x.shape[1]
    g = x.reshape((N, groups, C // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, g.dim()))
    mean = g.mean(dim=axes, keepdim=True)
    var = g.var(dim=axes, unbiased=False, keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    ctx.set("Y", _scale_shift(y, ctx.i_opt("Scale"), ctx.i_opt("Bias")))
    ctx.set("Mean", mean.reshape(N, groups))
    ctx.set("Variance", var.reshape(N, groups))


@register_op("instance_norm")
def _instance_norm(ctx, op):
    """misc_ops.py:182: each (sample, channel) map normalised by its own
    mean and population variance, then Scale and Bias; SavedMean and
    SavedVariance ``[N, C]`` hold the statistics; no running
    statistics."""
    x = ctx.i("X")
    eps = _f32(ctx.attr("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    ctx.set("Y", _scale_shift(y, ctx.i_opt("Scale"), ctx.i_opt("Bias")))
    ctx.set("SavedMean", mean.reshape(x.shape[0], x.shape[1]))
    ctx.set("SavedVariance", var.reshape(x.shape[0], x.shape[1]))


@register_op("spectral_norm", nondiff_inputs=("U", "V"))
def _spectral_norm(ctx, op):
    """misc_ops.py:202: Weight over its largest singular value, as
    ``max(power_iters, 1)`` power iterations from U and V estimate it on
    the weight moved to put ``dim`` first and flattened to ``[h, w]``;
    the iterations carry no gradient and U and V are not written back,
    so the gradient flows through ``sigma = u·(mat·v)`` alone."""
    w = ctx.i("Weight")
    dim = ctx.attr("dim", 0)
    eps = _full(_f32(ctx.attr("eps", 1e-12)), w)
    mat = torch.movedim(w, dim, 0)
    mat = mat.reshape(mat.shape[0], -1)
    with torch.no_grad():
        u, v = ctx.i("U").reshape(-1), ctx.i("V").reshape(-1)
        m = mat.detach()
        for _ in range(max(ctx.attr("power_iters", 1), 1)):
            v = _matmul_p(m.t(), u)
            v = v / torch.maximum(torch.linalg.vector_norm(v), eps)
            u = _matmul_p(m, v)
            u = u / torch.maximum(torch.linalg.vector_norm(u), eps)
    sigma = _matmul_p(u, _matmul_p(mat, v))
    ctx.set("Out", w / sigma)


# ---------------------------------------------------------------------------
# image / shape manipulation
# ---------------------------------------------------------------------------

@register_op("pad2d")
def _pad2d(ctx, op):
    """misc_ops.py:232: NCHW padded by ``[top, bottom, left, right]``,
    ``constant`` (``pad_value``), ``reflect``, or any other mode as
    ``edge``."""
    x = ctx.i("X")
    t, b, le, r = ctx.attr("paddings", [0, 0, 0, 0])
    mode = ctx.attr("mode", "constant")
    if mode == "constant":
        out = F.pad(x, (le, r, t, b), value=float(ctx.attr("pad_value", 0.0)))
    else:
        out = F.pad(x, (le, r, t, b),
                    mode="reflect" if mode == "reflect" else "replicate")
    ctx.set("Out", out)


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, op):
    """misc_ops.py:248: ``[N, c·r², H, W]`` → ``[N, c, H·r, W·r]``."""
    x = ctx.i("X")
    r = ctx.attr("upscale_factor")
    N, C, H, W = x.shape
    c = C // (r * r)
    out = x.reshape(N, c, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    ctx.set("Out", out.reshape(N, c, H * r, W * r))


@register_op("space_to_depth")
def _space_to_depth(ctx, op):
    """misc_ops.py:258: each ``b x b`` block into channels, the block's
    offsets outermost: ``[N, b²·C, H / b, W / b]``."""
    x = ctx.i("X")
    b = ctx.attr("blocksize")
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    ctx.set("Out", out.reshape(N, C * b * b, H // b, W // b))


@register_op("shuffle_channel")
def _shuffle_channel(ctx, op):
    """misc_ops.py:267: the channels as ``[group, C / group]``,
    transposed."""
    x = ctx.i("X")
    g = ctx.attr("group")
    N, C, H, W = x.shape
    ctx.set("Out", x.reshape(N, g, C // g, H, W).transpose(1, 2)
            .reshape(N, C, H, W))


@register_op("affine_channel")
def _affine_channel(ctx, op):
    """misc_ops.py:276: ``x·scale + bias``, one of each a channel."""
    x = ctx.i("X")
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    ctx.set("Out", x * ctx.i("Scale").reshape(bshape) +
            ctx.i("Bias").reshape(bshape))


@register_op("temporal_shift")
def _temporal_shift(ctx, op):
    """misc_ops.py:285, TSM's shift of ``[N·T, C, H, W]`` over the T
    frames of each clip: channels below ``c1 = int(C·ratio)`` read frame
    t − 1, channels in ``[c1, c2)`` with ``c2 = int(2·C·ratio)`` read
    frame t + 1, each zero where that frame is outside the clip; the rest
    keep frame t."""
    x = ctx.i("X")
    T = ctx.attr("seg_num")
    ratio = ctx.attr("shift_ratio", 0.25)
    NT, C, H, W = x.shape
    v = x.reshape(NT // T, T, C, H, W)
    c1, c2 = int(C * ratio), int(C * 2 * ratio)
    back = F.pad(v[:, :-1, :c1], (0, 0, 0, 0, 0, 0, 1, 0))
    fwd = F.pad(v[:, 1:, c1:c2], (0, 0, 0, 0, 0, 0, 0, 1))
    out = torch.cat([back, fwd, v[:, :, c2:]], dim=2)
    ctx.set("Out", out.reshape(NT, C, H, W))


@register_op("grid_sampler")
def _grid_sampler(ctx, op):
    """misc_ops.py:305: bilinear sampling of X ``[N, C, H, W]`` at Grid
    ``[N, Ho, Wo, 2]`` mapped by ``(g + 1)(size − 1) / 2``; the corner
    indices are clamped into the map, the weights ``g − floor(g)`` are
    not, so a point left of the map extrapolates from its first two
    pixels and one right of it repeats the edge (not ``F.grid_sample``
    in any mode); the Grid gradient flows through the weights alone."""
    x, grid = ctx.i("X"), ctx.i("Grid")
    N, C, H, W = x.shape
    gx = (grid[..., 0] + 1) * (W - 1) / 2
    gy = (grid[..., 1] + 1) * (H - 1) / 2
    x0 = torch.floor(gx).long().clamp(0, W - 1)
    y0 = torch.floor(gy).long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    lx = (gx - x0)[:, None]
    ly = (gy - y0)[:, None]
    flat = x.reshape(N, C, H * W)
    Ho, Wo = grid.shape[1], grid.shape[2]

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(N, 1, Ho * Wo).expand(N, C, Ho * Wo)
        return torch.gather(flat, 2, idx).reshape(N, C, Ho, Wo)

    out = (gather(y0, x0) * (1 - ly) * (1 - lx) +
           gather(y0, x1) * (1 - ly) * lx +
           gather(y1, x0) * ly * (1 - lx) + gather(y1, x1) * ly * lx)
    ctx.set("Output", out)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

@register_op("sampling_id", stop_gradient=True)
def _sampling_id(ctx, op):
    """misc_ops.py:335: one class a row of probabilities X ``[N, C]``,
    drawn as ``jax.random.categorical`` draws it: the argmax of
    ``log(max(x, 1e-20))`` plus Gumbel noise, here from the op's own
    generator (the two packages' streams differ).  int64."""
    x = ctx.i("X")
    u = torch.rand(x.shape, generator=ctx.generator(), dtype=torch.float32,
                   device=x.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    logits = torch.log(torch.clamp_min(x.float(), 1e-20))
    ctx.set("Out", torch.argmax(logits + gumbel, dim=-1))


@register_op("shard_index", nondiff_inputs=("X",), stop_gradient=True)
def _shard_index(ctx, op):
    """misc_ops.py:344: an id of shard ``shard_id`` (``id // size``, with
    ``size = ceil(index_num / nshards)``) becomes ``id % size``, any
    other ``ignore_value``; floor division and modulo, negative ids
    too."""
    x = ctx.i("X")
    nshards = ctx.attr("nshards")
    size = (ctx.attr("index_num") + nshards - 1) // nshards
    belongs = torch.div(x, size, rounding_mode="floor") == ctx.attr(
        "shard_id")
    ctx.set("Out", torch.where(belongs, torch.remainder(x, size),
                               torch.full_like(x, ctx.attr("ignore_value",
                                                           -1))))


@register_op("linspace", stop_gradient=True)
def _linspace(ctx, op):
    """misc_ops.py:356: ``num`` (static) points from Start to Stop, then
    Stop itself, on the device (``torch.linspace`` would need host
    scalars, and fills its second half from the end).  The arithmetic is
    the one XLA compiles ``jnp.linspace``'s ``start·(1 − i/d) + stop·i/d``
    into for the JAX package's program (d = num − 1): the division folded
    into a product with ``r = float32(1/d)``, ``stop·(i·r)`` reassociated
    to ``i·(stop·r)`` and contracted with the sum into one fused
    multiply-add, ``fma(i, stop·r, start·(1 − i·r))``, here in float64
    (exact products of float32 values, one rounding of the sum before the
    one to float32), so the card and the CPU give the same bits."""
    start = ctx.i("Start").reshape(())
    stop = ctx.i("Stop").reshape(())
    num = int(np.asarray(ctx.attr("num", 0)) or 0)
    if num <= 0:
        raise ValueError("linspace needs a static positive Num attr")
    if num == 1:
        ctx.set("Out", start.reshape(1))
        return
    r = _f32(1.0 / (num - 1))
    i = torch.arange(num - 1, dtype=start.dtype, device=start.device)
    head = start * (1 - i * r)
    out = (i.double() * (stop * r).double() + head.double()).to(start.dtype)
    ctx.set("Out", torch.cat([out, stop.reshape(1)]))


@register_op("diag", stop_gradient=True)
def _diag(ctx, op):
    """misc_ops.py:366: ``jnp.diag``: a vector's diagonal matrix (a
    matrix's diagonal)."""
    ctx.set("Out", torch.diag(ctx.i("Diagonal")))


@register_op("roll")
def _roll(ctx, op):
    """misc_ops.py:371: X rolled by ``shifts`` along ``dims`` (or
    ``axis``); with neither, the flattened X by ``shifts[0]``."""
    x = ctx.i("X")
    shifts = list(ctx.attr("shifts", [0]))
    dims = ctx.attr("dims", None) or ctx.attr("axis", None)
    if dims is None:
        ctx.set("Out", torch.roll(x.reshape(-1), shifts[0]).reshape(x.shape))
        return
    dims = list(dims)
    if len(shifts) == 1:                 # jnp.roll broadcasts one shift
        shifts = shifts * len(dims)
    ctx.set("Out", torch.roll(x, shifts, dims))


@register_op("im2sequence")
def _im2sequence(ctx, op):
    """misc_ops.py:383: ``[N, C, H, W]`` → ``[N, Ho·Wo, C·kh·kw]``, one
    step a window position (row-major over ``Ho, Wo``), the features in
    ``(C, kh, kw)`` order, as ``lax.conv_general_dilated_patches`` lays
    them out; ``paddings`` is ``[up, left, down, right]``."""
    x = ctx.i("X")
    kh, kw = ctx.attr("kernels")
    sh, sw = ctx.attr("strides", [1, 1])
    ph0, pw0, ph1, pw1 = ctx.attr("paddings", [0, 0, 0, 0])
    x = F.pad(x, (pw0, pw1, ph0, ph1))
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))   # [N, C*kh*kw, L]
    ctx.set("Out", patches.transpose(1, 2))
