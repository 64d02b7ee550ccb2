"""NN op lowerings of the slice (counterpart ``paddle_tpu/fluid/ops/
nn_ops.py``): conv2d / depthwise_conv2d, pool2d, batch_norm, layer_norm,
dropout, softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits
and accuracy.

Every conv route but K1's stays a library convolution (``F.conv2d``,
cuDNN on the card), as the JAX package leaves its convs to XLA; K1 is
``ops/conv_ops.py``.  ``batch_norm`` and ``pool2d`` are written out as
the JAX rules compute them, not as ``F.batch_norm``/``F.avg_pool2d``,
whose statistics, running update and border counts differ."""

import numpy as np
import torch
import torch.nn.functional as F

from .. import flags
from ..lowering import amp_operands
from ..registry import register_op
from .conv_ops import Conv3x3Function, k1_applies
from .math_ops import _matmul_p


def _im2col_applies(mode, w, groups):
    if groups != 1 or mode in ("off", "", "0"):
        return False
    if mode == "all":
        return True
    return mode == "3x3" and w.shape[2] == 3 and w.shape[3] == 3


def _conv2d_im2col(x, w, strides, pads, dilations):
    """conv2d as extracted patches times one matrix (nn_ops.py:66): the
    patches ``[N·Ho·Wo, C·kh·kw]`` in channel-major order, as
    ``conv_general_dilated_patches`` and ``F.unfold`` both give them."""
    N = x.shape[0]
    O, _, kh, kw = w.shape
    Ho = (x.shape[2] + 2 * pads[0] - dilations[0] * (kh - 1) - 1) \
        // strides[0] + 1
    Wo = (x.shape[3] + 2 * pads[1] - dilations[1] * (kw - 1) - 1) \
        // strides[1] + 1
    cols = F.unfold(x, (kh, kw), dilation=dilations, padding=pads,
                    stride=strides)                       # [N, C*kh*kw, L]
    out = _matmul_p(cols.transpose(1, 2), w.reshape(O, -1).t())
    return out.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2)


@register_op("conv2d")
def _conv2d(ctx, op):
    """nn_ops.py:88, route by route: K1 (``FLAGS_conv_pallas`` and the
    same gate), unfold x matmul (``FLAGS_conv_im2col``), channels-last
    (``FLAGS_conv_layout=NHWC``), else the NCHW library conv.  The filter
    is cast to the input's dtype before AMP; under AMP without pure bf16
    the output returns to float32 after the bf16 conv."""
    x = ctx.i("Input")          # NCHW
    w = ctx.i("Filter")         # OIHW (out, in/groups, kh, kw)
    strides = tuple(ctx.attr("strides", [1, 1]))
    pads = tuple(ctx.attr("paddings", [0, 0]))[:2]
    dilations = tuple(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    x, w, acc = amp_operands(ctx.state, x, w.to(x.dtype))
    if flags.get_flag("conv_pallas") and k1_applies(
            tuple(x.shape), x.element_size(), tuple(w.shape), strides, pads,
            dilations, groups):
        out = Conv3x3Function.apply(x, w)
    elif _im2col_applies(flags.get_flag("conv_im2col"), w, groups):
        out = _conv2d_im2col(x, w, strides, pads, dilations)
    elif flags.get_flag("conv_layout") == "NHWC":
        cl = torch.channels_last
        out = F.conv2d(x.contiguous(memory_format=cl),
                       w.contiguous(memory_format=cl), None, strides, pads,
                       dilations, groups)
    else:
        out = F.conv2d(x, w, None, strides, pads, dilations, groups)
    if acc is not None:
        out = out.to(acc)
    ctx.set("Output", out)


# groups == in_channels (the reference has a dedicated kernel; here the
# same rule covers it)
register_op("depthwise_conv2d")(_conv2d)


@register_op("pool2d")
def _pool2d(ctx, op):
    """nn_ops.py:193.  ``ceil_mode`` pads the high border so the last
    window fits; max pads with -inf, average with 0 and divides by the
    window size, or with ``exclusive`` and any padding by the count of
    in-image entries — JAX's ``ssum / counts``, which at the extra
    ceil-mode border differs from ``F.avg_pool2d(count_include_pad=
    False)``.  A non-exclusive average divides by a float32 constant, so
    a bf16 input gives a float32 output, as in JAX."""
    x = ctx.i("X")              # NCHW
    ptype = ctx.attr("pooling_type", "max")
    ksize = tuple(ctx.attr("ksize", [2, 2]))
    strides = tuple(ctx.attr("strides", [1, 1]))
    pads = tuple(ctx.attr("paddings", [0, 0]))
    if ctx.attr("global_pooling", False):
        ksize = (x.shape[2], x.shape[3])
        strides = (1, 1)
        pads = (0, 0)
    if ctx.attr("ceil_mode", False):
        extra_h = -(x.shape[2] + 2 * pads[0] - ksize[0]) % strides[0]
        extra_w = -(x.shape[3] + 2 * pads[1] - ksize[1]) % strides[1]
    else:
        extra_h = extra_w = 0
    border = (pads[1], pads[1] + extra_w, pads[0], pads[0] + extra_h)
    if ptype == "max":
        low = -float("inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = F.max_pool2d(F.pad(x, border, value=low), ksize, strides)
        ctx.set("Out", out)
        return
    ssum = F.avg_pool2d(F.pad(x, border), ksize, strides,
                        divisor_override=1)
    if ctx.attr("exclusive", True) and any(border):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(F.pad(ones, border), ksize, strides,
                              divisor_override=1)
        out = ssum / counts
    else:
        out = ssum.to(torch.promote_types(ssum.dtype, torch.float32)) / \
            float(np.prod(ksize))
    ctx.set("Out", out)


def _local_moments(xm, axes):
    """E[x] and E[x²] over ``axes``, float32."""
    return xm.mean(axes), torch.square(xm).mean(axes)


def _batch_norm_rule(ctx, moments):
    """batch_norm and sync_batch_norm: ``moments(xm, axes)`` gives the
    batch's E[x] and E[x²]; the rest is nn_ops.py:232's formula — the
    variance ``E[x²] − E[x]²`` clamped at 0, the running update
    ``running·m + batch·(1 − m)`` with the biased batch variance,
    ``SavedVariance = 1/sqrt(var + eps)``, ``y = x·a + b`` with
    ``a = scale·inv`` and ``b = bias − mean·a``, cast to x's dtype.  The
    gradient flows through the batch statistics.  MeanOut/VarianceOut
    name the Mean/Variance variables (the in-place update)."""
    x = ctx.i("X")
    scale = ctx.i("Scale")
    bias = ctx.i("Bias")
    mean = ctx.i("Mean")
    var = ctx.i("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    is_test = ctx.attr("is_test", False) or ctx.state.is_test
    use_global = ctx.attr("use_global_stats", False) or is_test
    if ctx.attr("data_layout", "NCHW") == "NCHW" and x.dim() == 4:
        axes = (0, 2, 3)
        bshape = (1, -1, 1, 1)
    else:
        axes = tuple(range(x.dim() - 1))
        bshape = (1,) * (x.dim() - 1) + (-1,)
    xm = x.float()
    if use_global:
        use_mean, use_var = mean.float(), var.float()
        ctx.set("MeanOut", mean)
        ctx.set("VarianceOut", var)
    else:
        use_mean, mean_sq = moments(xm, axes)
        use_var = torch.clamp_min(mean_sq - torch.square(use_mean), 0.0)
        ctx.set("MeanOut", (mean.float() * momentum + use_mean.detach() *
                            (1 - momentum)).to(mean.dtype))
        ctx.set("VarianceOut", (var.float() * momentum + use_var.detach() *
                                (1 - momentum)).to(var.dtype))
    inv = torch.rsqrt(use_var + eps)
    a = scale.float() * inv
    b = bias.float() - use_mean * a
    y = xm * a.reshape(bshape) + b.reshape(bshape)
    ctx.set("Y", y.to(x.dtype))
    ctx.set("SavedMean", use_mean)
    ctx.set("SavedVariance", inv)


@register_op("batch_norm", nondiff_inputs=("Mean", "Variance"))
def _batch_norm(ctx, op):
    """nn_ops.py:232 (see ``_batch_norm_rule``)."""
    _batch_norm_rule(ctx, _local_moments)


@register_op("sync_batch_norm", nondiff_inputs=("Mean", "Variance"))
def _sync_batch_norm(ctx, op):
    """Cross-rank batch norm (nn_ops.py:593; reference
    operators/sync_batch_norm_op.cu): the moments of the GLOBAL batch.
    As in the JAX rule, one all-reduce of each rank's [Σx, Σx², row
    count] gives the global sums, and E[x], E[x²] are those over the
    summed count, which stays on the device.  The payload is float64:
    a rank's sums are its float32 moments times its count, a product
    float64 holds exactly, so beside the local means' rounding the
    global moments carry only float64's and the one cast back (in a
    world of one they are batch_norm's bit for bit).  The all-reduce is
    differentiable (``collective_ops.all_reduce_sum``: its backward
    all-reduces the gradient), so the grad op, which pulls back through
    this op's own autograd graph, gets the global statistics' gradient.
    With no process group it is batch_norm."""
    from . import collective_ops
    w = collective_ops._world(ctx)
    if w is None:
        _batch_norm_rule(ctx, _local_moments)
        return
    _d, group, _n = w

    def moments(xm, axes):
        m, msq = _local_moments(xm, axes)
        c = m.numel()
        rows = float(np.prod([xm.shape[a] for a in axes]))
        count = torch.full((1,), rows, dtype=torch.float64,
                           device=xm.device)
        sums = collective_ops.all_reduce_sum(
            torch.cat([m.double(), msq.double(), torch.ones_like(count)])
            * count, group)
        collective_ops.calls[ctx.op.type] += 1
        ctx.state.record_comm("allreduce", "fp64", 2 * 8 * (2 * c + 1))
        n = sums[2 * c:]
        return (sums[:c] / n).float(), (sums[c:2 * c] / n).float()

    _batch_norm_rule(ctx, moments)


@register_op("layer_norm")
def _layer_norm(ctx, op):
    """Statistics in float32 whatever the input dtype; outputs Y and the
    per-row Mean / Variance (population variance), as nn_ops.py:285."""
    x = ctx.i("X")
    scale = ctx.i_opt("Scale")
    bias = ctx.i_opt("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    bna = ctx.attr("begin_norm_axis", 1)
    dims = tuple(range(bna, x.dim()))
    xm = x.float()
    var, mean = torch.var_mean(xm, dim=dims, keepdim=True, correction=0)
    y = (xm - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    lead = tuple(x.shape[:bna])
    ctx.set("Y", y.to(x.dtype))
    ctx.set("Mean", mean.reshape(lead))
    ctx.set("Variance", var.reshape(lead))


def keep_mask(ctx, p, shape):
    """bool keep mask, each element kept with probability ``1 - p``,
    drawn from the op's generator (Philox on the card).  The JAX package
    draws ``jax.random.bernoulli``: the same law, other bits."""
    u = torch.rand(shape, generator=ctx.generator(),
                   device=ctx.state.device)
    return u < 1.0 - p


@register_op("dropout")
def _dropout(ctx, op):
    """nn_ops.py:308.  Train mode keeps each element with probability
    1 - p; ``upscale_in_train`` divides the kept ones by 1 - p,
    ``downgrade_in_infer`` leaves them and scales at inference instead.
    Mask is the uint8 keep mask; dropout_grad differentiates the taped
    forward, so it uses this very mask."""
    x = ctx.i("X")
    p = ctx.attr("dropout_prob", 0.5)
    upscale = ctx.attr("dropout_implementation",
                       "downgrade_in_infer") == "upscale_in_train"
    if ctx.attr("is_test", False) or ctx.state.is_test:
        ctx.set("Out", x if upscale else x * (1.0 - p))
        ctx.set("Mask", torch.ones_like(x, dtype=torch.uint8))
        return
    keep = keep_mask(ctx, p, x.shape)
    if upscale:
        out = torch.where(keep, x / max(1.0 - p, 1e-8), torch.zeros_like(x))
    else:
        out = torch.where(keep, x, torch.zeros_like(x))
    ctx.set("Out", out)
    ctx.set("Mask", keep.to(torch.uint8))


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, op):
    """nn_ops.py:336: log-softmax in float32, hard or soft labels,
    ``ignore_index`` rows give 0 loss.  Loss ``[..., 1]``."""
    logits = ctx.i("Logits")
    label = ctx.i("Label")
    log_sm = torch.log_softmax(logits.float(), dim=-1)
    ctx.set("Softmax", torch.exp(log_sm).to(logits.dtype))
    if ctx.attr("soft_label", False):
        loss = -(label.float() * log_sm).sum(-1, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        lab = lab.long()
        loss = -torch.gather(log_sm, -1, lab.clamp_min(0).unsqueeze(-1))
        ignore_index = ctx.attr("ignore_index", -100)
        if ignore_index >= 0:
            loss = loss.masked_fill((lab == ignore_index).unsqueeze(-1),
                                    0.0)
    ctx.set("Loss", loss.to(logits.dtype))


@register_op("sigmoid_cross_entropy_with_logits", nondiff_inputs=("Label",))
def _sigmoid_cross_entropy_with_logits(ctx, op):
    """nn_ops.py:379, the same stable form
    ``max(x, 0) − x·z + log1p(exp(−|x|))`` (not
    ``F.binary_cross_entropy_with_logits``, whose backward rounds
    differently and splits the subgradient at x = 0 otherwise:
    ``torch.maximum``, like ``jnp.maximum``, sends half to each side of
    the tie).  Entries whose label is ``ignore_index`` (when it is not
    -100) give 0; ``normalize`` divides by the count of the others."""
    x = ctx.i("X")
    label = ctx.i("Label").to(x.dtype)
    loss = torch.maximum(x, torch.zeros((), dtype=x.dtype)) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    ignore_index = ctx.attr("ignore_index", -100)
    if ignore_index != -100:
        loss = torch.where(label == ignore_index, torch.zeros_like(loss),
                           loss)
    if ctx.attr("normalize", False):
        n = torch.sum((label != ignore_index).to(x.dtype))
        loss = loss / torch.clamp_min(n, 1.0)
    ctx.set("Out", loss)


@register_op("accuracy", stop_gradient=True)
def _accuracy(ctx, op):
    """nn_ops.py:414: a row is correct when any of its top-k indices
    equals its label; Accuracy (float32, 0-d), Correct and Total
    (int32 [1])."""
    indices = ctx.i("Indices")
    label = ctx.i("Label")
    if label.dim() == 1:
        label = label[:, None]
    correct = (indices == label.to(indices.dtype)).any(-1)
    num_correct = correct.float().sum()
    rows = correct.shape[0]
    ctx.set("Accuracy", (num_correct / rows).reshape(()))
    ctx.set("Correct", num_correct.to(torch.int32).reshape((1,)))
    ctx.set("Total", torch.full((1,), rows, dtype=torch.int32,
                                device=indices.device))
