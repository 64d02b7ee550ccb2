"""The op zoo's first batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops.py``), so far ``im2sequence``, the OCR models' sliding window,
and ``smooth_l1_loss``, SSD's localisation loss; the rest of the JAX
file is ROADMAP item 13c.3."""

import torch
import torch.nn.functional as F

from ..registry import register_op


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
