"""The op zoo's first batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops.py``), so far only ``im2sequence``, the OCR models' sliding
window; the rest of the JAX file is ROADMAP item 13c.3."""

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
