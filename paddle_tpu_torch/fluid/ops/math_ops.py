"""Elementwise / activation / matmul lowerings (counterpart
``paddle_tpu/fluid/ops/math_ops.py``), in plain torch."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op
from ..flags import matmul_precision

# ---------------------------------------------------------------------------
# Paddle elementwise broadcast: Y aligns to X starting at `axis`
# (operators/elementwise/elementwise_op_function.h semantics).
# ---------------------------------------------------------------------------


def _align(x, y, axis):
    if y.dim() == 0 or x.shape == y.shape:
        return y
    if axis is None or axis == -1:
        return y
    trailing = x.dim() - axis - y.dim()
    if trailing > 0:
        return y.reshape(tuple(y.shape) + (1,) * trailing)
    return y


@register_op("elementwise_add")
def _elementwise_add(ctx, op):
    x = ctx.i("X")
    y = _align(x, ctx.i("Y"), ctx.attr("axis", -1))
    ctx.set("Out", x + y)


@register_op("scale")
def _scale(ctx, op):
    x = ctx.i("X")
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    ctx.set("Out", out.to(x.dtype))


@contextlib.contextmanager
def _fp32_precision(a):
    """FLAGS_matmul_precision around one float32 product: the flag's
    PyTorch precision name, restored afterwards; ``default`` touches
    nothing."""
    want = matmul_precision() if a.dtype == torch.float32 else None
    if want is None:
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(want)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _matmul_p(a, b):
    with _fp32_precision(a):
        return torch.matmul(a, b)


@register_op("mul")
def _mul(ctx, op):
    """Reference mul_op: flatten x to 2-D at x_num_col_dims, then matmul."""
    x = ctx.i("X")
    y = ctx.i("Y")
    xnc = ctx.attr("x_num_col_dims", 1)
    ynd = ctx.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((int(np.prod(xs[:xnc])) if xnc else 1, -1))
    y2 = y.reshape((int(np.prod(ys[:ynd])) if ynd else 1, -1)) \
        if y.dim() != 2 or ynd != 1 else y
    out = _matmul_p(x2, y2)
    ctx.set("Out", out.reshape(xs[:xnc] + ys[ynd:]))


@register_op("matmul")
def _matmul(ctx, op):
    x = ctx.i("X")
    y = ctx.i("Y")
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = _matmul_p(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set("Out", out)


@register_op("gelu")
def _gelu(ctx, op):
    approx = ctx.attr("approximate", False)
    ctx.set("Out", F.gelu(ctx.i("X"),
                          approximate="tanh" if approx else "none"))


@register_op("tanh")
def _tanh(ctx, op):
    ctx.set("Out", torch.tanh(ctx.i("X")))


@register_op("sum")
def _sum(ctx, op):
    """Sum of the X list (gradient accumulation in backward.py), left to
    right as math_ops.py:80."""
    xs = [ctx.env[n] for n in op.input("X")]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set("Out", out)


@register_op("mean")
def _mean(ctx, op):
    # the reference mean_op emits a 1-element tensor, not a 0-d scalar
    ctx.set("Out", torch.mean(ctx.i("X")).reshape((1,)))


@register_op("softmax")
def _softmax(ctx, op):
    ctx.set("Out", torch.softmax(ctx.i("X"), dim=ctx.attr("axis", -1)))
