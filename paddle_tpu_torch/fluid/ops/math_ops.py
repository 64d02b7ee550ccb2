"""Elementwise / activation / matmul lowerings (counterpart
``paddle_tpu/fluid/ops/math_ops.py``), in plain torch."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op
from ..flags import matmul_precision
from ..lowering import amp_operands

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


def _binary(fn):
    def lower(ctx, op):
        x = ctx.i("X")
        y = _align(x, ctx.i("Y"), ctx.attr("axis", -1))
        ctx.set("Out", fn(x, y))
    return lower


# the elementwise types of JAX's table (math_ops.py:42); torch's type
# promotion (bf16 with float32 gives float32) and true division are
# jnp's, and torch.maximum/minimum, like jnp's, split the gradient evenly
# at a tie.  jnp.mod takes the divisor's sign, as torch.remainder does
# (torch.fmod takes the dividend's)
for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
    ("elementwise_mod", torch.remainder),
    ("elementwise_floordiv", torch.floor_divide),
]:
    register_op(_name)(_binary(_fn))


@register_op("scale")
def _scale(ctx, op):
    x = ctx.i("X")
    scale = ctx.attr("scale", 1.0)
    bias = ctx.attr("bias", 0.0)
    if ctx.attr("__dp_mean__", False):
        # the gradient mean the collective transpiler inserts: divide by
        # the ranks of this run's ring 0 (the world, 1 without one; a
        # model-parallel program's dp group), as the JAX rule divides by
        # its mapped axis's size, whatever nranks the program was
        # transpiled for (0 means any world)
        ctx.set("Out", x / ctx.state.ring_size(0))
        return
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


def _matmul_p(a, b, acc=None):
    """``a @ b``; with ``acc`` (AMP, outputs not kept in the AMP dtype)
    the product of the AMP-rounded operands summed and returned in
    ``acc``, which is what the JAX rules' ``preferred_element_type``
    asks for (math_ops.py:96)."""
    if acc is not None:
        a, b = a.to(acc), b.to(acc)
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
    x2, y2, acc = amp_operands(ctx.state, x2, y2)
    out = _matmul_p(x2, y2, acc)
    ctx.set("Out", out.reshape(xs[:xnc] + ys[ynd:]))


@register_op("matmul")
def _matmul(ctx, op):
    x = ctx.i("X")
    y = ctx.i("Y")
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    x, y, acc = amp_operands(ctx.state, x, y)
    out = _matmul_p(x, y, acc)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set("Out", out)


@register_op("gelu")
def _gelu(ctx, op):
    approx = ctx.attr("approximate", False)
    ctx.set("Out", F.gelu(ctx.i("X"),
                          approximate="tanh" if approx else "none"))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x past
    # a threshold
    return torch.logaddexp(x, torch.zeros_like(x))


# JAX's whole unary table (math_ops.py:172), one torch function each
for _name, _fn in [
    ("relu", torch.relu),
    ("sigmoid", torch.sigmoid),
    ("tanh", torch.tanh),
    ("exp", torch.exp),
    ("log", torch.log),
    ("sqrt", torch.sqrt),
    ("rsqrt", torch.rsqrt),
    ("square", torch.square),
    ("abs", torch.abs),
    ("floor", torch.floor),
    ("ceil", torch.ceil),
    ("round", torch.round),           # half to even, as jnp.round
    ("reciprocal", torch.reciprocal),
    ("sin", torch.sin),
    ("cos", torch.cos),
    ("softsign", F.softsign),
    ("softplus", _softplus),
    ("sign", torch.sign),
    ("erf", torch.erf),
    ("logsigmoid", F.logsigmoid),
    ("acos", torch.acos),
    ("asin", torch.asin),
    ("atan", torch.atan),
]:
    register_op(_name)(
        lambda ctx, op, _fn=_fn: ctx.set("Out", _fn(ctx.i("X"))))


def _scalar(v, like):
    """A Python number as a 0-d host tensor of ``like``'s dtype: it acts
    as a scalar on any device, and rounds as ``jnp.asarray(v, dtype)``
    (or a weakly typed Python float) does in the JAX rules."""
    return torch.tensor(v, dtype=like.dtype)


@register_op("clip")
def _clip(ctx, op):
    """math_ops.py:248, ``jnp.clip``: ``minimum(maximum(x, min), max)``.
    The composition keeps jnp's gradient at a bound (half on each side of
    a tie), where ``torch.clamp`` passes all of it."""
    x = ctx.i("X")
    out = torch.maximum(x, _scalar(ctx.attr("min"), x))
    ctx.set("Out", torch.minimum(out, _scalar(ctx.attr("max"), x)))


@register_op("clip_by_norm")
def _clip_by_norm(ctx, op):
    """math_ops.py:254: ``x · max_norm / ‖x‖`` where ``‖x‖ > max_norm``,
    else x, the norm floored at 1e-12 in the division."""
    x = ctx.i("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    # the 0-d max_norm divides (a Python float on the left would be
    # torch's reciprocal-then-multiply, not jnp's division)
    scale = torch.where(norm > max_norm, _scalar(max_norm, norm) /
                        torch.maximum(norm, _scalar(1e-12, norm)), 1.0)
    ctx.set("Out", x * scale.to(x.dtype))


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, op):
    """math_ops.py:295: ``sum(x²)`` as a 1-element tensor."""
    ctx.set("Out", torch.sum(torch.square(ctx.i("X"))).reshape((1,)))


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


@register_op("reduce_sum")
def _reduce_sum(ctx, op):
    """math_ops.py:136: the sum over ``dim`` (Paddle's negative axes
    allowed), or over every axis with ``reduce_all``, which gives a 0-d
    tensor as ``jnp.sum(axis=None)`` does (a 1-element one of rank
    ``x.dim()`` with ``keep_dim``).  An empty ``dim`` sums nothing."""
    x = ctx.i("X")
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        axes = tuple(sorted({d % x.dim() for d in ctx.attr("dim", [0])}))
    ctx.set("Out", torch.sum(x, dim=axes, keepdim=keep) if axes else x)


@register_op("reduce_mean")
def _reduce_mean(ctx, op):
    """math_ops.py:151: the mean over ``dim``, or over every axis with
    ``reduce_all`` (0-d, as ``jnp.mean(axis=None)``), as reduce_sum
    reads its attributes."""
    x = ctx.i("X")
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        axes = tuple(sorted({d % x.dim() for d in ctx.attr("dim", [0])}))
    ctx.set("Out", torch.mean(x, dim=axes, keepdim=keep) if axes else x)


@register_op("softmax")
def _softmax(ctx, op):
    ctx.set("Out", torch.softmax(ctx.i("X"), dim=ctx.attr("axis", -1)))
