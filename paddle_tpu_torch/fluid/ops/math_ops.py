"""Elementwise / activation / matmul lowerings (counterpart
``paddle_tpu/fluid/ops/math_ops.py``), in plain torch."""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op
from ..flags import matmul_precision
from ..lowering import amp_operands
from .detection_ops import clip

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


def _abs(x):
    """``jnp.abs``, whose gradient is +1 at 0 (``select(x >= 0, g, -g)``
    in JAX's lax.py); ``torch.abs``'s is 0 there."""
    return torch.where(x >= 0, x, -x)


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
    ("abs", _abs),
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


def _full(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype filled on its device: a
    scalar to compare with or divide by (a true division on the card too)
    with no host copy."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


@register_op("clip")
def _clip(ctx, op):
    """math_ops.py:248, ``jnp.clip``."""
    ctx.set("Out", clip(ctx.i("X"), ctx.attr("min"), ctx.attr("max")))


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


@register_op("softmax")
def _softmax(ctx, op):
    ctx.set("Out", torch.softmax(ctx.i("X"), dim=ctx.attr("axis", -1)))


def _reduce_axes(ctx, x):
    """The sorted axes a reduce op names (Paddle's negative axes allowed),
    every axis with ``reduce_all``."""
    if ctx.attr("reduce_all", False):
        return tuple(range(x.dim()))
    return tuple(sorted({d % x.dim() for d in ctx.attr("dim", [0])}))


class _LastProd(torch.autograd.Function):
    """The product over the last dim.  Its gradient, each entry's product
    of all the others, is the exclusive running product from the left
    times the one from the right: exact where entries are 0, as JAX's,
    and with no host read (``torch.prod``'s backward asks the host
    whether an entry is 0)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return torch.prod(y, dim=-1)

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        one = torch.ones_like(y[..., :1])
        left = torch.cumprod(torch.cat([one, y[..., :-1]], -1), -1)
        right = torch.flip(torch.cumprod(torch.cat(
            [one, torch.flip(y[..., 1:], (-1,))], -1), -1), (-1,))
        return g.unsqueeze(-1) * left * right


def _prod(x, axes, keep):
    """``jnp.prod`` over ``axes``: the reduced axes moved last and
    flattened into one (:class:`_LastProd`)."""
    rest = [d for d in range(x.dim()) if d not in axes]
    y = x.permute(*rest, *axes).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = _LastProd.apply(y)
    if keep:
        out = out.reshape([1 if d in axes else s
                           for d, s in enumerate(x.shape)])
    return out


def _reduce(fn):
    def lower(ctx, op):
        x = ctx.i("X")
        axes = _reduce_axes(ctx, x)
        ctx.set("Out", fn(x, axes, ctx.attr("keep_dim", False))
                if axes else x)
    return lower


# math_ops.py:149-154: the reduction over ``dim`` (Paddle's negative
# axes allowed), or over every axis with ``reduce_all``, which gives a
# 0-d tensor as ``jnp.sum(axis=None)`` does (a 1-element one of rank
# ``x.dim()`` with ``keep_dim``).  torch.amax/amin share the gradient
# equally among tied extrema, as JAX's max/min do (torch.max(dim) would
# give it all to one); an empty ``dim`` reduces nothing (torch's dim=()
# would reduce every axis)
for _name, _fn in [
    ("reduce_sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k)),
    ("reduce_mean", lambda x, a, k: torch.mean(x, dim=a, keepdim=k)),
    ("reduce_max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k)),
    ("reduce_min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k)),
    ("reduce_prod", _prod),
]:
    register_op(_name)(_reduce(_fn))


@register_op("relu6")
def _relu6(ctx, op):
    """math_ops.py:199: ``clip(x, 0, threshold)``: gradient 0.5 at exactly
    0 and at exactly the threshold."""
    x = ctx.i("X")
    ctx.set("Out", clip(x, 0.0, ctx.attr("threshold", 6.0)))


@register_op("leaky_relu")
def _leaky_relu(ctx, op):
    """math_ops.py:206: ``where(x >= 0, x, alpha x)``: gradient 1 at
    exactly 0 (``F.leaky_relu`` gives alpha there)."""
    x = ctx.i("X")
    ctx.set("Out", torch.where(x >= 0, x,
                               x * _scalar(ctx.attr("alpha", 0.02), x)))


@register_op("hard_sigmoid")
def _hard_sigmoid(ctx, op):
    """math_ops.py:219: ``clip(slope x + offset, 0, 1)``: gradient half
    the slope at either bound."""
    x = ctx.i("X")
    y = x * _scalar(ctx.attr("slope", 0.2), x) + \
        _scalar(ctx.attr("offset", 0.5), x)
    ctx.set("Out", clip(y, 0.0, 1.0).to(x.dtype))


@register_op("swish")
def _swish(ctx, op):
    """math_ops.py:227: ``x sigmoid(beta x)``."""
    x = ctx.i("X")
    ctx.set("Out", x * torch.sigmoid(_scalar(ctx.attr("beta", 1.0), x) * x))


@register_op("stanh")
def _stanh(ctx, op):
    """math_ops.py:234: ``b tanh(a x)``."""
    x = ctx.i("X")
    a = _scalar(ctx.attr("scale_a", 0.67), x)
    ctx.set("Out", _scalar(ctx.attr("scale_b", 1.7159), x) *
            torch.tanh(a * x))


@register_op("pow")
def _pow(ctx, op):
    """math_ops.py:242: ``x ** factor``, the factor rounded to float32 as
    the JAX rule's ``jnp.asarray(factor, x.dtype)`` rounds it.  A Python
    exponent, not a 0-d tensor: the tensor exponent's backward reads a
    value back to the host."""
    x = ctx.i("X")
    factor = _scalar(ctx.attr("factor", 1.0), x).item()    # a host value
    ctx.set("Out", torch.pow(x, factor))


@register_op("log_softmax")
def _log_softmax(ctx, op):
    """math_ops.py:269: ``jax.nn.log_softmax`` over ``axis``."""
    ctx.set("Out", torch.log_softmax(ctx.i("X"), dim=ctx.attr("axis", -1)))


@register_op("cumsum")
def _cumsum(ctx, op):
    """math_ops.py:275: the running sum along ``axis``; ``exclusive``
    shifts it one place (the first entry 0), ``reverse`` runs it from
    the end."""
    x = ctx.i("X")
    axis = ctx.attr("axis", -1) % x.dim()
    reverse = ctx.attr("reverse", False)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if ctx.attr("exclusive", False):
        first = torch.zeros_like(out.narrow(axis, 0, 1))
        out = torch.cat([first, out.narrow(axis, 0, out.shape[axis] - 1)],
                        dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    ctx.set("Out", out)
