"""Tensor creation / manipulation lowerings (counterpart
``paddle_tpu/fluid/ops/tensor_ops.py``), in plain torch.  The random
fills draw from the op's explicit ``torch.Generator`` (LowerCtx)."""

import contextlib

import numpy as np
import torch

from ..data_types import np_dtype, torch_dtype
from ..registry import register_op


def _empty_xshape(ctx):
    return torch.zeros((0,), dtype=torch.float32, device=ctx.state.device)


@register_op("fill_constant")
def _fill_constant(ctx, op):
    shape = tuple(ctx.attr("shape", [1]))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set("Out", torch.full(shape, ctx.attr("value", 0.0), dtype=dtype,
                              device=ctx.state.device))


@register_op("fill_constant_batch_size_like", nondiff_inputs=("Input",))
def _fill_constant_batch_size_like(ctx, op):
    """tensor_ops.py:25: ``shape`` with its ``output_dim_idx`` entry taken
    from Input's ``input_dim_idx`` dim, filled with ``value`` (the fill
    behind a scalar on the left of a Variable operator)."""
    ref = ctx.i("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ref.shape[ctx.attr("input_dim_idx", 0)]
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set("Out", torch.full(tuple(shape), ctx.attr("value", 0.0),
                              dtype=dtype, device=ref.device))


@register_op("cast")
def _cast(ctx, op):
    """tensor_ops.py:54: X in ``out_dtype``.  A float-to-float cast passes
    its gradient through (autograd's ``to``); an integer input gets none
    (the tape differentiates float inputs only)."""
    ctx.set("Out", ctx.i("X").to(torch_dtype(ctx.attr("out_dtype"))))


@register_op("concat")
def _concat(ctx, op):
    """tensor_ops.py:133: the X list joined along ``axis``."""
    xs = [ctx.env[n] for n in op.input("X")]
    ctx.set("Out", torch.cat(xs, dim=ctx.attr("axis", 0)))


@register_op("assign")
def _assign(ctx, op):
    ctx.set("Out", ctx.i("X"))


@register_op("assign_value")
def _assign_value(ctx, op):
    shape = tuple(ctx.attr("shape"))
    dtype = ctx.attr("dtype", "float32")
    values = np.asarray(ctx.attr("values"), dtype=np_dtype(dtype))
    ctx.set("Out", torch.as_tensor(values.reshape(shape),
                                   device=ctx.state.device))


def _reshape_shape(x, shape):
    """Paddle reshape semantics: 0 copies input dim, -1 infers."""
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return tuple(shape)


@register_op("reshape2")
def _reshape2(ctx, op):
    x = ctx.i("X")
    ctx.set("Out", x.reshape(_reshape_shape(x, ctx.attr("shape"))))
    ctx.set("XShape", _empty_xshape(ctx))


# reshape (v1): the same rule; it has no XShape output (tensor_ops.py:80)
register_op("reshape")(_reshape2)


@register_op("split")
def _split(ctx, op):
    """tensor_ops.py:139: X cut along ``axis`` into ``sections`` (sizes)
    or ``num`` equal parts; the parts are views of X."""
    x = ctx.i("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", [])
    if sections:
        outs = torch.split(x, [int(s) for s in sections], dim=axis)
    else:
        num = int(ctx.attr("num", 0))
        if not num or x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d does not divide "
                             "into num=%d equal parts"
                             % (axis, x.shape[axis], num))
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    for i, o in enumerate(outs):
        ctx.set("Out", o, idx=i)


@register_op("transpose2")
def _transpose2(ctx, op):
    ctx.set("Out", ctx.i("X").permute(*ctx.attr("axis")))
    ctx.set("XShape", _empty_xshape(ctx))


@register_op("unsqueeze2")
def _unsqueeze2(ctx, op):
    x = ctx.i("X")
    for a in sorted(ctx.attr("axes")):
        x = x.unsqueeze(a)
    ctx.set("Out", x)
    ctx.set("XShape", _empty_xshape(ctx))


@register_op("slice")
def _slice(ctx, op):
    x = ctx.i("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    ctx.set("Out", x[tuple(idx)])


@register_op("gather", nondiff_inputs=("Index",))
def _gather(ctx, op):
    x = ctx.i("X")
    ctx.set("Out", torch.index_select(x, 0, ctx.i("Index").long()))


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms inside, the caller's setting
    restored after; a caller who asked for strict determinism keeps it.
    The setting is process-global, not per thread: while the block runs
    (a table gradient, on the autograd engine's device thread) another
    thread's work runs under it too, so no other thread of the process
    may rely on nondeterministic kernels over that moment."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(
        True, warn_only=was[1] if was[0] else True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


class LookupFunction(torch.autograd.Function):
    """``F.embedding`` whose table gradient repeats bit for bit.  On the
    card torch sums the gradient rows of an id that repeats many times
    (BERT's 2-row sentence table: ~2,048 rows each a batch) in an order
    that changes from run to run; under deterministic algorithms it
    takes a fixed order, so a run resumed from a checkpoint retraces the
    unbroken one."""

    @staticmethod
    def forward(ctx, ids, w):
        ctx.save_for_backward(ids)
        ctx.rows = w.shape[0]
        return torch.nn.functional.embedding(ids, w)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        with _deterministic():
            gw = torch.ops.aten.embedding_dense_backward(
                g, ids, ctx.rows, -1, False)
        return None, gw


@register_op("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ctx, op):
    """Embedding lookup (operators/lookup_table_op).  Out-of-range ids
    behave as in the JAX package (``jnp.take`` after clamping at 0):
    negative ids read row 0 and ids past the table give NaN rows — the
    lookup never indexes outside the table, so a bad request id cannot
    fault the device.  padding_idx rows return zeros."""
    w = ctx.i("W")
    ids = ctx.i("Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long().clamp_min(0)
    rows = w.shape[0]
    out = LookupFunction.apply(ids.clamp_max(rows - 1), w)
    bad = (ids >= rows).unsqueeze(-1)
    out = torch.where(bad, torch.full_like(out, float("nan")), out)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    ctx.set("Out", out)


def _random_fill(ctx, draw):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.state.device)
    draw(out, ctx.generator())
    ctx.set("Out", out.to(dtype))


@register_op("uniform_random", stop_gradient=True)
def _uniform_random(ctx, op):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    _random_fill(ctx, lambda t, g: torch.nn.init.uniform_(t, lo, hi,
                                                          generator=g))


@register_op("gaussian_random", stop_gradient=True)
def _gaussian_random(ctx, op):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    _random_fill(ctx, lambda t, g: torch.nn.init.normal_(t, mean, std,
                                                         generator=g))


@register_op("truncated_gaussian_random", stop_gradient=True)
def _truncated_gaussian_random(ctx, op):
    """Standard normal cut at ±2, then scaled — the JAX package's
    ``truncated_normal(key, -2, 2) * std + mean``."""
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)

    def draw(t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.mul_(std).add_(mean)
    _random_fill(ctx, draw)


@register_op("top_k", stop_gradient=True)
def _top_k(ctx, op):
    """tensor_ops.py:309: the k largest entries of the last axis, sorted
    descending, and their int64 indices."""
    vals, idxs = torch.topk(ctx.i("X"), ctx.attr("k", 1), dim=-1)
    ctx.set("Out", vals)
    ctx.set("Indices", idxs)


@register_op("one_hot", nondiff_inputs=("X",), stop_gradient=True)
def _one_hot(ctx, op):
    """tensor_ops.py:246: int ids ``[..., 1]`` (or ``[...]``) → float32
    ``[..., depth]``.  An id outside ``[0, depth)`` gives a row of zeros,
    as ``jax.nn.one_hot`` does, so a bad label cannot fault the device
    (``F.one_hot`` would raise)."""
    x = ctx.i("X")
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = int(ctx.attr("depth"))
    classes = torch.arange(depth, device=x.device)
    ctx.set("Out", (x.long().unsqueeze(-1) == classes).to(torch.float32))


@register_op("increment")
def _increment(ctx, op):
    """tensor_ops.py:274: ``X + step`` in X's dtype.  The learning-rate
    counter names one variable as X and Out; the result is a new tensor,
    which the executor writes back to the scope after the run."""
    x = ctx.i("X")
    ctx.set("Out", x + torch.tensor(ctx.attr("step", 1.0), dtype=x.dtype))
