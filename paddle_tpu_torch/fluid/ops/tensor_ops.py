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


# the v1 types share their v2 rule (tensor_ops.py:90-130); they have no
# XShape output, so the rule's XShape goes nowhere
register_op("transpose")(_transpose2)


@register_op("flatten2")
def _flatten2(ctx, op):
    """tensor_ops.py:93: X as ``[prod(shape[:axis]), -1]`` (1 rows ahead
    of axis 0)."""
    x = ctx.i("X")
    axis = ctx.attr("axis", 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    ctx.set("Out", x.reshape((lead, -1)))
    ctx.set("XShape", _empty_xshape(ctx))


register_op("flatten")(_flatten2)


@register_op("unsqueeze2")
def _unsqueeze2(ctx, op):
    x = ctx.i("X")
    for a in sorted(ctx.attr("axes")):
        x = x.unsqueeze(a)
    ctx.set("Out", x)
    ctx.set("XShape", _empty_xshape(ctx))


register_op("unsqueeze")(_unsqueeze2)


@register_op("squeeze2")
def _squeeze2(ctx, op):
    """tensor_ops.py:105: drop the size-1 dims among ``axes`` (every
    size-1 dim when ``axes`` is empty); XShape is the empty placeholder
    unsqueeze2 gives."""
    x = ctx.i("X")
    axes = {a % max(x.dim(), 1) for a in ctx.attr("axes", [])}
    if axes:
        out = x.reshape(tuple(s for i, s in enumerate(x.shape)
                              if not (i in axes and s == 1)))
    else:
        out = x.squeeze()
    ctx.set("Out", out)
    ctx.set("XShape", _empty_xshape(ctx))


register_op("squeeze")(_squeeze2)


@register_op("stack")
def _stack(ctx, op):
    """tensor_ops.py:153: the X list stacked along a new ``axis``."""
    ctx.set("Y", torch.stack([ctx.env[n] for n in op.input("X")],
                             dim=ctx.attr("axis", 0)))


@register_op("unstack")
def _unstack(ctx, op):
    """tensor_ops.py:158: X cut into its slices along ``axis``, that
    axis dropped."""
    x = ctx.i("X")
    for i, part in enumerate(torch.unbind(x, dim=ctx.attr("axis", 0))):
        ctx.set("Y", part, idx=i)


@register_op("expand")
def _expand(ctx, op):
    """tensor_ops.py:181: X tiled ``expand_times`` along each axis."""
    ctx.set("Out", ctx.i("X").repeat(*ctx.attr("expand_times")))


@register_op("expand_as")
def _expand_as(ctx, op):
    """tensor_ops.py:188: X tiled to target_tensor's shape (each of its
    dims a whole multiple of X's)."""
    x = ctx.i("X")
    target = ctx.i("target_tensor")
    ctx.set("Out", x.repeat(*(t // s for t, s in zip(target.shape,
                                                      x.shape))))


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, op):
    ctx.set("Out", torch.zeros_like(ctx.i("X")))


@register_op("range", stop_gradient=True)
def _range(ctx, op):
    """tensor_ops.py:261: ``arange(start, end, step)``, from the static
    attrs the layer writes for Python bounds, else from the Start, End
    and Step tensors (one read-back each).  Integer bounds give int64."""
    if ctx.attr("static_start") is not None:
        start, end, step = (ctx.attr("static_start"),
                            ctx.attr("static_end"), ctx.attr("static_step"))
    else:
        start, end, step = (ctx.i(s).reshape(-1)[0].item()
                            for s in ("Start", "End", "Step"))
    ctx.set("Out", torch.arange(start, end, step, device=ctx.state.device))


def _compare(fn):
    def lower(ctx, op):
        ctx.set("Out", fn(ctx.i("X"), ctx.i("Y")))
    return lower


# tensor_ops.py:282-302: the comparisons and the binary logical ops,
# elementwise with broadcasting, bool results
for _name, _fn in [
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
    ("logical_and", torch.logical_and),
    ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    register_op(_name, stop_gradient=True)(_compare(_fn))


@register_op("logical_not", stop_gradient=True)
def _logical_not(ctx, op):
    ctx.set("Out", torch.logical_not(ctx.i("X")))


@register_op("isfinite", stop_gradient=True)
def _isfinite(ctx, op):
    """tensor_ops.py:360: one ``(1,)`` bool, true when every entry of
    every X is finite (the AMP gate reads it)."""
    xs = [ctx.env[n] for n in op.input("X")]
    finite = torch.stack([torch.isfinite(x).all() for x in xs]).all()
    ctx.set("Out", finite.reshape((1,)))


@register_op("where", nondiff_inputs=("Condition",))
def _where(ctx, op):
    """tensor_ops.py:339: the JAX package's three-argument select,
    X where Condition holds, else Y (not the reference's index-returning
    ``where``)."""
    ctx.set("Out", torch.where(ctx.i("Condition"), ctx.i("X"), ctx.i("Y")))


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


def _wrap_negative(ids, n):
    """jnp indexing's reading of an index into a dim of ``n``: a negative
    index counts from the end."""
    return torch.where(ids < 0, ids + n, ids)


@register_op("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ctx, op):
    """tensor_ops.py:203: ``x[tuple(moveaxis(index, -1, 0))]``: the last
    dim of Index holds the leading coordinates into X.  As jnp indexing
    reads them, a negative coordinate counts from the end and one still
    out of range is clamped to the nearest row, so the gather never
    reads outside X; the gradient of such a clamped read is dropped, as
    the scatter-add of JAX's backward drops an out-of-range update."""
    x = ctx.i("X")
    index = ctx.i("Index").long()
    coords, valid = [], None
    for k in range(index.shape[-1]):
        c = _wrap_negative(index[..., k], x.shape[k])
        ok = (c >= 0) & (c < x.shape[k])
        valid = ok if valid is None else valid & ok
        coords.append(c.clamp(0, x.shape[k] - 1))
    out = x[tuple(coords)]
    valid = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    ctx.set("Out", torch.where(valid, out, out.detach()))


@register_op("scatter", nondiff_inputs=("Ids",))
def _scatter(ctx, op):
    """tensor_ops.py:210: ``x.at[ids].set(updates)`` (``overwrite``) or
    ``.add`` (duplicate ids summed).  A negative id counts from the end;
    one still out of range is dropped, as JAX's scatter drops it: it
    writes to a trash row one past X's, sliced off.  With duplicate ids
    and ``overwrite`` which write wins is unspecified in both packages."""
    x = ctx.i("X")
    n = x.shape[0]
    ids = _wrap_negative(ctx.i("Ids").long(), n)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    buf = torch.cat([x, torch.zeros_like(x[:1])])
    out = buf.index_put((ids,), ctx.i("Updates").to(x.dtype),
                        accumulate=not ctx.attr("overwrite", True))
    ctx.set("Out", out[:n])


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


# tensor_ops.py:253: v2 is the same rule; a trailing 1 on the ids is
# dropped here too, as the JAX package's shared rule drops it
register_op("lookup_table_v2", nondiff_inputs=("Ids",))(_lookup_table)


@register_op("shape", stop_gradient=True)
def _shape(ctx, op):
    """tensor_ops.py:256: Input's static shape as int32, a constant
    copied to the card once (no host copy, so no sync, in a step)."""
    from .detection_ops import const
    ctx.set("Out", const(np.asarray(ctx.i("Input").shape, np.int32),
                         ctx.state.device))


def _random_fill(ctx, draw, shape=None):
    shape = tuple(ctx.attr("shape")) if shape is None else shape
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.state.device)
    draw(out, ctx.generator())
    ctx.set("Out", out.to(dtype))


@register_op("uniform_random_batch_size_like", stop_gradient=True,
             nondiff_inputs=("Input",))
def _uniform_random_batch_size_like(ctx, op):
    """tensor_ops.py:400: ``uniform_random`` of ``shape`` with its
    ``output_dim_idx`` entry taken from Input's ``input_dim_idx`` dim."""
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.i("Input").shape[ctx.attr("input_dim_idx", 0)]
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    _random_fill(ctx, lambda t, g: torch.nn.init.uniform_(
        t, lo, hi, generator=g), tuple(shape))


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


def top_k_stable(x, k):
    """The k largest entries of the last axis, sorted descending, and
    their int64 indices, the lower index first among equal entries, as
    ``lax.top_k`` gives them (``torch.topk`` promises no order for ties
    on the card).  A stable descending sort, then the first k."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


@register_op("top_k", stop_gradient=True)
def _top_k(ctx, op):
    """tensor_ops.py:309 (:func:`top_k_stable`): a beam decode's dead
    beams tie at -1e9, and which of them comes first picks its ids."""
    vals, idxs = top_k_stable(ctx.i("X"), ctx.attr("k", 1))
    ctx.set("Out", vals)
    ctx.set("Indices", idxs)


@register_op("arg_max", stop_gradient=True)
def _arg_max(ctx, op):
    """tensor_ops.py:318: int64 index of the largest entry along
    ``axis``, the first one among ties (as ``jnp.argmax``; torch
    documents the same)."""
    ctx.set("Out", torch.argmax(ctx.i("X"), dim=ctx.attr("axis", -1)))


@register_op("arg_min", stop_gradient=True)
def _arg_min(ctx, op):
    """tensor_ops.py:324: as arg_max, the smallest entry."""
    ctx.set("Out", torch.argmin(ctx.i("X"), dim=ctx.attr("axis", -1)))


@register_op("argsort", stop_gradient=True)
def _argsort(ctx, op):
    """tensor_ops.py:330: X sorted ascending along ``axis`` (Out) and the
    int64 order (Indices); tied entries keep their order, as
    ``jnp.argsort``'s stable sort keeps it."""
    out, idx = torch.sort(ctx.i("X"), dim=ctx.attr("axis", -1),
                          stable=True)
    ctx.set("Out", out)
    ctx.set("Indices", idx)


@register_op("pad")
def _pad(ctx, op):
    """tensor_ops.py:344: ``paddings`` holds (before, after) for each dim
    in order; ``F.pad`` takes them last dim first."""
    x = ctx.i("X")
    p = ctx.attr("paddings")
    pairs = [int(v) for d in reversed(range(x.dim()))
             for v in (p[2 * d], p[2 * d + 1])]
    ctx.set("Out", torch.nn.functional.pad(
        x, pairs, value=float(ctx.attr("pad_value", 0.0))))


@register_op("reverse")
def _reverse(ctx, op):
    """tensor_ops.py:353: X flipped along each of ``axis``."""
    x = ctx.i("X")
    ctx.set("Out", torch.flip(x, tuple(a % x.dim()
                                      for a in ctx.attr("axis"))))


@register_op("has_nan", stop_gradient=True)
def _has_nan(ctx, op):
    """tensor_ops.py:369: one ``(1,)`` bool on X's device, true when any
    entry of any X is NaN; nothing is read back."""
    xs = [ctx.env[n] for n in op.input("X")]
    ctx.set("Out", torch.stack([torch.isnan(x).any() for x in xs])
            .any().reshape((1,)))


@register_op("has_inf", stop_gradient=True)
def _has_inf(ctx, op):
    """tensor_ops.py:379: as has_nan, for an infinite entry."""
    xs = [ctx.env[n] for n in op.input("X")]
    ctx.set("Out", torch.stack([torch.isinf(x).any() for x in xs])
            .any().reshape((1,)))


@register_op("fill_any_like")
def _fill_any_like(ctx, op):
    """misc_ops5.py:26 (the op behind ``layers.ones_like``): X's shape
    and dtype filled with ``value``."""
    ctx.set("Out", torch.full_like(ctx.i("X"), ctx.attr("value", 0.0)))


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
