"""Sequence ops on padded batches plus explicit lengths (counterpart
``paddle_tpu/fluid/ops/sequence_ops.py``): ``sequence_mask``,
``sequence_pool``, ``sequence_softmax``, ``sequence_reverse``,
``sequence_expand_as``, ``sequence_expand``, ``sequence_pad``,
``sequence_unpad``, ``sequence_concat``, ``sequence_conv``,
``sequence_slice`` and ``sequence_enumerate``: every op of the JAX file.

Every op takes a padded ``[batch, time, ...]`` tensor and a ``Length``
int vector ``[batch]`` in place of the reference's LoD, as the JAX
package does; ``Length`` never takes a gradient.  Where a JAX rule
scatters its invalid entries to a slot past the end (``mode="drop"``),
the rule here writes them to one trash row or column of a buffer one
longer and slices it off: ``index_put`` raises on an index out of range
instead of dropping it.
"""
import torch

from ..data_types import torch_dtype
from ..lowering import amp_operands
from ..registry import register_op
from .math_ops import _matmul_p
from .rnn_ops import _seq_reverse


def lengths_of(ctx, slot="Length"):
    ln = ctx.i(slot)
    if ln.dim() > 1:
        ln = ln.reshape(ln.shape[0])
    return ln.long()


def time_mask(lengths, T):
    """[B, T] bool: ``t < length[b]``."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def _expand_mask(mask, x):
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return mask


@register_op("sequence_mask", nondiff_inputs=("X",), stop_gradient=True)
def _sequence_mask(ctx, op):
    """sequence_ops.py:43: lengths ``[B]`` → ``[B, maxlen]`` in
    ``out_dtype``; ``maxlen`` must be static."""
    lengths = ctx.i("X")
    if lengths.dim() > 1:
        lengths = lengths.reshape(lengths.shape[0])
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen")
    mask = time_mask(lengths.long(), int(maxlen))
    ctx.set("Y", mask.to(torch_dtype(ctx.attr("out_dtype", "int64"))))


@register_op("sequence_pool", nondiff_inputs=("Length",))
def _sequence_pool(ctx, op):
    """sequence_ops.py:56: SUM, AVERAGE (over ``max(length, 1)``), SQRT,
    MAX (padding at the dtype's lowest value; ``amax`` splits the
    gradient evenly among tied maxima, as ``jnp.max`` does, where
    ``torch.max(dim)`` would send it all to one), FIRST (step 0) and
    LAST (step ``length − 1``)."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    pooltype = ctx.attr("pooltype", "AVERAGE").upper()
    mask = _expand_mask(time_mask(lengths, x.shape[1]), x)
    ln = lengths.clamp_min(1).to(x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 2))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if pooltype == "SUM":
        out = torch.where(mask, x, zero).sum(1)
    elif pooltype == "AVERAGE":
        out = torch.where(mask, x, zero).sum(1) / ln
    elif pooltype == "SQRT":
        out = torch.where(mask, x, zero).sum(1) / torch.sqrt(ln)
    elif pooltype == "MAX":
        low = torch.finfo(x.dtype).min if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = torch.amax(torch.where(mask, x, torch.tensor(
            low, dtype=x.dtype, device=x.device)), dim=1)
    elif pooltype == "FIRST":
        out = x[:, 0]
    elif pooltype == "LAST":
        idx = (lengths - 1).clamp_min(0).reshape(
            (-1, 1) + (1,) * (x.dim() - 2))
        out = torch.gather(x, 1, idx.expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))).squeeze(1)
    else:
        raise NotImplementedError("sequence_pool type %r" % pooltype)
    ctx.set("Out", out)


@register_op("sequence_conv", nondiff_inputs=("Length",))
def _sequence_conv(ctx, op):
    """sequence_ops.py:229: a context window over time, ``contextLength``
    steps from ``contextStart`` (default ``-((L − 1) // 2)``), each
    source step zero outside the sequence; the windows side by side
    ``[B, T, L·D]`` times Filter ``[L·D, num_filters]`` in one product
    (AMP as conv/matmul), and zero rows past each length."""
    x = ctx.i("X")                       # [B, T, D]
    w = ctx.i("Filter")
    lengths = lengths_of(ctx)
    ctx_len = ctx.attr("contextLength", 3)
    ctx_start = ctx.attr("contextStart", -((ctx_len - 1) // 2))
    B, T, D = x.shape
    mask = time_mask(lengths, T)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xz = torch.where(mask[..., None], x, zero)
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        idx = t + (ctx_start + k)
        src = idx.clamp(0, T - 1)
        valid = ((idx >= 0) & (idx < T))[None, :] & \
            (src[None, :] < lengths[:, None])
        cols.append(torch.where(valid[..., None], xz[:, src], zero))
    im2col = torch.cat(cols, dim=-1)                     # [B, T, L*D]
    a, b, acc = amp_operands(ctx.state, im2col, w)
    out = _matmul_p(a, b, acc)
    if acc is not None:
        out = out.to(acc)
    ctx.set("Out", torch.where(mask[..., None], out,
                               torch.zeros((), dtype=out.dtype,
                                           device=out.device)))


@register_op("sequence_softmax", nondiff_inputs=("Length",))
def _sequence_softmax(ctx, op):
    """sequence_ops.py:90: softmax over each row's valid steps (the
    rest at -1e9 before it, 0 after); X ``[B, T]`` or ``[B, T, 1]``."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x[..., 0] if squeeze else x
    mask = time_mask(lengths, v.shape[1])
    neg = torch.full((), -1e9, dtype=v.dtype, device=v.device)
    out = torch.softmax(torch.where(mask, v, neg), dim=1)
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))
    ctx.set("Out", out[..., None] if squeeze else out)


@register_op("sequence_reverse", nondiff_inputs=("Length",))
def _sequence_reverse(ctx, op):
    """sequence_ops.py:104: each row's valid prefix reversed, the
    padding left where it is."""
    ctx.set("Y", _seq_reverse(ctx.i("X"), lengths_of(ctx)))


@register_op("sequence_expand_as", nondiff_inputs=("Length",))
def _sequence_expand_as(ctx, op):
    """sequence_ops.py:116: X ``[B, ...]`` (one row a sequence) →
    ``[B, T, ...]``, the row repeated over its valid steps; T is the
    ``maxlen`` attr or Y's time axis."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    T = ctx.attr("maxlen", -1)
    if T is None or T < 0:
        y = ctx.i_opt("Y")
        if y is None:
            raise ValueError("sequence_expand_as needs maxlen or Y")
        T = y.shape[1]
    out = x[:, None].expand((x.shape[0], int(T)) + tuple(x.shape[1:]))
    mask = _expand_mask(time_mask(lengths, int(T)), out)
    ctx.set("Out", torch.where(mask, out, _zero(out)))


@register_op("sequence_expand", nondiff_inputs=("Length", "RefLength"))
def _sequence_expand(ctx, op):
    """sequence_ops.py:132: ``out[b, t] = x[b, t % length[b]]`` for
    ``t < ref_length[b]``, zeros after; the time axis is
    ``max_out_len`` (X's own when negative)."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    ref_lengths = lengths_of(ctx, "RefLength")
    Tout = ctx.attr("max_out_len", -1)
    if Tout is None or Tout < 0:
        Tout = x.shape[1]
    t = torch.arange(int(Tout), device=x.device)[None, :]
    src = torch.remainder(t, lengths[:, None].clamp_min(1))
    out = _take_time(x, src)
    mask = _expand_mask(t < ref_lengths[:, None], out)
    ctx.set("Out", torch.where(mask, out, _zero(out)))


@register_op("sequence_pad", nondiff_inputs=("Length",))
def _sequence_pad(ctx, op):
    """sequence_ops.py:154: flat-compact X ``[N, ...]`` (the sequences
    packed front to back at the offsets ``cumsum(length)``) → padded
    ``[B, padded_length, ...]``, PadValue (or 0) past each length; the
    gather's indices are clamped into ``[0, N)``.  Also emits Length
    as int64."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    T = ctx.attr("padded_length", -1)
    if T is None or T < 0:
        raise ValueError("sequence_pad needs a static padded_length")
    T = int(T)
    B = lengths.shape[0]
    pad_value = ctx.i_opt("PadValue")
    pv = pad_value.reshape(()).to(x.dtype) if pad_value is not None \
        else _zero(x)
    src = (_offsets(lengths)[:, None] +
           torch.arange(T, device=x.device)[None, :]).clamp(0, x.shape[0] - 1)
    out = x[src.reshape(-1)].reshape((B, T) + tuple(x.shape[1:]))
    mask = _expand_mask(time_mask(lengths, T), out)
    ctx.set("Out", torch.where(mask, out, pv))
    ctx.set("Length", lengths.to(torch.int64))


@register_op("sequence_unpad", nondiff_inputs=("Length",))
def _sequence_unpad(ctx, op):
    """sequence_ops.py:180: padded ``[B, T, ...]`` → flat-compact
    ``[B·T, ...]``, the valid rows packed to the front at the offsets
    ``cumsum(length)``, zeros after.  Invalid rows go to trash row
    ``B·T`` (JAX: ``mode="drop"``), which is sliced off."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    dest = torch.where(t < lengths[:, None],
                       _offsets(lengths)[:, None] + t,
                       torch.full((), B * T, device=x.device))
    flat = x.reshape((B * T,) + tuple(x.shape[2:]))
    out = flat.new_zeros((B * T + 1,) + tuple(x.shape[2:]))
    out = out.index_put((dest.reshape(-1),), flat)
    ctx.set("Out", out[:B * T])


@register_op("sequence_concat", nondiff_inputs=("Length",))
def _sequence_concat(ctx, op):
    """sequence_ops.py:200: per row, ``x1[b, :len1[b]] ++ x2[b,
    :len2[b]] ++ ...``, zero-padded to ``sum(Ti)`` steps; OutLength the
    sum of the lengths (int64).  Each input's invalid steps go to trash
    column ``sum(Ti)`` (JAX: ``mode="drop"``), sliced off."""
    xs = [ctx.env[n] for n in op.input("X")]
    lens = [ln.reshape(ln.shape[0]).long() for ln in
            (ctx.env[n] for n in op.input("Length"))]
    B = xs[0].shape[0]
    Tout = sum(x.shape[1] for x in xs)
    feat = tuple(xs[0].shape[2:])
    dev = xs[0].device
    out = xs[0].new_zeros((B, Tout + 1) + feat)
    base = torch.zeros(B, dtype=torch.long, device=dev)
    for x, ln in zip(xs, lens):
        T = x.shape[1]
        t = torch.arange(T, device=dev)[None, :]
        dest = torch.where(t < ln[:, None], base[:, None] + t,
                           torch.full((), Tout, device=dev))
        brow = torch.arange(B, device=dev)[:, None].expand(B, T)
        out = out.index_put((brow.reshape(-1), dest.reshape(-1)),
                            x.reshape((B * T,) + feat).to(out.dtype))
        base = base + ln
    ctx.set("Out", out[:, :Tout])
    ctx.set("OutLength", sum(lens).to(torch.int64))


@register_op("sequence_slice", nondiff_inputs=("Offset", "Length"))
def _sequence_slice(ctx, op):
    """sequence_ops.py:262: per row the steps ``[offset[b],
    offset[b] + length[b])``, packed to the front (sources clamped into
    the time axis) and zero-padded."""
    x = ctx.i("X")
    off = lengths_of(ctx, "Offset")
    ln = lengths_of(ctx, "Length")
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    out = _take_time(x, (off[:, None] + t).clamp(0, T - 1))
    mask = _expand_mask(t < ln[:, None], out)
    ctx.set("Out", torch.where(mask, out, _zero(out)))


@register_op("sequence_enumerate", nondiff_inputs=("X", "Length"),
             stop_gradient=True)
def _sequence_enumerate(ctx, op):
    """sequence_ops.py:278: windows of ids, ``out[b, t, k] = x[b, t +
    k]``, ``pad_value`` past the row's length and on its padding steps;
    ``[B, T, win_size]``."""
    x = ctx.i("X")
    lengths = lengths_of(ctx)
    win = int(ctx.attr("win_size", 2))
    pad = torch.tensor(int(ctx.attr("pad_value", 0)), dtype=x.dtype,
                       device=x.device)
    T = x.shape[1]
    outs = []
    for k in range(win):
        idx = torch.arange(T, device=x.device) + k
        g = x[:, idx.clamp(0, T - 1)]
        outs.append(torch.where(idx[None, :] < lengths[:, None], g, pad))
    out = torch.stack(outs, dim=-1)
    ctx.set("Out", torch.where(time_mask(lengths, T)[..., None], out, pad))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _offsets(lengths):
    """Exclusive cumulative sum: where each row's sequence starts in the
    flat-compact layout."""
    return torch.cumsum(lengths, 0) - lengths


def _take_time(x, src):
    """``x[b, src[b, t], ...]`` for x ``[B, T, ...]`` and src ``[B, T']``
    (JAX ``take_along_axis`` over axis 1)."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(
        tuple(src.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)

