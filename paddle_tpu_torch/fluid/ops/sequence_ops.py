"""Sequence ops on padded batches plus explicit lengths (counterpart
``paddle_tpu/fluid/ops/sequence_ops.py``): the book models' three,
``sequence_mask``, ``sequence_pool`` and ``sequence_conv``.

Every op takes a padded ``[batch, time, ...]`` tensor and a ``Length``
int vector ``[batch]`` in place of the reference's LoD, as the JAX
package does; ``Length`` never takes a gradient.  The rest of the JAX
file (softmax, reverse, expand, pad/unpad, concat, slice, enumerate) is
ROADMAP item 13c.
"""

import torch

from ..data_types import torch_dtype
from ..lowering import amp_operands
from ..registry import register_op
from .math_ops import _matmul_p


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
