"""Linear-chain CRF ops (counterpart ``paddle_tpu/fluid/ops/crf_ops.py``):
the negative log-likelihood and Viterbi decoding over padded
``[B, T, C]`` emissions plus ``Length``.

``Transition`` is the reference's ``[C+2, C]``: row 0 the start
weights, row 1 the stop weights, rows ``2..C+1`` tag-to-tag (from, to).
The alpha recursion runs in log space (``logsumexp``), as the JAX rule
does, in a Python loop over time where JAX has a ``lax.scan``; the
gradient differentiates the taped loop.
"""

import torch

from ..registry import register_op


def _prep(ctx):
    em = ctx.i("Emission")                    # [B, T, C]
    trans = ctx.i("Transition")               # [C+2, C]
    ln = ctx.i("Length")
    lengths = (ln.reshape(ln.shape[0]) if ln.dim() > 1 else ln).long()
    return em, lengths, trans[0], trans[1], trans[2:]


def _labels(label):
    return (label[..., 0] if label.dim() == 3 else label).long()


@register_op("linear_chain_crf", nondiff_inputs=("Label", "Length"))
def _linear_chain_crf(ctx, op):
    """crf_ops.py:44: ``log Z − score(label path)`` per sequence,
    ``LogLikelihood [B, 1]``; a step past a row's length leaves its
    alpha unchanged.  Alpha is the last step's ``[B, C]``."""
    em, lengths, start, stop, pair = _prep(ctx)
    label = _labels(ctx.i("Label"))           # [B, T]
    B, T, C = em.shape
    tmask = torch.arange(T, device=em.device)[None, :] < lengths[:, None]
    alpha = start[None, :] + em[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + pair[None, :, :],
                              dim=1) + em[:, t]
        alpha = torch.where(tmask[:, t, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)

    zero = torch.zeros((), dtype=em.dtype, device=em.device)
    picked = torch.gather(em, 2, label[..., None])[..., 0]
    score = start[label[:, 0]] + torch.where(tmask, picked, zero).sum(1)
    if T > 1:
        steps = pair[label[:, :-1], label[:, 1:]]            # [B, T-1]
        score = score + torch.where(tmask[:, 1:], steps, zero).sum(1)
    last = torch.gather(label, 1, (lengths - 1).clamp_min(0)[:, None])
    score = score + stop[last[:, 0]]
    ctx.set("LogLikelihood", (log_z - score)[:, None])
    ctx.set("Alpha", alpha)


@register_op("crf_decoding", nondiff_inputs=("Emission", "Transition",
                                             "Label", "Length"),
             stop_gradient=True)
def _crf_decoding(ctx, op):
    """crf_ops.py:88: the Viterbi path ``[B, T, 1]`` int64, 0 past each
    length; with ``Label`` the 0/1 indicator of the positions it gets
    right instead.  ``argmax`` takes the first maximum in both packages;
    a step past a row's length points back at itself."""
    em, lengths, start, stop, pair = _prep(ctx)
    B, T, C = em.shape
    tmask = torch.arange(T, device=em.device)[None, :] < lengths[:, None]
    v = start[None, :] + em[:, 0]
    ident = torch.arange(C, device=em.device)[None, :].expand(B, C)
    ptrs = []
    for t in range(1, T):
        cand = v[:, :, None] + pair[None, :, :]              # [B, from, to]
        best, ptr = cand.amax(dim=1), cand.argmax(dim=1)
        valid = tmask[:, t, None]
        v = torch.where(valid, best + em[:, t], v)
        ptrs.append(torch.where(valid, ptr, ident))
    tag = (v + stop[None, :]).argmax(dim=1)
    path = [tag]
    for ptr in reversed(ptrs):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    path = torch.where(tmask, path, torch.zeros_like(path))
    label = ctx.i_opt("Label")
    if label is not None:
        path = ((path == _labels(label)) & tmask).long()
    ctx.set("ViterbiPath", path[..., None])
