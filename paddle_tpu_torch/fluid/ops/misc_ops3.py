"""The op zoo's third batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops3.py``), so far its sequence ops and ``chunk_eval``:
``sequence_erase``, ``sequence_reshape``, ``sequence_scatter`` and
``chunk_eval``; the rest of the JAX file is ROADMAP item 13c.3.

``chunk_eval`` extracts its chunks in Python on the host, where the JAX
rule runs them in an ``io_callback``: its three inputs come back in one
copy, one host sync a run (``profiler.host_sync_count("chunk_eval")``
on the card).
"""

import numpy as np
import torch

from .. import profiler
from ..registry import register_op


@register_op("sequence_erase", nondiff_inputs=("X", "Length"),
             stop_gradient=True)
def _sequence_erase(ctx, op):
    """misc_ops3.py:22: drop the ids listed in ``tokens`` from each row's
    valid steps, the survivors shifted left in order, zeros after;
    OutLength the survivors' count.  Dropped entries go to trash column
    T of a ``T + 1`` buffer, sliced off."""
    x = ctx.i("X")
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    ln = ctx.i("Length").reshape(-1).long()
    tokens = torch.tensor(list(ctx.attr("tokens", [])), dtype=x.dtype,
                          device=x.device)
    B, T = x.shape
    valid = torch.arange(T, device=x.device)[None, :] < ln[:, None]
    keep = valid & ~torch.isin(x, tokens)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                      torch.full((), T, device=x.device))
    out = x.new_zeros((B, T + 1)).scatter(1, pos, x)
    ctx.set("Out", out[:, :T])
    ctx.set("OutLength", keep.sum(dim=1).to(torch.int64))


@register_op("sequence_reshape", nondiff_inputs=("Length",))
def _sequence_reshape(ctx, op):
    """misc_ops3.py:46: ``[B, T, D]`` → ``[B, T·D / new_dim, new_dim]``,
    each length scaled by ``D / new_dim`` (OutLength, int64)."""
    x = ctx.i("X")
    ln = ctx.i("Length").reshape(-1).long()
    new_dim = int(ctx.attr("new_dim"))
    B, T, D = x.shape
    assert (T * D) % new_dim == 0, "sequence_reshape: T*D % new_dim != 0"
    ctx.set("Out", x.reshape(B, T * D // new_dim, new_dim))
    ctx.set("OutLength", (ln * D // new_dim).to(torch.int64))


@register_op("sequence_scatter", nondiff_inputs=("Ids", "Length"))
def _sequence_scatter(ctx, op):
    """misc_ops3.py:59: X ``[B, D]`` with each row's valid Updates
    ``[B, L]`` added at its Ids ``[B, L]``; a negative id counts from
    the end, as a JAX index does.  Padding steps add 0."""
    x = ctx.i("X")
    ids = ctx.i("Ids").long()
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    upd = ctx.i("Updates")
    ln = ctx.i("Length").reshape(-1).long()
    valid = torch.arange(ids.shape[1], device=x.device)[None, :] < \
        ln[:, None]
    upd = torch.where(valid, upd, torch.zeros((), dtype=upd.dtype,
                                              device=upd.device))
    ids = torch.where(ids < 0, ids + x.shape[1], ids)
    ctx.set("Out", x.scatter_add(1, torch.where(valid, ids, 0), upd))


def _segments(seq, scheme, num_types):
    """The (start, end, type) chunks of one tag sequence under ``scheme``
    (misc_ops3.py:314-347, verbatim)."""
    tag_types = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    segs = []
    cur = None                      # (start, type)
    for i, lab in enumerate(seq):
        lab = int(lab)
        if lab >= num_types * tag_types:      # the "other" class
            if cur:
                segs.append((cur[0], i - 1, cur[1]))
            cur = None
            continue
        ctype = lab // tag_types
        tag = lab % tag_types
        if scheme == "plain":
            starts = cur is None or cur[1] != ctype
        elif scheme == "IOB":
            starts = tag == 0 or cur is None or cur[1] != ctype
        elif scheme == "IOE":
            starts = cur is None or cur[1] != ctype
        else:  # IOBES: B=0, I=1, E=2, S=3
            starts = tag in (0, 3) or cur is None or cur[1] != ctype
        if starts:
            if cur:
                segs.append((cur[0], i - 1, cur[1]))
            cur = (i, ctype)
        if scheme == "IOE" and tag == 1:      # E closes
            segs.append((cur[0], i, cur[1]))
            cur = None
        if scheme == "IOBES" and tag in (2, 3):
            segs.append((cur[0], i, cur[1]))
            cur = None
    if cur:
        segs.append((cur[0], len(seq) - 1, cur[1]))
    return set(segs)


@register_op("chunk_eval", nondiff_inputs=("Inference", "Label", "Length"),
             stop_gradient=True)
def _chunk_eval(ctx, op):
    """misc_ops3.py:296: chunk-level precision, recall and F1 of
    Inference against Label (padded tag rows ``[B, T]`` or ``[B, T,
    1]``) over each row's Length, under the IOB, IOE, IOBES or plain
    scheme, with the three counts.  The inputs come to the host in one
    copy (one sync on the card); the outputs are exact."""
    inference = ctx.i("Inference")
    label = ctx.i("Label")
    ln = ctx.i("Length").reshape(-1)
    scheme = ctx.attr("chunk_scheme", "IOB")
    num_types = int(ctx.attr("num_chunk_types"))
    B = ln.shape[0]
    packed = torch.cat([inference.reshape(-1).long(),
                        label.reshape(-1).long(), ln.long()])
    if packed.device.type != "cpu":
        profiler.record_host_sync("chunk_eval")
    host = packed.cpu().numpy()
    n_tags = inference.numel()
    inf = host[:n_tags].reshape(B, -1)
    lab = host[n_tags:n_tags + label.numel()].reshape(B, -1)
    n_inf = n_lab = n_cor = 0
    for b, n in enumerate(host[n_tags + label.numel():]):
        si = _segments(inf[b, :n], scheme, num_types)
        sl = _segments(lab[b, :n], scheme, num_types)
        n_inf += len(si)
        n_lab += len(sl)
        n_cor += len(si & sl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if n_cor else 0.0
    dev = inference.device
    for slot, v in (("Precision", np.float32(p)), ("Recall", np.float32(r)),
                    ("F1-Score", np.float32(f1))):
        ctx.set(slot, torch.tensor(v, dtype=torch.float32, device=dev))
    for slot, v in (("NumInferChunks", n_inf), ("NumLabelChunks", n_lab),
                    ("NumCorrectChunks", n_cor)):
        ctx.set(slot, torch.tensor(v, dtype=torch.int64, device=dev))
