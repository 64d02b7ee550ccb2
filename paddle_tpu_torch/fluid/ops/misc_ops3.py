"""The op zoo's third batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops3.py``), so far its sequence ops and ``chunk_eval``:
``sequence_erase``, ``sequence_reshape``, ``sequence_scatter`` and
``chunk_eval``, and its detection ops: ``density_prior_box``,
``polygon_box_transform`` and ``roi_pool``; the rest of the JAX file is
ROADMAP item 13c.3.

``chunk_eval`` extracts its chunks in Python on the host, where the JAX
rule runs them in an ``io_callback``: its three inputs come back in one
copy, one host sync a run (``profiler.host_sync_count("chunk_eval")``
on the card).
"""

import numpy as np
import torch

from .. import profiler
from ..registry import register_op
from .detection_ops import const, prior_scale, round_half_up


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


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@register_op("density_prior_box", stop_gradient=True)
def _density_prior_box(ctx, op):
    """misc_ops3.py:175: each fixed size with density d gives d x d
    shifted boxes a location and ratio, on the reference's integer pixel
    grid (``step_average = int((step_w + step_h) / 2)``); min corners
    floored at 0 and max corners capped at 1 always, ``clip`` clips both
    sides on top; ``flatten_to_2d`` gives ``[H·W·P, 4]``."""
    feat, img = ctx.i("Input"), ctx.i("Image")
    dev = feat.device
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    fixed_sizes = [float(s) for s in ctx.attr("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in ctx.attr("fixed_ratios", [1.0])]
    densities = [int(d) for d in ctx.attr("densities", [])]
    step_w = ctx.attr("step_w", 0.0) or IW / W
    step_h = ctx.attr("step_h", 0.0) or IH / H
    offset = ctx.attr("offset", 0.5)
    variances = [float(v) for v in
                 ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    step_average = int((step_w + step_h) * 0.5)
    whs, shifts = [], []
    for size, density in zip(fixed_sizes, densities):
        shift = step_average // density
        for ratio in fixed_ratios:
            bw, bh = size * np.sqrt(ratio), size / np.sqrt(ratio)
            base = -step_average / 2.0 + shift / 2.0
            for di in range(density):
                for dj in range(density):
                    whs.append((bw, bh))
                    shifts.append((base + dj * shift, base + di * shift))
    P = len(whs)
    f32 = dict(dtype=torch.float32, device=dev)
    wh = const(np.asarray(whs, np.float32), dev)
    sh = const(np.asarray(shifts, np.float32), dev)
    cx = (torch.arange(W, **f32) + offset) * step_w
    cy = (torch.arange(H, **f32) + offset) * step_h
    cxg = (cx[None, :, None] + sh[None, None, :, 0]).expand(H, W, P)
    cyg = (cy[:, None, None] + sh[None, None, :, 1]).expand(H, W, P)
    bw = wh[None, None, :, 0] / 2
    bh = wh[None, None, :, 1] / 2
    sx, sy = prior_scale(W, IW), prior_scale(H, IH)
    boxes = torch.stack([torch.clamp_min(sx(cxg - bw), 0.0),
                         torch.clamp_min(sy(cyg - bh), 0.0),
                         torch.clamp_max(sx(cxg + bw), 1.0),
                         torch.clamp_max(sy(cyg + bh), 1.0)], dim=-1)
    if ctx.attr("clip", False):
        boxes = boxes.clamp(0.0, 1.0)
    var = const(np.asarray(variances, np.float32), dev) \
        .expand(H, W, P, 4).contiguous()
    if ctx.attr("flatten_to_2d", False):
        boxes, var = boxes.reshape(-1, 4), var.reshape(-1, 4)
    ctx.set("Boxes", boxes)
    ctx.set("Variances", var)


@register_op("polygon_box_transform", nondiff_inputs=("Input",),
             stop_gradient=True)
def _polygon_box_transform(ctx, op):
    """misc_ops3.py:238: EAST geometry offsets ``[N, 2K, H, W]`` to
    absolute coordinates: ``4·w - x`` on even channels, ``4·h - x`` on
    odd ones."""
    x = ctx.i("Input")
    N, C, H, W = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    gw = 4.0 * torch.arange(W, **f32)[None, None, None, :]
    gh = 4.0 * torch.arange(H, **f32)[None, None, :, None]
    is_x = (torch.arange(C, device=x.device) % 2 == 0)[None, :, None, None]
    ctx.set("Output", torch.where(is_x, gw - x, gh - x))


@register_op("roi_pool", nondiff_inputs=("ROIs", "RoisBatchId"))
def _roi_pool(ctx, op):
    """misc_ops3.py:252: max over each quantized ROI bin (coordinates
    rounded half up after scaling, ``+1`` sizes), 0 for an empty bin;
    the ROI's image from RoisBatchId.  All ROIs and bins at once."""
    x = ctx.i("X")
    rois = ctx.i("ROIs").to(torch.float32)
    bid = ctx.i_opt("RoisBatchId")
    R = rois.shape[0]
    dev = x.device
    bid = torch.zeros(R, dtype=torch.long, device=dev) if bid is None \
        else bid.reshape(-1).long()
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    scale = ctx.attr("spatial_scale", 1.0)
    N, C, H, W = x.shape
    x1, y1, x2, y2 = (round_half_up(rois[:, k] * scale)[:, None]
                      for k in range(4))
    one = torch.ones((), device=dev)
    rw = torch.maximum(x2 - x1 + 1, one)
    rh = torch.maximum(y2 - y1 + 1, one)
    i = torch.arange(ph, device=dev)[None, :]
    j = torch.arange(pw, device=dev)[None, :]
    hs, he = torch.floor(y1 + i * rh / ph), torch.ceil(y1 + (i + 1) * rh / ph)
    ws, we = torch.floor(x1 + j * rw / pw), torch.ceil(x1 + (j + 1) * rw / pw)
    hi = torch.arange(H, dtype=torch.float32, device=dev)
    wi = torch.arange(W, dtype=torch.float32, device=dev)
    mh = (hi >= hs[..., None]) & (hi < he[..., None])      # [R, ph, H]
    mw = (wi >= ws[..., None]) & (wi < we[..., None])      # [R, pw, W]
    m = mh[:, None, :, None, :, None] & mw[:, None, None, :, None, :]
    img = x[bid][:, :, None, None]                         # [R, C, 1, 1, H, W]
    masked = torch.where(m, img, torch.full((), -float("inf"), device=dev,
                                            dtype=x.dtype))
    v = masked.amax(dim=(-2, -1))
    ctx.set("Out", torch.where(torch.isfinite(v), v,
                               torch.zeros((), dtype=x.dtype, device=dev)))
