"""Detection and image-interpolation ops (counterpart ``paddle_tpu/fluid/
ops/detection_ops.py``): ``nearest_interp``, ``bilinear_interp``,
``prior_box``, ``box_coder``, ``yolo_box``, ``roi_align`` and
``multiclass_nms``.

Every rule keeps the JAX rule's static shapes: NMS emits a fixed
``[N, keep_top_k, 6]`` slab padded with label -1 rows, and a ROI's image
arrives as an explicit ``RoisBatchId`` vector.  Where the JAX rule ranks
with ``lax.top_k`` or ``jnp.argsort`` (lower index first on ties), the
port sorts with ``torch.sort(stable=True)``: the padding rows of
``multiclass_nms`` take their boxes from the -1-score ties, so only that
order reproduces them.

Greedy suppression (:func:`greedy_keep`) is the JAX ``fori_loop`` of K
steps, batched: one loop over the K candidates on the device for every
(image, class) at once, over an overlap matrix computed before it.
"""

import numpy as np
import torch

from ..registry import register_op


_CONSTS = {}


def const(array, device):
    """``array`` on ``device``, copied there once per value and device, so
    that a step that reads a constant table copies nothing from the host
    (each copy from pageable memory would wait for the card).  Callers
    must not write into it."""
    a = np.ascontiguousarray(array)
    key = (a.tobytes(), a.shape, a.dtype.str, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(a.copy()).to(device)
    return t


def round_half_up(x):
    """C ``round()`` for nonnegative coordinates: half rounds up (JAX
    registry.py:83)."""
    return torch.floor(x + 0.5)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))`` (its gradient splits
    at a tie, as JAX's does); ``lo``/``hi`` numbers or tensors."""
    if not torch.is_tensor(lo):
        lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    if not torch.is_tensor(hi):
        hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(hi, torch.maximum(lo, x))


def top_k(x, k):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_rows(x, idx):
    """``x [N, M, D]`` rows ``idx [N, K]``: ``[N, K, D]``."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape,
                                                     x.shape[-1]))


def greedy_keep(over, valid):
    """Greedy suppression of score-sorted candidates: ``over[..., i, j]``
    says that candidate j would suppress i; candidate i stays when it is
    valid and no kept earlier candidate suppresses it.  The JAX rules'
    ``fori_loop(0, K, body, valid)``, one step a candidate over every
    leading index at once, with no host read."""
    keep = valid.clone()
    for i in range(1, keep.shape[-1]):
        sup = (keep[..., :i] & over[..., i, :i]).any(-1)
        keep[..., i] &= ~sup
    return keep


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------

@register_op("nearest_interp")
def _nearest_interp(ctx, op):
    """detection_ops.py:27: NCHW nearest resize; ``align_corners`` rounds
    half up (interpolate_op.h:35), else floors."""
    x = ctx.i("X")
    out_h, out_w = ctx.attr("out_h"), ctx.attr("out_w")
    align = ctx.attr("align_corners", True)
    N, C, H, W = x.shape
    hi = torch.arange(out_h, dtype=torch.float32, device=x.device)
    wi = torch.arange(out_w, dtype=torch.float32, device=x.device)
    if align:
        src_h = round_half_up(hi * (H - 1) / max(out_h - 1, 1))
        src_w = round_half_up(wi * (W - 1) / max(out_w - 1, 1))
    else:
        src_h = torch.floor(hi * H / out_h)
        src_w = torch.floor(wi * W / out_w)
    src_h = src_h.long().clamp(0, H - 1)
    src_w = src_w.long().clamp(0, W - 1)
    ctx.set("Out", x[:, :, src_h][:, :, :, src_w])


@register_op("bilinear_interp")
def _bilinear_interp(ctx, op):
    """detection_ops.py:51: NCHW bilinear resize, the four corner reads
    weighted as the JAX rule weights them."""
    x = ctx.i("X")
    out_h, out_w = ctx.attr("out_h"), ctx.attr("out_w")
    align = ctx.attr("align_corners", True)
    align_mode = ctx.attr("align_mode", 1)
    N, C, H, W = x.shape

    def src(dst, in_sz, out_sz):
        d = torch.arange(dst, dtype=torch.float32, device=x.device)
        if align:
            return d * (in_sz - 1) / max(out_sz - 1, 1)
        scale = in_sz / out_sz
        if align_mode == 0:
            return torch.clamp_min((d + 0.5) * scale - 0.5, 0.0)
        return d * scale

    sh = src(out_h, H, out_h)
    sw = src(out_w, W, out_w)
    h0 = torch.floor(sh).long().clamp(0, H - 1)
    w0 = torch.floor(sw).long().clamp(0, W - 1)
    h1 = (h0 + 1).clamp(0, H - 1)
    w1 = (w0 + 1).clamp(0, W - 1)
    lh = (sh - h0)[None, None, :, None]
    lw = (sw - w0)[None, None, None, :]
    tl = x[:, :, h0][:, :, :, w0]
    tr = x[:, :, h0][:, :, :, w1]
    bl = x[:, :, h1][:, :, :, w0]
    br = x[:, :, h1][:, :, :, w1]
    out = (tl * (1 - lh) * (1 - lw) + tr * (1 - lh) * lw +
           bl * lh * (1 - lw) + br * lh * lw)
    ctx.set("Out", out.to(x.dtype))


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------

def prior_ratios(aspect_ratios, flip):
    """1.0, then each new ratio (and its inverse under ``flip``)."""
    ars = [1.0]
    for ar in aspect_ratios or []:
        ar = float(ar)
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    return ars


def prior_scale(n, size):
    """``v / size`` as XLA computes it in the JAX rules, which keeps the
    priors bit-equal to JAX's (matching ties on them): an axis of one
    position is a constant XLA folds with a true division, a longer one
    (an iota) a division XLA rewrites into a product with the float32
    reciprocal."""
    if n == 1:
        return lambda v: v / size
    r = np.float32(1.0 / size)
    return lambda v: v * r


@register_op("prior_box", stop_gradient=True)
def _prior_box(ctx, op):
    """detection_ops.py:90: SSD priors ``[H, W, P, 4]`` (normalized
    corners) and their variances; per location each min size's ratios
    (1.0 first), then its max-size square."""
    feat, img = ctx.i("Input"), ctx.i("Image")
    dev = feat.device
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in ctx.attr("min_sizes", [])]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    ars = prior_ratios(ctx.attr("aspect_ratios", []), ctx.attr("flip", False))
    step_w = ctx.attr("step_w", 0.0) or IW / W
    step_h = ctx.attr("step_h", 0.0) or IH / H
    offset = ctx.attr("offset", 0.5)
    variances = [float(v) for v in
                 ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    whs = []
    for k, ms in enumerate(min_sizes):
        for ar in ars:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            bs = np.sqrt(ms * max_sizes[k])
            whs.append((bs, bs))
    P = len(whs)
    wh = const(np.asarray(whs, np.float32), dev)
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cxg = cx[None, :, None].expand(H, W, P)
    cyg = cy[:, None, None].expand(H, W, P)
    bw = wh[None, None, :, 0] / 2.0
    bh = wh[None, None, :, 1] / 2.0
    sx, sy = prior_scale(W, IW), prior_scale(H, IH)
    boxes = torch.stack([sx(cxg - bw), sy(cyg - bh), sx(cxg + bw),
                         sy(cyg + bh)], dim=-1)
    if ctx.attr("clip", False):
        boxes = boxes.clamp(0.0, 1.0)
    var = const(np.asarray(variances, np.float32), dev) \
        .expand(H, W, P, 4).contiguous()
    ctx.set("Boxes", boxes)
    ctx.set("Variances", var)


# ---------------------------------------------------------------------------
# box_coder
# ---------------------------------------------------------------------------

def _encode_center_size(t, pw, ph, pcx, pcy, norm, floor):
    """Center-size deltas of targets ``t [R, 4]`` against every prior:
    ``[R, M, 4]``; ``floor`` clamps the log's ratio at 1e-10."""
    tw = t[:, 2] - t[:, 0] + norm
    th = t[:, 3] - t[:, 1] + norm
    tcx = (t[:, 2] + t[:, 0]) / 2
    tcy = (t[:, 3] + t[:, 1]) / 2
    rw = torch.abs(tw[:, None] / pw[None, :])
    rh = torch.abs(th[:, None] / ph[None, :])
    if floor:
        rw = torch.clamp_min(rw, 1e-10)
        rh = torch.clamp_min(rh, 1e-10)
    return torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                        (tcy[:, None] - pcy[None, :]) / ph[None, :],
                        torch.log(rw), torch.log(rh)], dim=-1)


@register_op("box_coder", nondiff_inputs=("PriorBox", "PriorBoxVar"))
def _box_coder(ctx, op):
    """detection_ops.py:143 (box_coder_op.h): ``encode_center_size``
    (TargetBox ``[R, 4]`` → ``[R, M, 4]``, or the batched slab ``[B, R,
    4]`` → ``[B, R, M, 4]`` with the log's ratio floored at 1e-10) or
    ``decode_center_size`` (TargetBox ``[R, M, 4]``, ``axis`` the dim the
    priors run along); variances from PriorBoxVar or the ``variance``
    attr."""
    prior = ctx.i("PriorBox")
    pvar = ctx.i_opt("PriorBoxVar")
    target = ctx.i("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    norm = 0.0 if ctx.attr("box_normalized", True) else 1.0
    variance = ctx.attr("variance", []) or []
    pw = prior[:, 2] - prior[:, 0] + norm
    ph = prior[:, 3] - prior[:, 1] + norm
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2

    if code_type == "encode_center_size":
        batched = target.dim() == 3
        t = target.reshape(-1, 4)
        out = _encode_center_size(t, pw, ph, pcx, pcy, norm, batched)
        if pvar is not None:
            out = out / pvar[None, :, :]
        elif variance:
            out = out / const(np.asarray(variance, np.float32),
                              out.device).to(out.dtype)
        if batched:
            out = out.reshape(target.shape[0], target.shape[1], -1, 4)
        ctx.set("OutputBox", out)
        return
    ax = int(ctx.attr("axis", 0))

    def pb(a):
        return a[None, :] if ax == 0 else a[:, None]

    if pvar is not None:
        v = pvar[None, :, :] if ax == 0 else pvar[:, None, :]
        vs = [v[..., k] for k in range(4)]
    elif variance:
        v = const(np.asarray(variance, np.float32),
                  target.device).to(target.dtype)
        vs = [v[k] for k in range(4)]
    else:
        vs = [1.0] * 4
    t = target
    bcx = t[..., 0] * vs[0] * pb(pw) + pb(pcx)
    bcy = t[..., 1] * vs[1] * pb(ph) + pb(pcy)
    bw = torch.exp(t[..., 2] * vs[2]) * pb(pw)
    bh = torch.exp(t[..., 3] * vs[3]) * pb(ph)
    ctx.set("OutputBox", torch.stack(
        [bcx - bw / 2, bcy - bh / 2, bcx + bw / 2 - norm,
         bcy + bh / 2 - norm], dim=-1))


# ---------------------------------------------------------------------------
# yolo_box
# ---------------------------------------------------------------------------

@register_op("yolo_box", stop_gradient=True)
def _yolo_box(ctx, op):
    """detection_ops.py:231: decode a YOLOv3 head ``[N, A·(5+CLS), H, W]``
    into Boxes ``[N, A·H·W, 4]`` in image pixels and Scores ``[N, A·H·W,
    CLS]``; a box whose confidence is at most ``conf_thresh`` is zeroed."""
    x = ctx.i("X")
    img_size = ctx.i("ImgSize")
    anchors = [int(a) for a in ctx.attr("anchors")]
    class_num = int(ctx.attr("class_num"))
    conf_thresh = ctx.attr("conf_thresh", 0.01)
    downsample = ctx.attr("downsample_ratio", 32)
    dev = x.device
    A = len(anchors) // 2
    N, _, H, W = x.shape
    x = x.reshape(N, A, 5 + class_num, H, W)
    grid_x = torch.arange(W, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
    grid_y = torch.arange(H, dtype=torch.float32, device=dev)[None, None,
                                                              :, None]
    aw = const(np.asarray(anchors[0::2], np.float32), dev)[None, :, None,
                                                           None]
    ah = const(np.asarray(anchors[1::2], np.float32), dev)[None, :, None,
                                                           None]
    in_w, in_h = float(downsample * W), float(downsample * H)
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / W
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / H
    bw = torch.exp(x[:, :, 2]) * aw / in_w
    bh = torch.exp(x[:, :, 3]) * ah / in_h
    conf = torch.sigmoid(x[:, :, 4])
    keep = (conf > conf_thresh).to(torch.float32)
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    boxes = torch.stack([(bx - bw / 2) * imw, (by - bh / 2) * imh,
                         (bx + bw / 2) * imw, (by + bh / 2) * imh], dim=-1)
    boxes = boxes * keep[..., None]
    scores = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None] * \
        keep[:, :, None]
    boxes = torch.movedim(boxes, -1, 2).reshape(N, 4, -1).transpose(1, 2)
    scores = scores.reshape(N, class_num, -1).transpose(1, 2)
    ctx.set("Boxes", boxes)
    ctx.set("Scores", scores)


# ---------------------------------------------------------------------------
# roi_align
# ---------------------------------------------------------------------------

def gather_nhwc(x, b, y, xi):
    """``x [N, C, H, W]`` read at integer index tensors ``b, y, xi`` (one
    shape S): ``[*S, C]``."""
    return x.permute(0, 2, 3, 1)[b, y, xi]


@register_op("roi_align", nondiff_inputs=("ROIs", "RoisBatchId"))
def _roi_align(ctx, op):
    """detection_ops.py:272: average of s x s bilinear reads a bin, with
    s = ``sampling_ratio``, or 2 when it is at most 0 (the JAX rule's
    fixed sampling, not the reference's ceil(bin) per ROI)."""
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
    ratio = int(ctx.attr("sampling_ratio", -1))
    N, C, H, W = x.shape
    s = ratio if ratio > 0 else 2
    r = rois * scale
    x1, y1, x2, y2 = (r[:, k][:, None, None, None, None] for k in range(4))
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    bin_w, bin_h = rw / pw, rh / ph
    ar = lambda n: torch.arange(n, device=dev)         # noqa: E731
    iy = (ar(ph)[:, None, None, None] * bin_h + y1 +
          (ar(s)[None, None, :, None] + 0.5) * bin_h / s)
    ix = (ar(pw)[None, :, None, None] * bin_w + x1 +
          (ar(s)[None, None, None, :] + 0.5) * bin_w / s)
    iy = iy.expand(R, ph, pw, s, s).reshape(R, -1)
    ix = ix.expand(R, ph, pw, s, s).reshape(R, -1)
    y0 = torch.floor(iy).long().clamp(0, H - 1)
    x0 = torch.floor(ix).long().clamp(0, W - 1)
    y1i = (y0 + 1).clamp(0, H - 1)
    x1i = (x0 + 1).clamp(0, W - 1)
    ly = (iy - y0).clamp(0.0, 1.0)[..., None]
    lx = (ix - x0).clamp(0.0, 1.0)[..., None]
    b = bid[:, None].expand_as(y0)
    val = (gather_nhwc(x, b, y0, x0) * (1 - ly) * (1 - lx) +
           gather_nhwc(x, b, y0, x1i) * (1 - ly) * lx +
           gather_nhwc(x, b, y1i, x0) * ly * (1 - lx) +
           gather_nhwc(x, b, y1i, x1i) * ly * lx)         # [R, S, C]
    out = val.reshape(R, ph, pw, s * s, C).mean(dim=3).permute(0, 3, 1, 2)
    ctx.set("Out", out.to(x.dtype))


# ---------------------------------------------------------------------------
# multiclass_nms
# ---------------------------------------------------------------------------

def iou_matrix(a, b, normalized=True):
    """``_iou`` (detection_ops.py:324) of every box of ``a [..., K, 4]``
    against every box of ``b [..., L, 4]``: ``[..., K, L]``."""
    norm = 0.0 if normalized else 1.0
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    ix1 = torch.maximum(a_[..., 0], b_[..., 0])
    iy1 = torch.maximum(a_[..., 1], b_[..., 1])
    ix2 = torch.minimum(a_[..., 2], b_[..., 2])
    iy2 = torch.minimum(a_[..., 3], b_[..., 3])
    iw = torch.clamp_min(ix2 - ix1 + norm, 0.0)
    ih = torch.clamp_min(iy2 - iy1 + norm, 0.0)
    inter = iw * ih
    area_a = (a_[..., 2] - a_[..., 0] + norm) * (a_[..., 3] - a_[..., 1] +
                                                 norm)
    area_b = (b_[..., 2] - b_[..., 0] + norm) * (b_[..., 3] - b_[..., 1] +
                                                 norm)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-10)


@register_op("multiclass_nms", stop_gradient=True)
def _multiclass_nms(ctx, op):
    """detection_ops.py:339: per (image, class) the top ``nms_top_k``
    scores, greedy suppression at IoU ``> nms_threshold`` (``+1`` box
    sizes when not ``normalized``), then the ``keep_top_k`` best kept
    candidates of the image: Out ``[N, keep_top_k, 6]`` (label, score,
    x1, y1, x2, y2), label -1 on rows at or below ``score_threshold``.
    The background class holds zero scores and boxes that are never
    kept, as in the JAX rule."""
    boxes = ctx.i("BBoxes").to(torch.float32)       # [N, M, 4]
    scores = ctx.i("Scores").to(torch.float32)      # [N, CLS, M]
    score_thresh = ctx.attr("score_threshold", 0.0)
    nms_top_k = int(ctx.attr("nms_top_k", 64))
    keep_top_k = int(ctx.attr("keep_top_k", 16))
    nms_thresh = ctx.attr("nms_threshold", 0.3)
    normalized = ctx.attr("normalized", True)
    background = int(ctx.attr("background_label", 0))
    N, CLS, M = scores.shape
    K = min(nms_top_k, M)
    dev = boxes.device
    fg = [c for c in range(CLS) if c != background]
    top_sc, idx = top_k(scores[:, fg], K)                  # [N, F, K]
    top_bx = torch.gather(boxes[:, None].expand(N, len(fg), M, 4), 2,
                          idx[..., None].expand(N, len(fg), K, 4))
    over = iou_matrix(top_bx, top_bx, normalized) > nms_thresh
    keep = greedy_keep(over, top_sc > score_thresh)
    all_sc = torch.zeros(N, CLS, K, device=dev)
    all_bx = torch.zeros(N, CLS, K, 4, device=dev)
    all_keep = torch.zeros(N, CLS, K, dtype=torch.bool, device=dev)
    all_sc[:, fg] = top_sc * keep
    all_bx[:, fg] = top_bx
    all_keep[:, fg] = keep
    sc_rank = torch.where(all_keep, all_sc,
                          torch.full((), -1.0, device=dev)).reshape(N, -1)
    kk = min(keep_top_k, CLS * K)
    sel_sc, sel = top_k(sc_rank, kk)
    labels = (sel // K).to(torch.float32)
    sel_lab = torch.where(sel_sc > score_thresh, labels,
                          torch.full((), -1.0, device=dev))
    sel_bx = gather_rows(all_bx.reshape(N, -1, 4), sel)
    out = torch.cat([sel_lab[..., None], sel_sc[..., None], sel_bx], dim=2)
    if kk < keep_top_k:
        out = torch.cat([out, torch.full((N, keep_top_k - kk, 6), -1.0,
                                         device=dev)], dim=1)
    ctx.set("Out", out)
