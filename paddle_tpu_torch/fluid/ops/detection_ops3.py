"""The RPN / R-CNN and RetinaNet ops, perspective and deformable sampling,
and the two host-side detection ops (counterpart ``paddle_tpu/fluid/ops/
detection_ops3.py``): ``generate_proposals``, ``rpn_target_assign``,
``retinanet_target_assign``, ``generate_proposal_labels``,
``retinanet_detection_output``, ``roi_perspective_transform``,
``deformable_conv``, ``deformable_psroi_pooling``, ``detection_map`` and
``generate_mask_labels``.

The outputs keep the JAX rules' fixed slabs: index outputs padded with
repeats of the first pick at weight 0, or with -1.  ``use_random``
draws from the op's ``torch.Generator``, whose stream differs from
``jax.random``'s; with it off, the picks are the lowest eligible indices
in both packages.  Ranking uses a stable sort (lower index first on a
tie, as ``lax.top_k``); suppression is :func:`detection_ops.greedy_keep`.

``detection_map`` and ``generate_mask_labels`` are ``io_callback`` host
ops in JAX: here each copies its inputs to the host once, computes in
numpy as the JAX callback does, and counts that copy as one
``profiler.host_sync_count("<op>")`` on the card.
"""

import numpy as np
import torch

from .. import profiler
from ..registry import register_op
from .detection_ops import (clip, const, gather_rows, greedy_keep,
                            round_half_up, top_k)

_BBOX_CLIP = float(np.log(1000.0 / 16.0))


def _iou_xyxy(a, b, offset=1.0):
    """IoU ``[..., Ra, Rb]`` in the +1 pixel convention
    (detection_ops3.py:23)."""
    def area(t):
        return torch.clamp_min(t[..., 2] - t[..., 0] + offset, 0) * \
            torch.clamp_min(t[..., 3] - t[..., 1] + offset, 0)
    area_a, area_b = area(a), area(b)
    iw = torch.minimum(a[..., :, None, 2], b[..., None, :, 2]) - \
        torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + offset
    ih = torch.minimum(a[..., :, None, 3], b[..., None, :, 3]) - \
        torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + offset
    inter = torch.clamp_min(iw, 0) * torch.clamp_min(ih, 0)
    return inter / torch.clamp_min(area_a[..., :, None] +
                                   area_b[..., None, :] - inter, 1e-10)


def _decode(anchors, deltas, variances=None):
    """detection_ops3.py:38: +1 widths, dw/dh capped at log(1000/16)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    d = [deltas[..., k] for k in range(4)]
    if variances is not None:
        d = [variances[..., k] * d[k] for k in range(4)]
    cap = torch.full((), _BBOX_CLIP, dtype=deltas.dtype,
                     device=deltas.device)
    cx = d[0] * aw + acx
    cy = d[1] * ah + acy
    w = torch.exp(torch.minimum(d[2], cap)) * aw
    h = torch.exp(torch.minimum(d[3], cap)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1, cy + 0.5 * h - 1], dim=-1)


def _encode(anchors, gt):
    """detection_ops3.py:57: the deltas ``_decode`` inverts (no
    variances)."""
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * gw
    gcy = gt[:, 1] + 0.5 * gh
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(torch.clamp_min(gw / aw, 1e-10)),
                        torch.log(torch.clamp_min(gh / ah, 1e-10))], dim=1)


@register_op("generate_proposals", stop_gradient=True)
def _generate_proposals(ctx, op):
    """detection_ops3.py:87: per image the ``pre_nms_topN`` best anchors,
    decoded, clipped to the image, those under ``min_size`` (origin
    scale) or centred outside dropped, greedy NMS at ``nms_thresh``,
    the ``post_nms_topN`` best kept: RpnRois ``[N, post, 4]`` and
    RpnRoiProbs ``[N, post, 1]``, zero padding."""
    scores = ctx.i("Scores").to(torch.float32)          # [N, A, H, W]
    deltas = ctx.i("BboxDeltas").to(torch.float32)      # [N, 4A, H, W]
    im_info = ctx.i("ImInfo").to(torch.float32)         # [N, 3]
    anchors = ctx.i("Anchors").to(torch.float32).reshape(-1, 4)
    variances = ctx.i("Variances").to(torch.float32).reshape(-1, 4)
    pre_n = int(ctx.attr("pre_nms_topN", 6000))
    post_n = int(ctx.attr("post_nms_topN", 1000))
    nms_thresh = ctx.attr("nms_thresh", 0.5)
    min_size = max(ctx.attr("min_size", 0.1), 1.0)
    N, A, H, W = scores.shape
    total = A * H * W
    K = min(pre_n, total)
    sc_flat = scores.permute(0, 2, 3, 1).reshape(N, total)
    dl_flat = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, total, 4)
    top_sc, idx = top_k(sc_flat, K)
    props = _decode(anchors[idx], gather_rows(dl_flat, idx),
                    variances[idx])                      # [N, K, 4]
    info = im_info[:, None, :]
    hmax, wmax = info[..., 0] - 1, info[..., 1] - 1
    props = torch.stack([clip(props[..., 0], 0.0, wmax),
                         clip(props[..., 1], 0.0, hmax),
                         clip(props[..., 2], 0.0, wmax),
                         clip(props[..., 3], 0.0, hmax)], dim=-1)
    ws = props[..., 2] - props[..., 0] + 1
    hs = props[..., 3] - props[..., 1] + 1
    ws_o = (props[..., 2] - props[..., 0]) / info[..., 2] + 1
    hs_o = (props[..., 3] - props[..., 1]) / info[..., 2] + 1
    cx = props[..., 0] + ws / 2
    cy = props[..., 1] + hs / 2
    ok = (ws_o >= min_size) & (hs_o >= min_size) & \
        (cx <= info[..., 1]) & (cy <= info[..., 0])
    keep = greedy_keep(_iou_xyxy(props, props) > nms_thresh, ok)
    ranked = torch.where(keep, top_sc,
                         torch.full((), -float("inf"), device=keep.device))
    kk = min(post_n, K)
    fin_sc, fin_idx = top_k(ranked, kk)
    fin = torch.isfinite(fin_sc)
    out_b = torch.where(fin[..., None], gather_rows(props, fin_idx), 0.0)
    out_s = torch.where(fin, fin_sc, 0.0)
    if kk < post_n:
        out_b = torch.cat([out_b, out_b.new_zeros(N, post_n - kk, 4)], 1)
        out_s = torch.cat([out_s, out_s.new_zeros(N, post_n - kk)], 1)
    ctx.set("RpnRois", out_b)
    ctx.set("RpnRoiProbs", out_s[..., None])


def _sample_k(eligible, k, gen, use_random):
    """detection_ops3.py:147: up to ``k`` eligible slots, as (indices
    ``[k]`` padded by repeating the first pick, valid ``[k]``); without
    ``use_random`` the lowest eligible indices."""
    n = eligible.shape[0]
    dev = eligible.device
    if use_random:
        prio = torch.rand(n, generator=gen, device=dev)
    else:
        prio = -torch.arange(n, dtype=torch.float32, device=dev)
    ranked = torch.where(eligible, prio,
                         torch.full((), -float("inf"), device=dev))
    idx = top_k(ranked, k)[1]
    valid = eligible[idx] & (torch.arange(k, device=dev) < eligible.sum())
    return torch.where(valid, idx, idx[0]).to(torch.int32), valid


def _anchor_labels(anchor, gt, is_crowd):
    """IoU of every anchor against the valid gt (zero-area rows and crowd
    rows excluded), and the anchors that are some gt's best."""
    valid_gt = (gt[:, 2] - gt[:, 0] > 0) & (gt[:, 3] - gt[:, 1] > 0)
    if is_crowd is not None:
        valid_gt = valid_gt & (is_crowd.reshape(-1) == 0)
    iou = torch.where(valid_gt[None, :], _iou_xyxy(anchor, gt), 0.0)
    a2g_max = iou.amax(dim=1)
    a2g_arg = torch.argmax(iou, dim=1)
    g2a_max = iou.amax(dim=0)
    is_best = ((torch.abs(iou - g2a_max[None, :]) < 1e-5) &
               valid_gt[None, :] & (iou > 0)).any(dim=1)
    return a2g_max, a2g_arg, is_best


@register_op("rpn_target_assign", stop_gradient=True)
def _rpn_target_assign(ctx, op):
    """detection_ops3.py:165: anchors labelled foreground (some gt's best,
    or IoU at least ``rpn_positive_overlap``) or background (best IoU
    below ``rpn_negative_overlap``), ``F = batch · fg_fraction`` location
    slots and ``batch`` score slots (foreground, then background), the
    encoded targets; one image a call."""
    anchor = ctx.i("Anchor").to(torch.float32)
    gt = ctx.i("GtBoxes").to(torch.float32).reshape(-1, 4)
    batch = int(ctx.attr("rpn_batch_size_per_im", 256))
    pos_overlap = ctx.attr("rpn_positive_overlap", 0.7)
    neg_overlap = ctx.attr("rpn_negative_overlap", 0.3)
    fg_frac = ctx.attr("rpn_fg_fraction", 0.25)
    use_random = ctx.attr("use_random", True)
    F_ = int(batch * fg_frac)
    a2g_max, a2g_arg, is_best = _anchor_labels(anchor, gt,
                                               ctx.i_opt("IsCrowd"))
    fg_cand = is_best | (a2g_max >= pos_overlap)
    bg_cand = a2g_max < neg_overlap
    gen = ctx.generator() if use_random else None
    loc_idx, loc_valid = _sample_k(fg_cand, F_, gen, use_random)
    bg_idx, _ = _sample_k(bg_cand, batch - F_, gen, use_random)
    li = loc_idx.long()
    tgt_bbox = _encode(anchor[li], gt[a2g_arg[li]])
    dev = anchor.device
    ctx.set("LocationIndex", loc_idx)
    ctx.set("ScoreIndex", torch.cat([loc_idx, bg_idx]))
    ctx.set("TargetBBox", tgt_bbox)
    ctx.set("TargetLabel", torch.cat([
        torch.ones(F_, dtype=torch.int32, device=dev),
        torch.zeros(batch - F_, dtype=torch.int32, device=dev)])[:, None])
    ctx.set("BBoxInsideWeight",
            loc_valid[:, None].to(torch.float32).expand(F_, 4).contiguous())


@register_op("retinanet_target_assign", stop_gradient=True)
def _retinanet_target_assign(ctx, op):
    """detection_ops3.py:222: the RPN candidate rules without sampling:
    ``[A]`` slabs, LocationIndex the foreground anchors (first-pick
    repeats at weight 0), ScoreIndex foreground then background (label
    -1 past both), the gt class as label; ForegroundNumber exact."""
    anchor = ctx.i("Anchor").to(torch.float32)
    gt = ctx.i("GtBoxes").to(torch.float32).reshape(-1, 4)
    gt_labels = ctx.i("GtLabels").reshape(-1).to(torch.int32)
    pos_overlap = ctx.attr("positive_overlap", 0.5)
    neg_overlap = ctx.attr("negative_overlap", 0.4)
    A = anchor.shape[0]
    dev = anchor.device
    a2g_max, a2g_arg, is_best = _anchor_labels(anchor, gt,
                                               ctx.i_opt("IsCrowd"))
    fg = is_best | (a2g_max >= pos_overlap)
    bg = (~fg) & (a2g_max < neg_overlap)
    loc_idx, loc_valid = _sample_k(fg, A, None, False)
    fg_num = fg.sum().to(torch.int32)
    li = loc_idx.long()
    tgt_bbox = _encode(anchor[li], gt[a2g_arg[li]])
    bg_idx, _ = _sample_k(bg, A, None, False)
    fg_labels = gt_labels[a2g_arg[li]]
    slot = torch.arange(A, device=dev)
    bg_slot = (slot - fg_num).clamp(0, A - 1)
    is_fg = slot < fg_num
    score_idx = torch.where(is_fg, loc_idx, bg_idx[bg_slot])
    score_valid = is_fg | ((slot - fg_num) < bg.sum().to(torch.int32))
    tgt_label = torch.where(is_fg, fg_labels[slot.clamp(0, A - 1)], 0)
    tgt_label = torch.where(score_valid, tgt_label, -1)
    ctx.set("LocationIndex", loc_idx)
    ctx.set("ScoreIndex", score_idx)
    ctx.set("TargetBBox", tgt_bbox)
    ctx.set("TargetLabel", tgt_label[:, None].to(torch.int32))
    ctx.set("BBoxInsideWeight",
            loc_valid[:, None].to(torch.float32).expand(A, 4).contiguous())
    ctx.set("ForegroundNumber", fg_num.reshape(1))


@register_op("generate_proposal_labels", stop_gradient=True)
def _generate_proposal_labels(ctx, op):
    """detection_ops3.py:274: the gt boxes prepended to the proposals,
    each labelled by IoU (foreground at least ``fg_thresh`` takes its best
    gt's class; background in ``[bg_thresh_lo, bg_thresh_hi)``), sampled
    to ``batch_size_per_im`` rows with ``fg_fraction``, and per-class
    regression targets divided by ``bbox_reg_weights``; padding rows
    carry label -1 and zero weights.  One image a call.  The JAX rule
    broadcasts its ``[G]`` gt masks against the ``[G + R]`` rows, which
    holds only for one gt box (else it raises); the port pads them to
    ``[G + R]``, the same rows for one gt and any number besides."""
    rois = ctx.i("RpnRois").to(torch.float32).reshape(-1, 4)
    gt_classes = ctx.i("GtClasses").reshape(-1).to(torch.int32)
    is_crowd = ctx.i_opt("IsCrowd")
    gt_boxes = ctx.i("GtBoxes").to(torch.float32).reshape(-1, 4)
    batch = int(ctx.attr("batch_size_per_im", 256))
    fg_frac = ctx.attr("fg_fraction", 0.25)
    fg_thresh = ctx.attr("fg_thresh", 0.5)
    bg_hi = ctx.attr("bg_thresh_hi", 0.5)
    bg_lo = ctx.attr("bg_thresh_lo", 0.0)
    cls_num = int(ctx.attr("class_nums", 81))
    reg_w = [float(w) for w in
             ctx.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])]
    use_random = ctx.attr("use_random", True)
    G = gt_boxes.shape[0]
    dev = rois.device
    valid_gt = (gt_boxes[:, 2] - gt_boxes[:, 0] > 0) & \
        (gt_boxes[:, 3] - gt_boxes[:, 1] > 0)
    crowd = torch.zeros(G, dtype=torch.bool, device=dev) if is_crowd is None \
        else is_crowd.reshape(-1) != 0
    all_rois = torch.cat([gt_boxes, rois])
    R = all_rois.shape[0]
    iou = torch.where((valid_gt & ~crowd)[None, :],
                      _iou_xyxy(all_rois, gt_boxes), 0.0)
    max_ov = iou.amax(dim=1)
    arg_ov = torch.argmax(iou, dim=1)
    is_gt = torch.arange(R, device=dev) < G
    max_ov = torch.where(is_gt & torch.cat([crowd, crowd.new_zeros(R - G)]),
                         -1.0, max_ov)
    roi_valid = torch.where(
        is_gt, torch.cat([valid_gt, valid_gt.new_zeros(R - G)]),
        (all_rois[:, 2] - all_rois[:, 0] > 0) |
        (all_rois[:, 3] - all_rois[:, 1] > 0))
    fg_cand = (max_ov >= fg_thresh) & roi_valid
    bg_cand = (max_ov >= bg_lo) & (max_ov < bg_hi) & roi_valid
    F_ = int(batch * fg_frac)
    gen = ctx.generator() if use_random else None
    fg_idx, fg_valid = _sample_k(fg_cand, F_, gen, use_random)
    bg_idx, bg_valid = _sample_k(bg_cand, batch - F_, gen, use_random)
    sel = torch.cat([fg_idx, bg_idx]).long()
    sel_valid = torch.cat([fg_valid, bg_valid])
    is_fg = torch.cat([fg_valid, fg_valid.new_zeros(batch - F_)])
    out_rois = torch.where(sel_valid[:, None], all_rois[sel], 0.0)
    labels = torch.where(is_fg, gt_classes[arg_ov[sel]], 0)
    labels = torch.where(sel_valid, labels, -1).to(torch.int32)
    tgt = _encode(all_rois[sel], gt_boxes[arg_ov[sel]]) / \
        const(np.asarray(reg_w, np.float32), dev)[None, :]
    cls = torch.where(is_fg, labels, 0).long()
    onehot = (cls[:, None] == torch.arange(cls_num, device=dev)) \
        .to(torch.float32)
    w = (onehot * is_fg[:, None])[:, :, None] * \
        torch.ones(1, 1, 4, device=dev)
    ctx.set("Rois", out_rois)
    ctx.set("LabelsInt32", labels[:, None])
    ctx.set("BboxTargets", (tgt[:, None, :] * w).reshape(batch, cls_num * 4))
    weights = w.reshape(batch, cls_num * 4)
    ctx.set("BboxInsideWeights", weights)
    ctx.set("BboxOutsideWeights", weights)


@register_op("retinanet_detection_output", stop_gradient=True)
def _retinanet_detection_output(ctx, op):
    """detection_ops3.py:348: per level the ``nms_top_k`` best scores
    (above ``score_threshold``), decoded against the level's anchors at
    the origin scale and clipped, then class-wise greedy NMS over the
    merged levels and the ``keep_top_k`` best: Out ``[N, keep_top_k, 6]``
    (class + 1, score, box), label -1 rows padding.  All images at
    once."""
    bboxes = [ctx.env[n].to(torch.float32) for n in op.input("BBoxes")]
    scores = [ctx.env[n].to(torch.float32) for n in op.input("Scores")]
    anchors = [ctx.env[n].to(torch.float32).reshape(-1, 4)
               for n in op.input("Anchors")]
    im_info = ctx.i("ImInfo").to(torch.float32)
    score_thresh = ctx.attr("score_threshold", 0.05)
    nms_top_k = int(ctx.attr("nms_top_k", 1000))
    keep_top_k = int(ctx.attr("keep_top_k", 100))
    nms_thresh = ctx.attr("nms_threshold", 0.3)
    N = bboxes[0].shape[0]
    C = scores[0].shape[-1]
    dev = im_info.device
    ninf = torch.full((), -float("inf"), device=dev)
    info = im_info[:, None, :]
    hmax = round_half_up(info[..., 0] / info[..., 2]) - 1
    wmax = round_half_up(info[..., 1] / info[..., 2]) - 1
    cand_b, cand_s, cand_c = [], [], []
    for b, s, an in zip(bboxes, scores, anchors):
        Ai = an.shape[0]
        flat = s.reshape(N, -1)
        k = min(nms_top_k, flat.shape[1])
        top, idx = top_k(flat, k)
        a_idx = idx // C
        dec = _decode(an[a_idx], gather_rows(b.reshape(N, Ai, 4), a_idx))
        dec = dec / info[..., 2:3]
        dec = torch.stack([clip(dec[..., 0], 0.0, wmax),
                           clip(dec[..., 1], 0.0, hmax),
                           clip(dec[..., 2], 0.0, wmax),
                           clip(dec[..., 3], 0.0, hmax)], dim=-1)
        cand_b.append(dec)
        cand_s.append(torch.where(top > score_thresh, top, ninf))
        cand_c.append(idx % C)
    asq, order = top_k(torch.cat(cand_s, 1), sum(c.shape[1] for c in cand_c))
    ab = gather_rows(torch.cat(cand_b, 1), order)
    ac = torch.gather(torch.cat(cand_c, 1), 1, order)
    M = ab.shape[1]
    over = (_iou_xyxy(ab, ab) > nms_thresh) & \
        (ac[:, :, None] == ac[:, None, :])
    keep = greedy_keep(over, torch.isfinite(asq))
    kk = min(keep_top_k, M)
    fin_s, fin_i = top_k(torch.where(keep, asq, ninf), kk)
    good = torch.isfinite(fin_s)
    lab = torch.gather(ac, 1, fin_i) + 1
    row = torch.cat([
        torch.where(good, lab, -1).to(torch.float32)[..., None],
        torch.where(good, fin_s, 0.0)[..., None],
        torch.where(good[..., None], gather_rows(ab, fin_i), 0.0)], dim=2)
    if kk < keep_top_k:
        row = torch.cat([row, torch.full((N, keep_top_k - kk, 6), -1.0,
                                         device=dev)], 1)
    ctx.set("Out", row)


def _bilinear_zero(img, b, px, py):
    """``img [N, C, H, W]`` sampled bilinearly at float ``(px, py)`` of
    image ``b`` (all one shape S), zero outside: ``[*S, C]``."""
    N, C, H, W = img.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    inb = (px > -1) & (px < W) & (py > -1) & (py < H)
    val = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = (x0 + dx).long()
            yi = (y0 + dy).long()
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            wgt = (1 - wx if dx == 0 else wx) * (1 - wy if dy == 0 else wy)
            v = img.permute(0, 2, 3, 1)[b, yi.clamp(0, H - 1),
                                        xi.clamp(0, W - 1)]
            val = val + torch.where(ok & inb, wgt, 0.0)[..., None] * v
    return val


@register_op("roi_perspective_transform", nondiff_inputs=("ROIs",))
def _roi_perspective_transform(ctx, op):
    """detection_ops3.py:427: each quadrilateral ROI (8 coordinates,
    clockwise from top left) warped onto a ``transformed_height x
    transformed_width`` grid by its 4-point homography (one 8 x 8 solve
    per ROI), sampled bilinearly, zero outside the input; Mask ones,
    TransformMatrix the 3 x 3 rows."""
    x = ctx.i("X").to(torch.float32)
    rois = ctx.i("ROIs").to(torch.float32)
    bid = ctx.i_opt("RoisBatchId")
    th = int(ctx.attr("transformed_height"))
    tw = int(ctx.attr("transformed_width"))
    scale = ctx.attr("spatial_scale", 1.0)
    R = rois.shape[0]
    dev = x.device
    bid = torch.zeros(R, dtype=torch.long, device=dev) if bid is None \
        else bid.reshape(-1).long()
    src = [(0, 0), (tw - 1, 0), (tw - 1, th - 1), (0, th - 1)]
    dst = rois.reshape(R, 4, 2) * scale
    one = torch.ones(R, device=dev)
    zero = torch.zeros(R, device=dev)
    rows = []
    for k, (sx, sy) in enumerate(src):
        dxk, dyk = dst[:, k, 0], dst[:, k, 1]
        rows.append(torch.stack([one * sx, one * sy, one, zero, zero, zero,
                                 -dxk * sx, -dxk * sy], dim=1))
        rows.append(torch.stack([zero, zero, zero, one * sx, one * sy, one,
                                 -dyk * sx, -dyk * sy], dim=1))
    h8 = torch.linalg.solve(torch.stack(rows, dim=1),
                            dst.reshape(R, 8))
    hm = torch.cat([h8, one[:, None]], dim=1).reshape(R, 3, 3)
    oy, ox = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([ox, oy, torch.ones_like(ox)], dim=-1)
    pts = torch.einsum("rij,hwj->rhwi", hm, grid)
    px = pts[..., 0] / (pts[..., 2] + 1e-10)
    py = pts[..., 1] / (pts[..., 2] + 1e-10)
    b = bid[:, None, None].expand(R, th, tw)
    out = _bilinear_zero(x, b, px, py).permute(0, 3, 1, 2)
    ctx.set("Out", out)
    ctx.set("Mask", torch.ones(R, 1, th, tw, dtype=torch.int32, device=dev))
    ctx.set("TransformMatrix", hm.reshape(R, 9))


@register_op("deformable_conv", nondiff_inputs=())
def _deformable_conv(ctx, op):
    """detection_ops3.py:504: modulated deformable convolution (v2): each
    tap read bilinearly at its offset position (zero outside), scaled by
    the Mask, the patches ``[N, C, kh·kw, Ho, Wo]`` contracted with the
    Filter."""
    x = ctx.i("Input").to(torch.float32)
    offset = ctx.i("Offset").to(torch.float32)
    mask = ctx.i_opt("Mask")
    w = ctx.i("Filter").to(torch.float32)
    strides = tuple(ctx.attr("strides", [1, 1]))
    pads = tuple(ctx.attr("paddings", [0, 0]))
    dils = tuple(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    dg = ctx.attr("deformable_groups", 1) or 1
    N, C, H, W = x.shape
    O, _, kh, kw = w.shape
    dev = x.device
    K = kh * kw
    Ho = (H + 2 * pads[0] - (dils[0] * (kh - 1) + 1)) // strides[0] + 1
    Wo = (W + 2 * pads[1] - (dils[1] * (kw - 1) + 1)) // strides[1] + 1
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    msk = mask.to(torch.float32).reshape(N, dg, K, Ho, Wo) \
        if mask is not None else torch.ones(N, dg, K, Ho, Wo, device=dev)
    base_y = (torch.arange(Ho, device=dev) * strides[0] - pads[0])[:, None]
    base_x = (torch.arange(Wo, device=dev) * strides[1] - pads[1])[None, :]
    ky = torch.arange(K, device=dev) // kw
    kx = torch.arange(K, device=dev) % kw
    py = base_y + (ky * dils[0])[:, None, None] + off[:, :, :, 0]
    px = base_x + (kx * dils[1])[:, None, None] + off[:, :, :, 1]
    # [N, dg, K, Ho, Wo] positions; channels of group g read at group g's
    cpg = C // dg
    xg = x.reshape(N, dg, cpg, H * W)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    acc = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi = (y0 + dy).long()
            xi = (x0 + dx).long()
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            wgt = (1 - wy if dy == 0 else wy) * (1 - wx if dx == 0 else wx)
            flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)) \
                .reshape(N, dg, 1, -1).expand(N, dg, cpg, K * Ho * Wo)
            v = torch.gather(xg, 3, flat).reshape(N, dg, cpg, K, Ho, Wo)
            acc = acc + torch.where(ok, wgt, 0.0)[:, :, None] * v
    patches = acc * msk[:, :, None]                      # [N, dg, cpg, K..]
    cg, og = C // groups, O // groups
    pg = patches.reshape(N, groups, cg, K, Ho, Wo)
    wg = w.reshape(groups, og, cg, K)
    out = torch.einsum("ngckyx,gock->ngoyx", pg, wg)
    ctx.set("Output", out.reshape(N, O, Ho, Wo).to(ctx.i("Input").dtype))


@register_op("deformable_psroi_pooling",
             nondiff_inputs=("ROIs", "RoisBatchId"))
def _deformable_psroi_pooling(ctx, op):
    """detection_ops3.py:577: position-sensitive ROI pooling, each bin's
    ``sample_per_part``² bilinear reads (coordinates clamped into the
    image) shifted by the bin part's Trans offsets and averaged; output
    channel c of bin (i, j) reads input channel ``(c·group + gi)·group +
    gj``.  TopCount is ones."""
    x = ctx.i("Input").to(torch.float32)
    rois = ctx.i("ROIs").to(torch.float32)
    trans = ctx.i_opt("Trans")
    bid = ctx.i_opt("RoisBatchId")
    no_trans = ctx.attr("no_trans", False)
    sscale = ctx.attr("spatial_scale", 1.0)
    out_c = int(ctx.attr("output_dim"))
    group = ctx.attr("group_size", [1])
    group = int(group[0] if isinstance(group, (list, tuple)) else group)
    ph = int(ctx.attr("pooled_height", 7))
    pw = int(ctx.attr("pooled_width", 7))
    part = ctx.attr("part_size", [ph, pw])
    part_h, part_w = (int(part[0]), int(part[1])) \
        if isinstance(part, (list, tuple)) else (int(part), int(part))
    S = int(ctx.attr("sample_per_part", 4))
    trans_std = ctx.attr("trans_std", 0.1)
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    bid = torch.zeros(R, dtype=torch.long, device=dev) if bid is None \
        else bid.reshape(-1).long()
    x1 = rois[:, 0] * sscale - 0.5
    y1 = rois[:, 1] * sscale - 0.5
    x2 = (rois[:, 2] + 1) * sscale - 0.5
    y2 = (rois[:, 3] + 1) * sscale - 0.5
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bin_w, bin_h = rw / pw, rh / ph
    sub_w, sub_h = bin_w / S, bin_h / S
    ii = torch.arange(ph, device=dev)
    jj = torch.arange(pw, device=dev)
    if no_trans or trans is None:
        dx = torch.zeros(R, ph, pw, device=dev)
        dy = torch.zeros(R, ph, pw, device=dev)
    else:
        tr = trans.to(torch.float32)
        pi = [min(int(i * part_h / ph), part_h - 1) for i in range(ph)]
        pj = [min(int(j * part_w / pw), part_w - 1) for j in range(pw)]
        pi_t = const(np.asarray(pi, np.int64), dev)[:, None]
        pj_t = const(np.asarray(pj, np.int64), dev)[None, :]
        dx = tr[:, 0][:, pi_t, pj_t] * trans_std * rw[:, None, None]
        dy = tr[:, 1][:, pi_t, pj_t] * trans_std * rh[:, None, None]
    s = torch.arange(S, device=dev)

    def r5(t):
        return t[:, None, None, None, None]

    # [R, ph, pw, S(si), S(sj)]
    py = r5(y1) + (ii * 1.0)[None, :, None, None, None] * r5(bin_h) + \
        (s[None, None, None, :, None] + 0.5) * r5(sub_h) + \
        dy[:, :, :, None, None]
    px = r5(x1) + (jj * 1.0)[None, None, :, None, None] * r5(bin_w) + \
        (s[None, None, None, None, :] + 0.5) * r5(sub_w) + \
        dx[:, :, :, None, None]
    py = clip(py, 0.0, H - 1.0)
    px = clip(px, 0.0, W - 1.0)
    gi = const(np.asarray([min(int(i * group / ph), group - 1)
                           for i in range(ph)], np.int64), dev)
    gj = const(np.asarray([min(int(j * group / pw), group - 1)
                           for j in range(pw)], np.int64), dev)
    ch = (torch.arange(out_c, device=dev)[:, None, None] * group +
          gi[None, :, None]) * group + gj[None, None, :]   # [out_c, ph, pw]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    flat_img = x.reshape(N, C, H * W)
    acc = 0.0
    for dyk in (0, 1):
        for dxk in (0, 1):
            yi = (y0 + dyk).long().clamp(0, H - 1)
            xi = (x0 + dxk).long().clamp(0, W - 1)
            wgt = (1 - wy if dyk == 0 else wy) * (1 - wx if dxk == 0 else wx)
            pos = (yi * W + xi)[:, None]                 # [R, 1, ph, pw, S, S]
            v = flat_img[bid[:, None, None, None, None, None],
                         ch[None, :, :, :, None, None], pos]
            acc = acc + wgt[:, None] * v
    out = acc.sum(dim=(-2, -1)) / (S * S)
    ctx.set("Output", out.to(x.dtype))
    ctx.set("TopCount", torch.ones(R, out_c, ph, pw, device=dev))


def _voc_map(det_np, gt_np, overlap_t, evaluate_difficult, ap_type):
    """detection_ops3.py:684-743 (the JAX callback, verbatim): VOC mAP
    of one padded batch."""
    if det_np.ndim == 2:
        det_np = det_np[None]
    if gt_np.ndim == 2:
        gt_np = gt_np[None]
    n_gt = {}
    recs = {}
    for n in range(det_np.shape[0]):
        gts = [g for g in gt_np[n] if g[0] >= 0]
        used = np.zeros(len(gts), bool)
        for g in gts:
            diff = bool(g[5]) if len(g) > 5 else False
            if evaluate_difficult or not diff:
                n_gt[int(g[0])] = n_gt.get(int(g[0]), 0) + 1
        for d in sorted(det_np[n], key=lambda r: -r[1]):
            if d[0] < 0:
                continue
            best, best_j = 0.0, -1
            for j, g in enumerate(gts):
                if int(g[0]) != int(d[0]):
                    continue
                ix1, iy1 = max(d[2], g[1]), max(d[3], g[2])
                ix2, iy2 = min(d[4], g[3]), min(d[5], g[4])
                iw, ih = max(ix2 - ix1, 0), max(iy2 - iy1, 0)
                inter = iw * ih
                ua = max((d[4] - d[2]) * (d[5] - d[3]) +
                         (g[3] - g[1]) * (g[4] - g[2]) - inter, 1e-10)
                ov = inter / ua
                if ov > best:
                    best, best_j = ov, j
            tp = 0
            if best >= overlap_t and best_j >= 0 and not used[best_j]:
                used[best_j] = True
                tp = 1
            recs.setdefault(int(d[0]), []).append((float(d[1]), tp))
    aps = []
    for c, cnt in n_gt.items():
        dets = sorted(recs.get(c, ()), reverse=True)
        if not dets or cnt == 0:
            aps.append(0.0)
            continue
        tps = np.array([t for _s, t in dets], np.float64)
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(1 - tps)
        rec = tp_cum / cnt
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        if ap_type == "11point":
            ap = float(np.mean([prec[rec >= t].max() if (rec >= t).any()
                                else 0.0 for t in np.linspace(0, 1, 11)]))
        else:
            ap = 0.0
            prev_r = 0.0
            for k in range(len(rec)):
                ap += prec[k] * (rec[k] - prev_r)
                prev_r = rec[k]
        aps.append(float(ap))
    return np.float32(np.mean(aps) if aps else 0.0)


def _to_host(tag, *tensors):
    """The tensors as float32 numpy arrays, through one copy (one
    ``tag`` host sync when they lie on the card)."""
    packed = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    if packed.device.type != "cpu":
        profiler.record_host_sync(tag)
    host = packed.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


@register_op("detection_map", stop_gradient=True)
def _detection_map(ctx, op):
    """detection_ops3.py:668: VOC mAP of DetectRes ``[N, M, 6]`` (label,
    score, box; label -1 padding) against Label ``[N, G, 6]`` (label,
    box, difficult), on the host; the accumulator outputs are zeros, as
    in JAX (``metrics.DetectionMAP`` streams)."""
    det, gt = _to_host("detection_map", ctx.i("DetectRes"), ctx.i("Label"))
    mp = _voc_map(det, gt, ctx.attr("overlap_threshold", 0.5),
                  ctx.attr("evaluate_difficult", True),
                  ctx.attr("ap_type", "integral"))
    dev = ctx.i("DetectRes").device
    ctx.set("MAP", torch.full((1,), float(mp), dtype=torch.float32,
                              device=dev))
    ctx.set("AccumPosCount", torch.zeros(1, dtype=torch.int32, device=dev))
    ctx.set("AccumTruePos", torch.zeros(1, 2, device=dev))
    ctx.set("AccumFalsePos", torch.zeros(1, 2, device=dev))


def _poly_mask(poly, roi, M):
    """Even-odd rasterisation of one polygon (vertex rows, (-1, -1)
    padding) on the ROI's M x M cell centres (detection_ops3.py:786)."""
    ys, xs = np.meshgrid(
        roi[1] + (np.arange(M) + 0.5) * (roi[3] - roi[1]) / M,
        roi[0] + (np.arange(M) + 0.5) * (roi[2] - roi[0]) / M,
        indexing="ij")
    inside = np.zeros((M, M), bool)
    pts = poly[(poly[:, 0] >= 0) | (poly[:, 1] >= 0)]
    n = len(pts)
    if n < 3:
        return inside
    j = n - 1
    for i in range(n):
        xi, yi = pts[i]
        xj, yj = pts[j]
        cond = ((yi > ys) != (yj > ys)) & \
            (xs < (xj - xi) * (ys - yi) / (yj - yi + 1e-12) + xi)
        inside ^= cond
        j = i
    return inside


@register_op("generate_mask_labels", stop_gradient=True)
def _generate_mask_labels(ctx, op):
    """detection_ops3.py:753: Mask R-CNN mask targets on the host.  Each
    foreground ROI (label > 0) takes the polygon of its best-IoU gt of
    the same class, rasterised into its class's ``resolution``² slot;
    every other slot and ROI is -1.  GtSegms is the padded ``[G, P, 2]``
    polygon slab.  Outputs MaskRois (the ROIs), RoiHasMaskInt32 ``[R,
    1]`` and MaskInt32 ``[R, classes·resolution²]``."""
    rois_t = ctx.i("Rois").to(torch.float32).reshape(-1, 4)
    gcls, segms, rois, lbls = _to_host(
        "generate_mask_labels", ctx.i("GtClasses").reshape(-1),
        ctx.i("GtSegms"), rois_t, ctx.i("LabelsInt32").reshape(-1))
    num_classes = int(ctx.attr("num_classes"))
    M = int(ctx.attr("resolution"))
    R = rois.shape[0]
    masks = np.full((R, num_classes * M * M), -1, np.int32)
    has = np.zeros((R,), np.int32)
    for r in range(R):
        c = int(lbls[r])
        if c <= 0:
            continue
        best, best_g = 0.0, -1
        for g in range(segms.shape[0]):
            if int(gcls[g]) != c:
                continue
            pts = segms[g][(segms[g][:, 0] >= 0)]
            if len(pts) < 3:
                continue
            gx1, gy1 = pts[:, 0].min(), pts[:, 1].min()
            gx2, gy2 = pts[:, 0].max(), pts[:, 1].max()
            iw = min(rois[r, 2], gx2) - max(rois[r, 0], gx1)
            ih = min(rois[r, 3], gy2) - max(rois[r, 1], gy1)
            inter = max(iw, 0) * max(ih, 0)
            ua = max((rois[r, 2] - rois[r, 0]) * (rois[r, 3] - rois[r, 1]) +
                     (gx2 - gx1) * (gy2 - gy1) - inter, 1e-10)
            if inter / ua > best:
                best, best_g = inter / ua, g
        if best_g < 0:
            continue
        has[r] = 1
        slot = masks[r].reshape(num_classes, M * M)
        slot[c] = _poly_mask(segms[best_g], rois[r], M).astype(
            np.int32).reshape(-1)
        masks[r] = slot.reshape(-1)
    dev = rois_t.device
    ctx.set("MaskRois", rois_t)
    ctx.set("RoiHasMaskInt32", torch.from_numpy(has[:, None]).to(dev))
    ctx.set("MaskInt32", torch.from_numpy(masks).to(dev))
