"""Detection matching, assignment, FPN routing and the YOLOv3 loss
(counterpart ``paddle_tpu/fluid/ops/detection_ops2.py``):
``bipartite_match``, ``target_assign``, ``mine_hard_examples``,
``box_decoder_and_assign``, ``collect_fpn_proposals``,
``distribute_fpn_proposals`` and ``yolov3_loss``.

The outputs are the JAX rules' fixed slabs (-1 or zero padding, as each
rule documents).  ``bipartite_match`` runs its greedy rounds on every
image at once, one round a step of a loop of ``min(R, C)`` on the
device; its flattened argmax takes the first maximum, as ``jnp.argmax``
does, since grid priors give exactly equal IoUs against one box.
``mine_hard_examples`` ranks with a stable sort and reads nothing back.
"""

import numpy as np
import torch

from ..registry import register_op
from .detection_ops import const, top_k


@register_op("bipartite_match", stop_gradient=True)
def _bipartite_match(ctx, op):
    """detection_ops2.py:20: greedy global-max matching of rows (ground
    truth) to columns (priors) on DistMat ``[B, R, C]`` (or ``[R, C]``,
    one image); then, for ``per_prediction``, every unmatched column takes
    its best row when that distance is at least ``dist_threshold``."""
    dist = ctx.i("DistMat").to(torch.float32)
    match_type = ctx.attr("match_type", "bipartite")
    thresh = ctx.attr("dist_threshold", 0.5)
    if dist.dim() == 2:
        dist = dist[None]
    B, R, C = dist.shape
    dev = dist.device
    eps = 1e-6
    mi = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    md = torch.zeros(B, C, device=dev)
    used_row = torch.zeros(B, R, dtype=torch.bool, device=dev)
    used_col = torch.zeros(B, C, dtype=torch.bool, device=dev)
    bi = torch.arange(B, device=dev)
    neg = torch.full((), -1.0, device=dev)
    pos = dist > eps
    for _ in range(min(R, C)):
        avail = (~used_row[:, :, None]) & (~used_col[:, None, :]) & pos
        masked = torch.where(avail, dist, neg).reshape(B, -1)
        flat = torch.argmax(masked, dim=1)
        best = torch.gather(masked, 1, flat[:, None])[:, 0]
        i, j = flat // C, flat % C
        ok = best > 0
        mi[bi, j] = torch.where(ok, i.to(torch.int32), mi[bi, j])
        md[bi, j] = torch.where(ok, dist[bi, i, j], md[bi, j])
        used_row[bi, i] |= ok
        used_col[bi, j] |= ok
    if match_type == "per_prediction":
        cand = torch.where(dist >= thresh, dist, neg)
        best_d = cand.amax(dim=1)
        best = torch.argmax(cand, dim=1)
        extra = (mi == -1) & (best_d > eps)
        mi = torch.where(extra, best.to(torch.int32), mi)
        md = torch.where(extra, torch.gather(dist, 1, best[:, None])[:, 0],
                         md)
    ctx.set("ColToRowMatchIndices", mi)
    ctx.set("ColToRowMatchDist", md)


@register_op("target_assign", stop_gradient=True)
def _target_assign(ctx, op):
    """detection_ops2.py:73: ``out[b, m] = X[b, match[b, m]]`` (weight 1)
    where the match is at least 0, else ``mismatch_value`` (weight 0);
    X is ``[B, G, K]`` (``[B, G]`` reads as K = 1) or the per-prior slab
    ``[B, G, M, K]``.  A position listed in NegIndices (``[B, Q]``, -1
    padding) takes ``mismatch_value`` at weight 1."""
    x = ctx.i("X")
    match = ctx.i("MatchIndices").long()                 # [B, M]
    mismatch = ctx.attr("mismatch_value", 0)
    if x.dim() == 2:
        x = x[:, :, None]
    B, M = match.shape
    dev = x.device
    safe = match.clamp(0, x.shape[1] - 1)
    if x.dim() == 4:
        out = x[torch.arange(B, device=dev)[:, None], safe,
                torch.arange(M, device=dev)[None, :]]
    else:
        out = torch.gather(x, 1, safe[:, :, None].expand(B, M, x.shape[2]))
    matched = (match >= 0)[:, :, None]
    fill = torch.full((), mismatch, dtype=x.dtype, device=dev)
    out = torch.where(matched, out, fill)
    wt = matched.to(torch.float32)
    neg = ctx.i_opt("NegIndices")
    if neg is not None:
        neg = neg.long()
        if neg.dim() == 1:
            neg = neg[None]
        # position m is negative iff the row lists it; -1 (and any index
        # past M) lists nothing: it lands in the trash column M
        slot = torch.where((neg >= 0) & (neg < M), neg, M)
        is_neg = torch.zeros(B, M + 1, dtype=torch.bool, device=dev)
        is_neg = is_neg.scatter(1, slot, True)[:, :M, None]
        out = torch.where(is_neg, fill, out)
        wt = torch.where(is_neg, torch.ones((), device=dev), wt)
    ctx.set("Out", out)
    ctx.set("OutWeight", wt)


@register_op("mine_hard_examples", stop_gradient=True)
def _mine_hard_examples(ctx, op):
    """detection_ops2.py:116: among unmatched priors with MatchDist below
    ``neg_dist_threshold``, the ``neg_pos_ratio · num_pos`` largest
    classification losses of each image (``max_negative``; ``sample_size``
    of them for ``hard_example``, whose loss adds LocLoss).  NegIndices
    is ``[B, P]``, -1 padding, ranked by a stable descending sort (lower
    prior first on a tie, as ``jnp.argsort``); the count stays on the
    device.  UpdatedMatchIndices is MatchIndices."""
    cls_loss = ctx.i("ClsLoss").to(torch.float32)
    match = ctx.i("MatchIndices").to(torch.int32)
    dist = ctx.i("MatchDist").to(torch.float32)
    loc_loss = ctx.i_opt("LocLoss")
    ratio = ctx.attr("neg_pos_ratio", 3.0)
    neg_thresh = ctx.attr("neg_dist_threshold", 0.5)
    mining_type = ctx.attr("mining_type", "max_negative")
    sample_size = int(ctx.attr("sample_size", 0))
    B, P = match.shape
    dev = match.device
    loss = cls_loss
    if mining_type == "hard_example" and loc_loss is not None:
        loss = cls_loss + loc_loss.to(torch.float32)
    eligible = (match == -1) & (dist < neg_thresh)
    num_pos = (match != -1).sum(dim=1)
    n_elig = eligible.sum(dim=1)
    if mining_type == "max_negative":
        want = (num_pos.to(torch.float32) * ratio).to(torch.int32)
    else:
        want = torch.full_like(num_pos, sample_size or P)
    neg_sel = torch.minimum(want.long(), n_elig)
    masked = torch.where(eligible, loss,
                         torch.full((), -float("inf"), device=dev))
    order = torch.sort(-masked, dim=1, stable=True)[1]
    keep = torch.arange(P, device=dev)[None, :] < neg_sel[:, None]
    ctx.set("NegIndices", torch.where(keep, order, -1).to(torch.int32))
    ctx.set("UpdatedMatchIndices", match)


@register_op("box_decoder_and_assign",
             nondiff_inputs=("PriorBox", "PriorBoxVar", "BoxScore"))
def _box_decoder_and_assign(ctx, op):
    """detection_ops2.py:155: per-class deltas ``[N, C·4]`` decoded
    against each ROI's prior (+1 box sizes; dw, dh capped at
    ``box_clip``); OutputAssignBox is the box of the best non-background
    class (the prior when there is no such class)."""
    prior = ctx.i("PriorBox").to(torch.float32)
    var = ctx.i("PriorBoxVar").to(torch.float32)
    deltas = ctx.i("TargetBox").to(torch.float32)
    score = ctx.i("BoxScore").to(torch.float32)
    box_clip = ctx.attr("box_clip", np.log(1000.0 / 16.0))
    N, C4 = deltas.shape
    C = C4 // 4
    dev = deltas.device
    d = deltas.reshape(N, C, 4)
    pw = prior[:, 2] - prior[:, 0] + 1
    ph = prior[:, 3] - prior[:, 1] + 1
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    cap = torch.full((), box_clip, dtype=torch.float32, device=dev)
    dw = torch.minimum(var[2] * d[:, :, 2], cap)
    dh = torch.minimum(var[3] * d[:, :, 3], cap)
    cx = var[0] * d[:, :, 0] * pw[:, None] + pcx[:, None]
    cy = var[1] * d[:, :, 1] * ph[:, None] + pcy[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1,
                         cy + h / 2 - 1], dim=2)
    ctx.set("DecodeBox", boxes.reshape(N, C4))
    if C > 1:
        fg = score.clone()
        fg[:, 0] = -float("inf")
        best = torch.argmax(fg, dim=1)
        ctx.set("OutputAssignBox",
                boxes[torch.arange(N, device=dev), best])
    else:
        ctx.set("OutputAssignBox", prior)


@register_op("collect_fpn_proposals",
             nondiff_inputs=("MultiLevelRois", "MultiLevelScores"))
def _collect_fpn_proposals(ctx, op):
    """detection_ops2.py:190: the ``post_nms_topN`` best-scoring ROIs of
    all levels, ``[topN, 4]``, zero rows past the real ones."""
    rois = torch.cat([ctx.env[n].to(torch.float32)
                      for n in op.input("MultiLevelRois")])
    scores = torch.cat([ctx.env[n].to(torch.float32).reshape(-1)
                        for n in op.input("MultiLevelScores")])
    topn = int(ctx.attr("post_nms_topN", 100))
    k = min(topn, scores.shape[0])
    out = rois[top_k(scores, k)[1]]
    if k < topn:
        out = torch.cat([out, out.new_zeros(topn - k, 4)])
    ctx.set("FpnRois", out)


@register_op("distribute_fpn_proposals", stop_gradient=True)
def _distribute_fpn_proposals(ctx, op):
    """detection_ops2.py:211: each ROI to level ``floor(log2(sqrt(area) /
    refer_scale + 1e-6) + refer_level)`` clamped to ``[min_level,
    max_level]``; every MultiFpnRois output is the full ``[N, 4]`` slab, a
    level's ROIs compacted to its top rows; ``RestoreIndex[i] = level·N +
    slot``."""
    rois = ctx.i("FpnRois").to(torch.float32)
    min_l = int(ctx.attr("min_level", 2))
    max_l = int(ctx.attr("max_level", 5))
    refer_l = int(ctx.attr("refer_level", 4))
    refer_s = int(ctx.attr("refer_scale", 224))
    N = rois.shape[0]
    area = torch.clamp_min(rois[:, 2] - rois[:, 0] + 1, 0) * \
        torch.clamp_min(rois[:, 3] - rois[:, 1] + 1, 0)
    tgt = torch.floor(torch.log2(torch.sqrt(area) / refer_s + 1e-6) +
                      refer_l)
    tgt = tgt.clamp(min_l, max_l).to(torch.int64) - min_l
    restore = torch.zeros(N, dtype=torch.int64, device=rois.device)
    names = op.output("MultiFpnRois")
    for level in range(max_l - min_l + 1):
        m = tgt == level
        slot = torch.cumsum(m, 0) - 1
        buf = rois.new_zeros(N + 1, 4)
        buf[torch.where(m, slot, N)] = rois
        if level < len(names) and names[level]:
            ctx.env[names[level]] = buf[:N]
        restore = torch.where(m, level * N + slot, restore)
    ctx.set("RestoreIndex", restore.to(torch.int32)[:, None])


def _bce(logit, label):
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    return torch.maximum(logit, zero) - logit * label + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def _iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
    ow = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) - \
        torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
    oh = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) - \
        torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)


@register_op("yolov3_loss", nondiff_inputs=("GTBox", "GTLabel", "GTScore"))
def _yolov3_loss(ctx, op):
    """detection_ops2.py:247: the per-image YOLOv3 loss of X ``[N,
    mask·(5+C), H, W]`` against GTBox ``[N, B, 4]`` (cx, cy, w, h,
    normalized; zero w/h rows pad) and GTLabel ``[N, B]``: Loss ``[N]``,
    ObjectnessMask ``[N, mask, H, W]`` (gt score / 0 / -1 ignored) and
    GTMatchMask ``[N, B]`` (the matched anchor-mask slot or -1); the
    masks carry no gradient."""
    x = ctx.i("X").to(torch.float32)
    gt_box = ctx.i("GTBox").to(torch.float32)
    gt_label = ctx.i("GTLabel").long()
    gt_score = ctx.i_opt("GTScore")
    anchors = list(ctx.attr("anchors"))
    mask = list(ctx.attr("anchor_mask"))
    C = int(ctx.attr("class_num"))
    ignore_thresh = ctx.attr("ignore_thresh", 0.7)
    downsample = int(ctx.attr("downsample_ratio", 32))
    label_smooth = ctx.attr("use_label_smooth", True)
    N, _, H, W = x.shape
    dev = x.device
    A = len(mask)
    Bx = gt_box.shape[1]
    input_size = downsample * H
    an_w = const(np.asarray(anchors[0::2], np.float32), dev)
    an_h = const(np.asarray(anchors[1::2], np.float32), dev)
    xr = x.reshape(N, A, 5 + C, H, W)
    if label_smooth:
        delta = min(1.0 / C, 1.0 / 40)
        pos, negv = 1.0 - delta, delta
    else:
        pos, negv = 1.0, 0.0
    gt_score = torch.ones(N, Bx, device=dev) if gt_score is None else \
        gt_score.to(torch.float32)
    valid_gt = (gt_box[:, :, 2] > 1e-6) & (gt_box[:, :, 3] > 1e-6)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.no_grad():
        gx = (torch.arange(W, **f32)[None, None, None, :] +
              torch.sigmoid(xr[:, :, 0])) / W
        gy = (torch.arange(H, **f32)[None, None, :, None] +
              torch.sigmoid(xr[:, :, 1])) / H
        sel = const(np.asarray(mask, np.int64), dev)
        gw = torch.exp(xr[:, :, 2]) * an_w[sel][None, :, None, None] / \
            input_size
        gh = torch.exp(xr[:, :, 3]) * an_h[sel][None, :, None, None] / \
            input_size
        g = [gt_box[:, None, None, None, :, k] for k in range(4)]
        ious = _iou_cwh(gx[..., None], gy[..., None], gw[..., None],
                        gh[..., None], *g)
        ious = torch.where(valid_gt[:, None, None, None, :], ious,
                           torch.zeros((), device=dev))
        best_iou = ious.amax(dim=-1)
        obj_mask = torch.where(best_iou > ignore_thresh,
                               torch.full((), -1.0, device=dev),
                               torch.zeros((), device=dev))
    an_iou = _iou_cwh(torch.zeros((), **f32), torch.zeros((), **f32),
                      an_w[None, None, :] / input_size,
                      an_h[None, None, :] / input_size,
                      torch.zeros((), **f32), torch.zeros((), **f32),
                      gt_box[:, :, None, 2], gt_box[:, :, None, 3])
    best_n = torch.argmax(an_iou, dim=-1)               # [N, B]
    mask_arr = np.full(len(anchors) // 2, -1, np.int64)
    for slot, a in enumerate(mask):
        mask_arr[a] = slot
    mask_idx = const(mask_arr, dev)[best_n]
    mask_idx = torch.where(valid_gt, mask_idx, -1)
    gi = (gt_box[:, :, 0] * W).to(torch.int64).clamp(0, W - 1)
    gj = (gt_box[:, :, 1] * H).to(torch.int64).clamp(0, H - 1)
    nidx = torch.arange(N, device=dev)[:, None].expand(N, Bx)
    pos_slot = torch.where(mask_idx >= 0, mask_idx, A)   # A: dropped
    buf = torch.cat([obj_mask, obj_mask.new_zeros(N, 1, H, W)], dim=1)
    buf[nidx, pos_slot, gj, gi] = gt_score.detach()
    obj_mask = buf[:, :A]

    safe_slot = mask_idx.clamp(0, A - 1)
    pred = xr[nidx, safe_slot, :, gj, gi]               # [N, B, 5+C]
    tx = gt_box[:, :, 0] * W - gi
    ty = gt_box[:, :, 1] * H - gj
    tw = torch.log(torch.clamp_min(gt_box[:, :, 2] * input_size /
                                   torch.clamp_min(an_w[best_n], 1e-6),
                                   1e-9))
    th = torch.log(torch.clamp_min(gt_box[:, :, 3] * input_size /
                                   torch.clamp_min(an_h[best_n], 1e-6),
                                   1e-9))
    scale = (2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]) * gt_score
    loc = (_bce(pred[:, :, 0], tx) + _bce(pred[:, :, 1], ty) +
           torch.abs(pred[:, :, 2] - tw) +
           torch.abs(pred[:, :, 3] - th)) * scale
    onehot = (gt_label[..., None] ==
              torch.arange(C, device=dev)).to(torch.float32)
    cls_tgt = onehot * pos + (1 - onehot) * negv
    cls = torch.sum(_bce(pred[:, :, 5:], cls_tgt), dim=-1) * gt_score
    active = (mask_idx >= 0).to(torch.float32)
    per_img = torch.sum((loc + cls) * active, dim=1)
    obj_logit = xr[:, :, 4]
    zero = torch.zeros((), device=dev)
    obj_loss = torch.where(
        obj_mask > 1e-5, _bce(obj_logit, 1.0) * obj_mask,
        torch.where(obj_mask > -0.5, _bce(obj_logit, 0.0), zero))
    per_img = per_img + torch.sum(obj_loss, dim=(1, 2, 3))
    ctx.set("Loss", per_img)
    ctx.set("ObjectnessMask", obj_mask)
    ctx.set("GTMatchMask", mask_idx.to(torch.int32))

