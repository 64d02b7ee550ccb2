"""The op zoo's second batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops2.py``), so far its sequence, RNN-cell and CTC ops: ``row_conv``,
``lstm_unit``, ``gru_unit``, ``warpctc`` and ``edit_distance``, and its
detection ops: ``sigmoid_focal_loss``, ``iou_similarity``, ``box_clip``
and ``anchor_generator``; the rest of the JAX file is ROADMAP item
13c.3.

``warpctc`` is the JAX package's log-space forward recursion, one step a
time step, with its constants (``_NEG``, the ``1e-38`` inside each log),
so the loss and the gradient autograd takes of it follow the
``lax.scan`` VJP.  ``edit_distance`` runs one row of the Levenshtein
table a step, where the JAX rule scans the table cell by cell.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register_op
from .detection_ops import clip, const
from .math_ops import _matmul_p

_NEG = -1e30


@register_op("row_conv")
def _row_conv(ctx, op):
    """misc_ops2.py:284: lookahead convolution, ``out[t] = sum_{j<K}
    x[t + j] * w[j]`` over X ``[B, T, D]`` zero-padded at the end;
    Filter ``[K, D]``."""
    x = ctx.i("X")
    w = ctx.i("Filter")
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, K - 1))
    ctx.set("Out", sum(xp[:, j:j + T] * w[j] for j in range(K)))


@register_op("lstm_unit")
def _lstm_unit(ctx, op):
    """misc_ops2.py:405: one LSTM cell step, X ``[B, 4D]`` in ``[i, f,
    c̃, o]`` order, C_prev ``[B, D]`` → C, H; ``forget_bias`` is added
    to f's pre-activation."""
    x = ctx.i("X")
    c_prev = ctx.i("C_prev")
    D = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :D])
    f = torch.sigmoid(x[:, D:2 * D] + float(ctx.attr("forget_bias", 0.0)))
    g = torch.tanh(x[:, 2 * D:3 * D])
    o = torch.sigmoid(x[:, 3 * D:])
    c = f * c_prev + i * g
    ctx.set("C", c)
    ctx.set("H", o * torch.tanh(c))


@register_op("gru_unit")
def _gru_unit(ctx, op):
    """misc_ops2.py:422: one GRU cell step, Input ``[B, 3D]``,
    HiddenPrev ``[B, D]``, Weight ``[D, 3D]``, Bias ``[1, 3D]`` →
    Gate ``[u, r, c̃]``, ResetHiddenPrev ``r·h``, Hidden."""
    x = ctx.i("Input")
    h_prev = ctx.i("HiddenPrev")
    w = ctx.i("Weight")
    bias = ctx.i_opt("Bias")
    D = h_prev.shape[-1]
    if bias is not None:
        x = x + bias.reshape(-1)
    g_ur = x[:, :2 * D] + _matmul_p(h_prev, w[:, :2 * D])
    u = torch.sigmoid(g_ur[:, :D])
    r = torch.sigmoid(g_ur[:, D:])
    c = torch.tanh(x[:, 2 * D:] + _matmul_p(r * h_prev, w[:, 2 * D:]))
    if ctx.attr("origin_mode", False):
        h = u * h_prev + (1 - u) * c
    else:
        h = (1 - u) * h_prev + u * c
    ctx.set("Gate", torch.cat([u, r, c], dim=1))
    ctx.set("ResetHiddenPrev", r * h_prev)
    ctx.set("Hidden", h)


def _logsumexp3(a1, a2, a3):
    """``m + log(exp(a1 − m) + exp(a2 − m) + exp(a3 − m) + 1e-38)``
    with ``m`` their maximum, as misc_ops2.py:497-499 and :513-514
    write it."""
    m = torch.maximum(torch.maximum(a1, a2), a3)
    return m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m) +
                         torch.exp(a3 - m) + 1e-38)


@register_op("warpctc", nondiff_inputs=("Label", "LogitsLength",
                                        "LabelLength"))
def _warpctc(ctx, op):
    """misc_ops2.py:448: the CTC loss.  Logits ``[B, T, C]``, Label
    ``[B, L]`` padded, LogitsLength and LabelLength ``[B]`` → Loss
    ``[B, 1]``: the alpha recursion in log space over the extended label
    ``blank, l1, blank, ..., lL, blank`` (S = 2L + 1), from step 1 on;
    a row past its LogitsLength keeps its alpha.  ``norm_by_times``
    divides each loss by ``max(LogitsLength, 1)``.  WarpCTCGrad is an
    unused slot of zeros, as in the JAX rule."""
    logits = ctx.i("Logits")
    label = ctx.i("Label").long()
    logit_len = ctx.i("LogitsLength").reshape(-1).long()
    label_len = ctx.i("LabelLength").reshape(-1).long()
    blank = int(ctx.attr("blank", 0))
    B, T, C = logits.shape
    S = 2 * label.shape[1] + 1
    dev = logits.device

    logp = torch.log_softmax(logits, dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    ext_valid = torch.arange(S, device=dev)[None, :] < \
        (2 * label_len + 1)[:, None]
    can_skip = torch.zeros((B, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])

    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)
    first = torch.where(label_len > 0,
                        torch.gather(logp[:, 0], 1, ext[:, 1:2])[:, 0], neg)
    alpha = torch.cat([logp[:, 0, blank:blank + 1], first[:, None],
                       neg.expand(B, S - 2)], dim=1)
    tmask = torch.arange(T, device=dev)[:, None] < logit_len[None, :]
    pad1, pad2 = neg.expand(B, 1), neg.expand(B, 2)
    for t in range(1, T):
        a2 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a3 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        emit = torch.gather(logp[:, t], 1, ext)
        new = torch.where(ext_valid, _logsumexp3(alpha, a2, a3) + emit, neg)
        alpha = torch.where(tmask[t][:, None], new, alpha)
    a_end1 = torch.gather(alpha, 1, (2 * label_len)[:, None])[:, 0]
    end2 = (2 * label_len - 1).clamp_min(0)
    a_end2 = torch.where(label_len > 0,
                         torch.gather(alpha, 1, end2[:, None])[:, 0], neg)
    m = torch.maximum(a_end1, a_end2)
    loss = -(m + torch.log(torch.exp(a_end1 - m) + torch.exp(a_end2 - m) +
                           1e-38))
    if ctx.attr("norm_by_times", False):
        loss = loss / logit_len.to(loss.dtype).clamp_min(1.0)
    ctx.set("Loss", loss[:, None])
    ctx.set("WarpCTCGrad", torch.zeros_like(logits))


@register_op("edit_distance", nondiff_inputs=("Hyps", "Refs", "HypsLength",
                                              "RefsLength"),
             stop_gradient=True)
def _edit_distance(ctx, op):
    """misc_ops2.py:522: the Levenshtein distance of padded int rows,
    Hyps ``[B, L1]`` against Refs ``[B, L2]``, read at column
    ``RefsLength`` after ``HypsLength`` rows of the table (divided by
    ``max(RefsLength, 1)`` when ``normalized``) → Out ``[B, 1]`` float32
    and SequenceNum.

    One table row a step, for the whole batch: with ``cand[0] = row[0] +
    1`` and ``cand[j] = min(row[j] + 1, row[j − 1] + cost[j − 1])``, the
    left-neighbour chain ``new[j] = min(new[j − 1] + 1, cand[j])`` is
    ``j + cummin_{k<=j}(cand[k] − k)``.  The values are integers held in
    float32, so the answer is exact."""
    hyp = ctx.i("Hyps").long()
    ref = ctx.i("Refs").long()
    hlen = ctx.i("HypsLength").reshape(-1).long()
    rlen = ctx.i("RefsLength").reshape(-1).long()
    B, L1 = hyp.shape
    L2 = ref.shape[1]
    k = torch.arange(L2 + 1, dtype=torch.float32, device=hyp.device)
    row = k.expand(B, L2 + 1)
    for i in range(L1):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)
        cand = torch.cat([row[:, :1] + 1.0, torch.minimum(
            row[:, 1:] + 1.0, row[:, :-1] + cost)], dim=1)
        new = k + torch.cummin(cand - k, dim=1).values
        row = torch.where((i < hlen)[:, None], new, row)
    d = torch.gather(row, 1, rlen[:, None])[:, 0]
    if ctx.attr("normalized", False):
        d = d / rlen.to(torch.float32).clamp_min(1.0)
    ctx.set("Out", d[:, None])
    ctx.set("SequenceNum", torch.tensor(B, dtype=torch.int64,
                                        device=hyp.device))


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@register_op("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, op):
    """misc_ops2.py:187: RetinaNet's focal loss of logits X ``[N, C]``
    against Label in ``1..C`` (0 background), over ``max(FgNum, 1)``."""
    x = ctx.i("X")
    label = ctx.i("Label").reshape(-1).long()
    fg = torch.clamp_min(ctx.i("FgNum").reshape(()).to(torch.float32), 1.0)
    gamma = ctx.attr("gamma", 2.0)
    alpha = ctx.attr("alpha", 0.25)
    C = x.shape[1]
    tgt = ((label - 1)[:, None] ==
           torch.arange(C, device=x.device)).to(x.dtype)
    p = torch.sigmoid(x)
    ce = torch.logaddexp(x, torch.zeros_like(x)) - x * tgt
    pos = tgt > 0
    pt = torch.where(pos, p, 1 - p)
    a = torch.where(pos, torch.full((), alpha, dtype=x.dtype,
                                    device=x.device),
                    torch.full((), 1 - alpha, dtype=x.dtype, device=x.device))
    ctx.set("Out", a * (1 - pt) ** gamma * ce / fg)


def _iou_pair(x, y):
    """misc_ops2.py:326: IoU of every box of x ``[N, 4]`` against every
    box of y ``[M, 4]`` (no +1)."""
    ix1 = torch.maximum(x[:, None, 0], y[None, :, 0])
    iy1 = torch.maximum(x[:, None, 1], y[None, :, 1])
    ix2 = torch.minimum(x[:, None, 2], y[None, :, 2])
    iy2 = torch.minimum(x[:, None, 3], y[None, :, 3])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1, zero)
    ax = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    ay = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    return inter / torch.maximum(ax[:, None] + ay[None, :] - inter,
                                 torch.full((), 1e-10, dtype=x.dtype,
                                            device=x.device))


@register_op("iou_similarity", nondiff_inputs=("Y",))
def _iou_similarity(ctx, op):
    """misc_ops2.py:339: X ``[N, 4]`` against Y ``[M, 4]`` → ``[N, M]``,
    or the padded batch slab ``[B, N, 4]`` → ``[B, N, M]``."""
    x, y = ctx.i("X"), ctx.i("Y")
    if x.dim() == 3:
        B, N = x.shape[:2]
        ctx.set("Out", _iou_pair(x.reshape(-1, 4), y).reshape(B, N, -1))
        return
    ctx.set("Out", _iou_pair(x, y))


@register_op("box_clip", nondiff_inputs=("ImInfo",))
def _box_clip(ctx, op):
    """misc_ops2.py:350: boxes ``[..., 4]`` clipped into the first
    image's ``[0, h / scale - 1] x [0, w / scale - 1]``."""
    boxes, im = ctx.i("Input"), ctx.i("ImInfo")
    h = im[0, 0] / im[0, 2] - 1
    w = im[0, 1] / im[0, 2] - 1
    ctx.set("Output", torch.stack(
        [clip(boxes[..., 0], 0.0, w), clip(boxes[..., 1], 0.0, h),
         clip(boxes[..., 2], 0.0, w), clip(boxes[..., 3], 0.0, h)], dim=-1))


@register_op("anchor_generator", stop_gradient=True)
def _anchor_generator(ctx, op):
    """misc_ops2.py:363: Faster R-CNN anchors ``[H, W, A, 4]`` and their
    variances: ratio = h / w, base sizes rounded half up, scaled by
    size / stride per axis, (size - 1) pixel corners, centres at ``idx ·
    stride + offset · (stride - 1)``."""
    feat = ctx.i("Input")
    dev = feat.device
    H, W = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in ctx.attr("anchor_sizes")]
    ratios = [float(r) for r in ctx.attr("aspect_ratios")]
    stride = [float(s) for s in ctx.attr("stride")]
    variances = [float(v) for v in
                 ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    offset = ctx.attr("offset", 0.5)
    area = stride[0] * stride[1]
    whs = []
    for r in ratios:
        base_w = np.floor(np.sqrt(area / r) + 0.5)
        base_h = np.floor(base_w * r + 0.5)
        for s in sizes:
            whs.append(((s / stride[0]) * base_w, (s / stride[1]) * base_h))
    A = len(whs)
    wh = const(np.asarray(whs, np.float32), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cx = torch.arange(W, **f32) * stride[0] + offset * (stride[0] - 1)
    cy = torch.arange(H, **f32) * stride[1] + offset * (stride[1] - 1)
    cxg = cx[None, :, None].expand(H, W, A)
    cyg = cy[:, None, None].expand(H, W, A)
    hw = 0.5 * (wh[None, None, :, 0] - 1)
    hh = 0.5 * (wh[None, None, :, 1] - 1)
    ctx.set("Anchors", torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh],
                                   dim=-1))
    ctx.set("Variances", const(np.asarray(variances, np.float32), dev)
            .expand(H, W, A, 4).contiguous())
