"""The op zoo's second batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops2.py``): the 3-D vision ops (``conv3d``, ``conv3d_transpose``,
``pool3d``), ``lrn``, ``selu``, the losses and distances
(``hinge_loss``, ``modified_huber_loss``, ``squared_l2_distance``,
``l1_norm``, ``norm``, ``teacher_student_sigmoid_loss``), the CTR ops
(``bilinear_tensor_product``, ``cvm``), ``label_smooth``, the shape ops
(``crop``, ``pad_constant_like``, ``unfold``, ``size``, ``minus``),
``mean_iou``; its sequence, RNN-cell and CTC ops (``row_conv``,
``lstm_unit``, ``gru_unit``, ``warpctc``, ``edit_distance``) and its
detection ops (``sigmoid_focal_loss``, ``iou_similarity``, ``box_clip``,
``anchor_generator``).

The 3-D convolutions are library convolutions (cuDNN on the card), as
the JAX rules leave theirs to XLA; ``pool3d`` pads explicitly (with
``-inf`` for max, zeros for the average, which divides by the whole
window) so that any padding the JAX rule takes is taken here; ``lrn``
is the JAX formula, not ``F.local_response_norm`` (whose ``alpha`` is
divided by ``n``).

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
from .math_ops import _abs, _full, _matmul_p, _softplus

_NEG = -1e30


# ---------------------------------------------------------------------------
# 3-D vision
# ---------------------------------------------------------------------------

@register_op("conv3d")
def _conv3d(ctx, op):
    """misc_ops2.py:31: NCDHW Input by Filter ``[O, C/groups, kd, kh,
    kw]`` with symmetric ``paddings``."""
    x = ctx.i("Input")
    ctx.set("Output", F.conv3d(
        x, ctx.i("Filter").to(x.dtype), None,
        tuple(ctx.attr("strides", [1, 1, 1])),
        tuple(ctx.attr("paddings", [0, 0, 0])),
        tuple(ctx.attr("dilations", [1, 1, 1])), ctx.attr("groups", 1) or 1))


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, op):
    """misc_ops2.py:47: the transposed convolution of NCDHW Input by
    Filter ``[C_in, C_out/groups, kd, kh, kw]`` (the layout
    ``F.conv_transpose3d`` shares), output side ``(D − 1) s − 2 p + d (k −
    1) + 1``, as the JAX rule's dilated forward conv of the flipped
    filter gives it."""
    x = ctx.i("Input")
    ctx.set("Output", F.conv_transpose3d(
        x, ctx.i("Filter").to(x.dtype), None,
        tuple(ctx.attr("strides", [1, 1, 1])),
        tuple(ctx.attr("paddings", [0, 0, 0])), 0,
        ctx.attr("groups", 1) or 1, tuple(ctx.attr("dilations", [1, 1, 1]))))


@register_op("pool3d")
def _pool3d(ctx, op):
    """misc_ops2.py:77: max (padded with ``-inf``) or average (padded
    with zeros, divided by the whole window, padding included) over
    ``ksize`` windows; ``global_pooling`` takes the whole map, stride 1,
    no padding."""
    x = ctx.i("X")
    ksize = tuple(ctx.attr("ksize", [2, 2, 2]))
    strides = tuple(ctx.attr("strides", [1, 1, 1]))
    pads = tuple(ctx.attr("paddings", [0, 0, 0]))
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = tuple(x.shape[2:]), (1, 1, 1), (0, 0, 0)
    widths = (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0])
    if ctx.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(F.pad(x, widths, value=float("-inf")), ksize,
                           strides)
    else:
        s = F.avg_pool3d(F.pad(x, widths), ksize, strides,
                         divisor_override=1)
        out = s / _full(float(np.prod(ksize)), s)
    ctx.set("Out", out)


# ---------------------------------------------------------------------------
# norms / activations / losses
# ---------------------------------------------------------------------------

@register_op("lrn")
def _lrn(ctx, op):
    """misc_ops2.py:105: ``x / (k + alpha·Σ x²)^beta``, the sum over the
    ``n`` channels centred on each (zero-padded), alpha not divided by
    n; MidOut is ``k + alpha·Σ x²``.  The op's default k is 2.0; the
    layer passes 1.0."""
    x = ctx.i("X")
    n = ctx.attr("n", 5)
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    den = sum(pad[:, i:i + x.shape[1]] for i in range(n))
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * den
    ctx.set("Out", x / mid ** ctx.attr("beta", 0.75))
    ctx.set("MidOut", mid)


@register_op("selu")
def _selu(ctx, op):
    """misc_ops2.py:122: ``scale·where(x > 0, x, alpha·(exp(x) − 1))``."""
    x = ctx.i("X")
    alpha = ctx.attr("alpha", 1.6732632423543772)
    ctx.set("Out", ctx.attr("scale", 1.0507009873554805) * torch.where(
        x > 0, x, alpha * (torch.exp(x) - 1)))


@register_op("hinge_loss", nondiff_inputs=("Labels",))
def _hinge_loss(ctx, op):
    """misc_ops2.py:130: ``max(0, 1 − (2·label − 1)·logit)``."""
    logits = ctx.i("Logits")
    v = 1.0 - (2.0 * ctx.i("Labels") - 1.0) * logits
    ctx.set("Loss", torch.maximum(torch.zeros_like(v), v))


@register_op("modified_huber_loss", nondiff_inputs=("Y",))
def _modified_huber(ctx, op):
    """misc_ops2.py:138: on ``s = (2y − 1)·x``, ``−4s`` below −1, else
    ``max(0, 1 − s)²``; IntermediateVal is s."""
    x = ctx.i("X")
    s = (2.0 * ctx.i("Y") - 1.0) * x
    one = 1.0 - s
    ctx.set("Out", torch.where(s < -1.0, -4.0 * s, torch.square(
        torch.maximum(torch.zeros_like(one), one))))
    ctx.set("IntermediateVal", s)


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, op):
    """misc_ops2.py:149: sub_result ``X − Y`` and Out its squares summed
    over every axis but the first (kept as 1s)."""
    d = ctx.i("X") - ctx.i("Y")
    ctx.set("sub_result", d)
    ctx.set("Out", torch.sum(torch.square(d), dim=tuple(range(1, d.dim())),
                             keepdim=True) if d.dim() > 1 else torch.square(d))


@register_op("l1_norm")
def _l1_norm(ctx, op):
    """misc_ops2.py:160: ``Σ |x|`` (``|x|``'s gradient +1 at 0, as
    ``jnp.abs``'s)."""
    ctx.set("Out", torch.sum(_abs(ctx.i("X"))))


@register_op("norm")
def _norm(ctx, op):
    """misc_ops2.py:165: X over ``sqrt(Σ x² + eps)`` along ``axis``, and
    that Norm."""
    x = ctx.i("X")
    n = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", 1),
                             keepdim=True) + ctx.attr("epsilon", 1e-10))
    ctx.set("Out", x / n)
    ctx.set("Norm", n)


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op):
    """misc_ops2.py:175: ``out[b, s] = x[b]·W[s]·y[b]`` (X ``[B, M]``, Y
    ``[B, N]``, Weight ``[S, M, N]``) plus Bias ``[1, S]``."""
    x, y, w = ctx.i("X"), ctx.i("Y"), ctx.i("Weight")
    S, M, N = w.shape
    xw = _matmul_p(x, w.permute(1, 0, 2).reshape(M, S * N))   # [B, S*N]
    out = torch.sum(xw.reshape(-1, S, N) * y[:, None, :], dim=-1)
    bias = ctx.i_opt("Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    ctx.set("Out", out)


@register_op("teacher_student_sigmoid_loss", nondiff_inputs=("Label",))
def _ts_sigmoid_loss(ctx, op):
    """misc_ops2.py:204, the CTR distillation loss: ``softplus(x)`` for a
    label below −1 (no teacher, no click), ``softplus(x) − x`` in ``[−1,
    0)`` (no teacher, click), ``2·softplus(x) − x·label`` from 0 (the
    teacher's score in the fraction): Y ``[N, 1]``."""
    x = ctx.i("X").reshape(-1)
    label = ctx.i("Label").reshape(-1)
    sp = _softplus(x)
    y = torch.where(label < -1.0, sp,
                    torch.where(label < 0.0, sp - x, 2.0 * sp - x * label))
    ctx.set("Y", y[:, None])


@register_op("cvm", nondiff_inputs=("CVM",))
def _cvm(ctx, op):
    """misc_ops2.py:222: with ``use_cvm``, the show and click columns of
    X ``[B, D]`` become ``log(max(show, 0) + 1)`` and ``log(max(click, 0)
    + 1)`` minus that; without it they are dropped."""
    x = ctx.i("X")
    if not ctx.attr("use_cvm", True):
        ctx.set("Y", x[:, 2:])
        return
    head = x[:, :2]
    logs = torch.log(torch.maximum(head, torch.zeros_like(head)) + 1.0)
    show = logs[:, :1]
    ctx.set("Y", torch.cat([show, logs[:, 1:2] - show, x[:, 2:]], dim=1))


@register_op("label_smooth", nondiff_inputs=("PriorDist",))
def _label_smooth(ctx, op):
    """misc_ops2.py:236: ``(1 − eps)·x + eps·prior``, the prior uniform
    ``1 / C`` without PriorDist."""
    x = ctx.i("X")
    eps = ctx.attr("epsilon", 0.1)
    prior = ctx.i_opt("PriorDist")
    if prior is not None:
        ctx.set("Out", (1 - eps) * x + eps * prior.reshape(
            (1,) * (x.dim() - 1) + (-1,)))
    else:
        ctx.set("Out", (1 - eps) * x + eps / x.shape[-1])


# ---------------------------------------------------------------------------
# shape / misc
# ---------------------------------------------------------------------------

@register_op("crop")
def _crop(ctx, op):
    """misc_ops2.py:252, ``lax.dynamic_slice``: a block of ``shape`` from
    ``offsets``, each offset clamped so the block stays inside X."""
    x = ctx.i("X")
    index = tuple(slice(o, o + s) for o, s in (
        (min(max(int(o), 0), d - s), s) for o, s, d in zip(
            ctx.attr("offsets"), ctx.attr("shape"), x.shape)))
    ctx.set("Out", x[index])


@register_op("pad_constant_like", nondiff_inputs=("X",))
def _pad_constant_like(ctx, op):
    """misc_ops2.py:260: Y padded at the end of every axis to X's shape
    with ``pad_value``."""
    big, small = ctx.i("X"), ctx.i("Y")
    widths = []
    for b, s in reversed(list(zip(big.shape, small.shape))):
        widths += [0, b - s]
    ctx.set("Out", F.pad(small, widths,
                         value=float(ctx.attr("pad_value", 0.0))))


@register_op("unfold")
def _unfold(ctx, op):
    """misc_ops2.py:269: the sliding blocks of NCHW X, ``[N, C·kh·kw,
    L]`` in channel-major order; ``paddings`` ``[top, left, bottom,
    right]``."""
    x = ctx.i("X")
    p = ctx.attr("paddings", [0, 0, 0, 0])
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    ctx.set("Y", F.unfold(xp, tuple(ctx.attr("kernel_sizes")),
                          dilation=tuple(ctx.attr("dilations", [1, 1])),
                          stride=tuple(ctx.attr("strides", [1, 1]))))


@register_op("size", stop_gradient=True)
def _size(ctx, op):
    """misc_ops2.py:297: Input's element count, an int64 scalar (the JAX
    rule's int64 is int32 with x64 off), a constant copied to the card
    once."""
    ctx.set("Out", const(np.asarray(ctx.i("Input").numel(), np.int64),
                         ctx.state.device).reshape(()))


@register_op("minus")
def _minus(ctx, op):
    """misc_ops2.py:303: ``X − Y``."""
    ctx.set("Out", ctx.i("X") - ctx.i("Y"))


def _class_counts(idx, values, C):
    """``zeros(C).at[idx].add(values)``: an index out of ``[−C, C)`` is
    dropped (into a trash slot), a negative one counts from the end."""
    idx = torch.where(idx < 0, idx + C, idx)
    idx = torch.where((idx < 0) | (idx >= C), torch.full_like(idx, C), idx)
    out = torch.zeros(C + 1, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx, values)[:C]


@register_op("mean_iou", nondiff_inputs=("Predictions", "Labels"),
             stop_gradient=True)
def _mean_iou(ctx, op):
    """misc_ops2.py:308: per class, the intersection (right
    predictions), the union (predicted + labelled − intersection); the
    mean IoU over the classes with a union; OutWrong and OutCorrect int32
    per class."""
    pred = ctx.i("Predictions").reshape(-1).long()
    lab = ctx.i("Labels").reshape(-1).long()
    C = int(ctx.attr("num_classes"))
    hit = pred == lab
    inter = _class_counts(torch.where(hit, pred, torch.full_like(pred, C - 1)),
                          hit.to(torch.float32), C)
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    area_p = _class_counts(pred, ones, C)
    union = area_p + _class_counts(lab, ones, C) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1.0), 0.0)
    ctx.set("OutMeanIou", iou.sum() / torch.clamp_min(valid.sum(), 1))
    ctx.set("OutWrong", (area_p - inter).to(torch.int32))
    ctx.set("OutCorrect", inter.to(torch.int32))


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
