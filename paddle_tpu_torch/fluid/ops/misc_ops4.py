"""The op zoo's fourth batch (counterpart ``paddle_tpu/fluid/ops/
misc_ops4.py``), so far ``add_position_encoding``, ``ctc_align`` (the
collapse step of ``ctc_greedy_decoder``), ``lstmp`` and ``psroi_pool``;
the rest of the JAX file is ROADMAP item 13c.3.

``lstmp`` keeps two properties of the JAX rule: it adds only the first
4D entries of its Bias (peephole entries past them are ignored), and its
recurrent Weight is ``[P, 4D]``, acting on the previous projection.
"""

import numpy as np
import torch

from ..registry import register_op
from .math_ops import _matmul_p
from .detection_ops import round_half_up
from .rnn_ops import _act, _seq_reverse


@register_op("add_position_encoding")
def _add_position_encoding(ctx, op):
    """misc_ops4.py:142: ``alpha·x + beta·pe`` for X ``[B, T, D]``, the
    reference's table: sin in the first half of the features, cos in
    the second (not interleaved), angle ``t / 10000^(k / (D/2 − 1))``.
    An odd D raises."""
    x = ctx.i("X")
    alpha = float(np.float32(ctx.attr("alpha", 1.0)))
    beta = float(np.float32(ctx.attr("beta", 1.0)))
    B, T, D = x.shape
    if D % 2 != 0:
        raise ValueError(
            "add_position_encoding only supports an even encode size, got "
            "%d (reference PADDLE_ENFORCE 'Only support even encode size!')"
            % D)
    half = D // 2
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    if half > 1:
        div = torch.pow(10000.0, torch.arange(
            half, dtype=torch.float32, device=x.device) / (half - 1))
    else:
        div = torch.full((half,), 10000.0, dtype=torch.float32,
                         device=x.device)
    ang = pos / div
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    ctx.set("Out", alpha * x + beta * pe[None].to(x.dtype))


@register_op("ctc_align", nondiff_inputs=("Input", "Length"),
             stop_gradient=True)
def _ctc_align(ctx, op):
    """misc_ops4.py:170: the CTC greedy collapse of argmax ids Input
    ``[B, T]``: repeats merged, ``blank`` dropped, the survivors packed
    to the front (Output int64, zeros after) with their count
    (OutputLength).  Dropped entries go to trash column T of a ``T + 1``
    buffer, sliced off."""
    x = ctx.i("Input").long()
    ln = ctx.i("Length").reshape(-1).long()
    blank = int(ctx.attr("blank", 0))
    B, T = x.shape
    valid = torch.arange(T, device=x.device)[None, :] < ln[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], dim=1)
    keep = valid & (x != blank) & (x != prev)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                      torch.full((), T, device=x.device))
    out = x.new_zeros((B, T + 1)).scatter(1, pos, x)
    ctx.set("Output", out[:, :T])
    ctx.set("OutputLength", keep.sum(dim=1).to(torch.int64))


@register_op("lstmp", nondiff_inputs=("Length",))
def _lstmp(ctx, op):
    """misc_ops4.py:211: the LSTM with a projection, Input ``[B, T,
    4D]`` (gates ``[c̃, i, f, o]``), Weight ``[P, 4D]`` on the previous
    projection, ProjWeight ``[D, P]``: ``h = act_proj((o·act_cell(c))
    ProjWeight)`` → Projection ``[B, T, P]``, Cell ``[B, T, D]``, from
    zero states."""
    x = ctx.i("Input")
    w = ctx.i("Weight")
    proj = ctx.i("ProjWeight")
    bias = ctx.i_opt("Bias")
    lengths = ctx.i("Length").reshape(-1).long()
    B, T, four_d = x.shape
    D = four_d // 4
    act_gate = _act(ctx.attr("gate_activation", "sigmoid"))
    act_cell = _act(ctx.attr("cell_activation", "tanh"))
    act_cand = _act(ctx.attr("candidate_activation", "tanh"))
    act_proj = _act(ctx.attr("proj_activation", "identity"))
    is_reverse = ctx.attr("is_reverse", False)
    if bias is not None:
        x = x + bias.reshape(-1)[:4 * D].to(x.dtype)
    if is_reverse:
        x = _seq_reverse(x, lengths)
    w, proj = w.to(x.dtype), proj.to(x.dtype)
    tmask = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h_prev = torch.zeros((B, proj.shape[1]), dtype=x.dtype, device=x.device)
    c_prev = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    hs, cs = [], []
    for t in range(T):
        g = x[:, t] + _matmul_p(h_prev, w)
        a = act_cand(g[:, :D])
        i = act_gate(g[:, D:2 * D])
        f = act_gate(g[:, 2 * D:3 * D])
        o = act_gate(g[:, 3 * D:])
        c = a * i + c_prev * f
        h = act_proj(_matmul_p(o * act_cell(c), proj))
        m = tmask[t][:, None]
        h_prev = torch.where(m, h, h_prev)
        c_prev = torch.where(m, c, c_prev)
        hs.append(torch.where(m, h, zero))
        cs.append(torch.where(m, c, zero))
    proj_out = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        proj_out = _seq_reverse(proj_out, lengths)
        cell = _seq_reverse(cell, lengths)
    ctx.set("Projection", proj_out)
    ctx.set("Cell", cell)


@register_op("psroi_pool", nondiff_inputs=("ROIs", "RoisBatchId"))
def _psroi_pool(ctx, op):
    """misc_ops4.py:314: position-sensitive ROI pooling: input channels
    ``out_C · ph · pw``, bin (i, j) the mean of its own channel group over
    the bin's pixels (coordinates rounded half up, ``+1`` end, then
    scaled)."""
    x = ctx.i("X")
    rois = ctx.i("ROIs").to(torch.float32)
    bid = ctx.i_opt("RoisBatchId")
    R = rois.shape[0]
    dev = x.device
    bid = torch.zeros(R, dtype=torch.long, device=dev) if bid is None \
        else bid.reshape(-1).long()
    ph = int(ctx.attr("pooled_height"))
    pw = int(ctx.attr("pooled_width"))
    out_c = int(ctx.attr("output_channels"))
    scale = ctx.attr("spatial_scale", 1.0)
    N, C, H, W = x.shape
    r = round_half_up(rois)
    x1, y1 = (r[:, 0] * scale)[:, None], (r[:, 1] * scale)[:, None]
    x2, y2 = ((r[:, 2] + 1.0) * scale)[:, None], \
        ((r[:, 3] + 1.0) * scale)[:, None]
    lo = torch.full((), 0.1, device=dev)
    rw = torch.maximum(x2 - x1, lo)
    rh = torch.maximum(y2 - y1, lo)
    i = torch.arange(ph, device=dev)[None, :]
    j = torch.arange(pw, device=dev)[None, :]
    hs, he = y1 + i * rh / ph, y1 + (i + 1) * rh / ph
    ws, we = x1 + j * rw / pw, x1 + (j + 1) * rw / pw
    hi = torch.arange(H, dtype=torch.float32, device=dev)
    wi = torch.arange(W, dtype=torch.float32, device=dev)
    mh = (hi >= torch.floor(hs)[..., None]) & (hi < torch.ceil(he)[..., None])
    mw = (wi >= torch.floor(ws)[..., None]) & (wi < torch.ceil(we)[..., None])
    m = (mh[:, :, None, :, None] & mw[:, None, :, None, :]).to(torch.float32)
    cnt = torch.clamp_min(m.sum(dim=(-2, -1)), 1.0)         # [R, ph, pw]
    img = x[bid].reshape(R, out_c, ph, pw, H, W)
    v = (img * m[:, None]).sum(dim=(-2, -1)) / cnt[:, None]
    ctx.set("Out", v.to(x.dtype))
