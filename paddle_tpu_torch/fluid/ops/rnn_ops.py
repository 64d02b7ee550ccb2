"""The fused recurrent ops over padded batches (counterpart
``paddle_tpu/fluid/ops/rnn_ops.py``): ``lstm`` and ``gru``, with their
recurrences ``lstm_core`` and ``gru_core``.

Where the JAX package runs each recurrence as one ``lax.scan``, the port
runs it as a Python loop over the time axis of plain torch ops: one
``[B, D] x [D, 4D]`` product a step for the LSTM, one ``[B, D] x [D, 2D]``
and one ``[B, D] x [D, D]`` for the GRU; the grad op differentiates the
unrolled loop that the forward left on the tape.  No Pallas kernel
carries the JAX recurrences, so no hand-written kernel carries these.

The gate layouts are the reference kernels': LSTM ``[c̃, i, f, o]``
(``lstm_kernel.h``), GRU ``[u, r, c̃]`` with the weight ``[D, 2D]``
(update|reset) beside ``[D, D]`` (candidate) (``gru_kernel.h``).
``Length`` takes no gradient; a step at ``t >= length[b]`` keeps that
row's state and emits zeros, and ``is_reverse`` runs each sequence
backwards within its own length.
"""
import torch

from ..registry import register_op
from .math_ops import _matmul_p

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name):
    try:
        return _ACTS[name]
    except KeyError:
        raise NotImplementedError("rnn activation %r" % name)


def _seq_reverse(x, lengths):
    """x ``[B, T, ...]`` with the valid prefix of each row reversed
    (rnn_ops.py:49); the padding stays where it is."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < lengths[:, None], lengths[:, None] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def split_lstm_bias(bias, D, use_peepholes):
    """(gate bias [4D] or None, w_ic, w_fc, w_oc): the peephole slices
    come from the extended ``[1, 7D]`` bias when ``use_peepholes``
    (rnn_ops.py:65)."""
    if bias is None:
        return None, None, None, None
    b = bias.reshape(-1)
    w_ic = w_fc = w_oc = None
    if use_peepholes and b.shape[0] >= 7 * D:
        w_ic, w_fc, w_oc = b[4 * D:5 * D], b[5 * D:6 * D], b[6 * D:7 * D]
    return b[:4 * D], w_ic, w_fc, w_oc


def lstm_core(x, w, lengths, h0, c0, is_reverse=False, w_ic=None,
              w_fc=None, w_oc=None, act_gate=torch.sigmoid,
              act_cell=torch.tanh, act_cand=torch.tanh):
    """The LSTM recurrence over pre-projected gates x ``[B, T, 4D]``
    (rnn_ops.py:80): (hidden, cell), each ``[B, T, D]``."""
    B, T, four_d = x.shape
    D = four_d // 4
    if is_reverse:
        x = _seq_reverse(x, lengths)
    tmask = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
    w = w.to(x.dtype)
    h_prev, c_prev = h0, c0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hs, cs = [], []
    for t in range(T):
        g = x[:, t] + _matmul_p(h_prev, w)
        ga, gi, gf, go = (g[:, :D], g[:, D:2 * D], g[:, 2 * D:3 * D],
                          g[:, 3 * D:])
        if w_ic is not None:
            gi = gi + w_ic * c_prev
            gf = gf + w_fc * c_prev
        c = act_cand(ga) * act_gate(gi) + c_prev * act_gate(gf)
        if w_oc is not None:
            go = go + w_oc * c
        h = act_gate(go) * act_cell(c)
        m = tmask[t][:, None]
        h_prev = torch.where(m, h, h_prev)
        c_prev = torch.where(m, c, c_prev)
        hs.append(torch.where(m, h, zero))
        cs.append(torch.where(m, c, zero))
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        hidden = _seq_reverse(hidden, lengths)
        cell = _seq_reverse(cell, lengths)
    return hidden, cell


@register_op("lstm", nondiff_inputs=("Length",))
def _lstm(ctx, op):
    """dynamic_lstm (rnn_ops.py:125): Input ``[B, T, 4D]``, Weight
    ``[D, 4D]``, Bias ``[1, 4D]`` (``[1, 7D]`` with the peepholes, the
    default), optional H0/C0 ``[B, D]`` → Hidden, Cell ``[B, T, D]``."""
    x = ctx.i("Input")
    w = ctx.i("Weight")
    bias = ctx.i_opt("Bias")
    ln = ctx.i("Length")
    lengths = (ln.reshape(ln.shape[0]) if ln.dim() > 1 else ln).long()
    B, T, four_d = x.shape
    D = four_d // 4
    gate_b, w_ic, w_fc, w_oc = split_lstm_bias(
        bias, D, ctx.attr("use_peepholes", True))
    if gate_b is not None:
        x = x + gate_b.to(x.dtype)
    h0 = ctx.i_opt("H0")
    c0 = ctx.i_opt("C0")
    zeros = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    h0 = zeros if h0 is None else h0.to(x.dtype)
    c0 = zeros if c0 is None else c0.to(x.dtype)
    hidden, cell = lstm_core(
        x, w, lengths, h0, c0, is_reverse=ctx.attr("is_reverse", False),
        w_ic=w_ic, w_fc=w_fc, w_oc=w_oc,
        act_gate=_act(ctx.attr("gate_activation", "sigmoid")),
        act_cell=_act(ctx.attr("cell_activation", "tanh")),
        act_cand=_act(ctx.attr("candidate_activation", "tanh")))
    ctx.set("Hidden", hidden)
    ctx.set("Cell", cell)


@register_op("gru", nondiff_inputs=("Length",))
def _gru(ctx, op):
    """dynamic_gru (rnn_ops.py:159): Input ``[B, T, 3D]``, Weight
    ``[D, 3D]``, Bias ``[1, 3D]``, optional H0 ``[B, D]`` → Hidden
    ``[B, T, D]``."""
    x = ctx.i("Input")
    w = ctx.i("Weight")
    bias = ctx.i_opt("Bias")
    ln = ctx.i("Length")
    lengths = (ln.reshape(ln.shape[0]) if ln.dim() > 1 else ln).long()
    B, T, three_d = x.shape
    D = three_d // 3
    if bias is not None:
        x = x + bias.reshape(-1).to(x.dtype)
    h0 = ctx.i_opt("H0")
    h0 = torch.zeros((B, D), dtype=x.dtype, device=x.device) \
        if h0 is None else h0.to(x.dtype)
    ctx.set("Hidden", gru_core(
        x, w, lengths, h0, is_reverse=ctx.attr("is_reverse", False),
        origin_mode=ctx.attr("origin_mode", False),
        act_gate=_act(ctx.attr("gate_activation", "sigmoid")),
        act_cand=_act(ctx.attr("activation", "tanh"))))


def gru_core(x, w, lengths, h0, is_reverse=False, origin_mode=False,
             act_gate=torch.sigmoid, act_cand=torch.tanh):
    """The GRU recurrence over pre-projected gates x ``[B, T, 3D]``
    (rnn_ops.py:185): ``u, r = act_gate(x_ur + h W_ur)``, ``c̃ =
    act_cand(x_c + (r h) W_c)``, then ``h = (1 − u) h + u c̃``, or
    ``u h + (1 − u) c̃`` with ``origin_mode``.  Hidden ``[B, T, D]``."""
    B, T, three_d = x.shape
    D = three_d // 3
    if is_reverse:
        x = _seq_reverse(x, lengths)
    w = w.to(x.dtype)
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    tmask = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h_prev, hs = h0, []
    for t in range(T):
        xt = x[:, t]
        g_ur = xt[:, :2 * D] + _matmul_p(h_prev, w_ur)
        u = act_gate(g_ur[:, :D])
        r = act_gate(g_ur[:, D:])
        c = act_cand(xt[:, 2 * D:] + _matmul_p(r * h_prev, w_c))
        if origin_mode:
            h = u * h_prev + (1.0 - u) * c
        else:
            h = (1.0 - u) * h_prev + u * c
        m = tmask[t][:, None]
        h_prev = torch.where(m, h, h_prev)
        hs.append(torch.where(m, h, zero))
    hidden = torch.stack(hs, dim=1)
    if is_reverse:
        hidden = _seq_reverse(hidden, lengths)
    return hidden
