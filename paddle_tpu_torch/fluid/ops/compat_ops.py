"""Structural ops the executor subsumes (``feed``/``fetch``,
``listen_and_serv``) and ``cudnn_lstm`` (counterpart
``paddle_tpu/fluid/ops/compat_ops.py``).  The executor binds feeds and
reads fetches itself; the lowerings exist so programs that carry these
ops still run."""

import torch

from ..registry import register_op
from .math_ops import _matmul_p


@register_op("feed", stop_gradient=True)
def _feed(ctx, op):
    v = ctx.i_opt("X")
    if v is not None:
        ctx.set("Out", v)


@register_op("fetch", stop_gradient=True)
def _fetch(ctx, op):
    v = ctx.i_opt("X")
    if v is not None:
        ctx.set("Out", v)


@register_op("listen_and_serv", stop_gradient=True)
def _listen_and_serv(ctx, op):
    """The executor intercepts pserver programs (the ``_ps_endpoint``
    metadata get_pserver_program sets) before planning them and blocks in
    ``distributed.ps.ParameterServer`` (JAX compat_ops.py:162); this rule
    only exists so a cloned or serialized pserver program still runs: a
    no-op in the graph."""


def _cudnn_lstm_weights(w_flat, in_size, H, layers, ndir):
    """Slices of the flat blob in cuDNN's canonical order: every (layer,
    direction)'s ``W_i [4H, in]`` and ``W_h [4H, H]`` first, then every
    (layer, direction)'s ``b_i [4H]`` and ``b_h [4H]`` (compat_ops.py:
    52-71).  ``[layer][direction] -> [W_i, W_h, b_i, b_h]``."""
    off = [0]

    def take(shape):
        n = 1
        for s in shape:
            n *= s
        start = off[0]
        off[0] = start + n
        return w_flat[start:start + n].reshape(shape)

    weights = []
    for layer in range(layers):
        il = in_size if layer == 0 else H * ndir
        weights.append([[take((4 * H, il)), take((4 * H, H)), None, None]
                        for _ in range(ndir)])
    for layer in range(layers):
        for d in range(ndir):
            weights[layer][d][2] = take((4 * H,))
            weights[layer][d][3] = take((4 * H,))
    return weights


def _cudnn_lstm_dir(inp, w_i, w_h, b_i, b_h, h0, c0, reverse):
    """One direction of one layer over time-major ``inp [T, B, in]``,
    gates ``i|f|c̃|o``: (outputs ``[T, B, H]``, last h, last c)."""
    H = h0.shape[-1]
    seq = torch.flip(inp, [0]) if reverse else inp
    w_i_t, w_h_t = w_i.t(), w_h.t()
    h, c, hs = h0, c0, []
    for t in range(seq.shape[0]):
        g = _matmul_p(seq[t], w_i_t) + _matmul_p(h, w_h_t) + b_i + b_h
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        cand = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * cand
        h = o * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs)
    if reverse:
        hs = torch.flip(hs, [0])
    return hs, h, c


@register_op("cudnn_lstm", nondiff_inputs=("W",))
def _cudnn_lstm(ctx, op):
    """compat_ops.py:29: a stacked, optionally bidirectional LSTM over a
    time-major Input ``[T, B, I]`` in float32, every weight in one flat
    blob W (cuDNN's order, ``_cudnn_lstm_weights``), gates ``i|f|c̃|o``
    (not the ``lstm`` op's ``[c̃, i, f, o]``), InitH/InitC ``[L·dir, B,
    H]`` → Out ``[T, B, H·dir]``, last_h, last_c.  A plain loop, as
    ``lstm_core`` is, not cuDNN's kernel: W takes no gradient, as in the
    JAX rule, and training dropout between layers draws from the op's
    generator."""
    x = ctx.i("Input").to(torch.float32)
    init_h = ctx.i("InitH").to(torch.float32)
    init_c = ctx.i("InitC").to(torch.float32)
    w_flat = ctx.i("W").to(torch.float32).reshape(-1)
    H = int(ctx.attr("hidden_size"))
    layers = int(ctx.attr("num_layers", 1))
    ndir = 2 if ctx.attr("is_bidirec", False) else 1
    weights = _cudnn_lstm_weights(
        w_flat, int(ctx.attr("input_size", x.shape[-1])), H, layers, ndir)
    dropout_p = float(ctx.attr("dropout_prob", 0.0))
    training = not (ctx.attr("is_test", False) or ctx.state.is_test)
    gen = ctx.generator() if dropout_p > 0 and training else None
    out, last_h, last_c = x, [], []
    for layer in range(layers):
        if layer > 0 and gen is not None:
            keep = torch.rand(out.shape, generator=gen,
                              device=out.device) >= dropout_p
            out = torch.where(keep, out / (1.0 - dropout_p),
                              torch.zeros((), device=out.device))
        dirs = []
        for d in range(ndir):
            hs, hT, cT = _cudnn_lstm_dir(
                out, *weights[layer][d], init_h[layer * ndir + d],
                init_c[layer * ndir + d], d == 1)
            dirs.append(hs)
            last_h.append(hT)
            last_c.append(cT)
        out = dirs[0] if ndir == 1 else torch.cat(dirs, dim=-1)
    ctx.set("Out", out)
    ctx.set("last_h", torch.stack(last_h))
    ctx.set("last_c", torch.stack(last_c))
