"""Ring attention and Ulysses (all-to-all) sequence parallelism
(counterpart ``paddle_tpu/parallel/sequence_parallel.py``).

Every rank holds ``T_local = T / P`` of the sequence (P ranks in the
sequence-parallel process group).

- :func:`ring_attention`: K/V blocks rotate around the ring (rank r
  sends to r + 1 and receives from r - 1, one exchange a step) while the
  rank's Q stays; the softmax accumulates online, so the full ``T × T``
  score matrix never exists.  Two routes, as in the JAX package:

  * the **flash ring** (non-causal, bias-free, ``T_local`` a multiple of
    ``min(128, T_local)``): each step's block runs K2 with its LSE and
    the steps merge by logsumexp reweighting; the backward runs K3 and
    K4 on every step with the *global* LSE and a delta built from the
    global output, and the dK/dV accumulators travel with their blocks
    for P rotations, so they arrive home (:class:`RingFlashFunction`).
    On CPU tensors the same structure runs the kernels' plain versions.
  * the **einsum ring** (causal or biased): the masked blockwise online
    softmax, each step recomputed in the backward
    (``torch.utils.checkpoint``) so only the rotating blocks are kept;
    causal masking uses ``q_offset = rank · T_local`` and a bias
    ``[B, 1|H, T_local, T]`` is sliced to the arriving block's columns.

- :func:`ulysses_attention`: an all-to-all swaps the sequence shard for a
  head shard (``[B, T/P, H, D] → [B, T, H/P, D]``), the rank attends over
  the whole sequence on its heads through K2–K4 (causal and biased
  included), and the inverse all-to-all swaps back.  Needs ``H % P == 0``.

:func:`local_attention` is the single-rank oracle.  The public functions
take the JAX package's ``[B, T, H, D]`` layout; the ``*_bhsd`` ones take
the ``fused_attention`` op's ``[B, H, T, D]``.  The rotations and the LSE
merge are torch ops, as they are ``jnp`` ops outside any Pallas kernel in
the JAX package; the per-block attention is the ported kernels'.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..fluid.ops import attention_ops as _attn
from ..fluid.quantized_collectives import staged
from .tensor_parallel import (_dist, count, global_rank, group_rank,
                              group_size)

NEG_INF = -1e30


def _bshd_to_bhsd(x):
    return x.permute(0, 2, 1, 3)


def local_attention(q, k, v, causal=False, scale=None, q_offset=0,
                    k_offset=0, bias=None):
    """Single-rank softmax attention on ``[B, T, H, D]``: scores and
    softmax in float32, output in v's dtype.  ``q_offset``/``k_offset``
    are the blocks' global positions for causal masking; ``bias`` is an
    additive ``[B, 1|H, Tq, Tk]``."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# The ring rotation
# ---------------------------------------------------------------------------

def _send_recv(x, group, shift):
    """``x`` sent to rank ``r + shift`` of ``group``; returns what rank
    ``r - shift`` sent.  A card tensor on a gloo group goes through host
    memory (gloo's send/recv take host tensors)."""
    dist = _dist()
    P, r = group_size(group), group_rank(group)
    if P == 1:
        return x
    host = staged(group, x)
    src = (x.cpu() if host else x).contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, global_rank(group, (r + shift) % P),
                      group),
           dist.P2POp(dist.irecv, buf, global_rank(group, (r - shift) % P),
                      group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    count("sendrecv", "sp", src.numel() * src.element_size())
    return buf.to(x.device) if host else buf


class _Rotate(torch.autograd.Function):
    """One ring step: forward to the next rank; the gradient goes back to
    the previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g.contiguous(), ctx.group, -1), None


def rotate(x, group):
    """``x`` passed one rank along the ring (differentiable)."""
    return _Rotate.apply(x, group)


# ---------------------------------------------------------------------------
# The einsum ring
# ---------------------------------------------------------------------------

def _ring_step(q32, kb, vb, m, l, acc, bb, qpos, kpos, causal, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kb.float()) * scale
    if bb is not None:
        s = s + bb.float()
    if causal:
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows masked so far (m_new still -inf) contribute nothing
    live = m_new > NEG_INF / 2
    corr = torch.where(live, torch.exp(m - m_new), torch.zeros_like(m))
    p = torch.where(live.unsqueeze(-1), torch.exp(s - m_new.unsqueeze(-1)),
                    torch.zeros_like(s))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
    return m_new, l_new, acc * corr.unsqueeze(-1) + pv


def ring_attention_einsum_bhsd(q, k, v, group, causal=False, scale=None,
                               bias=None):
    """The masked-einsum ring on ``[B, H, T_local, D]`` shards
    (``_ring_attention_einsum``, sequence_parallel.py:231).  ``bias`` is
    ``[B, 1|H, T_local, T]``: this rank's q rows, every kv column."""
    P, my = group_size(group), group_rank(group)
    B, H, Tl, D = q.shape
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    q32 = q.float()
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    ar = torch.arange(Tl, device=q.device)
    qpos = my * Tl + ar
    kb, vb = k, v
    for step in range(P):
        src = (my - step) % P            # whose block this rank holds
        bb = None if bias is None else \
            bias[..., src * Tl:(src + 1) * Tl]
        # recomputed in the backward: only each step's inputs are kept,
        # not its [Tl, Tl] score and probability blocks
        m, l, acc = checkpoint(_ring_step, q32, kb, vb, m, l, acc, bb,
                               qpos, src * Tl + ar, causal, scale,
                               use_reentrant=False)
        if step < P - 1:
            kb, vb = rotate(kb, group), rotate(vb, group)
    denom = torch.clamp(l, min=1e-20).unsqueeze(-1)
    return (acc / denom).to(q.dtype)


# ---------------------------------------------------------------------------
# The flash ring
# ---------------------------------------------------------------------------

def _flat(x):
    B, H, T, D = x.shape
    return x.reshape(B * H, T, D).contiguous()


def ring_flash_forward(q, k, v, group, scale):
    """Forward of the flash ring on ``[BH, T_local, D]``: K2 with its LSE
    on every step, merged by logsumexp reweighting in float32.  Returns
    the output (q's dtype) and the global LSE (float32 ``[BH, T_local]``)."""
    P = group_size(group)
    kb, vb = k, v
    o = lse = None
    for step in range(P):
        o_s, lse_s = _attn.flash_attention(q, kb, vb, None, scale,
                                           with_lse=True)
        if o is None:
            o, lse = o_s.float(), lse_s
        else:
            new = torch.logaddexp(lse, lse_s)
            o = o * torch.exp(lse - new).unsqueeze(-1) + \
                o_s.float() * torch.exp(lse_s - new).unsqueeze(-1)
            lse = new
        if step < P - 1:
            kb, vb = _send_recv(kb, group, 1), _send_recv(vb, group, 1)
    return o.to(q.dtype), lse


def ring_flash_backward(q, k, v, out, lse, g, group, scale):
    """Backward of the flash ring: K3 and K4 on every step with the
    global LSE and ``delta = rowsum(dO ∘ O)`` of the global output; dQ
    accumulates here, dK/dV accumulators rotate with their blocks and
    are home after P rotations.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    P = group_size(group)
    g = g.to(q.dtype).contiguous()
    delta = _attn.attention_delta(out, g)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(P):
        args = (q, kb, vb, None, scale, g, lse, delta)
        dq += _attn.flash_attention_bwd_dq(*args).float()
        dk_s, dv_s = _attn.flash_attention_bwd_dkv(*args)
        dkb += dk_s.float()
        dvb += dv_s.float()
        if step < P - 1:
            kb, vb = _send_recv(kb, group, 1), _send_recv(vb, group, 1)
        dkb, dvb = _send_recv(dkb, group, 1), _send_recv(dvb, group, 1)
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class RingFlashFunction(torch.autograd.Function):
    """``_ring_attention_flash`` (sequence_parallel.py:119): the flash
    ring forward and its tiled backward on ``[BH, T_local, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        out, lse = ring_flash_forward(q, k, v, group, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, out, lse, g, ctx.group,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_ring_ok(Tl, causal, bias, scale):
    """The JAX package's conditions for the flash ring
    (sequence_parallel.py:217-220): non-causal, bias-free, a tileable
    local length and a static scale."""
    try:
        float(scale)
    except (TypeError, ValueError):
        return False
    return (not causal) and bias is None and Tl % min(128, Tl) == 0


def ring_attention_bhsd(q, k, v, group, causal=False, scale=None,
                        use_flash=None, bias=None):
    """Ring attention on ``[B, H, T_local, D]`` shards; ``use_flash``
    None takes the flash ring where :func:`flash_ring_ok` allows it."""
    B, H, Tl, D = q.shape
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if use_flash and causal:
        raise ValueError(
            "use_flash=True is not available for causal ring attention "
            "(the block mask depends on the ring position) — omit "
            "use_flash")
    if use_flash and bias is not None:
        raise ValueError(
            "use_flash=True is not available for biased ring attention "
            "(the bias column window depends on the ring position) — "
            "omit use_flash")
    if use_flash and Tl % min(128, Tl):
        raise ValueError(
            "use_flash=True needs the local shard length (%d) to be a "
            "multiple of the 128 block size — pad/bucket the sequence or "
            "omit use_flash" % Tl)
    if use_flash is None:
        use_flash = flash_ring_ok(Tl, causal, bias, scale)
    if use_flash:
        out = RingFlashFunction.apply(_flat(q), _flat(k), _flat(v), group,
                                      scale)
        return out.reshape(B, H, Tl, D)
    return ring_attention_einsum_bhsd(q, k, v, group, causal, scale, bias)


def ring_attention(q, k, v, group=None, causal=False, scale=None,
                   use_flash=None, bias=None):
    """Blockwise ring attention over ``group`` (the JAX package's
    ``ring_attention``, sequence_parallel.py:170): ``q, k, v`` are this
    rank's ``[B, T_local, H, D]`` shards; the result is this rank's rows
    of exact attention over the whole sequence.  ``bias`` is additive
    ``[B, 1|H, T_local, T]`` (this rank's q rows, every kv column) and
    takes the einsum ring, as causal masking does."""
    out = ring_attention_bhsd(_bshd_to_bhsd(q), _bshd_to_bhsd(k),
                              _bshd_to_bhsd(v), group, causal, scale,
                              use_flash, bias)
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def ulysses_attention_bhsd(q, k, v, group, causal=False, scale=None,
                           bias=None, bias_sharded=True):
    """Ulysses on ``[B, H, T_local, D]`` shards.  ``bias`` is
    ``[B, 1|H, T_local, T]`` (``bias_sharded``: this rank's q rows) or,
    with ``bias_sharded=False``, the whole ``[B, 1|H, T, T]``: a per-head
    bias rides the q all-to-all (heads split, q rows gathered), a bias
    broadcast over heads is all-gathered on the q dim."""
    from .expert_parallel import all_to_all
    from .tensor_parallel import copy_to, gather_reduce_scatter, scatter_to
    P = group_size(group)
    B, H, Tl, D = q.shape
    if H % P:
        raise ValueError("ulysses needs heads %% axis size == 0 "
                         "(H=%d, P=%d)" % (H, P))
    scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    if bias is not None:
        # every rank's heads read the whole broadcast bias, so its
        # gradient is each rank's part (summed back); a per-head bias is
        # cut by heads like q
        if bias.shape[1] == 1:
            bias = gather_reduce_scatter(bias, group, 2) if bias_sharded \
                else copy_to(bias, group, "sp")
        elif bias_sharded:
            bias = all_to_all(bias, group, split_axis=1, concat_axis=2,
                              axis="sp")
        else:
            bias = scatter_to(bias, group, 1, axis="sp")
    # [B, H, T/P, D] -> [B, H/P, T, D]: heads split, sequence gathered
    qf, kf, vf = (all_to_all(t, group, split_axis=1, concat_axis=2,
                             axis="sp") for t in (q, k, v))
    Hl, T = qf.shape[1], qf.shape[2]
    out = _attn.FlashAttentionFunction.apply(
        _flat(qf), _flat(kf), _flat(vf),
        None if bias is None else bias.to(q.dtype), scale, causal)
    out = out.reshape(B, Hl, T, D)
    return all_to_all(out, group, split_axis=2, concat_axis=1, axis="sp")


def ulysses_attention(q, k, v, group=None, causal=False, scale=None,
                      bias=None):
    """DeepSpeed-Ulysses over ``group`` (the JAX package's
    ``ulysses_attention``, sequence_parallel.py:291) on ``[B, T_local, H,
    D]`` shards; ``bias`` as in :func:`ring_attention`."""
    out = ulysses_attention_bhsd(_bshd_to_bhsd(q), _bshd_to_bhsd(k),
                                 _bshd_to_bhsd(v), group, causal, scale,
                                 bias)
    return out.permute(0, 2, 1, 3)
