"""Flash attention, forward and backward, and the ``fused_attention`` op.

Counterpart of ``paddle_tpu/fluid/ops/pallas_ops.py``.  ``flash_attention``
computes ``softmax(q kᵀ · scale + bias) v`` over ``[BH, S, D]`` heads; the
three backward passes compute dQ, dK/dV and dBias from the forward's
logsumexp (LSE).  On a CUDA tensor each launches its hand-written Hopper
kernel or raises:

- K2 ``flash_attention``: ``csrc/flash_attention_fwd.cu``, the port of
  ``_attention_kernel`` (pallas_ops.py:44);
- K3 ``flash_attention_bwd_dq``, K4 ``flash_attention_bwd_dkv``, K5
  ``flash_attention_bwd_dbias``: ``csrc/flash_attention_bwd.cu``, the ports
  of ``_dq_kernel`` (:115), ``_dkv_kernel`` (:152), ``_dbias_kernel``
  (:196).

On a CPU tensor each runs its plain PyTorch version beside it
(:func:`attention_reference`, :func:`dq_reference`,
:func:`dkv_reference`, :func:`dbias_reference`).  There is no fallback
from one to the other.  Each wrapper's ``launches`` counts kernel
launches, and nothing else.

:class:`FlashAttentionFunction` is the autograd node (``jax.custom_vjp``
at pallas_ops.py:403): K2 with the LSE forward, K3 and K4 backward, and
K5 only when the bias needs a gradient.  ``fused_attention`` routes
through it whenever attention dropout is off, and through the exact
composition with a dropout mask otherwise (pallas_ops.py:682).  Under
sequence parallelism it runs ring attention, Ulysses or the q-row gather
route over the sp group (``paddle_tpu_torch/parallel/
sequence_parallel.py``), whose blocks are these same kernels: the flash
ring launches K2 with the LSE on every ring step and K3/K4 with the
global LSE.
"""

import ctypes
import threading

import torch

from .. import costmodel
from ..registry import register_op
from . import _kernels
from .nn_ops import keep_mask

_NEG = -1e30
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _bias_view(bias, BH, S_q, S_kv):
    """``bias`` as a ``[Bb, heads, S_q, S_kv]`` view with Bb·heads == BH
    (broadcast dims get stride 0, nothing is copied), plus ``heads``.
    Takes the JAX interface's ``[BH, S_q, S_kv]`` and any 4-D bias that
    broadcasts over heads, such as BERT's ``[B, 1, S, S]`` mask."""
    if bias.dim() == 3:
        if tuple(bias.shape) != (BH, S_q, S_kv):
            raise ValueError("bias %s must be [BH=%d, S_q=%d, S_kv=%d]"
                             % (tuple(bias.shape), BH, S_q, S_kv))
        return bias.unsqueeze(1), 1
    if bias.dim() != 4:
        raise ValueError("bias must be 3-D or 4-D, got %s"
                         % (tuple(bias.shape),))
    Bb = bias.shape[0]
    if Bb < 1 or BH % Bb:
        raise ValueError("bias batch %d does not divide BH=%d" % (Bb, BH))
    heads = BH // Bb
    try:
        view = bias.expand(Bb, heads, S_q, S_kv)
    except RuntimeError:
        raise ValueError("bias %s does not broadcast to [%d, %d, %d, %d]"
                         % (tuple(bias.shape), Bb, heads, S_q, S_kv))
    return view, heads


def _check(q, k, v, bias, causal):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [BH, S, D]")
    BH, S_q, D = q.shape
    if k.shape[0] != BH or v.shape != k.shape or k.shape[2] != D:
        raise ValueError("k/v %s, %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    S_kv = k.shape[1]
    if S_q < 1 or S_kv < 1:
        raise ValueError("empty sequence: S_q=%d, S_kv=%d" % (S_q, S_kv))
    if causal and S_q != S_kv:
        # the diagonal alignment for unequal lengths is ambiguous
        # (pallas_ops.py:246-252) — refuse rather than silently pick one
        raise ValueError(
            "causal=True needs S_q == S_kv (got %d vs %d); apply an "
            "explicit bias for cross-length causal masking" % (S_q, S_kv))
    if bias is not None:
        _bias_view(bias, BH, S_q, S_kv)
    return BH, S_q, S_kv, D


def attention_reference(q, k, v, bias, scale, causal=False, with_lse=False):
    """Plain PyTorch attention on ``[BH, S, D]``: the oracle of the kernel
    and the CPU path.  Scores and softmax in float32; output in q's dtype;
    LSE (float32 ``[BH, S_q]``) when ``with_lse``."""
    BH, S_q, S_kv, D = _check(q, k, v, bias, causal)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        view, _ = _bias_view(bias, BH, S_q, S_kv)
        s = s + view.reshape(BH, S_q, S_kv).float()
    if causal:
        allowed = torch.ones(S_q, S_kv, dtype=torch.bool,
                             device=q.device).tril()
        s = s.masked_fill(~allowed, _NEG)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    out = torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
    return (out, lse) if with_lse else out


def _kernel_device(name, q, k, v, bias, extra=()):
    """False when every tensor lies on the CPU (run the plain version);
    True when they all lie on one CUDA device in a form the kernels take
    (float32 or bfloat16 in q's dtype, contiguous, D in (64, 128));
    raises otherwise."""
    tensors = [q, k, v] + ([bias] if bias is not None else []) + list(extra)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("%s: every input must lie on one CUDA device (or "
                         "all on the CPU), got %s"
                         % (name, [str(t.device) for t in tensors]))
    if q.dtype not in _KERNEL_DTYPES or \
            any(t.dtype != q.dtype for t in [k, v] + ([bias] if bias is
                                                       not None else [])):
        raise TypeError("%s kernel takes float32 or bfloat16 with q, k, v "
                        "and bias in q's dtype, got %s"
                        % (name, [str(t.dtype) for t in tensors]))
    D = q.shape[2]
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError("%s kernel takes head dim D in %s, got %d"
                         % (name, _KERNEL_HEAD_DIMS, D))
    if not all(t.is_contiguous() for t in [q, k, v] + list(extra)):
        raise ValueError("%s kernel needs contiguous q, k, v (and dO, LSE, "
                         "delta)" % name)
    if q.shape[0] > 65535:
        raise ValueError("%s kernel takes BH <= 65535, got %d"
                         % (name, q.shape[0]))
    return True


def _bias_args(bias, BH, S_q, S_kv):
    """(pointer, strides b/h/q/k, heads) of the bias as the kernels read
    it, a broadcast view that is never copied."""
    if bias is None:
        return None, (0, 0, 0, 0), 1
    view, heads = _bias_view(bias, BH, S_q, S_kv)
    return view.data_ptr(), view.stride(), heads


def _aligned(t):
    """``t``, or a copy of it where its data does not start on the 16-byte
    boundary that the kernels' cp.async loads need (a view at an odd
    offset; never on the main path)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(fn):
    with _count_lock:
        fn.launches += 1


def _fwd_work(q, k, v, bias, scale, causal=False, with_lse=False):
    return costmodel.kernel_work(
        "K2", bh=q.shape[0], sq=q.shape[1], sk=k.shape[1], d=q.shape[2],
        esz=q.element_size(), bias_bytes=costmodel.stored_bytes(bias),
        lse=with_lse, causal=causal)


def _bwd_work(kernel):
    def work(q, k, v, bias, scale, dO, lse, delta, causal=False):
        return costmodel.kernel_work(
            kernel, bh=q.shape[0], sq=q.shape[1], sk=k.shape[1],
            d=q.shape[2], esz=q.element_size(),
            bias_bytes=costmodel.stored_bytes(bias), causal=causal)
    return work


@costmodel.hand_kernel("K2", _fwd_work)
def flash_attention(q, k, v, bias, scale, causal=False, with_lse=False):
    """``softmax(q kᵀ · scale + bias) v``.  q ``[BH, S_q, D]``, k/v
    ``[BH, S_kv, D]`` (cross-attention supported), bias ``[BH, S_q, S_kv]``
    or a 4-D bias broadcast over heads (``[B, 1|H, S_q, S_kv]``) or None.
    Returns the output, and the float32 ``[BH, S_q]`` LSE with
    ``with_lse``.

    CPU tensors run :func:`attention_reference`.  CUDA tensors launch the
    kernel, which takes float32 or bfloat16 (bias in q's dtype),
    contiguous q/k/v, and D in (64, 128); anything else raises."""
    BH, S_q, S_kv, D = _check(q, k, v, bias, causal)
    if not _kernel_device("flash_attention", q, k, v, bias):
        return attention_reference(q, k, v, bias, scale, causal=causal,
                                   with_lse=with_lse)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, S_q), dtype=torch.float32, device=q.device) \
        if with_lse else None
    bias_ptr, strides, heads = _bias_args(bias, BH, S_q, S_kv)
    lib = _kernels.load("flash_attention_fwd")
    # the C side launches on the calling thread's current device
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_fwd(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias_ptr, strides[0], strides[1], strides[2],
            strides[3], heads, out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            BH, S_q, S_kv, D, ctypes.c_float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: %s"
                           % _kernels.cuda_error_string(lib, rc))
    _count(flash_attention)
    return (out, lse) if with_lse else out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward: K3 (dQ), K4 (dK/dV), K5 (dBias) and their plain versions
# ---------------------------------------------------------------------------

def recompute_p_dp(q, k, v, bias, scale, dO, lse, causal):
    """fp32 ``p = exp(s − lse)`` recomputed from the LSE and
    ``dp = dO vᵀ``, both ``[BH, S_q, S_kv]``; dO enters in q's dtype, as
    the TPU kernels read it (pallas_ops.py:138)."""
    BH, S_q, S_kv, D = _check(q, k, v, bias, causal)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        view, _ = _bias_view(bias, BH, S_q, S_kv)
        s = s + view.reshape(BH, S_q, S_kv).float()
    if causal:
        allowed = torch.ones(S_q, S_kv, dtype=torch.bool,
                             device=q.device).tril()
        s = s.masked_fill(~allowed, _NEG)
    p = torch.exp(s - lse.float().unsqueeze(-1))
    dp = torch.einsum("bqd,bkd->bqk", dO.to(q.dtype).float(), v.float())
    return p, dp


def dq_reference(q, k, v, bias, scale, dO, lse, delta, causal=False):
    """Plain K3: ``dq = (p ∘ (dp − delta) · scale) k``, ds rounded to q's
    dtype before the product (pallas_ops.py:141)."""
    p, dp = recompute_p_dp(q, k, v, bias, scale, dO, lse, causal)
    ds = p * (dp - delta.float().unsqueeze(-1)) * scale
    return torch.einsum("bqk,bkd->bqd", ds.to(q.dtype).float(),
                        k.float()).to(q.dtype)


def dkv_reference(q, k, v, bias, scale, dO, lse, delta, causal=False):
    """Plain K4: ``dv = pᵀ dO`` and ``dk = dsᵀ q``, p and ds rounded to
    q's dtype before the products (pallas_ops.py:180-182)."""
    p, dp = recompute_p_dp(q, k, v, bias, scale, dO, lse, causal)
    ds = p * (dp - delta.float().unsqueeze(-1)) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).float(),
                      dO.to(q.dtype).float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def dbias_reference(q, k, v, bias, scale, dO, lse, delta, causal=False):
    """Plain K5: ``p ∘ (dp − delta)``, unscaled, ``[BH, S_q, S_kv]`` in the
    bias's dtype (pallas_ops.py:196)."""
    p, dp = recompute_p_dp(q, k, v, bias, scale, dO, lse, causal)
    return (p * (dp - delta.float().unsqueeze(-1))).to(bias.dtype)


def flash_attention_bwd_reference(q, k, v, bias, scale, out, lse, dO,
                                  causal=False):
    """Plain backward of :func:`flash_attention` from its output and LSE
    (``_flash_backward``, pallas_ops.py:300): ``dq, dk, dv, dbias``, with
    dbias ``[BH, S_q, S_kv]`` (None without a bias)."""
    delta = attention_delta(out, dO)
    dq = dq_reference(q, k, v, bias, scale, dO, lse, delta, causal)
    dk, dv = dkv_reference(q, k, v, bias, scale, dO, lse, delta, causal)
    dbias = None if bias is None else \
        dbias_reference(q, k, v, bias, scale, dO, lse, delta, causal)
    return dq, dk, dv, dbias


def attention_delta(out, dO):
    """``delta = rowsum(dO ∘ O)`` in float32 ``[BH, S_q]``, computed
    outside the kernels as pallas_ops.py:307 does."""
    return (dO.float() * out.float()).sum(-1)


def _launch_bwd(name, fn, plain, outs, q, k, v, bias, scale, dO, lse,
                delta, causal):
    """Shared body of the three backward wrappers: plain version on the
    CPU, else check, launch ``lib.<name>`` writing ``outs`` and count."""
    BH, S_q, S_kv, D = _check(q, k, v, bias, causal)
    if tuple(dO.shape) != (BH, S_q, D) or \
            tuple(lse.shape) != (BH, S_q) or \
            tuple(delta.shape) != (BH, S_q):
        raise ValueError("%s: dO %s must be [BH, S_q, D] and lse %s, delta "
                         "%s [BH, S_q]" % (fn.__name__, tuple(dO.shape),
                                           tuple(lse.shape),
                                           tuple(delta.shape)))
    if not _kernel_device(fn.__name__, q, k, v, bias, (dO, lse, delta)):
        return plain(q, k, v, bias, scale, dO, lse, delta, causal)
    if dO.dtype != q.dtype or lse.dtype != torch.float32 or \
            delta.dtype != torch.float32:
        raise TypeError("%s kernel takes dO in q's dtype and float32 lse "
                        "and delta, got %s, %s, %s"
                        % (fn.__name__, dO.dtype, lse.dtype, delta.dtype))
    q, k, v, dO = _aligned(q), _aligned(k), _aligned(v), _aligned(dO)
    out = outs()
    bias_ptr, strides, heads = _bias_args(bias, BH, S_q, S_kv)
    lib = _kernels.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias_ptr, strides[0], strides[1], strides[2],
            strides[3], heads, dO.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *[t.data_ptr() for t in out],
            BH, S_q, S_kv, D, ctypes.c_float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: %s"
                           % (fn.__name__, _kernels.cuda_error_string(lib,
                                                                      rc)))
    _count(fn)
    return out[0] if len(out) == 1 else tuple(out)


@costmodel.hand_kernel("K3", _bwd_work("K3"))
def flash_attention_bwd_dq(q, k, v, bias, scale, dO, lse, delta,
                           causal=False):
    """dQ ``[BH, S_q, D]`` (K3) from the forward's LSE and
    :func:`attention_delta`.  Same inputs and rules as
    :func:`flash_attention`, plus dO ``[BH, S_q, D]`` in q's dtype and
    float32 ``[BH, S_q]`` lse/delta, which the caller supplies (a ring
    sequence-parallel backward passes the global LSE)."""
    return _launch_bwd("paddle_flash_attention_bwd_dq",
                       flash_attention_bwd_dq, dq_reference,
                       lambda: [torch.empty_like(q)], q, k, v, bias, scale,
                       dO, lse, delta, causal)


@costmodel.hand_kernel("K4", _bwd_work("K4"))
def flash_attention_bwd_dkv(q, k, v, bias, scale, dO, lse, delta,
                            causal=False):
    """(dK, dV), each ``[BH, S_kv, D]`` (K4); inputs as
    :func:`flash_attention_bwd_dq`."""
    return _launch_bwd(
        "paddle_flash_attention_bwd_dkv", flash_attention_bwd_dkv,
        dkv_reference, lambda: [torch.empty_like(k), torch.empty_like(v)],
        q, k, v, bias, scale, dO, lse, delta, causal)


@costmodel.hand_kernel("K5", _bwd_work("K5"))
def flash_attention_bwd_dbias(q, k, v, bias, scale, dO, lse, delta,
                              causal=False):
    """dBias ``[BH, S_q, S_kv]`` in the bias's dtype, unscaled (K5); the
    caller sums it over broadcast dims.  Inputs as
    :func:`flash_attention_bwd_dq`; a bias is required."""
    if bias is None:
        raise ValueError("flash_attention_bwd_dbias needs the bias")
    BH, S_q, S_kv, _ = _check(q, k, v, bias, causal)
    return _launch_bwd(
        "paddle_flash_attention_bwd_dbias", flash_attention_bwd_dbias,
        dbias_reference,
        lambda: [torch.empty((BH, S_q, S_kv), dtype=q.dtype,
                             device=q.device)],
        q, k, v, bias, scale, dO, lse, delta, causal)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dbias.launches = 0


def _sum_to_bias(db, bias):
    """K5's ``[BH, S_q, S_kv]`` summed over the dims that ``bias``
    broadcasts (the vjp of a broadcast)."""
    if bias.dim() == 3:
        return db
    BH, S_q, S_kv = db.shape
    Bb = bias.shape[0]
    db = db.reshape(Bb, BH // Bb, S_q, S_kv)
    dims = [d for d in range(4) if bias.shape[d] == 1 and db.shape[d] != 1]
    return (db.sum(dims, keepdim=True) if dims else db).to(bias.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd node of flash attention: K2 with the LSE forward; K3 and
    K4 backward; K5 only when the bias needs a gradient (JAX launches it
    always and XLA drops the unused result, pallas_ops.py:378-398; eager
    torch has no dead-code pass).  On CPU tensors the same node runs the
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = flash_attention(q, k, v, bias, scale, causal=causal,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dO):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dO = dO.contiguous()
        delta = attention_delta(out, dO)
        args = (q, k, v, bias, ctx.scale, dO, lse, delta, ctx.causal)
        need = ctx.needs_input_grad
        dq = flash_attention_bwd_dq(*args) if need[0] else None
        dk, dv = flash_attention_bwd_dkv(*args) if (need[1] or need[2]) \
            else (None, None)
        dbias = None
        if bias is not None and need[3]:
            dbias = _sum_to_bias(flash_attention_bwd_dbias(*args), bias)
        return dq, dk, dv, dbias, None, None


def attention_dropout_composition(q, k, v, bias, scale, causal, keep,
                                  dropout, q_offset=0):
    """``_attn_core`` (pallas_ops.py:521) on ``[B, H, S, D]``: scores and
    softmax in float32, the probabilities kept where ``keep`` and divided
    by ``1 − dropout`` (upscale_in_train; ``keep`` None keeps all), then
    ``p·V`` in q's dtype.  ``q_offset`` is the global index of q's first
    row (a rank's sequence shard), which aligns the causal mask.
    Differentiable; the op runs it on the tape, which keeps its
    residuals, so the mask is drawn once."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)
        ki = torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(~(qi[:, None] >= ki[None, :]), _NEG)
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout), torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _sp_fused_attention(ctx, q, k, v, bias, scale, causal, dropout):
    """The sequence-parallel routes of ``fused_attention``
    (``_sp_attention`` and ``_sp_gather_attention``,
    pallas_ops.py:440-616) on this rank's q rows ``[B, H, S_q/P, D]``.

    ``__sp__`` (set by ``fluid/model_parallel.py``) says which inputs
    arrive sharded on their sequence dim.  Equal lengths without dropout
    and with sharded k/v take ring attention or Ulysses over the sp group
    (``sp_mode``); cross-attention and attention dropout take the gather
    route: q rows stay sharded, k/v are all-gathered (their gradient
    reduce-scattered), then flash attention on the rows (dropout off) or
    the composition with the rank's keep mask (the rank is folded into
    the op's generator seed).  A replicated input that the rank's rows
    use gets its gradient summed over the group (``copy_to``); a
    replicated bias is cut to the rank's q rows."""
    from ...parallel import sequence_parallel as spm
    from ...parallel.tensor_parallel import (copy_to,
                                             gather_reduce_scatter,
                                             scatter_to)
    sp = ctx.state.parallel["sp"]
    group, P = sp.group, sp.degree
    sharded = ctx.attr("__sp__")
    B, H, S_l, D = q.shape
    S_q = S_l * P
    kv_sharded = sharded.get("K", False) and sharded.get("V", False)
    S_kv = k.shape[2] * (P if kv_sharded else 1)
    if causal and S_q != S_kv:
        raise ValueError(
            "fused_attention: causal=True needs S_q == S_kv (got %d vs "
            "%d); pass an explicit additive bias instead" % (S_q, S_kv))
    bias_sharded = False
    if bias is not None:
        if bias.dim() == 3:             # [B|1, S_q, S_kv]: insert head dim
            bias = bias.unsqueeze(1)
        bias_sharded = sharded.get("BiasQK", False)
        hb = H if bias.shape[1] == H else 1
        bias = bias.to(q.dtype).expand(
            B, hb, S_l if bias_sharded else S_q, S_kv)
    ring_ok = kv_sharded and S_q == S_kv and not dropout
    mode = ctx.attr("sp_mode", "ring") or "ring"
    if ring_ok and mode == "ulysses":
        return spm.ulysses_attention_bhsd(q, k, v, group, causal, scale,
                                          bias, bias_sharded)
    if bias is not None and not bias_sharded:
        bias = scatter_to(bias, group, 2, axis="sp")
    if ring_ok:
        return spm.ring_attention_bhsd(q, k, v, group, causal, scale,
                                       bias=bias)
    if kv_sharded:
        k = gather_reduce_scatter(k, group, 2)
        v = gather_reduce_scatter(v, group, 2)
    else:
        k, v = copy_to(k, group, "sp"), copy_to(v, group, "sp")
    if not dropout and not causal:
        qf = q.reshape(B * H, S_l, D).contiguous()
        kf = k.reshape(B * H, S_kv, D).contiguous()
        vf = v.reshape(B * H, S_kv, D).contiguous()
        out = FlashAttentionFunction.apply(qf, kf, vf, bias, scale, False)
        return out.reshape(B, H, S_l, D)
    keep = keep_mask(ctx, dropout, (B, H, S_l, S_kv)) if dropout else None
    return attention_dropout_composition(q, k, v, bias, scale, causal, keep,
                                         dropout, q_offset=sp.rank * S_l)


@register_op("fused_attention")
def _fused_attention(ctx, op):
    """Fused multi-head attention core (pallas_ops.py:616): Q
    ``[B, H, S_q, D]``, K/V ``[B, H, S_kv, D]``, optional additive BiasQK
    ``[B, 1|H, S_q, S_kv]`` → Out ``[B, H, S_q, D]``.

    With attention dropout off (always so in an inference clone) the op
    runs flash attention; the bias stays a broadcast view, never a
    ``[B·H, S_q, S_kv]`` copy.  When autograd records (a taped training
    op) it goes through :class:`FlashAttentionFunction`, else straight to
    :func:`flash_attention` without the LSE.  With attention dropout on
    it runs :func:`attention_dropout_composition`, the keep mask drawn
    from the op's generator.

    Stamped for sequence parallelism (``sp_axis``) and run on a rank's
    sequence shard (an sp group of more than one rank), it takes the
    routes of :func:`_sp_fused_attention`; outside such a world it runs
    as above, as the JAX op does off the mesh."""
    q = ctx.i("Q")
    k = ctx.i("K")
    v = ctx.i("V")
    bias = ctx.i_opt("BiasQK")
    scale = float(ctx.attr("scale", 1.0))
    causal = bool(ctx.attr("causal", False))
    dropout = float(ctx.attr("attn_dropout", 0.0) or 0.0)
    if ctx.attr("is_test", False) or ctx.state.is_test:
        dropout = 0.0
    if ctx.attr("sp_axis", None) and ctx.attr("__sp__", None) and \
            ctx.attr("__sp__").get("Q"):
        ctx.set("Out", _sp_fused_attention(ctx, q, k, v, bias, scale,
                                           causal, dropout))
        return
    B, H, S_q, D = q.shape
    S_kv = k.shape[2]
    if causal and S_q != S_kv:
        raise ValueError(
            "fused_attention: causal=True needs S_q == S_kv (got %d vs "
            "%d); pass an explicit additive bias instead" % (S_q, S_kv))
    if bias is not None:
        if bias.dim() == 3:             # [B|1, S_q, S_kv]: insert head dim
            bias = bias.unsqueeze(1)
        hb = H if bias.shape[1] == H else 1
        bias = bias.to(q.dtype).expand(B, hb, S_q, S_kv)
    if dropout:
        keep = keep_mask(ctx, dropout, (B, H, S_q, S_kv))
        ctx.set("Out", attention_dropout_composition(
            q, k, v, bias, scale, causal, keep, dropout))
        return
    qf = q.reshape(B * H, S_q, D).contiguous()
    kf = k.reshape(B * H, S_kv, D).contiguous()
    vf = v.reshape(B * H, S_kv, D).contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qf, kf, vf, bias)):
        out = FlashAttentionFunction.apply(qf, kf, vf, bias, scale, causal)
    else:
        out = flash_attention(qf, kf, vf, bias, scale, causal)
    ctx.set("Out", out.reshape(B, H, S_q, D))
