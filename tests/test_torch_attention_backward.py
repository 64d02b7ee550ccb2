"""The port's flash-attention backward (paddle_tpu_torch) against
paddle_tpu's ``_flash_backward``, which runs its three Pallas kernels
(dQ, dK/dV, dBias) in interpret mode on the CPU, as
tests/test_pallas_attention.py runs them.  Inputs come from one numpy
seed and reach both packages as numpy arrays; the forward's output and
LSE come from the JAX forward and are handed to both backwards.

On the CPU the port's wrappers run their plain versions
(``dq_reference``, ``dkv_reference``, ``dbias_reference``); the CUDA
kernels are held against those on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).

Tolerances: float32 ``rtol 2e-4, atol 2e-5`` (the JAX kernels' own
test); bfloat16 ``rtol/atol 2e-2`` in float32: both round p and ds to
bf16 at the same points, but sum in other orders, so a rounded value may
land one bf16 step apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.fluid.ops import pallas_ops as jax_attn

from paddle_tpu_torch.fluid.ops import attention_ops as port_attn

FP32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SCALE = 0.125

# (BH, S_q, S_kv, D, bias, causal, dtype), all tileable for the TPU kernels
CASES = {
    "nobias": (4, 64, 64, 64, False, False, "float32"),
    "bias": (4, 64, 64, 64, True, False, "float32"),
    "causal": (4, 64, 64, 64, False, True, "float32"),
    "causal_bias": (4, 64, 64, 64, True, True, "float32"),
    "cross_64x128": (4, 64, 128, 64, True, False, "float32"),
    "bf16_bias": (4, 64, 64, 64, True, False, "bfloat16"),
    "bf16_causal": (4, 64, 64, 64, False, True, "bfloat16"),
}


def _arrays(BH, S_q, S_kv, D, bias, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S_q, D).astype(np.float32)
    k = rng.randn(BH, S_kv, D).astype(np.float32)
    v = rng.randn(BH, S_kv, D).astype(np.float32)
    g = rng.randn(BH, S_q, D).astype(np.float32)
    # a real-valued bias (not only a mask), so dbias is not trivially 0
    b = (rng.randn(BH, S_q, S_kv).astype(np.float32) +
         np.where(rng.rand(BH, S_q, S_kv) < 0.1, -1e4, 0.0).astype(
             np.float32)) if bias else None
    return q, k, v, b, g


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_flash_backward(case):
    BH, S_q, S_kv, D, bias, causal, dt = CASES[case]
    q, k, v, b, g = _arrays(BH, S_q, S_kv, D, bias)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jb = None if b is None else jnp.asarray(b, jdt)
    out, lse = jax_attn._flash_forward(jq, jk, jv, jb, SCALE, with_lse=True,
                                       causal=causal)
    want = jax_attn._flash_backward(jq, jk, jv, jb, SCALE, out, lse, jg,
                                    causal=causal)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(tdt)
    got = port_attn.flash_attention_bwd_reference(
        t(q), t(k), t(v), None if b is None else t(b), SCALE,
        t(np.asarray(out.astype(jnp.float32))),
        torch.from_numpy(np.array(lse)), t(g), causal=causal)
    assert (got[3] is None) == (b is None)
    tol = BF16_TOL if dt == "bfloat16" else FP32_TOL
    for name, w, p in zip(("dq", "dk", "dv", "dbias"), want, got):
        if w is None:
            continue
        assert p.dtype == tdt, name
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **tol)


def _torch_inputs(bias, seed=1, S_q=48, S_kv=80):
    """B=2, H=3, D=64 on the CPU; bias None, a [B, 1, S_q, S_kv] mask, or
    a trainable [1, H, S_q, S_kv] bias (the leaf; callers pass it
    expanded over the batch, as the fused_attention op does)."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(6, s, 64).astype(np.float32))
               .requires_grad_() for s in (S_q, S_kv, S_kv))
    b = None
    if bias == "mask":
        b = torch.from_numpy(np.where(rng.rand(2, 1, S_q, S_kv) < 0.2, -1e4,
                                      0.0).astype(np.float32))
    elif bias == "trainable":
        b = torch.from_numpy(rng.randn(1, 3, S_q, S_kv).astype(np.float32)
                             ).requires_grad_()
    g = torch.from_numpy(rng.randn(6, S_q, 64).astype(np.float32))
    return q, k, v, b, g


@pytest.mark.parametrize("bias,causal", [(None, False), ("mask", False),
                                         ("trainable", False),
                                         ("trainable", True)],
                         ids=["nobias", "mask", "trainable_bias",
                              "trainable_bias_causal"])
def test_function_grads_match_autograd_of_plain_forward(bias, causal):
    """FlashAttentionFunction on CPU tensors (plain versions of K2-K5)
    against torch.autograd through attention_reference.  Both fp32: the
    Function recomputes p from the LSE, autograd differentiates softmax,
    so they differ by rounding only (rtol 1e-4, atol 1e-5)."""
    S_kv = 48 if causal else 80
    q, k, v, b, g = _torch_inputs(bias, S_kv=S_kv)
    wrt = [t for t in (q, k, v, b) if t is not None and t.requires_grad]
    bx = b if bias != "trainable" else b.expand(2, 3, -1, -1)
    got = torch.autograd.grad(port_attn.FlashAttentionFunction.apply(
        q, k, v, bx, SCALE, causal), wrt, g)
    want = torch.autograd.grad(port_attn.attention_reference(
        q, k, v, bx, SCALE, causal=causal), wrt, g)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("trainable", [False, True])
def test_dbias_pass_runs_only_for_a_trainable_bias(monkeypatch, trainable):
    """K5 (here its plain version) is not called when the bias does not
    need a gradient, as BERT's mask does not."""
    calls = []
    real = port_attn.dbias_reference

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(port_attn, "dbias_reference", counted)
    q, k, v, b, g = _torch_inputs("trainable")
    b.requires_grad_(trainable)
    out = port_attn.FlashAttentionFunction.apply(
        q, k, v, b.expand(2, 3, -1, -1), SCALE, False)
    grads = torch.autograd.grad(out, [q, k, v] + ([b] if trainable else []),
                                g)
    assert len(calls) == int(trainable)
    if trainable:
        assert grads[3].shape == b.shape


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu():
    """On CPU tensors each backward wrapper returns its plain version's
    result and counts no launch; a CPU/meta mix raises."""
    q, k, v, b, g = _torch_inputs("mask")
    q, k, v = (t.detach() for t in (q, k, v))
    out, lse = port_attn.attention_reference(q, k, v, b, SCALE,
                                             with_lse=True)
    delta = port_attn.attention_delta(out, g)
    args = (q, k, v, b, SCALE, g, lse, delta)
    before = (port_attn.flash_attention_bwd_dq.launches,
              port_attn.flash_attention_bwd_dkv.launches,
              port_attn.flash_attention_bwd_dbias.launches)
    torch.testing.assert_close(port_attn.flash_attention_bwd_dq(*args),
                               port_attn.dq_reference(*args))
    for a, w in zip(port_attn.flash_attention_bwd_dkv(*args),
                    port_attn.dkv_reference(*args)):
        torch.testing.assert_close(a, w)
    torch.testing.assert_close(port_attn.flash_attention_bwd_dbias(*args),
                               port_attn.dbias_reference(*args))
    assert before == (port_attn.flash_attention_bwd_dq.launches,
                      port_attn.flash_attention_bwd_dkv.launches,
                      port_attn.flash_attention_bwd_dbias.launches)
    with pytest.raises(ValueError, match="one CUDA device"):
        port_attn.flash_attention_bwd_dq(q, k, v, b, SCALE,
                                         g.to("meta"), lse, delta)
