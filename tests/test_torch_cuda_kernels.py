"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode).

This file imports neither jax nor paddle_tpu, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py -m cuda

Tolerances: float32 ``rtol/atol 1e-4``; bfloat16 ``rtol/atol 2e-2``,
the forward against the float32 plain version of the bf16-rounded
inputs, the backward (K3, K4, K5) against plain versions that round at
the same points in bf16.  Bias masks are random (not whole padded rows),
so no row is fully masked.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.fluid.ops import attention_ops as port_attn


def _inputs(BH, S_q, S_kv, D, bias, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, S_q, D).astype(np.float32)
    k = rng.randn(BH, S_kv, D).astype(np.float32)
    v = rng.randn(BH, S_kv, D).astype(np.float32)
    b = None
    if bias == "mask3d":
        b = np.where(rng.rand(BH, S_q, S_kv) < 0.1, -1e4,
                     0.0).astype(np.float32)
    elif bias == "mask4d":      # [B, 1, S_q, S_kv], H = 12
        b = np.where(rng.rand(BH // 12, 1, S_q, S_kv) < 0.2, -1e4,
                     0.0).astype(np.float32)
    return q, k, v, b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bias_s128_d64", "causal_d128",
                                  "ragged_cross_d64", "bf16_d64"])
def test_flash_attention_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    BH, S_q, S_kv, D, bias, causal, dt, tol = {
        "bias_s128_d64": (24, 128, 128, 64, "mask3d", False,
                          torch.float32, dict(rtol=1e-4, atol=1e-4)),
        "causal_d128": (8, 128, 128, 128, None, True, torch.float32,
                        dict(rtol=1e-4, atol=1e-4)),
        "ragged_cross_d64": (8, 77, 200, 64, "mask3d", False,
                             torch.float32, dict(rtol=1e-4, atol=1e-4)),
        "bf16_d64": (24, 128, 128, 64, "mask4d", False, torch.bfloat16,
                     dict(rtol=2e-2, atol=2e-2)),
    }[case]
    q, k, v, b = _inputs(BH, S_q, S_kv, D, bias, seed=11)
    dev = torch.device("cuda", 0)
    args = [None if a is None else torch.from_numpy(a).to(dev, dt)
            for a in (q, k, v, b)]
    before = port_attn.flash_attention.launches
    got, lse = port_attn.flash_attention(*args, 0.125, causal=causal,
                                         with_lse=True)
    torch.cuda.synchronize()
    assert port_attn.flash_attention.launches == before + 1
    ref_args = [None if a is None else a.float() for a in args]
    want, want_lse = port_attn.attention_reference(
        *ref_args, 0.125, causal=causal, with_lse=True)
    torch.testing.assert_close(got.float(), want, **tol)
    torch.testing.assert_close(lse, want_lse, **tol)


# (BH, S_q, S_kv, D, bias, causal, dtype) of the backward cases: the
# BERT-base training shape with a head-broadcast mask, bf16, causal at
# D=128, and a ragged cross-length case
BWD_CASES = {
    "bert_fp32_d64": (48, 128, 128, 64, "mask4d", False, torch.float32),
    "bert_bf16_d64": (48, 128, 128, 64, "mask4d", False, torch.bfloat16),
    "causal_fp32_d128": (8, 128, 128, 128, None, True, torch.float32),
    "ragged_cross_fp32_d64": (8, 77, 200, 64, "mask3d", False,
                              torch.float32),
    "ragged_cross_bf16_d128": (4, 77, 200, 128, "mask3d", False,
                               torch.bfloat16),
}


def _bwd_inputs(case, seed=5):
    BH, S_q, S_kv, D, bias, causal, dt = BWD_CASES[case]
    q, k, v, b = _inputs(BH, S_q, S_kv, D, bias, seed)
    dO = np.random.RandomState(seed + 1).randn(BH, S_q, D).astype(
        np.float32)
    dev = torch.device("cuda", 0)
    q, k, v, b, dO = [None if a is None else torch.from_numpy(a).to(dev, dt)
                      for a in (q, k, v, b, dO)]
    # out and LSE from the plain forward in fp32, shared by both versions
    ref = [None if a is None else a.float() for a in (q, k, v, b)]
    out, lse = port_attn.attention_reference(*ref, 0.125, causal=causal,
                                             with_lse=True)
    delta = port_attn.attention_delta(out.to(dt), dO)
    return (q, k, v, b, 0.125, dO, lse, delta, causal), dt


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_attention_bwd_kernels_match_plain_versions(case):
    """K3, K4 and K5 against dq_reference / dkv_reference /
    dbias_reference on the same inputs (the plain versions round to the
    working dtype at the same points, so bf16 is compared in bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args, dt = _bwd_inputs(case)
    tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    before = [f.launches for f in (port_attn.flash_attention_bwd_dq,
                                   port_attn.flash_attention_bwd_dkv,
                                   port_attn.flash_attention_bwd_dbias)]
    dq = port_attn.flash_attention_bwd_dq(*args)
    dk, dv = port_attn.flash_attention_bwd_dkv(*args)
    got = [dq, dk, dv]
    want = [port_attn.dq_reference(*args)] + \
        list(port_attn.dkv_reference(*args))
    if args[3] is not None:
        got.append(port_attn.flash_attention_bwd_dbias(*args))
        want.append(port_attn.dbias_reference(*args))
    torch.cuda.synchronize()
    after = [f.launches for f in (port_attn.flash_attention_bwd_dq,
                                  port_attn.flash_attention_bwd_dkv,
                                  port_attn.flash_attention_bwd_dbias)]
    assert [a - b for a, b in zip(after, before)] == \
        [1, 1, int(args[3] is not None)]
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_grad", [False, True],
                         ids=["mask_bias", "trainable_bias"])
def test_flash_attention_function_grads_match_autograd_of_plain(bias_grad):
    """FlashAttentionFunction (K2 forward with the LSE, K3/K4, and K5 only
    for a bias that needs a gradient) against torch.autograd through
    attention_reference, fp32, head-broadcast [B, 1, S, S] bias."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    q, k, v, b = _inputs(48, 128, 128, 64, "mask4d", seed=3)
    dev = torch.device("cuda", 0)
    q, k, v, b = [torch.from_numpy(a).to(dev).requires_grad_(
        i < 3 or bias_grad) for i, a in enumerate((q, k, v, b))]
    g = torch.from_numpy(np.random.RandomState(4).randn(48, 128, 64).astype(
        np.float32)).to(dev)
    wants = (q, k, v, b) if bias_grad else (q, k, v)
    k5 = port_attn.flash_attention_bwd_dbias.launches
    got = torch.autograd.grad(port_attn.FlashAttentionFunction.apply(
        q, k, v, b, 0.125, False), wants, g)
    torch.cuda.synchronize()
    assert port_attn.flash_attention_bwd_dbias.launches == k5 + bias_grad
    want = torch.autograd.grad(port_attn.attention_reference(
        q, k, v, b, 0.125), wants, g)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
