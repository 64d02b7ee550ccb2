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
so no row is fully masked; the cases cross the mma fragments' and tiles'
edges (1 x 1, 9 x 13, 130 x 130) and read biases broadcast over heads or
transposed (bs_k != 1).  A K2 built with a fault planted in its p v step
must fail chip_smoke.py's K2 check (it imports chip_smoke.py), and the
backward built with faults planted in K3's ds k and K5's store must fail
its backward check; K3 and K5 repeat bit for bit.  K1 (3x3
conv): float32 within 1e-4 of the largest output, bf16 within 2e-2 of
it (the plain version rounds the float32 sum once, as the kernel does);
each K1 case also asserts which
variant (``conv_ops.k1_plan``) launched.  K6 (row layer norm): float32
within 1e-5 of the largest output, bf16 within 1e-2.  The last test
plants faults in K1's output and shows that chip_smoke.py's ResNet-50
route check fails on each (it imports chip_smoke.py from the repo root).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.fluid.ops import attention_ops as port_attn
from paddle_tpu_torch.fluid.ops import conv_ops as port_conv
from paddle_tpu_torch.fluid.ops import norm_ops as port_norm


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
    elif bias == "head_bcast":  # [B, 1, S_q, S_kv] of random values
        b = rng.randn(BH // 12, 1, S_q, S_kv).astype(np.float32)
    elif bias == "transposed":  # bs_q = 1, bs_k = S_q (a transposed view)
        b = rng.randn(BH, S_kv, S_q).astype(np.float32).transpose(0, 2, 1)
    return q, k, v, b


def _to(a, dev, dt):
    """numpy -> torch on ``dev`` in ``dt``; a transposed view keeps its
    strides (the kernels read the bias through them)."""
    return None if a is None else torch.from_numpy(a).to(dev, dt)


_FP32 = dict(rtol=1e-4, atol=1e-4)
_BF16 = dict(rtol=2e-2, atol=2e-2)
# (BH, S_q, S_kv, D, bias, causal, dtype, tolerance) of the forward cases;
# the last six cross the edges of the mma fragments and tiles (S_q and
# S_kv not multiples of 8 or 16, three K/V tiles) and read the bias
# through other strides (broadcast over heads, bs_k != 1)
FWD_CASES = {
    "bias_s128_d64": (24, 128, 128, 64, "mask3d", False, torch.float32,
                      _FP32),
    "causal_d128": (8, 128, 128, 128, None, True, torch.float32, _FP32),
    "ragged_cross_d64": (8, 77, 200, 64, "mask3d", False, torch.float32,
                         _FP32),
    "bf16_d64": (24, 128, 128, 64, "mask4d", False, torch.bfloat16, _BF16),
    "1x1_d64": (4, 1, 1, 64, None, False, torch.float32, _FP32),
    "9x13_head_bcast_d64": (24, 9, 13, 64, "head_bcast", False,
                            torch.float32, _FP32),
    "130x130_causal_d64": (8, 130, 130, 64, None, True, torch.float32,
                           _FP32),
    "transposed_bias_d64": (8, 77, 200, 64, "transposed", False,
                            torch.float32, _FP32),
    "transposed_bias_bf16_d128": (8, 77, 200, 128, "transposed", False,
                                  torch.bfloat16, _BF16),
    "causal_bf16_d128": (8, 130, 130, 128, None, True, torch.bfloat16,
                         _BF16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_attention_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    BH, S_q, S_kv, D, bias, causal, dt, tol = FWD_CASES[case]
    q, k, v, b = _inputs(BH, S_q, S_kv, D, bias, seed=11)
    dev = torch.device("cuda", 0)
    args = [_to(a, dev, dt) for a in (q, k, v, b)]
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


@pytest.mark.cuda
def test_attention_kernels_take_misaligned_inputs():
    """q, k, v and dO that start 4 bytes past a 16-byte boundary (views
    into a larger buffer) give K2 and K4 the plain versions' results: the
    wrappers copy them to aligned memory for the kernels' cp.async."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(17)
    shape = (8, 77, 64)
    n = int(np.prod(shape))

    def odd():
        buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(dev)
        return buf[1:].view(shape)

    q, k, v, dO = odd(), odd(), odd(), odd()
    assert q.data_ptr() % 16 and q.is_contiguous()
    out, lse = port_attn.flash_attention(q, k, v, None, 0.125,
                                         with_lse=True)
    want, want_lse = port_attn.attention_reference(q, k, v, None, 0.125,
                                                   with_lse=True)
    delta = port_attn.attention_delta(want, dO)
    got = port_attn.flash_attention_bwd_dkv(q, k, v, None, 0.125, dO,
                                            want_lse, delta)
    wants = port_attn.dkv_reference(q, k, v, None, 0.125, dO, want_lse,
                                    delta)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **_FP32)
    torch.testing.assert_close(lse, want_lse, **_FP32)
    for g, w in zip(got, wants):
        torch.testing.assert_close(g, w, **_FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_k2_check_catches_a_fault_planted_in_p_v(dt, monkeypatch):
    """chip_smoke.py's K2 check fails a K2 built with the rows of V paired
    with the wrong columns of p (PADDLE_ATTN_PLANTED_FAULT) and passes
    the kernel as built, on the BERT-base serving case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke
    from paddle_tpu_torch.fluid.ops import _kernels
    q, k, v, b = _inputs(96, 128, 128, 64, "mask4d", seed=13)
    dev = torch.device("cuda", 0)
    case = dict(zip(("q", "k", "v", "bias"),
                    (_to(a, dev, torch.float32) for a in (q, k, v, b))))
    assert chip_smoke._k2_check("as_built", case, dt, False)[0]
    real = _kernels.load
    name, defines = chip_smoke.PLANTED_FAULT
    monkeypatch.setattr(_kernels, "load", lambda n, d=(): real(
        n, defines if n == name else d))
    assert not chip_smoke._k2_check("planted", case, dt, False)[0]


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
    "1x1_fp32_d64": (4, 1, 1, 64, None, False, torch.float32),
    "9x13_head_bcast_fp32_d64": (24, 9, 13, 64, "head_bcast", False,
                                 torch.float32),
    "130x130_causal_fp32_d64": (8, 130, 130, 64, None, True,
                                torch.float32),
    "transposed_bias_fp32_d64": (8, 77, 200, 64, "transposed", False,
                                 torch.float32),
    "transposed_bias_bf16_d64": (8, 77, 200, 64, "transposed", False,
                                 torch.bfloat16),
    "130x130_causal_bf16_d128": (8, 130, 130, 128, None, True,
                                 torch.bfloat16),
}


def _bwd_inputs(case, seed=5):
    BH, S_q, S_kv, D, bias, causal, dt = BWD_CASES[case]
    q, k, v, b = _inputs(BH, S_q, S_kv, D, bias, seed)
    dO = np.random.RandomState(seed + 1).randn(BH, S_q, D).astype(
        np.float32)
    dev = torch.device("cuda", 0)
    q, k, v, b, dO = [_to(a, dev, dt) for a in (q, k, v, b, dO)]
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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_bwd_check_catches_a_fault_planted_in_ds_k(dt, monkeypatch):
    """chip_smoke.py's backward check passes K3 and K5 as built and fails
    the variant built with PADDLE_ATTN_BWD_PLANTED_FAULT on dq (K's rows
    2t and 2t + 1 paired with the wrong columns of ds) and on dbias (the
    two columns of each stored pair swapped), on a BERT-like case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    from paddle_tpu_torch.fluid.ops import _kernels
    q, k, v, b = _inputs(96, 128, 128, 64, "mask4d", seed=19)
    dO = np.random.RandomState(20).randn(96, 128, 64).astype(np.float32)
    dev = torch.device("cuda", 0)
    case = dict(zip(("q", "k", "v", "bias", "dO"),
                    (_to(a, dev, torch.float32) for a in (q, k, v, b, dO))))
    ok, rep = chip_smoke._bwd_check("as_built", case, dt, False, True)
    assert ok, rep
    real = _kernels.load
    name, defines = chip_smoke.BWD_PLANTED_FAULT
    monkeypatch.setattr(_kernels, "load", lambda n, d=(): real(
        n, defines if n == name else d))
    errors = chip_smoke._bwd_check("planted", case, dt, False, True)[1][
        "errors"]
    assert not errors["dq"]["ok"] and not errors["dbias"]["ok"], errors


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dq_and_dbias_kernels_repeat_bit_for_bit(dt):
    """K3 and K5 own their output rows (no atomics): a second launch on
    the same inputs gives the same bits, causal and with a bias."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args, _ = _bwd_inputs("bert_bf16_d64" if dt == torch.bfloat16
                          else "bert_fp32_d64")
    causal = (*args[:8], True)
    for fn in (port_attn.flash_attention_bwd_dq,
               port_attn.flash_attention_bwd_dbias):
        for a in (args, causal):
            assert torch.equal(fn(*a), fn(*a)), (fn.__name__, a[8])


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


# (N, H, W, C, O, epilogue, dtype, variant) of the K1 cases: C != O, W
# not a multiple of any tile width, a multi-image tile, one wider than a
# tile (W > 256), C not a multiple of the 16-channel chunk; at the wgmma
# variant's edges: C = 64 (a single 64-channel chunk), C = O = 72 (a
# ragged chunk and a ragged 128-channel BN block), 7 x 7 with several
# images to a (flat) tile and N*H*W not a multiple of the tile, W = 300
# with C = 64 (rectangular column tiles), 37 images of 1 x 1 in one
# rectangular tile; and the bfloat16 calls that stay on mma_sync: C = 20
# (TMA needs 16-byte strides) and an x that does not start on a 16-byte
# boundary
K1_CASES = {
    "c64_o96_w30_fp32": (3, 17, 30, 64, 96, True, torch.float32, "fp32"),
    "c48_o16_7x7_bf16": (9, 7, 7, 48, 16, False, torch.bfloat16, "wgmma"),
    "c20_o70_5x9_fp32": (4, 5, 9, 20, 70, True, torch.float32, "fp32"),
    "wide_w300_bf16": (1, 3, 300, 16, 64, True, torch.bfloat16, "wgmma"),
    "1x1_image_fp32": (37, 1, 1, 32, 8, False, torch.float32, "fp32"),
    "c64_single_chunk_bf16": (2, 9, 20, 64, 64, True, torch.bfloat16,
                              "wgmma"),
    "c72_o72_ragged_bf16": (2, 11, 13, 72, 72, True, torch.bfloat16,
                            "wgmma"),
    "7x7_two_images_ragged_bf16": (5, 7, 7, 128, 64, True, torch.bfloat16,
                                   "wgmma"),
    "w300_c64_bf16": (2, 3, 300, 64, 64, True, torch.bfloat16, "wgmma"),
    "1x1_images_bf16": (37, 1, 1, 32, 8, False, torch.bfloat16, "wgmma"),
    "c20_o24_bf16": (3, 6, 10, 20, 24, True, torch.bfloat16, "mma_sync"),
    "c20_o24_w300_bf16": (1, 3, 300, 20, 24, True, torch.bfloat16,
                          "mma_sync"),
    "misaligned_x_bf16": (2, 5, 8, 64, 64, True, torch.bfloat16,
                          "mma_sync"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_conv3x3_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    N, H, W, C, O, epilogue, dt, variant = K1_CASES[case]
    rng = np.random.RandomState(N * H + W)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).to(dev,
                                                                      dt)
    if case.startswith("misaligned"):
        # the same values one element past a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=dt, device=dev)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(N, H, W, C)
        assert x.data_ptr() % 16 != 0
    w = torch.from_numpy((rng.randn(3, 3, C, O) * 0.1).astype(
        np.float32)).to(dev, dt)
    sc = sh = None
    if epilogue:
        sc = torch.from_numpy((rng.rand(O) + 0.5).astype(np.float32)).to(dev)
        sh = torch.from_numpy(rng.randn(O).astype(np.float32)).to(dev)
    assert port_conv.k1_plan(N, H, W, C, O, dt, aligned=x.data_ptr() % 16
                             == 0)["variant"] == variant
    before = port_conv.conv3x3_bn_relu.launches
    by_variant = dict(port_conv.conv3x3_bn_relu.launches_by_variant)
    got = port_conv.conv3x3_bn_relu(x, w, sc, sh, relu=epilogue)
    torch.cuda.synchronize()
    assert port_conv.conv3x3_bn_relu.launches == before + 1
    assert {k: v - by_variant[k] for k, v in
            port_conv.conv3x3_bn_relu.launches_by_variant.items()
            if v != by_variant[k]} == {variant: 1}
    want = port_conv.conv3x3_bn_relu_reference(x, w, sc, sh, relu=epilogue)
    assert got.dtype == dt and got.shape == want.shape
    bound = (1e-4 if dt == torch.float32 else 2e-2) * \
        want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_conv3x3_function_on_the_card_matches_the_library_conv():
    """Conv3x3Function (K1 forward, library backward) against F.conv2d and
    its autograd, float32 NCHW, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(12)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy(rng.randn(4, 24, 13, 11).astype(np.float32)).to(
        dev).requires_grad_()
    w = torch.from_numpy((rng.randn(40, 24, 3, 3) * 0.1).astype(
        np.float32)).to(dev).requires_grad_()
    g = torch.from_numpy(rng.randn(4, 40, 13, 11).astype(np.float32)).to(dev)
    out = port_conv.Conv3x3Function.apply(x, w)
    ref = torch.nn.functional.conv2d(x, w, padding=1)
    got = torch.autograd.grad(out, (x, w), g)
    want = torch.autograd.grad(ref, (x, w), g)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,dt", [(1, 768, torch.float32),
                                    (333, 1000, torch.float32),
                                    (77, 3, torch.bfloat16),
                                    (9, 4097, torch.bfloat16)],
                         ids=["m1_fp32", "ragged_fp32", "d3_bf16",
                              "d4097_bf16"])
def test_layer_norm_kernel_matches_plain_version(M, D, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.RandomState(M + D)
    dev = torch.device("cuda", 0)
    x = torch.from_numpy((rng.randn(M, D) * 3 + 1).astype(np.float32)).to(
        dev, dt)
    sc = torch.from_numpy((rng.rand(D) + 0.5).astype(np.float32)).to(dev)
    bi = torch.from_numpy(rng.randn(D).astype(np.float32)).to(dev)
    before = port_norm.row_layer_norm.launches
    got = port_norm.row_layer_norm(x, sc, bi, 1e-5)
    torch.cuda.synchronize()
    assert port_norm.row_layer_norm.launches == before + 1
    want = port_norm.layer_norm_reference(x, sc, bi, 1e-5)
    assert got.dtype == dt and got.shape == want.shape
    bound = (1e-5 if dt == torch.float32 else 1e-2) * \
        want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bound


def _halo_shift(real, x, w, *rest):
    """Every output one column off, as a wrong halo offset gives."""
    return torch.roll(real(x, w, *rest), 1, dims=2)


def _border_column_zero(real, x, w, *rest):
    """The last output column lost, as a wrong padding predicate gives."""
    out = real(x, w, *rest)
    out[:, :, -1, :] = 0
    return out


def _taps_transposed_at_7x7(real, x, w, *rest):
    """dy and dx swapped at stage 4's shape only (7 x 7, C = 512)."""
    return real(x, w.transpose(0, 1) if x.shape[1] == 7 else w, *rest)


def _one_percent_noise(real, x, w, *rest):
    """Each output off by ~1% of itself, as a low-precision sum gives."""
    out = real(x, w, *rest)
    gen = torch.Generator(device=out.device).manual_seed(0)
    noise = torch.randn(out.shape, generator=gen, device=out.device)
    return (out.float() * (1 + 0.01 * noise)).to(out.dtype)


def _channel_scaled(real, x, w, *rest):
    """Output channel 0 doubled, as a wrong epilogue scale gives."""
    out = real(x, w, *rest)
    out[..., 0] *= 2
    return out


K1_FAULTS = {f.__name__.lstrip("_"): f for f in (
    _halo_shift, _border_column_zero, _taps_transposed_at_7x7,
    _one_percent_noise, _channel_scaled)}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["none"] + sorted(K1_FAULTS))
def test_resnet_check_catches_a_fault_planted_in_k1(fault, monkeypatch):
    """chip_smoke.py's resnet_check (ResNet-50 step 1 from the startup
    weights: the K1 route against the cuDNN route in bf16 at batch 256,
    and the card against the CPU path in fp32 at batch 2) passes with K1
    as it is, and fails when a fault is planted in K1's output on the
    card (the CPU path's plain version stays as it is).  A constant added
    to one output channel is not among the faults: the batch norm after
    every K1 conv removes it in the forward and the backward alike, so no
    result of this path can show it; kernel_conv holds K1's output
    itself.  Run with ``-s`` to see the check's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if fault != "none":
        real = port_conv.conv3x3_bn_relu

        def planted(x, w, scale=None, shift=None, relu=True):
            if not x.is_cuda:           # the CPU path's plain version
                return real(x, w, scale, shift, relu)
            return K1_FAULTS[fault](real, x, w, scale, shift, relu)
        # the kernel wrapper counts its launches on the module's name
        planted.launches = real.launches
        planted.launches_by_variant = real.launches_by_variant
        planted.input_copies = real.input_copies
        monkeypatch.setattr(port_conv, "conv3x3_bn_relu", planted)
    fluid = chip_smoke.fluid
    main, startup, loss = chip_smoke._resnet_program()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).cuda() for k, v in chip_smoke.
            _resnet_feed(chip_smoke.RN_BATCH, chip_smoke.SEED).items()}
    checks = chip_smoke.phase_resnet_check(exe, main, loss, scope, feed)
    compared = (checks["k1_route_matches_cudnn_route"] and
                checks["card_matches_cpu_path"])
    assert compared == (fault == "none"), checks
    if fault == "none":
        assert all(checks.values()), checks


@pytest.mark.cuda
def test_snapshot_and_checkpoint_keep_bf16_bits_on_the_card(tmp_path):
    """Scope.snapshot copies card tensors through pinned buffers with one
    synchronisation: bf16 comes back as its bits (V2), every array owns
    its memory (an in-place update after the snapshot changes nothing),
    and a CheckpointManager save and restore on the card is bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.data_types import BF16_HOST
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    vals = {"emb": torch.randn(1000, 77, device=dev, generator=g)
            .mul(30).to(torch.bfloat16),
            "w": torch.randn(64, 33, device=dev, generator=g),
            "n": torch.arange(5, device=dev, dtype=torch.int64)}
    prog = fluid.Program()
    scope = fluid.Scope()
    for n, t in vals.items():
        prog.global_block().create_var(
            name=n, shape=tuple(t.shape), persistable=True,
            dtype=str(t.dtype).replace("torch.", ""))
        scope.set_var(n, t.clone())
    snap = scope.snapshot()
    assert snap["emb"].dtype == BF16_HOST
    np.testing.assert_array_equal(
        snap["emb"].view(np.int16),
        vals["emb"].view(torch.int16).cpu().numpy())
    for n in ("w", "n"):
        np.testing.assert_array_equal(snap[n], vals[n].cpu().numpy())
    for t in scope.vars.values():
        t.zero_()
    np.testing.assert_array_equal(snap["w"], vals["w"].cpu().numpy())
    for n, t in vals.items():
        scope.set_var(n, t.clone())
    mgr = fluid.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(step=4, scope=scope, main_program=prog)
    mgr.wait()
    fresh = fluid.Scope()
    mgr.restore(scope=fresh, main_program=prog)
    assert fresh.step_counter == 0
    for n, t in vals.items():
        got = fresh.find_var(n)
        assert got.device == dev and got.dtype == t.dtype, n
        assert torch.equal(got, t), n


@pytest.mark.cuda
def test_lookup_gradient_repeats_bit_for_bit_on_the_card():
    """BERT's sentence table on the card: 4,096 ids into 2 rows.  torch's
    embedding backward sums such repeated rows in an order that changes
    from call to call; the lookup_table rule's ``LookupFunction`` gives
    the same bits every time, within float32 rounding of a float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.fluid.ops.tensor_ops import LookupFunction
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 2, 4096)).to(dev)
    g = torch.from_numpy(rng.randn(4096, 768).astype(np.float32)).to(dev)
    w = torch.zeros(2, 768, device=dev, requires_grad=True)
    grads = [torch.autograd.grad(LookupFunction.apply(ids, w), w, g)[0]
             for _ in range(20)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    want = torch.zeros(2, 768, dtype=torch.float64).index_add_(
        0, ids.cpu(), g.cpu().double())
    assert float((grads[0].cpu().double() - want).abs().max()) < 1e-3
    assert not torch.are_deterministic_algorithms_enabled()


def _ring_batches(n=12, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(4, 256, 128).astype(np.float32),
             "ids": rng.randint(0, 30522, (4, 128)).astype(np.int64)}
            for _ in range(n)]


def _through_ring(batches, depth):
    """Every feed of ``batches`` staged on the card by a CardStager
    through ``prefetch_ahead`` at ``depth``, copied on the compute
    stream as it arrives and read back at the end."""
    from paddle_tpu_torch.fluid import reader as port_reader
    from paddle_tpu_torch.fluid.executor import prefetch_ahead
    stager = port_reader.CardStager(torch.device("cuda", 0))
    kept = [{k: v.clone() for k, v in d.items()}
            for d in prefetch_ahead(stager, iter(batches), depth=depth)]
    return [{k: v.cpu().numpy() for k, v in d.items()} for d in kept]


@pytest.mark.cuda
def test_pinned_feed_ring_on_the_card_is_bit_equal_to_depth_0():
    """The feed ring (pinned buffers, side-stream copies, events) and the
    synchronous depth-0 path give the host's bits, every batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.fluid import telemetry
    batches = _ring_batches()
    pinned = telemetry.registry().get("feed_pinned_copies_total")
    c0 = pinned.value()
    ring = _through_ring(batches, 2)
    assert pinned.value() == c0 + len(batches)
    sync = _through_ring(batches, 0)
    assert pinned.value() == c0 + len(batches)
    for r, s, b in zip(ring, sync, batches):
        for k in b:
            np.testing.assert_array_equal(r[k], b[k])
            np.testing.assert_array_equal(s[k], b[k])


@pytest.mark.cuda
def test_a_pinned_buffer_is_refilled_only_after_its_copy(monkeypatch):
    """Each side-stream copy is held back ~25 ms behind a spin kernel, so
    the producer comes back for a recycled pinned buffer while the copy
    that reads it is still queued.  With the event gate the feeds are
    right; with the gate planted away (``_gate`` a no-op) the early
    refill overwrites a buffer before its copy ran and the check sees
    wrong feeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.fluid import reader as port_reader
    real = port_reader._h2d

    def slow_copy(dst, src):
        torch.cuda._sleep(50_000_000)
        real(dst, src)
    monkeypatch.setattr(port_reader, "_h2d", slow_copy)
    batches = _ring_batches(n=8, seed=1)

    def matches(got):
        return all(np.array_equal(g[k], b[k])
                   for g, b in zip(got, batches) for k in b)
    assert matches(_through_ring(batches, 2))
    monkeypatch.setattr(port_reader, "_gate", lambda event: None)
    assert not matches(_through_ring(batches, 2))
