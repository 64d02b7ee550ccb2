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
so no row is fully masked.  K1 (3x3 conv): float32 within 1e-4 of the
largest output, bf16 within 2e-2 of it (the plain version rounds the
float32 sum once, as the kernel does); each K1 case also asserts which
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
