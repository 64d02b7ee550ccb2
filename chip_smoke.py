"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a
non-zero exit (nothing is caught):

1. device: card name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: every CUDA kernel of the port, from paddle_tpu_torch/csrc/,
   K2 with a fault planted in its p v step and the backward with faults
   planted in K3's ds k and K5's store, with nvcc (one process per
   library, started together); the tensor-core kernels K2, K3/K5 and K4
   must show 0 spills in ptxas's report and HMMA in cuobjdump's SASS at
   every instantiation (fp32/bf16 x D 64/128, and x dQ/dBias for K3/K5).
3. bounds: the least time of K1 and K6 at the shapes of their paths,
   computed from their work (no device work).
4. kernel: the flash-attention forward (K2) against its plain PyTorch
   version on the card — BERT-base shapes with a [B,1,S,S] padding bias
   in fp32 and bf16, causal with the LSE, a ragged cross case (S_q=77,
   S_kv=200), D=128, and the edges of its mma fragments and tiles (1 x 1,
   9 x 13, 130 x 130) with biases read through other strides (broadcast
   over heads or batch, transposed, rows longer than S_kv); the K2 with a
   planted fault must fail the same check; then its time beside the
   plain version, one scaled_dot_product_attention call (the yardstick,
   never used by the port) and the bound (fp32 products at the faster of
   the CUDA cores and split TF32 on the tensor cores).
5. kernel_bwd: the backward kernels K3 (dQ), K4 (dK/dV) and K5 (dBias)
   against their plain versions — the BERT-base training shape (BH=384,
   S=128, D=64, [32,1,128,128] padding bias) in fp32 and bf16, causal,
   ragged cross 77 x 200, D=128 and phase 4's edge cases; the backward
   with planted faults must fail the same check on dq and dbias in fp32
   and bf16, and two launches of K3 (and of K5) give the same bits —
   then their times at the training shape beside the plain versions, the
   SDPA backward (and the names of the kernels it runs) and the bounds,
   and K2's with the LSE.
5b. kernel_nmt: K2 (with the LSE), K3 and K4 at Transformer NMT's
   shape (BH=256, S=256, D=64), causal and with its [B,1,1,S] pad bias
   read as a stride-0 view, in fp32 (the dtype its attention runs in)
   and bf16, against their plain versions at the same tolerances (K5 too
   in the pad-bias check); their times beside the plain versions, SDPA
   and the bounds, the causal half of the work counted.
6. kernel_conv: ptxas's report for K1's wgmma kernel (registers,
   spills: none allowed); K1 (3x3 implicit-GEMM conv) against its plain
   version at the four ResNet-50 3x3 stride-1 shapes, batch 256 in bf16
   and batch 32 in fp32, with and without the BN+relu epilogue, each
   launching the variant its plan names (wgmma in bf16, fp32 in fp32);
   then its time per shape beside the plain version, cuDNN (F.conv2d,
   channels_last bf16; never called by the port for these convs), the
   bound, and the NCHW -> NHWC copy the wrapper makes of an input that
   is not channels_last.
7. kernel_ln: K6 (row layer norm) against its plain version at
   [4096, 768] fp32 and bf16 and a ragged [1000, 1000]; its time beside
   the plain version, F.layer_norm and the bound.
8. slice: BERT-base (12 x 768, 12 heads, S=128, ~109M parameters, random
   weights from a seed) built with the port's layers, cloned for test,
   started on CUDAPlace(0) and served through ServingExecutor(max_batch=8)
   — 24 requests of 1-8 rows with random true lengths — checked against
   the same rows run alone, against the matmul/softmax composition with
   the same weights, and against the port's CPU path on two rows; K2's
   launch count must be 12 per dispatched batch, and no other kernel
   may launch.  Then a profile.
9. train: BERT-base pretraining (build_pretrain: batch 32, 20 masked
   positions, fp32, Adam lr 1e-4, hidden dropout 0.1, attention dropout
   0) through Executor, 2 warm-up and 8 timed steps on one synthetic
   batch: finite falling losses, 12 K2, 12 K3, 12 K4 and 0 K5 launches
   per step, ms per step, sequences/s, tokens/s, peak memory, one
   profiled step; then fused vs composition path and card vs the port's
   CPU path (batch 2) on the step-1 loss and named gradients.
10. train_bias: an attention layer whose bias is a trainable [1,H,S,S]
   parameter — the path that launches K5 — against the composition path.
11. train_attn_dropout: BERT with attention dropout 0.1 at 2 layers, the
   composition route: finite losses, no flash kernel launched.
12. resnet_train: bench.py's bench_resnet program built with the port —
   ResNet-50 v1.5, 224 x 224, batch 256, pure bf16, Momentum 0.9 with
   L2Decay 1e-4, lr 0.1, FLAGS_conv_pallas=1 — 2 warm-up and 8 timed
   steps on one synthetic batch: finite falling losses, 13 K1 launches
   per step, all of the wgmma variant, and no other kernel; how many of
   the 13 copy their input to NHWC first; ms per step, images/s, peak
   memory.
13. resnet_profile: one profiled ResNet-50 step: kernel time against
   wall, device busy share, events, launch calls, top kernels, kernel
   time by kind (K1's share must not be 0).
   resnet_check: step 1 from the startup weights, the K1 route against
   the cuDNN route (flag off, bf16, batch 256) and the card against the
   port's CPU path (fp32, batch 2), on the loss and chosen gradients,
   each within the larger of its fixed bound and twice the spread of a
   route that runs no K1 either.
14. ln_path: a fused_layer_norm program forward and backward through
   Executor: one K6 launch per run, and the gradients of the layer_norm
   op's program.
15. nmt_train: bench.py's bench_nmt program built with the port —
   Transformer NMT base (6 + 6 layers, width 512, 8 heads, S=256,
   vocabularies of 30,000, dropout 0.1, label smoothing 0.1), Adam on
   noam_decay, pure bf16, batch 32, bench_nmt's two all-ones-mask feeds
   in turn — 2 warm-up and 8 timed steps: finite losses, the fetched
   learning rate equal to the Noam closed form at steps 1-10, the step
   counter at 10, no flash kernel (attention dropout takes the
   composition); ms per step, tokens/s, peak memory, one profiled step.
16. nmt_train_flash: the same with attention dropout off and ragged
   masks: 18 K2, 18 K3, 18 K4 (6 causal) and 0 K5 per step; then
   nmt_check: step 1 from the startup weights, dropout off, the fused
   route against the composition route (bf16, batch 32) and the card
   against the port's CPU path (fp32, batch 2, 2 + 2 layers), each
   within the larger of its fixed bound and twice the spread of the
   fused route running the kernels' plain versions.
17. lenet_train: bench_lenet's program (LeNet-5, batch 1024, Adam 1e-3,
   two feeds in turn), 2 warm-up and 8 timed steps: finite falling
   losses, images/s, none of the port's kernels launched.
18. deepfm_train: bench_deepfm's program (DeepFM base_config: 26
   fields over a 1,000,001-row table, embeddings of 10, a 400 x 3 tower;
   Adam 1e-3, batch 4096, two feeds in turn), 2 warm-up and 8 timed
   steps: finite falling losses, examples/s, peak memory, one profiled
   step, none of the port's kernels launched; then deepfm_check: three
   steps from the startup weights on the card (twice, then with each
   batch's examples reversed) and on the port's CPU path (as fed and
   reversed), losses within 1e-4, each parameter within max(2 x the sum
   of the largest spreads over the card's runs and the CPU's, 1e-6).
19. deepfm_optimizers: DeepFM at batch 512, the same check for each of
   the eight optimizers the port adds (LarsMomentum, Adamax, Adagrad,
   DecayedAdagrad, Adadelta, centered RMSProp, Ftrl, Lamb), Adam with
   GradientClipByGlobalNorm, SGD with GradientClipByValue on the tower
   and a per-parameter rate of 0.5 on fm_emb, and SGD on each of the
   seven schedules, whose fetched rate must equal its closed form
   within 1e-6.
20. kernels: one JSON line listing every ported kernel, with its
   launches on every main path (0 on DeepFM's).

The last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
no result, where torch.cuda.is_available() is false.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import _kernels, attention_ops
from paddle_tpu_torch.fluid.ops.attention_ops import (
    attention_delta, attention_reference, dbias_reference, dkv_reference,
    dq_reference, flash_attention, flash_attention_bwd_dbias,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, recompute_p_dp)
from paddle_tpu_torch.fluid.ops.conv_ops import (
    K1_VARIANTS, conv3x3_bn_relu, conv3x3_bn_relu_reference, k1_plan)
from paddle_tpu_torch.fluid.ops.norm_ops import (
    layer_norm_reference, row_layer_norm)
from paddle_tpu_torch.models import bert, deepfm, lenet, resnet, transformer

# H100 SXM published peaks (NVIDIA data sheet): device memory rate, and
# float32 on the CUDA cores (the main path runs fp32 with TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # tensor cores, dense (K1's bound in bf16)
PEAK_TF32_FLOPS = 495e12      # tensor cores, dense; split TF32 (three
#                               products for one fp32-accurate product, as
#                               K2 and K4 compute) runs at a third of it
# the K2 variant with a wrong pairing of p's columns and V's rows, which
# phase_kernel's check must fail
PLANTED_FAULT = ("flash_attention_fwd", ("PADDLE_ATTN_PLANTED_FAULT",))
# the backward variant whose K3 pairs K's rows 2t and 2t + 1 with the wrong
# columns of ds in ds k, and whose K5 swaps the two columns of each pair it
# writes: phase_kernel_bwd's check must fail both
BWD_PLANTED_FAULT = ("flash_attention_bwd", ("PADDLE_ATTN_BWD_PLANTED_FAULT",))
# the tensor-core kernels of the attention sources, held to no spills and
# to HMMA instructions in their machine code, with their instantiations
# (fp32/bf16 x D 64/128; q_rows_kernel also x dQ (K3) / dBias (K5))
MMA_KERNELS = (("flash_attention_fwd", "flash_fwd_kernel", 4),
               ("flash_attention_bwd", "dkv_kernel", 4),
               ("flash_attention_bwd", "q_rows_kernel", 8))

SEED = 1234
# every kernel wrapper of the port, by the name the kernels line gives it
KERNELS = {"flash_attention_fwd": flash_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "flash_attention_bwd_dbias": flash_attention_bwd_dbias,
           "conv3x3_bn_relu": conv3x3_bn_relu,
           "layer_norm": row_layer_norm}
B, H, S, D = 8, 12, 128, 64             # BERT-base serving shape
# Tolerances.  A query row whose every key is masked (a padding position:
# BERT's mask adds -1e4 to all its scores) holds its scores at -1e4 + O(1),
# where float32 spacing is 2^-10 ~ 1e-3: two summation orders that differ
# by one ulp in q.k move such a row's probabilities by up to ~1e-3
# relative, so its output by up to ~1e-3 * max|v|.  Those rows get their
# own bound; every other row is held to the tight one.
FP32_ATOL = 1e-4              # kernel vs plain version, fp32, real rows
MASKED_ATOL = 5e-3            # ... fully masked rows (|v| <= ~5 for randn)
BF16_TOL = 2e-2               # bf16 kernel vs fp32 plain (atol and rtol)
SERVE_TOL = 1e-3              # served rows vs alone / composition / CPU,
#                               real token positions
SERVE_PAD_TOL = 5e-2          # ... padding positions: the masked-row
#                               spread above (~3e-3 per layer) over 12 layers


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_time_ms(fn, iters=50, warmup=20):
    """Device time per call of ``fn``.  A spin kernel holds the stream
    while the host enqueues the calls, so the CUDA events around them
    bracket device work only, not Python's launch overhead.  The calls
    must also fit the device's queue of pending launches (about a
    thousand), or enqueueing blocks: while the host cannot get ahead,
    the spin doubles and the count halves.  A call that waits for the
    device inside never lets the host get ahead, and its timing fails."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 100_000_000                  # GPU cycles, ~50 ms at 2 GHz
    while iters >= 1:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        h0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        spin *= 2
        iters //= 2
    raise SystemExit("could not keep the host ahead of the device "
                     "while timing %r" % (fn,))


def _check_no_host_sync(fn, spin=100_000_000):
    """A kernel wrapper must only enqueue: called while a spin kernel holds
    the stream, it has to return long before the spin ends."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(spin)
    ev[1].record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    emit(phase="kernel_no_host_sync", host_ms=host_ms, spin_ms=spin_ms,
         ok=host_ms < spin_ms / 2)
    if host_ms >= spin_ms / 2:
        raise SystemExit("a kernel wrapper blocked the host %.1f ms behind "
                         "a %.1f ms busy stream (a hidden synchronisation)"
                         % (host_ms, spin_ms))


def _fail_unless(name, checks):
    """Ends the run, naming the phase and its failed checks, unless every
    check passed."""
    if not all(checks.values()):
        raise SystemExit("%s checks failed: %s"
                         % (name, [k for k, ok in checks.items() if not ok]))


def _card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device():
    smi = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


SASS_OPS = ("HMMA", "LDSM", "LDGSTS")    # tensor-core mma, ldmatrix, cp.async


def _sass_counts(source, kernel):
    """Instructions of each name in SASS_OPS in cuobjdump's SASS of each
    instantiation of ``kernel`` in the library of ``source``."""
    cuobjdump = str(Path(_kernels._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_kernels.library_path(source))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            name = fn if kernel in fn else None
            if name is not None:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                if op + "." in ln or op + " " in ln:
                    counts[name][op] += 1
    return counts


def phase_build():
    """Every source and the planted-fault variants of K2 and of the
    backward, one nvcc each, all at once; then the tensor-core attention
    kernels (K2, K3/K5, K4) are held to 0 spills (ptxas) and to HMMA
    instructions (cuobjdump) at every instantiation."""
    t0 = time.perf_counter()
    times = _kernels.build_all(variants=[PLANTED_FAULT, BWD_PLANTED_FAULT])
    wall = time.perf_counter() - t0
    ptxas = {}
    for src in _kernels.sources():
        lines = _kernels.build_log(src.stem).splitlines()
        ptxas[src.stem] = [ln.strip() for ln in lines
                           if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(wall, 3), compiled=times,
         ptxas=ptxas)
    bad = []
    for source, kernel, want in MMA_KERNELS:
        report = _ptxas_report(source, kernel)
        sass = _sass_counts(source, kernel)
        spill_free = {n: any(" 0 bytes spill stores, 0 bytes spill loads"
                             in ln for ln in lines)
                      for n, lines in report.items()}
        emit(phase="build_mma", source=source, kernel=kernel,
             instantiations=len(report), ptxas=report, sass=sass,
             spill_free=spill_free)
        if len(report) != want or len(sass) != want:
            bad.append("%s: %d instantiations in ptxas's report, %d in "
                       "the SASS (want %d)"
                       % (kernel, len(report), len(sass), want))
        bad += ["%s spills" % n for n, ok in spill_free.items() if not ok]
        bad += ["%s has no HMMA" % n for n, c in sass.items()
                if not c["HMMA"]]
    if bad:
        raise SystemExit("attention kernels fail the build gate: %s" % bad)


def _padding_bias(lengths, dtype, dev):
    """[B, 1, S, S] additive mask as bert_encoder builds it: 0 where both
    query and key are real tokens, -1e4 elsewhere."""
    m = (torch.arange(S, device=dev)[None, :] <
         torch.as_tensor(lengths, device=dev)[:, None]).float()
    keep = m[:, :, None] * m[:, None, :]
    return ((keep - 1.0) * 1e4).unsqueeze(1).to(dtype)


def _fully_masked_rows(bias, BH, S_q):
    """[BH, S_q] bool: rows whose every key carries a -1e4 mask."""
    if bias is None:
        return torch.zeros(BH, S_q, dtype=torch.bool, device="cuda")
    rows = bias.float().amax(-1)                # [Bb, 1|heads, S_q] or 3-D
    if rows.dim() == 2:
        return rows <= -1e3
    Bb = rows.shape[0]
    return (rows.expand(Bb, BH // Bb, S_q) <= -1e3).reshape(BH, S_q)


def _k2_check(name, t, dt, causal):
    """K2 against attention_reference (fp32, on the dt-rounded inputs) in
    one case: (ok, report)."""
    args = [None if t[n] is None else t[n].to(dt)
            for n in ("q", "k", "v", "bias")]
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    got, lse = flash_attention(*args, scale, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    # the plain version in fp32 on the (possibly bf16-rounded) inputs
    ref_args = [None if a is None else a.float() for a in args]
    want, want_lse = attention_reference(*ref_args, scale, causal=causal,
                                         with_lse=True)
    row_err = (got.float() - want).abs().amax(-1)       # [BH, S_q]
    masked = _fully_masked_rows(args[3], *row_err.shape)
    err = row_err[~masked].max().item()
    masked_err = row_err[masked].max().item() if masked.any() else 0.0
    lse_err = (lse - want_lse).abs()[~masked].max().item()
    finite = bool(torch.isfinite(got.float()).all())
    if dt == torch.float32:
        ok = err <= FP32_ATOL and lse_err <= FP32_ATOL and \
            masked_err <= MASKED_ATOL
        tol = "atol %g (fully masked rows %g)" % (FP32_ATOL, MASKED_ATOL)
    else:
        ok = bool(torch.allclose(got.float(), want, atol=BF16_TOL,
                                 rtol=BF16_TOL)) and lse_err <= BF16_TOL
        tol = "atol/rtol %g vs fp32 plain of bf16 inputs" % BF16_TOL
    b = args[3]
    return ok and finite, dict(
        case=name, dtype=str(dt), shape=list(args[0].shape),
        kv=args[1].shape[1], causal=causal,
        bias=None if b is None else dict(shape=list(b.shape),
                                         strides=list(b.stride())),
        max_abs_err=err, masked_rows=int(masked.sum()),
        masked_rows_max_abs_err=masked_err, lse_max_abs_err=lse_err,
        tolerance=tol, finite=finite)


def phase_kernel():
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def qkv(BH, S_q, S_kv, d=D, bias=None):
        return dict(q=rand(BH, S_q, d), k=rand(BH, S_kv, d),
                    v=rand(BH, S_kv, d), bias=bias)

    lengths = torch.randint(1, S + 1, (B,), generator=gen,
                            device=dev).tolist()
    base = qkv(B * H, S, S, bias=_padding_bias(lengths, torch.float32, dev))
    cases = [
        ("bert_base_fp32", base, torch.float32, False),
        ("bert_base_bf16", base, torch.bfloat16, False),
        ("causal_lse_fp32", qkv(B * H, S, S), torch.float32, True),
        ("ragged_cross_77x200_fp32",
         qkv(16, 77, 200, bias=torch.where(rand(16, 77, 200) < -1.5, -1e4,
                                           0.0)), torch.float32, False),
        ("d128_bias_fp32", qkv(48, S, S, 128, bias=base["bias"][:4]),
         torch.float32, False),
        ("d128_causal_lse_bf16", qkv(48, S, S, 128), torch.bfloat16, True),
        # the edges of the mma fragments and tiles: S_q and S_kv not
        # multiples of 8 or 16, one key, three K/V tiles under causal
        ("1x1_fp32", qkv(4, 1, 1), torch.float32, False),
        ("9x13_head_broadcast_bias_fp32",
         qkv(24, 9, 13, bias=rand(2, 1, 9, 13)), torch.float32, False),
        ("130x130_causal_fp32", qkv(8, 130, 130), torch.float32, True),
        ("130x130_bias_bf16", qkv(8, 130, 130, bias=rand(8, 130, 130)),
         torch.bfloat16, False),
        # a bias read with bs_k != 1 (a transposed view) and one broadcast
        # over the batch (bs_b = 0)
        ("transposed_bias_77x200_fp32",
         qkv(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.float32, False),
        ("transposed_bias_77x200_bf16",
         qkv(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.bfloat16, False),
        # rows longer than S_kv: the last 16-byte chunk of a bias row is cut
        ("sliced_bias_77x198_fp32",
         qkv(16, 77, 198, bias=rand(16, 77, 208)[:, :, :198]),
         torch.float32, False),
        ("batch_broadcast_bias_d128_fp32",
         qkv(4 * H, S, S, 128, bias=rand(1, H, S, S).expand(4, H, S, S)),
         torch.float32, False),
    ]
    errs = {}
    for name, t, dt, causal in cases:
        ok, rep = _k2_check(name, t, dt, causal)
        emit(phase="kernel_check", ok=ok, **rep)
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain "
                             "version in case %s" % name)
        errs[name] = rep["max_abs_err"]
    _planted_fault_check(cases[:2])

    # timing at the main path's shape and dtype (BERT-base, fp32, B=8)
    q, k, v, bias = base["q"], base["k"], base["v"], base["bias"]
    scale = 1.0 / math.sqrt(D)
    _check_no_host_sync(lambda: flash_attention(q, k, v, bias, scale))
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, bias, scale))
    plain_ms = cuda_time_ms(
        lambda: attention_reference(q, k, v, bias, scale))
    q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, scale=scale))
    flops = 4.0 * B * H * S * S * D
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * \
        bias.element_size()
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  **_attention_bound(nbytes, flops))
    emit(phase="kernel_time", shape=[B * H, S, D], dtype="float32",
         roofline_share=timing["bound_ms"] / ms, **timing)
    return dict(max_abs_err=errs["bert_base_fp32"], **timing)


def _planted_fault_check(cases):
    """K2 built with a wrong pairing of p's columns and V's rows in p v
    (PLANTED_FAULT) must fail _k2_check in every one of ``cases``."""
    real = _kernels.load
    name, defines = PLANTED_FAULT
    _kernels.load = lambda n, d=(): real(n, defines if n == name else d)
    try:
        caught = {c[0]: not _k2_check(*c)[0] for c in cases}
    finally:
        _kernels.load = real
    emit(phase="kernel_planted_fault", fault="p v rows 2t and 2t+1 "
         "swapped (%s)" % defines[0], caught=caught, ok=all(caught.values()))
    if not all(caught.values()):
        raise SystemExit("the K2 check passed a kernel with a fault planted "
                         "in its p v step: %s" % caught)


FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def _build_bert(cfg):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = [fluid.layers.data(n, [cfg.max_seq_len, 1],
                                  dtype="float32" if n == "input_mask"
                                  else "int64") for n in FEEDS]
        enc = bert.bert_encoder(*data, cfg)
    return main, startup, enc


def _requests(cfg, rng, n):
    out = []
    for _ in range(n):
        rows = int(rng.randint(1, 9))
        lengths = rng.randint(1, cfg.max_seq_len + 1, rows)
        out.append({
            "src_ids": rng.randint(0, cfg.vocab_size,
                                   (rows, cfg.max_seq_len, 1)),
            "pos_ids": np.tile(np.arange(cfg.max_seq_len).reshape(
                1, -1, 1), (rows, 1, 1)),
            "sent_ids": rng.randint(0, 2, (rows, cfg.max_seq_len, 1)),
            "input_mask": (np.arange(cfg.max_seq_len)[None, :, None] <
                           lengths[:, None, None]).astype(np.float32),
        })
    return out


def _split_err(a, b, feed):
    """[max abs err over real token positions, over padding positions]."""
    real = feed["input_mask"][..., 0] > 0
    d = np.abs(a - b).max(-1)
    return [float(d[real].max()),
            float(d[~real].max()) if (~real).any() else 0.0]


def _within(err):
    return bool(err[0] <= SERVE_TOL and err[1] <= SERVE_PAD_TOL)


def _device_ms(prof, n):
    """Kernel time per iteration, by kernel name, from a profiler run of
    n iterations: device-side events only (CPU ops also carry the time of
    the kernels they launched, which would count it twice)."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return total, [dict(name=e.key[:90],
                        ms=e.self_device_time_total / n / 1e3,
                        calls=e.count / n) for e in top]


def _timeline(prof):
    """(busy ms, idle-gap ms, event count) of the device timeline of a
    profiled window: kernels, copies and fills in start order; busy is
    the union of their spans, idle the time between the first start and
    the last end that no event covers."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, idle_us, end = 0.0, 0.0, None
    for a, b in spans:
        if end is not None and a > end:
            idle_us += a - end
        lo = a if end is None else max(a, end)
        busy_us += max(0.0, b - lo)
        end = b if end is None else max(end, b)
    return busy_us / 1e3, idle_us / 1e3, len(spans)


WARM_STEPS, TIMED_STEPS = 2, 8      # every training phase


def _train_steps(exe, main, feeds, fetch, scope):
    """Runs WARM_STEPS + TIMED_STEPS steps, feeds taken in turn; (fetches
    of each step as tensors, ms per timed step)."""
    got = []
    for i in range(WARM_STEPS + TIMED_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        got.append(exe.run(main, feed=feeds[i % len(feeds)],
                           fetch_list=fetch, scope=scope,
                           return_numpy=False))
    torch.cuda.synchronize()
    return got, (time.perf_counter() - t0) / TIMED_STEPS * 1e3


def _profile_step(name, exe, main, feed, fetch, scope):
    """One profiled step: kernel time against wall, the device timeline's
    busy share, device events, launch calls, top kernels and the kernel
    time by kind, which it returns."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev_ms, top = _device_ms(prof, 1)
    busy_ms, _, events = _timeline(prof)
    launch = [e for e in prof.key_averages()
              if e.key.startswith("cudaLaunchKernel")]
    kinds = _kernel_kinds(prof)
    emit(phase=name, wall_ms=wall_ms, kernel_ms=dev_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         device_events=events, launch_calls=sum(e.count for e in launch),
         kernel_ms_by_kind=kinds, top_kernels=top)
    return kinds


def phase_profile(exe, infer, enc, scope, sv_args, reqs):
    """Where the time goes.  (a) One full batch of 8: host wall of
    back-to-back Executor.run calls (no serving threads) against the
    kernel time torch.profiler records.  (b) The same 24-request burst
    served again under the profiler: the device timeline's busy time and
    idle gaps against wall, and the host's kernel-launch calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    req = max(reqs, key=lambda r: r["src_ids"].shape[0])
    feed = {n: np.concatenate([a] * 8)[:8] for n, a in req.items()}

    def run():
        exe.run(infer, feed=feed, fetch_list=[enc], scope=scope,
                return_numpy=False)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=acts) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    dev_ms, top = _device_ms(prof, 5)
    emit(phase="profile_batch", batch=8,
         ops_per_batch=len(infer.global_block().ops),
         host_wall_ms_per_batch=wall_ms, device_ms_per_batch=dev_ms,
         device_busy_share=dev_ms / wall_ms, top_kernels=top)

    sv = fluid.ServingExecutor(**sv_args)
    sv.warmup()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        futs = [sv.submit(r) for r in reqs]
        for f in futs:
            f.result(timeout=300)
        wall_ms = (time.perf_counter() - t0) * 1e3
        sv.close()
    st = sv.stats()
    busy_ms, idle_ms, events = _timeline(prof)
    launch = [e for e in prof.key_averages()
              if e.key.startswith("cudaLaunchKernel")]
    emit(phase="profile_serve", requests=len(reqs), batches=st["batches"],
         wall_ms=wall_ms, wall_ms_per_batch=wall_ms / st["batches"],
         device_events=events,
         device_events_per_batch=events / st["batches"],
         device_busy_ms=busy_ms, device_idle_gaps_ms=idle_ms,
         device_busy_share=busy_ms / wall_ms,
         launch_calls=sum(e.count for e in launch),
         launch_api_ms=sum(e.self_cpu_time_total for e in launch) / 1e3)


def phase_slice():
    cfg = bert.base_config()
    main, startup, enc = _build_bert(cfg)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(scope.find_var(v.name).numel()
                   for v in main.global_block().all_parameters())
    emit(phase="startup", seconds=time.perf_counter() - t0,
         parameters=int(n_params), layers=cfg.num_layers,
         hidden=cfg.hidden_size, heads=cfg.num_heads, seq=cfg.max_seq_len)

    specs = {n: ((cfg.max_seq_len, 1), "float32" if n == "input_mask"
                 else "int64") for n in FEEDS}
    sv_args = dict(program=infer, feed_specs=specs, fetch_list=[enc],
                   scope=scope, executor=exe, max_batch=8)
    sv = fluid.ServingExecutor(**sv_args)
    reqs = _requests(cfg, np.random.RandomState(SEED), 24)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after close()
    _reset_launches()
    warm = sv.warmup()
    warm_launches = flash_attention.launches
    done = {}
    t_start = time.perf_counter()
    futs = []
    for i, r in enumerate(reqs):
        t = time.perf_counter()
        f = sv.submit(r)
        f.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append((f, t))
    outs = [f.result(timeout=300)[0] for f, _ in futs]
    wall = time.perf_counter() - t_start
    sv.close()
    all_launches = _launches()
    launches = all_launches["flash_attention_fwd"]
    st = sv.stats()
    served_launches = launches - warm_launches
    lat_ms = sorted((done[i] - t) * 1e3 for i, (_, t) in enumerate(futs))
    rows = sum(r["src_ids"].shape[0] for r in reqs)
    emit(phase="serve", warmup_s=warm, stats=st, wall_s=wall,
         requests_per_s=len(reqs) / wall, rows_per_s=rows / wall,
         p50_ms=float(np.percentile(lat_ms, 50)),
         p99_ms=float(np.percentile(lat_ms, 99)),
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         kernel_launches=launches, warmup_launches=warm_launches,
         served_launches=served_launches)
    checks = {
        "recompiles_after_warmup_0": st["recompiles"] == 0,
        "all_answered": st["responses"] == len(reqs),
        "launches_12_per_warmup_bucket":
            warm_launches == cfg.num_layers * len(sv.buckets),
        "launches_12_per_batch":
            served_launches == cfg.num_layers * st["batches"],
        "no_backward_launches": not any(
            c for n, c in all_launches.items() if n != "flash_attention_fwd"),
    }

    # every response finite, and equal to its rows run alone
    err_alone = [0.0, 0.0]
    for r, out in zip(reqs, outs):
        n = r["src_ids"].shape[0]
        if out.shape != (n, cfg.max_seq_len, cfg.hidden_size) or \
                not np.isfinite(out).all():
            raise SystemExit("non-finite or mis-shaped response %s"
                             % (out.shape,))
        alone, = exe.run(infer, feed=r, fetch_list=[enc], scope=scope)
        err_alone = np.maximum(err_alone, _split_err(out, alone, r))
    checks["batched_matches_alone"] = _within(err_alone)

    # the composition path (use_fused_attention=False) with the same weights
    ccfg = bert.base_config(use_fused_attention=False)
    cmain, _, cenc = _build_bert(ccfg)
    probe = reqs[int(np.argmax([r["src_ids"].shape[0] for r in reqs]))]
    fused, = exe.run(infer, feed=probe, fetch_list=[enc], scope=scope)
    comp, = exe.run(cmain.clone(for_test=True), feed=probe,
                    fetch_list=[cenc], scope=scope)
    err_comp = _split_err(fused, comp, probe)
    checks["composition_matches_fused"] = _within(err_comp)

    # the port's CPU path (plain attention, CPU matmuls) on two rows
    cpu_scope = fluid.Scope()
    for v in main.global_block().all_parameters():
        cpu_scope.set_var(v.name, scope.find_var(v.name).cpu())
    two = {n: a[:2] for n, a in probe.items()}
    cpu_out, = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed=two, fetch_list=[enc], scope=cpu_scope)
    err_cpu = _split_err(fused[:2], cpu_out, two)
    checks["gpu_matches_cpu_path"] = _within(err_cpu)

    emit(phase="slice_check",
         tolerance="atol %g real tokens, %g padding positions"
         % (SERVE_TOL, SERVE_PAD_TOL),
         max_abs_err_batched_vs_alone=list(map(float, err_alone)),
         max_abs_err_fused_vs_composition=err_comp,
         max_abs_err_gpu_vs_cpu=err_cpu, checks=checks)
    _fail_unless("slice", checks)
    phase_profile(exe, infer, enc, scope, sv_args, reqs)
    return all_launches


# ---------------------------------------------------------------------------
# Backward kernels (K3, K4, K5) and BERT-base pretraining
# ---------------------------------------------------------------------------

BT = 32                       # BERT-base training batch
MAX_PRED = 20                 # masked positions per sequence
TRAIN_LR = 1e-4
BWD_FP32_ATOL = 1e-4          # K3/K4/K5 vs plain version, fp32, real rows
# A fully masked query row has scores at -1e4 + O(1), where fp32 spacing
# is 2^-10 ~ 1e-3: two summation orders can put s one grid step apart,
# which moves p = exp(s - lse) by up to ~1e-3 relative (2e-3 allows one
# step in the scale product and one in the bias add).  Such rows are held
# to that bound propagated through each gradient (_masked_bounds); every
# other entry keeps BWD_FP32_ATOL.
MASKED_P_REL = 2e-3
TRAIN_LOSS_RTOL = 1e-4        # step-1 loss, card fused vs composition/CPU
TRAIN_GRAD_TOL = 1e-3         # |grad diff| / max|grad|, same comparisons


def _bwd_args(t, dt, causal, zero_masked_do):
    """(q, k, v, bias, scale, dO, lse, delta, causal) in ``dt``, with out
    and LSE from the plain forward in fp32 of the dt-rounded inputs.
    ``zero_masked_do``: dO is 0 on fully masked rows, as training gives it
    (the loss never reads a padding position)."""
    q, k, v, b, dO = [None if t[n] is None else t[n].to(dt)
                      for n in ("q", "k", "v", "bias", "dO")]
    scale = 1.0 / math.sqrt(q.shape[-1])
    masked = _fully_masked_rows(b, q.shape[0], q.shape[1])
    if zero_masked_do:
        dO = dO.masked_fill(masked.unsqueeze(-1), 0.0)
    ref = [None if a is None else a.float() for a in (q, k, v, b)]
    out, lse = attention_reference(*ref, scale, causal=causal,
                                   with_lse=True)
    delta = attention_delta(out.to(dt), dO)
    return (q, k, v, b, scale, dO, lse, delta, causal), masked


def _masked_bounds(args, masked):
    """Per-entry bounds on dq, dk, dv, dbias from MASKED_P_REL on the p of
    fully masked rows (see above), from the plain version's p and dp."""
    q, k, v, b, scale, dO, lse, delta, causal = args
    p, dp = recompute_p_dp(q, k, v, b, scale, dO, lse, causal)
    p_err = p * masked.unsqueeze(-1) * MASKED_P_REL   # 0 on other rows
    ds_err = p_err * (dp - delta.float().unsqueeze(-1)).abs()
    return dict(
        dq=torch.einsum("bqk,bkd->bqd", ds_err * scale, k.float().abs()),
        dk=torch.einsum("bqk,bqd->bkd", ds_err * scale, q.float().abs()),
        dv=torch.einsum("bqk,bqd->bkd", p_err, dO.float().abs()),
        dbias=ds_err)


def _bound(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    """The least time (ms) for work of ``flops`` moving ``nbytes``, at
    ``peak_flops`` (fp32 on the CUDA cores unless given)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def _attention_bound(nbytes, flops):
    """_bound of an fp32 attention kernel (K2-K5): its products at the
    faster of the CUDA cores' fp32 (67 TFLOP/s) and split TF32 on the
    tensor cores (495 / 3 TFLOP/s, fp32-accurate), named in ``ops_peak``;
    ``bound_ms_cuda_cores`` keeps the bound at the CUDA cores' rate."""
    peak, ops = max((PEAK_FP32_FLOPS, "fp32 CUDA cores 67 TFLOP/s"),
                    (PEAK_TF32_FLOPS / 3, "split TF32 495/3 TFLOP/s"))
    return dict(_bound(nbytes, flops, peak), ops_peak=ops,
                bound_ms_cuda_cores=_bound(nbytes, flops)["bound_ms"])


# ResNet-50 v1.5's 3x3 stride-1 pad-1 convs (the ones K1 takes behind
# FLAGS_conv_pallas): (H = W, C = O, convs per step) — the 3x3 conv of
# each bottleneck block but the first of stages 2-4 (stride 2)
RESNET_K1_SHAPES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
RN_BATCH = 256                # bench.py bench_resnet's batch
RN_SIZE = 224
LN_SHAPE = (BT * S, H * D)    # K6: BERT-base's training hidden state


def k1_work(n, hw, c, o, esz):
    """(bytes, flops) of one K1 launch: x read once, w read once, out
    written once (scale/shift absent on the op path), 2·M·K·N flops."""
    flops = 2.0 * n * hw * hw * 9 * c * o
    nbytes = esz * (n * hw * hw * c + 9 * c * o + n * hw * hw * o)
    return nbytes, flops


def k1_bound(n, hw, c, esz=2):
    """K1's least time at one shape: bf16 against the tensor cores' peak
    (the work the card could do there), fp32 against the CUDA cores'."""
    peak = PEAK_BF16_FLOPS if esz == 2 else PEAK_FP32_FLOPS
    return _bound(*k1_work(n, hw, c, c, esz), peak)


def k6_bound(M, Dm, esz=4):
    """K6's least time: x read and y written once, scale and bias read
    once; mean, centre, square, variance, scale and shift ~8 flops per
    entry."""
    return _bound(esz * 2 * M * Dm + 4 * 2 * Dm, 8.0 * M * Dm)


def phase_bounds():
    """Bounds of K1 and K6 at the shapes of their paths, from their work
    (no device work).  K1 (conv_pallas.py:80) runs on the 13 3x3 stride-1
    convs of ResNet-50 training (bench_resnet: batch 256, 224 x 224, pure
    bf16), forward only; K6 (pallas_ops.py:726) backs fused_layer_norm,
    at BERT-base's training hidden state x2d [32 * 128, 768] fp32."""
    rows, step_ms = [], 0.0
    for hw, c, n in RESNET_K1_SHAPES:
        b = k1_bound(RN_BATCH, hw, c)
        rows.append(dict(hw=hw, C=c, O=c, convs=n, **b))
        step_ms += n * b["bound_ms"]
    emit(phase="bounds", kernel="K1 conv3x3", dtype="bfloat16",
         batch=RN_BATCH, convs=rows, bound_ms_per_step=step_ms,
         bound_by=rows[0]["bound_by"])
    k6 = k6_bound(*LN_SHAPE)
    emit(phase="bounds", kernel="K6 layer_norm", dtype="float32",
         x2d=list(LN_SHAPE), **k6)
    return dict(k1_rows=rows, k1_step_ms=step_ms, k6=k6)


def _bwd_check(name, t, dt, causal, zero_do):
    """K3, K4 and K5 (with a bias) against dq_reference, dkv_reference
    and dbias_reference in one case: (ok, report); each output's entry
    in report["errors"] carries its own ``ok``."""
    args, masked = _bwd_args(t, dt, causal, zero_do)
    before = _launches()
    got = dict(dq=flash_attention_bwd_dq(*args))
    got["dk"], got["dv"] = flash_attention_bwd_dkv(*args)
    want = dict(dq=dq_reference(*args))
    want["dk"], want["dv"] = dkv_reference(*args)
    if args[3] is not None:
        got["dbias"] = flash_attention_bwd_dbias(*args)
        want["dbias"] = dbias_reference(*args)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in _launches().items()
                if n.startswith("flash_attention_bwd")}
    finite = all(bool(torch.isfinite(g.float()).all())
                 for g in got.values())
    # each wrapper must have launched its kernel once (K5 with a bias)
    rep, ok = {}, finite and launched == {
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_bwd_dbias": int(args[3] is not None)}
    if dt == torch.float32:
        bounds = _masked_bounds(args, masked)
        for n in got:
            diff = (got[n].float() - want[n].float()).abs()
            excess = (diff - BWD_FP32_ATOL - bounds[n]).max().item()
            if n in ("dq", "dbias"):
                rows = diff.amax(-1)
                real = rows[~masked]
                rep[n] = dict(
                    max_abs_err=real.max().item() if real.numel() else 0.0,
                    masked_rows_max_abs_err=rows[masked].max().item()
                    if masked.any() else 0.0)
            else:
                rep[n] = dict(max_abs_err=diff.max().item(),
                              masked_rows_bound_max=bounds[n].max().item())
            rep[n]["ok"] = excess <= 0
        tol = ("atol %g; fully masked rows and their share of dk/dv add "
               "%g x |p| propagated" % (BWD_FP32_ATOL, MASKED_P_REL))
    else:
        for n in got:
            rep[n] = dict(
                max_abs_err=(got[n].float() - want[n].float()).abs().max()
                .item(),
                ok=bool(torch.allclose(got[n].float(), want[n].float(),
                                       atol=BF16_TOL, rtol=BF16_TOL)))
        tol = ("atol/rtol %g vs the plain version in bf16 (same rounding "
               "points)" % BF16_TOL)
    ok = ok and all(r["ok"] for r in rep.values())
    return ok, dict(
        case=name, dtype=str(dt), shape=list(args[0].shape),
        kv=args[1].shape[1], causal=causal,
        bias=None if args[3] is None else list(args[3].shape),
        dO_zero_on_masked_rows=zero_do, masked_rows=int(masked.sum()),
        launched=launched, errors=rep, tolerance=tol, finite=finite, ok=ok)


def _bwd_planted_fault_check(cases):
    """The backward built with BWD_PLANTED_FAULT must fail _bwd_check on
    dq and on dbias in every one of ``cases`` (each with a bias)."""
    real = _kernels.load
    name, defines = BWD_PLANTED_FAULT
    _kernels.load = lambda n, d=(): real(n, defines if n == name else d)
    try:
        caught = {}
        for c in cases:
            errors = _bwd_check(*c)[1]["errors"]
            caught[c[0]] = {n: not errors[n]["ok"] for n in ("dq", "dbias")}
    finally:
        _kernels.load = real
    ok = all(all(c.values()) for c in caught.values())
    emit(phase="kernel_bwd_planted_fault", fault="ds k: K's rows 2t and "
         "2t+1 swapped; dbias: the columns of each stored pair swapped "
         "(%s)" % defines[0], caught=caught, ok=ok)
    if not ok:
        raise SystemExit("the backward check passed a kernel with a fault "
                         "planted in ds k or in the dbias store: %s"
                         % caught)


def _bwd_repeat_check(t):
    """Two launches of K3, and two of K5, on the same inputs (the BERT
    training case in fp32) give the same bits."""
    args, _ = _bwd_args(t, torch.float32, False, True)
    same = {}
    for name, fn in (("dq", flash_attention_bwd_dq),
                     ("dbias", flash_attention_bwd_dbias)):
        first, second = fn(*args), fn(*args)
        same[name] = bool(torch.equal(first, second))
    emit(phase="kernel_bwd_repeat", case="bert_train_fp32",
         bit_identical=same, ok=all(same.values()))
    if not all(same.values()):
        raise SystemExit("K3/K5 gave other bits on a second launch: %s"
                         % same)


def phase_kernel_bwd():
    """K3, K4 and K5 against their plain versions on the card (and the
    planted faults and repeat launches of K3 and K5), then their times at
    the BERT-base training shape (and K2's, with the LSE)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def qkvd(BH, S_q, S_kv, d=D, bias=None):
        return dict(q=rand(BH, S_q, d), k=rand(BH, S_kv, d),
                    v=rand(BH, S_kv, d), dO=rand(BH, S_q, d), bias=bias)

    lengths = torch.randint(S // 2, S + 1, (BT,), generator=gen,
                            device=dev).tolist()
    BH = BT * H
    train = qkvd(BH, S, S, bias=_padding_bias(lengths, torch.float32, dev))
    cases = [
        ("bert_train_fp32", train, torch.float32, False, True),
        ("bert_padding_rows_fp32", train, torch.float32, False, False),
        ("bert_train_bf16", train, torch.bfloat16, False, True),
        ("causal_fp32", qkvd(96, S, S), torch.float32, True, False),
        ("ragged_cross_77x200_fp32",
         qkvd(16, 77, 200, bias=torch.where(rand(16, 77, 200) < -1.5, -1e4,
                                            0.0)),
         torch.float32, False, False),
        ("d128_bias_fp32", qkvd(48, S, S, 128, bias=train["bias"][:4]),
         torch.float32, False, True),
        ("d128_causal_bf16", qkvd(48, S, S, 128), torch.bfloat16, True,
         False),
        # fragment and tile edges, and biases read through other strides,
        # as phase_kernel's
        ("1x1_fp32", qkvd(4, 1, 1), torch.float32, False, False),
        ("9x13_head_broadcast_bias_fp32",
         qkvd(24, 9, 13, bias=rand(2, 1, 9, 13)), torch.float32, False,
         False),
        ("130x130_causal_fp32", qkvd(8, 130, 130), torch.float32, True,
         False),
        ("130x130_bias_bf16", qkvd(8, 130, 130, bias=rand(8, 130, 130)),
         torch.bfloat16, False, False),
        ("transposed_bias_77x200_fp32",
         qkvd(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.float32, False, False),
        ("transposed_bias_77x200_bf16",
         qkvd(16, 77, 200, bias=rand(16, 200, 77).transpose(1, 2)),
         torch.bfloat16, False, False),
        ("sliced_bias_77x198_fp32",
         qkvd(16, 77, 198, bias=rand(16, 77, 208)[:, :, :198]),
         torch.float32, False, False),
        ("batch_broadcast_bias_d128_fp32",
         qkvd(4 * H, S, S, 128, bias=rand(1, H, S, S).expand(4, H, S, S)),
         torch.float32, False, False),
    ]
    kernels = (("dq", flash_attention_bwd_dq),
               ("dkv", flash_attention_bwd_dkv),
               ("dbias", flash_attention_bwd_dbias))
    errs = {}
    for case in cases:
        ok, rep = _bwd_check(*case)
        emit(phase="kernel_bwd_check", **rep)
        if not ok:
            raise SystemExit("flash-attention backward kernels disagree "
                             "with their plain versions in case %s"
                             % case[0])
        errs[case[0]] = rep["errors"]
    _bwd_planted_fault_check([c for c in cases
                              if c[0] in ("bert_train_fp32",
                                          "bert_train_bf16")])
    _bwd_repeat_check(train)

    # times at the training shape (fp32, [32,1,128,128] padding mask)
    args, _ = _bwd_args(train, torch.float32, False, True)
    q, k, v, b, scale, dO, lse, delta, _c = args
    for name, fn in kernels:
        _check_no_host_sync(lambda fn=fn: fn(*args))
    esz = q.element_size()
    qkv = q.numel() * esz
    side = b.numel() * b.element_size() + 2 * lse.numel() * 4
    sq = BH * S * S
    q4, k4, v4 = (t.detach().view(BT, H, S, D).requires_grad_()
                  for t in (q, k, v))
    mask = b.detach().clone().requires_grad_()
    g4 = dO.view(BT, H, S, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o_qkv = sdpa(q4, k4, v4, attn_mask=b, scale=scale)
    o_all = sdpa(q4, k4, v4, attn_mask=mask, scale=scale)
    lib_qkv = cuda_time_ms(lambda: torch.autograd.grad(
        o_qkv, (q4, k4, v4), g4, retain_graph=True))
    lib_all = cuda_time_ms(lambda: torch.autograd.grad(
        o_all, (q4, k4, v4, mask), g4, retain_graph=True))
    # which kernels the yardstick runs (its backward computes dq, dk and
    # dv in one pass)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(sdpa(q4, k4, v4, attn_mask=b, scale=scale),
                            (q4, k4, v4), g4)
        torch.cuda.synchronize()
    emit(phase="library_kernels", call="scaled_dot_product_attention "
         "forward + backward, fp32, [32,1,128,128] mask",
         kernels=sorted({e.key for e in prof.key_averages()
                         if "fmha" in e.key or "ttention" in e.key}))
    plain = dict(dq=dq_reference, dkv=dkv_reference, dbias=dbias_reference)
    work = dict(dq=(5 * qkv + side, 6.0 * sq * D),
                dkv=(6 * qkv + side, 8.0 * sq * D),
                dbias=(4 * qkv + side + sq * esz, 4.0 * sq * D))
    out = {}
    for name, fn in kernels:
        timing = dict(ms=cuda_time_ms(lambda fn=fn: fn(*args)),
                      plain_ms=cuda_time_ms(
                          lambda p=plain[name]: p(*args)),
                      library_ms=lib_all if name == "dbias" else lib_qkv,
                      **_attention_bound(*work[name]))
        emit(phase="kernel_bwd_time", kernel=name, shape=[BH, S, D],
             bias=list(b.shape), dtype="float32",
             library="scaled_dot_product_attention backward (dq, dk, dv%s)"
             % (", dmask" if name == "dbias" else ""),
             roofline_share=timing["bound_ms"] / timing["ms"], **timing)
        rep = errs["bert_train_fp32"]
        err = max(rep["dk"]["max_abs_err"], rep["dv"]["max_abs_err"]) \
            if name == "dkv" else rep[name]["max_abs_err"]
        out[name] = dict(max_abs_err=err, **timing)
    # K2 with the LSE, as training launches it
    k2 = dict(ms=cuda_time_ms(lambda: flash_attention(
        q, k, v, b, scale, with_lse=True)),
        plain_ms=cuda_time_ms(lambda: attention_reference(
            q, k, v, b, scale, with_lse=True)),
        library_ms=cuda_time_ms(lambda: sdpa(q4.detach(), k4.detach(),
                                             v4.detach(), attn_mask=b,
                                             scale=scale)),
        **_attention_bound(4 * qkv + b.numel() * 4 + lse.numel() * 4,
                           4.0 * sq * D))
    emit(phase="kernel_time", kernel="flash_attention_fwd with_lse",
         shape=[BH, S, D], bias=list(b.shape), dtype="float32",
         roofline_share=k2["bound_ms"] / k2["ms"], **k2)
    out["fwd_with_lse"] = k2
    return out


# Transformer NMT's attention (bench_nmt: batch 32, 8 heads, S = 256,
# D = 64): the decoder's causal self-attention and the encoder's and the
# cross-attention's [B,1,1,S] pad bias, which fused_attention hands the
# kernels as a [B,1,S,S] view with a stride-0 query dim
NB, NH, NS = 32, 8, 256


def _pad_bias_view(lengths, dtype, dev):
    """[B,1,1,S] additive key-padding bias as _pad_bias builds it (0 on a
    real key, -1e4 on a padding key), in ``dtype``, expanded to [B,1,S,S]
    as the fused_attention op expands it."""
    m = (torch.arange(NS, device=dev)[None, :] <
         torch.as_tensor(lengths, device=dev)[:, None]).float()
    bias = ((m - 1.0) * 1e4).reshape(len(lengths), 1, 1, NS).to(dtype)
    return bias.expand(len(lengths), 1, NS, NS)


def _causal_share(S_q, S_kv):
    """The share of the score matrix that a causal mask keeps."""
    return (S_q * (S_q + 1) / 2) / (S_q * S_kv)


def phase_kernel_nmt():
    """K2, K3 and K4 at Transformer NMT's shape (BH = 256, S = 256,
    D = 64), causal and with the stride-0 pad-bias view, in float32 (the
    dtype the program's attention runs in under pure bf16: every q/k/v
    projection adds its float32 bias) and in bf16, against their plain
    versions at the unchanged tolerances; then their times beside the
    plain versions, SDPA and the bounds (the causal half of the work
    counted).  The pad-bias cases also run K5 in the check; the NMT path
    launches none."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    BH = NB * NH
    lengths = torch.randint(NS // 2, NS + 1, (NB,), generator=gen,
                            device=dev).tolist()
    t = dict(q=rand(BH, NS, D), k=rand(BH, NS, D), v=rand(BH, NS, D),
             dO=rand(BH, NS, D))
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = "fp32" if dt == torch.float32 else "bf16"
        cases["causal_" + tag] = (dict(t, bias=None), dt, True)
        cases["pad_bias_" + tag] = (
            dict(t, bias=_pad_bias_view(lengths, dt, dev)), dt, False)
    errs = {}
    for name, (tt, dt, causal) in cases.items():
        ok, rep = _k2_check("nmt_" + name, tt, dt, causal)
        emit(phase="kernel_nmt_check", kernel="K2", ok=ok, **rep)
        if not ok:
            raise SystemExit("flash_attention disagrees with its plain "
                             "version at the NMT shape, case %s" % name)
        bok, brep = _bwd_check("nmt_" + name, tt, dt, causal, True)
        emit(phase="kernel_nmt_check", kernel="K3/K4/K5", **brep)
        if not bok:
            raise SystemExit("flash-attention backward kernels disagree "
                             "with their plain versions at the NMT shape, "
                             "case %s" % name)
        errs[name] = dict(fwd=rep["max_abs_err"], **{
            n: e["max_abs_err"] for n, e in brep["errors"].items()})

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for name, (tt, dt, causal) in cases.items():
        args, _ = _bwd_args(tt, dt, causal, True)
        q, k, v, b, scale, dO, lse, delta, _c = args
        esz = q.element_size()
        qkv = q.numel() * esz
        # K2 writes the LSE; K3 and K4 read it and delta
        bias = 0 if b is None else NB * NS * esz
        lse_bytes = lse.numel() * 4
        share = _causal_share(NS, NS) if causal else 1.0
        sq = BH * NS * NS * share
        peak_bound = (_attention_bound if dt == torch.float32 else
                      lambda nb, fl: _bound(nb, fl, PEAK_BF16_FLOPS))
        q4, k4, v4 = (x.detach().view(NB, NH, NS, D).requires_grad_()
                      for x in (q, k, v))
        g4 = dO.view(NB, NH, NS, D)
        kw = dict(is_causal=True) if causal else dict(attn_mask=b)
        o4 = sdpa(q4, k4, v4, scale=scale, **kw)
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True))
        work = dict(fwd=(4 * qkv + bias + lse_bytes, 4.0 * sq * D),
                    dq=(5 * qkv + bias + 2 * lse_bytes, 6.0 * sq * D),
                    dkv=(6 * qkv + bias + 2 * lse_bytes, 8.0 * sq * D))
        fns = dict(
            fwd=(lambda: flash_attention(q, k, v, b, scale, causal=causal,
                                         with_lse=True),
                 lambda: attention_reference(q, k, v, b, scale,
                                             causal=causal, with_lse=True),
                 cuda_time_ms(lambda: sdpa(q4.detach(), k4.detach(),
                                           v4.detach(), scale=scale,
                                           **kw))),
            dq=(lambda: flash_attention_bwd_dq(*args),
                lambda: dq_reference(*args), lib_bwd),
            dkv=(lambda: flash_attention_bwd_dkv(*args),
                 lambda: dkv_reference(*args), lib_bwd))
        for kname, (fn, plain, lib) in fns.items():
            timing = dict(ms=cuda_time_ms(fn), plain_ms=cuda_time_ms(plain),
                          library_ms=lib, **peak_bound(*work[kname]))
            emit(phase="kernel_nmt_time", kernel=kname, case=name,
                 shape=[BH, NS, D], dtype=str(dt), causal=causal,
                 bias=None if b is None else [NB, 1, 1, NS],
                 library="scaled_dot_product_attention %s"
                 % ("forward" if kname == "fwd" else
                    "backward (dq, dk, dv)"),
                 roofline_share=timing["bound_ms"] / timing["ms"], **timing)
            timings.setdefault(kname, {})[name] = timing
    return dict(errors=errs, timings=timings)


class _GradsOnly:
    """An optimizer stand-in for build_pretrain: the backward only, so a
    comparison run reads gradients and leaves the weights as they are."""

    def minimize(self, loss):
        return [], fluid.append_backward(loss)


def _build_pretrain(cfg, optimizer=None):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = bert.build_pretrain(cfg, lr=TRAIN_LR, max_pred_per_seq=MAX_PRED,
                                  optimizer=optimizer)
    return main, startup, out


def _train_feed(cfg, batch, seed):
    """Synthetic pretraining batch: true lengths S/2..S, MAX_PRED distinct
    masked positions per sequence (flat indices into [batch * S]), random
    MLM and NSP labels."""
    rng = np.random.RandomState(seed)
    S_ = cfg.max_seq_len
    lengths = rng.randint(S_ // 2, S_ + 1, batch)
    pos = np.stack([rng.choice(n, MAX_PRED, replace=False) + i * S_
                    for i, n in enumerate(lengths)])
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (batch, S_, 1)),
        "pos_ids": np.tile(np.arange(S_).reshape(1, S_, 1), (batch, 1, 1)),
        "sent_ids": rng.randint(0, 2, (batch, S_, 1)),
        "input_mask": (np.arange(S_)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
        "mask_pos": pos.reshape(-1, 1).astype(np.int32),
        "mask_label": rng.randint(0, cfg.vocab_size, (batch * MAX_PRED, 1)),
        "nsp_label": rng.randint(0, 2, (batch, 1)),
    }


def _head(feed, n):
    """The first n sequences of a pretraining batch."""
    out = {k: v[:n] for k, v in feed.items()}
    out["mask_pos"] = feed["mask_pos"][:n * MAX_PRED]
    out["mask_label"] = feed["mask_label"][:n * MAX_PRED]
    return out


def _reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    conv3x3_bn_relu.launches_by_variant = dict.fromkeys(K1_VARIANTS, 0)
    conv3x3_bn_relu.input_copies = 0


def _launches():
    return {n: fn.launches for n, fn in KERNELS.items()}


def _grads(exe, prog, out, names, feed, scope):
    loss, *gs = exe.run(prog, feed=feed, fetch_list=[out["loss"]] +
                        [prog._grad_name_map[n] for n in names], scope=scope)
    return float(loss[0]), gs


def _compare(a, b, names):
    """[loss relative diff, {param: max|Δg| / max|g|}] of two runs."""
    (la, ga), (lb, gb) = a, b
    return (abs(la - lb) / abs(lb),
            {n: float(np.abs(x - y).max() / np.abs(y).max())
             for n, x, y in zip(names, ga, gb)})


def phase_train():
    """BERT-base pretraining (12 x 768, 12 heads, S=128, vocab 30522,
    batch 32, 20 masked positions, fp32, Adam lr 1e-4, hidden dropout
    0.1, attention dropout 0) through Executor on the card: 2 warm-up and
    8 timed steps on one batch, then the checks against the composition
    path and the port's CPU path."""
    cfg = bert.base_config(attn_dropout=0.0)
    main, startup, out = _build_pretrain(cfg)
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(p.name).numel() for p in params)
    emit(phase="train_startup", seconds=time.perf_counter() - t0,
         parameters=int(n_params), parameter_tensors=len(params),
         ops=len(ops), grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"),
         fused_attention_grad_ops=ops.count("fused_attention_grad"))
    feed = _train_feed(cfg, BT, SEED)
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, [feed], [out["loss"]], scope)
    launches = _launches()
    losses = [float(g[0].item()) for g in got]
    steps = len(got)
    per_step = {n: c / steps for n, c in launches.items()}
    emit(phase="train", steps=steps, losses=losses, ms_per_step=step_ms,
         sequences_per_s=BT / step_ms * 1e3,
         tokens_per_s=BT * cfg.max_seq_len / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches, launches_per_step=per_step)
    L = cfg.num_layers
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "k2_k3_k4_12_per_step": all(launches[n] == L * steps for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "k5_0": launches["flash_attention_bwd_dbias"] == 0,
    }

    _profile_step("train_profile", exe, main, feed, [out["loss"]], scope)

    # fused vs composition on the card, and the card vs the port's CPU
    # path, from the trained weights.  Dropout is off in these programs:
    # masks come from per-device Philox streams, and the two attention
    # routes number their random ops differently, so only a dropout-free
    # step can agree to rounding.
    names = ["fc_0.w_0", "fc_%d.w_0" % (6 * L - 1), "word_embedding"]
    gcfg = dict(hidden_dropout=0.0, attn_dropout=0.0)
    fused, _, fout = _build_pretrain(bert.base_config(**gcfg), _GradsOnly())
    comp, _, cout = _build_pretrain(
        bert.base_config(use_fused_attention=False, **gcfg), _GradsOnly())
    assert all(fused.global_block().has_var(n) for n in names)
    wscope = fluid.Scope()
    for p in params:
        wscope.set_var(p.name, scope.find_var(p.name))
    _reset_launches()
    card = _grads(exe, fused, fout, names, feed, wscope)
    card_comp = _grads(exe, comp, cout, names, feed, wscope)
    two = _head(feed, 2)
    card2 = _grads(exe, fused, fout, names, two, wscope)
    cpu_scope = fluid.Scope()
    for p in params:
        cpu_scope.set_var(p.name, scope.find_var(p.name).cpu())
    t2 = time.perf_counter()
    cpu2 = _grads(fluid.Executor(fluid.CPUPlace()), fused, fout, names, two,
                  cpu_scope)
    cpu_s = time.perf_counter() - t2
    comp_loss, comp_g = _compare(card, card_comp, names)
    cpu_loss, cpu_g = _compare(card2, cpu2, names)
    checks["fused_matches_composition"] = \
        comp_loss <= TRAIN_LOSS_RTOL and max(comp_g.values()) <= TRAIN_GRAD_TOL
    checks["card_matches_cpu_path"] = \
        cpu_loss <= TRAIN_LOSS_RTOL and max(cpu_g.values()) <= TRAIN_GRAD_TOL
    emit(phase="train_check",
         tolerance="loss rel %g, grads max|diff|/max|grad| %g"
         % (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL),
         loss_card=card[0], loss_card_composition=card_comp[0],
         fused_vs_composition=dict(loss_rel=comp_loss, grads=comp_g),
         loss_card_b2=card2[0], loss_cpu_b2=cpu2[0], cpu_seconds=cpu_s,
         card_vs_cpu=dict(loss_rel=cpu_loss, grads=cpu_g), checks=checks)
    _fail_unless("train", checks)
    return dict(launches=launches, ms_per_step=step_ms)


def _bias_program(fused, optimizer=None, B_=8):
    """One attention layer at BERT-base head shape whose additive bias is
    a trainable [1, H, S, S] parameter: x -> q, k, v -> attention(+bias)
    -> output projection -> mean.  ``fused`` picks fused_attention (the
    flash kernels) or the matmul/softmax/matmul composition."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    hid = H * D
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [S, hid])
        q, k, v = (fluid.layers.transpose(fluid.layers.reshape(
            fluid.layers.fc(x, hid, num_flatten_dims=2), [0, S, H, D]),
            [0, 2, 1, 3]) for _ in range(3))
        bias = fluid.layers.create_parameter(
            [1, H, S, S], "float32", name="attn_bias",
            default_initializer=fluid.initializer.Normal(0.0, 0.5))
        if fused:
            ctx = fluid.layers.fused_attention(q, k, v, bias,
                                               scale=1.0 / math.sqrt(D))
        else:
            s = fluid.layers.matmul(q, k, transpose_y=True,
                                    alpha=1.0 / math.sqrt(D))
            ctx = fluid.layers.matmul(fluid.layers.softmax(s + bias), v)
        ctx = fluid.layers.reshape(fluid.layers.transpose(ctx, [0, 2, 1, 3]),
                                   [0, S, hid])
        loss = fluid.layers.mean(fluid.layers.fc(ctx, 1, num_flatten_dims=2,
                                                 act="tanh"))
        if optimizer is None:
            fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
        else:
            optimizer.minimize(loss)
    return main, startup, loss


def phase_train_bias(B_=8, steps=3):
    """The path that reaches K5: a trainable attention bias.  Checks its
    gradient against the composition path from the same weights, then
    trains a few steps and counts the launches."""
    main, startup, loss = _bias_program(True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    x = np.random.RandomState(SEED).randn(B_, S, H * D).astype(np.float32)
    grads = {}
    for fused in (True, False):
        prog, _, gl = _bias_program(fused, _GradsOnly())
        grads[fused] = exe.run(prog, feed={"x": x},
                               fetch_list=[gl, "attn_bias@GRAD"],
                               scope=scope)
    gf, gc = grads[True][1], grads[False][1]
    bias_err = float(np.abs(gf - gc).max() / np.abs(gc).max())
    _reset_launches()
    losses = [float(exe.run(main, feed={"x": x}, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(steps)]
    launches = _launches()
    checks = {
        "k5_once_per_step": launches["flash_attention_bwd_dbias"] == steps,
        "k2_k3_k4_once_per_step": all(launches[n] == steps for n in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")),
        "losses_finite": bool(np.isfinite(losses).all()),
        "bias_grad_matches_composition": bias_err <= TRAIN_GRAD_TOL,
    }
    emit(phase="train_bias", batch=B_, bias_shape=[1, H, S, S],
         losses=losses, launches=launches,
         bias_grad_shape=list(gf.shape),
         bias_grad_max_err_rel=bias_err, tolerance="max|diff|/max|grad| %g"
         % TRAIN_GRAD_TOL, checks=checks)
    _fail_unless("train_bias", checks)
    return launches


def phase_train_attn_dropout(batch=8, steps=2):
    """BERT's default attn_dropout=0.1 at a cut depth (2 layers): the
    attention-dropout composition route, which launches no flash
    kernel."""
    cfg = bert.base_config(num_layers=2)
    main, startup, out = _build_pretrain(cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _train_feed(cfg, batch, SEED + 2)
    _reset_launches()
    losses = [float(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                            scope=scope)[0][0]) for _ in range(steps)]
    launches = _launches()
    ok = bool(np.isfinite(losses).all()) and not any(launches.values())
    emit(phase="train_attn_dropout", layers=2, batch=batch,
         attn_dropout=cfg.attn_dropout, losses=losses, launches=launches,
         ok=ok)
    if not ok:
        raise SystemExit("attention-dropout route: non-finite loss or a "
                         "flash kernel launched: %s %s" % (losses, launches))


# ---------------------------------------------------------------------------
# K1 (3x3 conv) and K6 (row layer norm); ResNet-50 training
# ---------------------------------------------------------------------------

K1_FP32_BATCH = 32
K1_FP32_TOL = 1e-4            # |kernel - plain| / max|plain|, fp32
K1_BF16_TOL = 2e-2            # ... bf16 (the same float32 sum, one rounding)
K6_FP32_TOL = 1e-5            # K6, fp32
K6_BF16_TOL = 1e-2            # K6, bf16
# ResNet-50 checks, from the startup weights.  Each bound is the larger
# of a fixed tolerance and twice how far a route that runs no K1 either
# lies from the reference.  In pure bf16 at batch 256 rounding alone
# moves most gradients by as much as their size: the card's two library
# routes (cuDNN, and unfold x matmul) give gradients at cosine ~0.5,
# apart by ~100% of the largest entry of most conv and batch-norm
# gradients, and by ~10% of the classifier's.  So the bf16 comparison
# holds the loss and the gradients RN_GRADS only.  The sharp comparison
# is float32 at batch 2: there the loss and the classifier's weight
# gradient agree within 1e-6 and 1e-4 between routes, and all 161
# gradients together are held in relative L2 norm (~2% between routes).
RN_LOSS_RTOL = 1e-2           # step-1 loss, K1 route vs cuDNN route (bf16)
RN_GRAD_TOL = 5e-2            # RN_GRADS, same comparison
RN_CPU_LOSS_RTOL = 1e-4       # step-1 loss, card vs CPU path (fp32, b2)
RN_CPU_GRAD_TOL = 1e-3        # RN_GRADS and all gradients in L2, same
LN_PATH_TOL = 1e-5            # fused_layer_norm vs layer_norm op grads


def _rel(a, b):
    """max |a - b| / max |b| over two tensors or arrays, in float32."""
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ptxas_report(source, kernel):
    """ptxas's lines (registers, barriers, stack, spills) for each
    instantiation of ``kernel`` in the build log of ``source``."""
    report, name = {}, None
    for ln in _kernels.build_log(source).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
            if name is not None:
                report[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            report[name].append(ln.replace("ptxas info    :", "").strip())
    return report


def phase_kernel_conv(bounds):
    """K1 against conv3x3_bn_relu_reference on the card at the four
    ResNet-50 shapes (bf16 at batch 256, fp32 at batch 32), with and
    without the epilogue, one launch of the planned variant asserted per
    case (wgmma in bf16, fp32 in fp32); ptxas's report for the wgmma
    kernel, which must not spill; then K1's time per shape in bf16 at
    batch 256 without epilogue (the op path's call) beside the plain
    version, cuDNN, the bound, and the NCHW -> NHWC copy the wrapper
    makes when its input is not channels_last."""
    ptxas = _ptxas_report("conv3x3_bn_relu", "conv3x3_wgmma_kernel")
    spills = {n: [ln for ln in lines if "spill" in ln and
                  not ln.startswith("0 bytes stack frame, 0 bytes spill "
                                    "stores, 0 bytes spill loads")]
              for n, lines in ptxas.items()}
    emit(phase="kernel_conv_ptxas", kernel="conv3x3_wgmma_kernel",
         report=ptxas, ok=bool(ptxas) and not any(spills.values()))
    if not ptxas or any(spills.values()):
        raise SystemExit("the wgmma K1 kernel is missing from the build log "
                         "or spills: %s" % spills)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = []
    for hw, c, _ in RESNET_K1_SHAPES:
        for dt, n in ((torch.bfloat16, RN_BATCH),
                      (torch.float32, K1_FP32_BATCH)):
            x = torch.randn(n, hw, hw, c, device=dev, generator=gen).to(dt)
            w = (torch.randn(3, 3, c, c, device=dev, generator=gen) *
                 (2.0 / (9 * c)) ** 0.5).to(dt)
            sc = torch.rand(c, device=dev, generator=gen) + 0.5
            sh = torch.randn(c, device=dev, generator=gen)
            plan = k1_plan(n, hw, hw, c, c, dt)
            want_variant = "wgmma" if dt == torch.bfloat16 else "fp32"
            for epi in (False, True):
                args = (x, w, sc, sh) if epi else (x, w, None, None)
                before = conv3x3_bn_relu.launches
                by_variant = dict(conv3x3_bn_relu.launches_by_variant)
                got = conv3x3_bn_relu(*args, relu=epi)
                torch.cuda.synchronize()
                launched = conv3x3_bn_relu.launches - before
                variants = {k: v - by_variant[k] for k, v in
                            conv3x3_bn_relu.launches_by_variant.items()
                            if v != by_variant[k]}
                want = conv3x3_bn_relu_reference(*args, relu=epi)
                err = _rel(got, want)
                tol = K1_FP32_TOL if dt == torch.float32 else K1_BF16_TOL
                finite = bool(torch.isfinite(got.float()).all())
                ok = launched == 1 and variants == {want_variant: 1} and \
                    plan["variant"] == want_variant and err <= tol and \
                    finite and got.dtype == dt
                emit(phase="kernel_conv_check", shape=[n, hw, hw, c, c],
                     dtype=str(dt), epilogue=epi, launched=launched,
                     variant=variants, plan=plan, max_err_rel=err,
                     tolerance="max|diff| <= %g max|plain|" % tol,
                     finite=finite, ok=ok)
                if not ok:
                    raise SystemExit("K1 disagrees with its plain version "
                                     "or took another variant at %s %s "
                                     "epilogue=%s" % ([n, hw, hw, c], dt, epi))
                if dt == torch.bfloat16 and not epi:
                    errs.append(err * want.float().abs().max().item())
                del got, want
    times, step = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                           input_copy_ms=0.0)
    for (hw, c, count), b in zip(RESNET_K1_SHAPES, bounds["k1_rows"]):
        x = torch.randn(RN_BATCH, hw, hw, c, device=dev,
                        generator=gen).to(torch.bfloat16)
        # the weights in the kernel's K-major [O, 3, 3, C] storage, passed
        # as their HWIO view: the wrapper makes no copy, so the time is
        # the kernel's (the op path's OIHW weights take one small copy)
        wk = (torch.randn(c, 3, 3, c, device=dev, generator=gen) * 0.05).to(
            torch.bfloat16)
        w = wk.permute(1, 2, 3, 0)
        if hw == 56:
            _check_no_host_sync(lambda: conv3x3_bn_relu(x, w, relu=False))
        # cuDNN on the same data: NCHW views of NHWC storage (channels_last)
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        # the copy conv3x3_bn_relu makes of an NCHW-contiguous input
        xn = xl.contiguous()
        # the plain version's F.unfold launches one im2col kernel per
        # image, 262 launches a call at batch 256: three calls fill the
        # launch queue, so it is timed two at a time
        t = dict(ms=cuda_time_ms(lambda: conv3x3_bn_relu(x, w, relu=False)),
                 plain_ms=cuda_time_ms(lambda: conv3x3_bn_relu_reference(
                     x, w, relu=False), iters=2, warmup=2),
                 library_ms=cuda_time_ms(lambda: torch.nn.functional.conv2d(
                     xl, wl, padding=1)),
                 input_copy_ms=cuda_time_ms(
                     lambda: xn.permute(0, 2, 3, 1).contiguous()))
        row = dict(shape=[RN_BATCH, hw, hw, c, c], convs_per_step=count,
                   variant=k1_plan(RN_BATCH, hw, hw, c, c,
                                   torch.bfloat16)["variant"],
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   tflops=b["gflop"] / t["ms"], **t)
        row["roofline_share"] = b["bound_ms"] / t["ms"]
        emit(phase="kernel_conv_time", dtype="bfloat16", **row)
        times.append(row)
        for k in step:
            step[k] += count * t[k]
        del x, w, wk, xl, wl, xn
    emit(phase="kernel_conv_step", per="ResNet-50 step, 13 launches",
         bound_ms=bounds["k1_step_ms"], **step)
    return dict(max_abs_err=max(errs), per="ResNet-50 step (13 launches "
                "at batch 256, bf16); per shape in kernel_conv_time",
                bound_ms=bounds["k1_step_ms"],
                bound_by=bounds["k1_rows"][0]["bound_by"],
                **{k: step[k] for k in ("ms", "plain_ms", "library_ms")})


def phase_kernel_ln(bounds):
    """K6 against layer_norm_reference at [4096, 768] in fp32 and bf16 and
    a ragged [1000, 1000]; its time at [4096, 768] fp32 beside the plain
    version, F.layer_norm and the bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    errs = {}
    for name, (M, Dm), dt in (("bert_hidden_fp32", LN_SHAPE, torch.float32),
                              ("bert_hidden_bf16", LN_SHAPE, torch.bfloat16),
                              ("ragged_1000_fp32", (1000, 1000),
                               torch.float32)):
        x = (torch.randn(M, Dm, device=dev, generator=gen) * 3 + 1).to(dt)
        sc = torch.rand(Dm, device=dev, generator=gen) + 0.5
        bi = torch.randn(Dm, device=dev, generator=gen)
        before = row_layer_norm.launches
        got = row_layer_norm(x, sc, bi, 1e-5)
        torch.cuda.synchronize()
        launched = row_layer_norm.launches - before
        err = _rel(got, layer_norm_reference(x, sc, bi, 1e-5))
        tol = K6_FP32_TOL if dt == torch.float32 else K6_BF16_TOL
        ok = launched == 1 and err <= tol and got.dtype == dt
        emit(phase="kernel_ln_check", case=name, shape=[M, Dm],
             dtype=str(dt), launched=launched, max_err_rel=err,
             tolerance="max|diff| <= %g max|plain|" % tol, ok=ok)
        if not ok:
            raise SystemExit("K6 disagrees with its plain version in %s"
                             % name)
        errs[name] = err * got.float().abs().max().item()
    M, Dm = LN_SHAPE
    x = torch.randn(M, Dm, device=dev, generator=gen)
    sc = torch.rand(Dm, device=dev, generator=gen) + 0.5
    bi = torch.randn(Dm, device=dev, generator=gen)
    _check_no_host_sync(lambda: row_layer_norm(x, sc, bi, 1e-5))
    t = dict(ms=cuda_time_ms(lambda: row_layer_norm(x, sc, bi, 1e-5)),
             plain_ms=cuda_time_ms(lambda: layer_norm_reference(x, sc, bi,
                                                                1e-5)),
             library_ms=cuda_time_ms(lambda: torch.nn.functional.layer_norm(
                 x, (Dm,), sc, bi, 1e-5)))
    b = bounds["k6"]
    emit(phase="kernel_ln_time", shape=[M, Dm], dtype="float32",
         roofline_share=b["bound_ms"] / t["ms"], **b, **t)
    return dict(max_abs_err=errs["bert_hidden_fp32"], bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], **t)


def _resnet_program(pure_bf16=True):
    """bench.py bench_resnet's program in the port: ResNet-50 v1.5 at
    224 x 224, 1000 classes, Momentum 0.9 + L2Decay 1e-4, lr 0.1, and
    (``pure_bf16``) pure-bf16 AMP; the random weights come from the
    startup program's seed."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[3, RN_SIZE, RN_SIZE],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        logits = resnet.resnet(img, class_dim=1000, depth=50)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4))
        if pure_bf16:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_pure_bf16=True)
        opt.minimize(loss)
    return main, startup, loss


def _resnet_feed(batch, seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.normal(0, 1, (batch, 3, RN_SIZE, RN_SIZE))
            .astype(np.float32),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}


def _state_copy(main, scope, device="cuda"):
    """A scope holding a copy, on ``device``, of every persistable of
    ``main`` in ``scope``."""
    out = fluid.Scope()
    for v in main.list_vars():
        if v.persistable:
            out.set_var(v.name, scope.find_var(v.name).to(device, copy=True))
    return out


# the classifier's weight and bias, and the last batch norm's bias
RN_GRADS = ("fc_0.w_0", "fc_0.b_0", "batch_norm_52.b_0")
# a K1 conv's weight and the batch norm's scale after it: reported in
# bf16, not held (rounding dominates them there)
RN_ROUNDING = ("conv2d_2.w_0", "batch_norm_2.w_0")


def _step_grads(exe, main, loss, state, feed, names=RN_GRADS):
    """The loss and the gradients of ``names`` of one step of ``main`` on
    a copy of ``state``."""
    scope = _state_copy(main, state, exe.device)
    out = exe.run(main, feed=feed, fetch_list=[loss] + [
        main._grad_name_map[n] for n in names], scope=scope)
    return float(out[0].reshape(-1)[0]), dict(zip(names, out[1:]))


def _l2_rel(a, b):
    """||a - b|| / ||b|| over every gradient of two {name: grad} dicts."""
    num = sum(float(((torch.as_tensor(a[n]).double() -
                      torch.as_tensor(b[n]).double()) ** 2).sum())
              for n in b)
    den = sum(float((torch.as_tensor(b[n]).double() ** 2).sum()) for n in b)
    return math.sqrt(num / den)


def _route_check(got, want, other, loss_rtol, grad_tol, whole=False,
                 names=RN_GRADS):
    """``got``, a route through the kernels under test (K1; K2-K4 for
    NMT), against ``want`` ((loss, {name: grad}) each): the loss, each of
    ``names`` and (``whole``) every gradient together in L2, each bound
    the larger of the fixed one and twice how far ``other``, a route
    that runs none of those kernels either, lies from ``want``."""
    def dist(a):
        d = {"loss": abs(a[0] - want[0]) / abs(want[0])}
        d.update((n, _rel(a[1][n], want[1][n])) for n in names)
        if whole:
            d["all_grads_l2"] = _l2_rel(a[1], want[1])
        return d
    err, spread = dist(got), dist(other)
    bound = {k: max(loss_rtol if k == "loss" else grad_tol, 2 * v)
             for k, v in spread.items()}
    return dict(err=err, spread=spread, bound=bound,
                ok=all(err[k] <= bound[k] for k in err))


def phase_resnet_train():
    """bench_resnet through the port's Executor on the card (see the
    module docstring, phase 12)."""
    from paddle_tpu_torch.fluid import flags
    flags.set_flag("conv_pallas", True)
    main, startup, loss = _resnet_program()
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase="resnet_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         conv2d=ops.count("conv2d"), batch_norm=ops.count("batch_norm"),
         momentum=ops.count("momentum"), batch=RN_BATCH, image=RN_SIZE,
         amp="pure bf16", conv_pallas=True)
    init = _state_copy(main, scope)         # the startup weights
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, [feed], [loss], scope)
    launches = _launches()
    k1_variants = dict(conv3x3_bn_relu.launches_by_variant)
    k1_copies = conv3x3_bn_relu.input_copies
    losses = [float(g[0].float().item()) for g in got]
    steps = len(got)
    emit(phase="resnet_train", steps=steps, losses=losses,
         ms_per_step=step_ms, images_per_s=RN_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches,
         launches_per_step={n: c / steps for n, c in launches.items()},
         k1_launches_by_variant=k1_variants,
         k1_input_copies_per_step=k1_copies / steps)
    checks = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "last_loss_below_first": losses[-1] < losses[0],
        "k1_13_per_step": launches["conv3x3_bn_relu"] == 13 * steps,
        "k1_all_wgmma": k1_variants["wgmma"] == 13 * steps,
        "no_other_kernel": not any(c for n, c in launches.items()
                                   if n != "conv3x3_bn_relu"),
    }
    checks["profile_has_k1"] = _profile_step(
        "resnet_profile", exe, main, feed, [loss], scope)["k1"] > 0
    checks.update(phase_resnet_check(exe, main, loss, init, feed))
    _fail_unless("resnet_train", checks)
    return dict(launches=launches, ms_per_step=step_ms,
                k1_launches_by_variant=k1_variants)


def phase_resnet_check(exe, main, loss, init, feed):
    """Step 1 from the startup weights ``init``: the K1 route against the
    cuDNN route (flag off) in bf16 at batch 256, with the unfold x matmul
    route as the spread; then the card against the port's CPU path, fp32
    with the flag on, at batch 2, with the card's cuDNN route as the
    spread.  Returns the checks by name."""
    from paddle_tpu_torch.fluid import flags

    def route(prog, ls, state, fd, pallas, im2col="off", **kw):
        flags.set_flag("conv_pallas", pallas)
        flags.set_flag("conv_im2col", im2col)
        try:
            return _step_grads(exe, prog, ls, state, fd, **kw)
        finally:
            flags.set_flag("conv_pallas", False)
            flags.set_flag("conv_im2col", "off")

    names = RN_GRADS + RN_ROUNDING
    card = route(main, loss, init, feed, True, names=names)
    cudnn = route(main, loss, init, feed, False, names=names)
    im2col = route(main, loss, init, feed, False, "all", names=names)
    bf16 = _route_check(card, cudnn, im2col, RN_LOSS_RTOL, RN_GRAD_TOL)
    bf16["not_held"] = {n: dict(err=_rel(card[1][n], cudnn[1][n]),
                                spread=_rel(im2col[1][n], cudnn[1][n]))
                        for n in RN_ROUNDING}
    fmain, _, floss = _resnet_program(pure_bf16=False)
    names = [p.name for p in fmain.global_block().all_parameters()]
    two = {k: v[:2] for k, v in _resnet_feed(RN_BATCH, SEED).items()}
    before = conv3x3_bn_relu.launches
    card2 = route(fmain, floss, init, two, True, names=names)
    k1_card2 = conv3x3_bn_relu.launches - before
    t2 = time.perf_counter()
    flags.set_flag("conv_pallas", True)
    try:
        cpu2 = _step_grads(fluid.Executor(fluid.CPUPlace()), fmain, floss,
                             init, two, names)
    finally:
        flags.set_flag("conv_pallas", False)
    cpu_s = time.perf_counter() - t2
    cudnn2 = route(fmain, floss, init, two, False, names=names)
    fp32 = _route_check(card2, cpu2, cudnn2, RN_CPU_LOSS_RTOL,
                        RN_CPU_GRAD_TOL, whole=True)
    checks = {"k1_route_matches_cudnn_route": bf16["ok"],
              "card_fp32_ran_k1": k1_card2 == 13,
              "card_matches_cpu_path": fp32["ok"]}
    emit(phase="resnet_check",
         tolerance="each: max(fixed, 2 x the spread of a route without K1 "
         "from the same reference); fixed: K1 vs cuDNN route (bf16, batch "
         "%d; spread: unfold x matmul route) loss rel %g, grads "
         "max|diff|/max|grad| %g; card vs CPU (fp32, batch 2; spread: the "
         "card's cuDNN route) %g, %g, all gradients in relative L2 %g"
         % (RN_BATCH, RN_LOSS_RTOL, RN_GRAD_TOL, RN_CPU_LOSS_RTOL,
            RN_CPU_GRAD_TOL, RN_CPU_GRAD_TOL),
         grads=list(RN_GRADS), loss_k1_route=card[0],
         loss_cudnn_route=cudnn[0], loss_im2col_route=im2col[0],
         k1_vs_cudnn=bf16, loss_card_b2=card2[0], loss_cpu_b2=cpu2[0],
         loss_cudnn_b2=cudnn2[0], cpu_seconds=cpu_s, card_vs_cpu=fp32,
         checks=checks)
    return checks


def _kernel_kinds(prof):
    """Device ms of one profiled step by kind of kernel, from the kernel
    names: K1; the flash-attention kernels K2-K5; the library's
    convolutions and GEMMs (cuDNN / cuBLAS / cuBLASLt's nvjet / CUTLASS
    names); embedding, index, gather and scatter kernels (DeepFM's
    lookups and their gradients); reductions; PyTorch's elementwise
    kernels; everything else (copies, fills)."""
    kinds = dict(k1=0.0, k2_k5=0.0, library_conv_gemm=0.0,
                 gather_scatter=0.0, reduce=0.0, elementwise=0.0, other=0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "conv3x3" in name:
            kind = "k1"
        elif any(w in name for w in ("flash_fwd_kernel", "dkv_kernel",
                                     "q_rows_kernel")):
            kind = "k2_k5"
        elif any(w in name for w in ("xmma", "cudnn", "cutlass", "gemm",
                                     "nvjet", "implicit", "conv", "dgrad",
                                     "wgrad")):
            kind = "library_conv_gemm"
        elif any(w in name for w in ("embedding", "index", "scatter",
                                     "gather")):
            kind = "gather_scatter"
        elif "reduce" in name:
            kind = "reduce"
        elif "elementwise" in name:
            kind = "elementwise"
        else:
            kind = "other"
        kinds[kind] += e.self_device_time_total / 1e3
    return kinds


def _ln_program(fused):
    """x [32, 128, 768] -> layer norm over the last axis (fused_layer_norm
    appended by hand, or the layer_norm layer) with trainable scale and
    bias -> mean(fc(y, 1)); backward only."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    shape = [BT, S, H * D]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape, append_batch_size=False)
        x.stop_gradient = False
        if fused:
            blk = main.global_block()
            sc = fluid.layers.create_parameter(
                [H * D], "float32", name="ln_scale",
                default_initializer=fluid.initializer.Constant(1.0))
            bi = fluid.layers.create_parameter(
                [H * D], "float32", name="ln_bias",
                default_initializer=fluid.initializer.Constant(0.0))
            y = blk.create_var(name="ln_y", shape=shape, dtype="float32")
            outs = {n: [blk.create_var(name="ln_" + n.lower(),
                                       dtype="float32")]
                    for n in ("Mean", "Variance")}
            blk.append_op("fused_layer_norm",
                          inputs={"X": [x], "Scale": [sc], "Bias": [bi]},
                          outputs=dict(Y=[y], **outs),
                          attrs={"begin_norm_axis": 2, "epsilon": 1e-5})
        else:
            y = fluid.layers.layer_norm(
                x, begin_norm_axis=2, param_attr="ln_scale",
                bias_attr="ln_bias")
        loss = fluid.layers.mean(fluid.layers.fc(y, 1, num_flatten_dims=2))
        fluid.append_backward(loss)
    return main, startup, loss


def phase_ln_path():
    """The fused_layer_norm path through Executor on the card: one K6
    launch per run, and the gradients of x, scale and bias equal to the
    layer_norm op's program from the same weights."""
    fused, startup, floss = _ln_program(True)
    plain, _, ploss = _ln_program(False)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    feed = {"x": (rng.randn(BT, S, H * D) * 3 + 1).astype(np.float32)}
    names = ["x", "ln_scale", "ln_bias"]
    _reset_launches()
    got = exe.run(fused, feed=feed, fetch_list=[floss] + [
        fused._grad_name_map[n] for n in names], scope=scope)
    launches = _launches()
    want = exe.run(plain, feed=feed, fetch_list=[ploss] + [
        plain._grad_name_map[n] for n in names], scope=scope)
    errs = {n: _rel(a, b) for n, a, b in zip(["loss"] + names, got, want)}
    checks = {
        "k6_once": launches["layer_norm"] == 1,
        "no_other_kernel": not any(c for n, c in launches.items()
                                   if n != "layer_norm"),
        "grads_match_layer_norm_op": max(errs.values()) <= LN_PATH_TOL,
    }
    emit(phase="ln_path", x=[BT, S, H * D], launches=launches,
         errors_rel=errs, tolerance="max|diff|/max|ref| %g" % LN_PATH_TOL,
         checks=checks)
    _fail_unless("ln_path", checks)
    return launches



# ---------------------------------------------------------------------------
# Transformer NMT training (bench_nmt) and LeNet (bench_lenet)
# ---------------------------------------------------------------------------

NMT_BATCH = 32                # bench.py runs bench_nmt(batch=32)
NMT_LR, NMT_WARMUP = 2.0, 4000
NMT_LR_RTOL = 1e-6            # fetched learning rate vs the closed form
NMT_LOSS_RTOL = 1e-2          # step-1 loss, fused route vs composition (bf16)
NMT_GRAD_TOL = 5e-2           # _nmt_grad_names, same comparison
NMT_CPU_BATCH = 2             # card vs CPU path: fp32, batch 2,
NMT_CPU_LAYERS = 2            # 2 + 2 layers
NMT_CPU_LOSS_RTOL = 1e-4
NMT_CPU_GRAD_TOL = 1e-3       # named gradients, and all in relative L2
LENET_BATCH = 1024            # bench.py runs bench_lenet(batch=1024)
COUNTER = "@LR_DECAY_COUNTER@"


def _nmt_config(**kw):
    return transformer.base_config(**kw)


def _nmt_program(cfg, amp=True):
    """bench_nmt's program: build_train(cfg, lr=2.0, warmup_steps=4000)
    and (``amp``) pure bf16 as bench_nmt tags it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = transformer.build_train(cfg, lr=NMT_LR,
                                      warmup_steps=NMT_WARMUP)
    if amp:
        main._amp_dtype = "bfloat16"
        main._amp_keep = True
    return main, startup, out


def _nmt_feed(cfg, batch, rng, ragged=False):
    """A feed on the card drawn as bench_nmt draws it (all-ones masks), or
    with source and target lengths S/2..S (``ragged``)."""
    S_ = cfg.max_len

    def mask():
        if not ragged:
            return np.ones((batch, S_, 1), np.float32)
        n = rng.randint(S_ // 2, S_ + 1, batch)
        return (np.arange(S_)[None, :, None] < n[:, None, None]).astype(
            np.float32)
    feed = {"src_ids": rng.randint(0, cfg.src_vocab_size, (batch, S_, 1)),
            "src_mask": mask(),
            "trg_ids": rng.randint(0, cfg.trg_vocab_size, (batch, S_, 1)),
            "trg_mask": mask(),
            "label": rng.randint(0, cfg.trg_vocab_size, (batch, S_, 1))}
    return {k: torch.from_numpy(np.asarray(v)).to("cuda")
            for k, v in feed.items()}


def _nmt_grad_names(L):
    """The encoder's first q projection, the decoder's first
    self-attention q projection (causal) and the output projection: fc
    numbering runs 6 per encoder layer, 10 per decoder layer, then the
    projection."""
    return ("fc_0.w_0", "fc_%d.w_0" % (6 * L), "fc_%d.w_0" % (16 * L))


@contextlib.contextmanager
def _plain_attention():
    """The attention wrappers run their plain versions on the card's
    tensors: a route through the fused op that launches none of K2-K5."""
    real = attention_ops._kernel_device
    attention_ops._kernel_device = lambda *a, **kw: False
    try:
        yield
    finally:
        attention_ops._kernel_device = real


def _nmt_startup(name, main, startup, cfg):
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase=name + "_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         startup_ops=len(startup.global_block().ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"),
         fused_attention=ops.count("fused_attention"),
         attn_dropout=cfg.attn_dropout, hidden_dropout=cfg.dropout,
         amp="pure bf16", batch=NMT_BATCH, seq=cfg.max_len,
         layers=cfg.num_layers)
    return exe, scope


def _nmt_phase(name, cfg, feeds, fetch_lr, checks_fn, keep_init=False):
    """One NMT training phase: bench_nmt's program for ``cfg`` started on
    the card, WARM_STEPS + TIMED_STEPS steps with ``feeds`` taken in turn
    (the main path's run, with the launch counts set to 0 before it and
    read after it), ms per step, tokens/s (batch x S a step, as bench_nmt
    counts), peak memory and launches, then one profiled step.
    ``checks_fn(got, launches, extra, scope)`` returns the checks by
    name and may add fields to ``extra`` for the phase's line.  Returns
    the executor, a copy of the startup weights (``keep_init``, else
    None), the checks and the launches."""
    main, startup, out = _nmt_program(cfg)
    exe, scope = _nmt_startup(name, main, startup, cfg)
    init = _state_copy(main, scope) if keep_init else None
    fetch = [out["loss"]]
    if fetch_lr:
        fetch.append(out["optimizer"]._global_learning_rate(main))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, fetch, scope)
    launches = _launches()
    extra = dict(losses=[float(g[0].float().item()) for g in got])
    checks = {"losses_finite": bool(np.isfinite(extra["losses"]).all())}
    checks.update(checks_fn(got, launches, extra, scope))
    emit(phase=name, card=_card(), steps=len(got), ms_per_step=step_ms,
         tokens_per_s=NMT_BATCH * cfg.max_len / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches,
         launches_per_step={n: c / len(got) for n, c in launches.items()},
         **extra)
    _profile_step(name + "_profile", exe, main, feeds[0], fetch, scope)
    return exe, init, checks, launches


def phase_nmt_train():
    """bench_nmt's configuration through Executor on the card: base_config
    (6 + 6 layers, width 512, 8 heads, ffn 2048, S = 256, vocabularies of
    30,000, dropout 0.1 on the hidden states and the attention weights,
    label smoothing 0.1), Adam on noam_decay(512, 4000) x 2.0, pure bf16,
    batch 32, all-ones masks, bench_nmt's two feeds taken in turn.
    Attention dropout routes every fused_attention op through the
    composition: no flash kernel may launch.  The learning rate of each
    run must be the closed form and the step counter 10 after ten runs;
    the loss only finite (over these steps the rate stays under
    3.5e-6)."""
    cfg = _nmt_config()
    rng = np.random.RandomState(0)
    feeds = [_nmt_feed(cfg, NMT_BATCH, rng) for _ in range(2)]

    def checks(got, launches, extra, scope):
        lrs = [float(g[1].reshape(-1)[0].item()) for g in got]
        t = np.arange(1, len(got) + 1, dtype=np.float64)
        want = NMT_LR * cfg.hidden_size ** -0.5 * np.minimum(
            t ** -0.5, t * NMT_WARMUP ** -1.5)
        lr_err = float(np.max(np.abs(np.array(lrs) - want) / want))
        counter = float(scope.find_var(COUNTER).reshape(-1)[0].item())
        extra.update(learning_rates=lrs, lr_max_rel_err=lr_err,
                     counter=counter)
        return {"lr_is_noam": lr_err <= NMT_LR_RTOL,
                "counter_reads_10": counter == len(got),
                "no_flash_kernel": not any(launches.values())}
    _, _, ok, launches = _nmt_phase("nmt_train", cfg, feeds, True, checks)
    _fail_unless("nmt_train", ok)
    return launches


def phase_nmt_train_flash():
    """bench_nmt's widths, batch and bf16 with attention dropout off
    (hidden dropout stays 0.1) and ragged masks: every fused_attention
    op runs flash attention, 18 K2, 18 K3, 18 K4 and 0 K5 a step (6
    causal).  Then phase_nmt_check."""
    cfg = _nmt_config()
    cfg.attn_dropout = 0.0
    feed = _nmt_feed(cfg, NMT_BATCH, np.random.RandomState(SEED),
                     ragged=True)
    n_attn = 3 * cfg.num_layers

    def checks(got, launches, extra, scope):
        steps = len(got)
        return {
            "k2_k3_k4_18_per_step": all(
                launches[n] == n_attn * steps for n in (
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")),
            "k5_0": launches["flash_attention_bwd_dbias"] == 0,
            "no_other_kernel": not any(
                c for n, c in launches.items()
                if not n.startswith("flash_attention"))}
    exe, init, ok, launches = _nmt_phase("nmt_train_flash", cfg, [feed],
                                         False, checks, keep_init=True)
    ok.update(phase_nmt_check(exe, init, feed))
    _fail_unless("nmt_train_flash", ok)
    return launches


def phase_nmt_check(exe, init, feed):
    """Step 1 from the startup weights ``init``, with all dropout off in
    both routes of each comparison (the routes number their random ops
    differently): the fused route (K2-K4) against the composition route
    (use_fused_attention=False) in bf16 at batch 32, with the fused route
    running the kernels' plain versions as the spread; then the card
    against the port's CPU path, fp32 at batch 2 and 2 + 2 layers, with
    the card's plain-version route as the spread.  Returns the checks by
    name."""
    L = _nmt_config().num_layers
    names = _nmt_grad_names(L)
    fused, _, fout = _nmt_program(_nmt_config(dropout=0.0))
    comp, _, cout = _nmt_program(_nmt_config(dropout=0.0,
                                             use_fused_attention=False))
    before = _launches()
    card = _step_grads(exe, fused, fout["loss"], init, feed, names)
    ran = {n: c - before[n] for n, c in _launches().items()}
    want = _step_grads(exe, comp, cout["loss"], init, feed, names)
    with _plain_attention():
        plain = _step_grads(exe, fused, fout["loss"], init, feed, names)
    bf16 = _route_check(card, want, plain, NMT_LOSS_RTOL, NMT_GRAD_TOL,
                        names=names)

    cut = _nmt_config(dropout=0.0, num_layers=NMT_CPU_LAYERS)
    fmain, fstartup, fo = _nmt_program(cut, amp=False)
    fscope = fluid.Scope()
    exe.run(fstartup, scope=fscope)
    all_names = [p.name for p in fmain.global_block().all_parameters()]
    two = {k: v[:NMT_CPU_BATCH] for k, v in feed.items()}
    before = _launches()
    card2 = _step_grads(exe, fmain, fo["loss"], fscope, two, all_names)
    ran2 = {n: c - before[n] for n, c in _launches().items()}
    t2 = time.perf_counter()
    cpu2 = _step_grads(fluid.Executor(fluid.CPUPlace()), fmain, fo["loss"],
                         fscope, {k: v.cpu() for k, v in two.items()},
                         all_names)
    cpu_s = time.perf_counter() - t2
    with _plain_attention():
        plain2 = _step_grads(exe, fmain, fo["loss"], fscope, two,
                               all_names)
    fp32 = _route_check(card2, cpu2, plain2, NMT_CPU_LOSS_RTOL,
                        NMT_CPU_GRAD_TOL, whole=True,
                        names=_nmt_grad_names(NMT_CPU_LAYERS))
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    checks = {
        "fused_route_ran_k2_k3_k4": all(ran[n] == 3 * L for n in kernels)
        and ran["flash_attention_bwd_dbias"] == 0,
        "fused_matches_composition": bf16["ok"],
        "card_fp32_ran_k2_k3_k4": all(ran2[n] == 3 * NMT_CPU_LAYERS
                                      for n in kernels),
        "card_matches_cpu_path": fp32["ok"],
    }
    emit(phase="nmt_check",
         tolerance="each: max(fixed, 2 x the spread of a route without "
         "K2-K5 from the same reference); dropout off in every route; "
         "fixed: fused vs composition route (bf16, batch %d; spread: the "
         "fused route with the kernels' plain versions) loss rel %g, "
         "grads max|diff|/max|grad| %g; card vs CPU (fp32, batch %d, %d + "
         "%d layers; spread: the card's plain-version route) %g, %g, all "
         "gradients in relative L2 %g"
         % (NMT_BATCH, NMT_LOSS_RTOL, NMT_GRAD_TOL, NMT_CPU_BATCH,
            NMT_CPU_LAYERS, NMT_CPU_LAYERS, NMT_CPU_LOSS_RTOL,
            NMT_CPU_GRAD_TOL, NMT_CPU_GRAD_TOL),
         grads=list(names), loss_fused_route=card[0],
         loss_composition_route=want[0], loss_plain_route=plain[0],
         fused_vs_composition=bf16, launched_fused_route=ran,
         loss_card_b2=card2[0], loss_cpu_b2=cpu2[0],
         loss_plain_b2=plain2[0], cpu_seconds=cpu_s, card_vs_cpu=fp32,
         launched_card_b2=ran2, checks=checks)
    return checks


def phase_lenet_train():
    """bench_lenet's configuration through Executor on the card: LeNet-5,
    1 x 28 x 28, batch 1024, Adam 1e-3, bench_lenet's two feeds taken in
    turn, 2 warm-up and 8 timed steps: finite losses, the last below the
    first, and none of the port's kernels launched (its 5x5 convs are
    cuDNN's)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = lenet.build_train(lr=1e-3)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(2):
        feeds.append({
            "img": torch.from_numpy(rng.normal(
                0, 1, (LENET_BATCH, 1, 28, 28)).astype(np.float32)).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, 10, (LENET_BATCH, 1)).astype(np.int64)).cuda()})
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [out["loss"]], scope)
    launches = _launches()
    losses = [float(g[0].item()) for g in got]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "last_loss_below_first": losses[-1] < losses[0],
              "no_port_kernel": not any(launches.values())}
    emit(phase="lenet_train", card=_card(), steps=len(got),
         batch=LENET_BATCH,
         losses=losses, ms_per_step=step_ms,
         images_per_s=LENET_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches, checks=checks)
    _fail_unless("lenet_train", checks)
    return launches


DFM_BATCH = 4096              # bench.py runs bench_deepfm(batch=4096)
DFM_LR = 1e-3                 # ... with build_train(cfg, lr=1e-3): Adam
DFM_OPT_BATCH = 512           # deepfm_optimizers: the CPU side stays cheap
DFM_CHECK_STEPS = 3           # card vs the port's CPU path, from one state
DFM_LOSS_RTOL = 1e-4          # per-step losses, card vs CPU
DFM_PARAM_FLOOR = 1e-6        # parameters, card vs CPU: max(2 x the
                              # card's spread, this floor)
DFM_LR_RTOL = 1e-6            # fetched rate vs the schedule's closed form


def _dfm_config():
    return deepfm.base_config()


def _dfm_feeds(cfg, batch, n=2):
    """bench_deepfm's feeds: ``n`` batches drawn from RandomState(0),
    taken in turn, as numpy arrays."""
    rng = np.random.RandomState(0)
    return [{"sparse_ids": rng.randint(0, cfg.sparse_feature_dim,
                                       (batch, cfg.num_fields, 1))
             .astype(np.int64),
             "dense_value": rng.rand(batch, cfg.dense_dim).astype(np.float32),
             "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _dfm_program(make_opt=None, tweak=None):
    """DeepFM at ``_dfm_config()``: bench_deepfm's build_train(cfg,
    lr=1e-3) (Adam), or with ``make_opt`` the same forward, then
    ``tweak(main)`` (clip or rate attributes on its parameters) and
    ``make_opt().minimize``.  (main, startup, loss, optimizer)."""
    cfg = _dfm_config()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if make_opt is None:
            out = deepfm.build_train(cfg, lr=DFM_LR)
            return main, startup, out["loss"], out["optimizer"]
        ids = fluid.layers.data(name="sparse_ids",
                                shape=[cfg.num_fields, 1], dtype="int64")
        dense = fluid.layers.data(name="dense_value", shape=[cfg.dense_dim],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = deepfm.deepfm(ids, dense, label, cfg)
        if tweak is not None:
            tweak(main)
        opt = make_opt()
        opt.minimize(loss)
    return main, startup, loss, opt


def _dfm_steps(exe, main, loss, fetch, state, feeds, steps=DFM_CHECK_STEPS):
    """``steps`` runs of ``main`` on a copy of ``state`` on ``exe``'s
    device, feeds taken in turn: ([loss and ``fetch`` of each step],
    {parameter: value after the last step})."""
    scope = _state_copy(main, state, exe.device)
    got = []
    for i in range(steps):
        out = exe.run(main, feed=feeds[i % len(feeds)],
                      fetch_list=[loss] + fetch, scope=scope,
                      return_numpy=False)
        got.append([float(t.reshape(-1)[0].item()) for t in out])
    return got, {p.name: scope.find_var(p.name)
                 for p in main.global_block().all_parameters()}


def _max_abs(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _reversed(feeds):
    """The same batches with their examples in reverse order: the same
    loss and gradients in exact arithmetic, summed in another order."""
    return [{k: np.ascontiguousarray(v[::-1]) for k, v in f.items()}
            for f in feeds]


def _dfm_card_vs_cpu(exe, main, loss, init, feeds, fetch=()):
    """Three card runs (the feeds twice, then each batch's examples in
    reverse order) and two runs of the port's CPU path (the feeds, then
    reversed), each DFM_CHECK_STEPS steps from the state ``init``:
    per-step losses within DFM_LOSS_RTOL; each parameter within the
    larger of DFM_PARAM_FLOOR and twice the sum of the two sides'
    spreads, a side's spread being how far its first run lies from its
    others (the card's nondeterminism, and each side's rounding: sums in
    another order), at the parameter that moves most.  Adagrad, Adamax
    and Ftrl divide by the gradient's own size plus a small epsilon,
    which turns the rounding of a gradient entry near 0 into a step up
    to lr/epsilon times larger; which tensor holds the most sensitive
    entry is chance, so the spread is taken over the whole model, not
    tensor by tensor.  Returns (report, checks, fetches of the first
    card run); no port kernel may launch."""
    before = _launches()
    card, cp = _dfm_steps(exe, main, loss, list(fetch), init, feeds)
    card2, cp2 = _dfm_steps(exe, main, loss, list(fetch), init, feeds)
    rev, rp = _dfm_steps(exe, main, loss, list(fetch), init,
                         _reversed(feeds))
    launched = {n: c - before[n] for n, c in _launches().items()}
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    t0 = time.perf_counter()
    cpu, pp = _dfm_steps(cpu_exe, main, loss, list(fetch), init, feeds)
    cpu_s = time.perf_counter() - t0
    _, prp = _dfm_steps(cpu_exe, main, loss, list(fetch), init,
                        _reversed(feeds))
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card, cpu))
    spread = {n: max(_max_abs(cp[n], cp2[n]), _max_abs(cp[n], rp[n]))
              for n in cp}
    cpu_spread = {n: _max_abs(pp[n], prp[n]) for n in cp}
    err = {n: _max_abs(cp[n], pp[n]) for n in cp}
    bound = max(2 * (max(spread.values()) + max(cpu_spread.values())),
                DFM_PARAM_FLOOR)
    over = {n: e for n, e in err.items() if e > bound}
    losses = [g[0] for g in card]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "card_losses_match_cpu": loss_err <= DFM_LOSS_RTOL,
              "card_params_match_cpu": not over,
              "no_port_kernel": not any(launched.values())}
    report = dict(losses_card=losses, losses_card_2=[g[0] for g in card2],
                  losses_card_reversed=[g[0] for g in rev],
                  losses_cpu=[g[0] for g in cpu], loss_max_rel_err=loss_err,
                  card_runs_bit_equal=all(_max_abs(cp[n], cp2[n]) == 0
                                          for n in cp),
                  param_max_abs_err=err, param_spread_card=spread,
                  param_spread_cpu=cpu_spread, param_bound=bound,
                  params_over_bound=over,
                  cpu_seconds=cpu_s)
    return report, checks, card


def phase_deepfm_train():
    """bench_deepfm's configuration through Executor on the card:
    base_config (26 fields over a 1,000,001-row table, embeddings of 10,
    13 dense features, a 273 -> 400 -> 400 -> 400 -> 1 tower), Adam 1e-3,
    batch 4096, bench_deepfm's two feeds from RandomState(0) taken in
    turn, 2 warm-up and 8 timed steps: finite losses, the last below the
    first, none of the port's kernels launched (the lookups, their dense
    scatter-add gradients and the tower are PyTorch's); ms per step,
    examples/s, peak memory, one profiled step.  Then phase_deepfm_check
    from the startup weights."""
    main, startup, loss, _ = _dfm_program()
    ops = [op.type for op in main.global_block().ops]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    emit(phase="deepfm_startup", seconds=time.perf_counter() - t0,
         parameters=int(sum(scope.find_var(p.name).numel() for p in params)),
         parameter_tensors=len(params), ops=len(ops),
         grad_ops=sum(t.endswith("_grad") for t in ops),
         adam_ops=ops.count("adam"), batch=DFM_BATCH)
    init = _state_copy(main, scope)
    feeds_np = _dfm_feeds(_dfm_config(), DFM_BATCH)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()}
             for f in feeds_np]
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts go to 0 here and are read after it
    _reset_launches()
    got, step_ms = _train_steps(exe, main, feeds, [loss], scope)
    launches = _launches()
    losses = [float(g[0].item()) for g in got]
    checks = {"losses_finite": bool(np.isfinite(losses).all()),
              "last_loss_below_first": losses[-1] < losses[0],
              "no_port_kernel": not any(launches.values())}
    emit(phase="deepfm_train", card=_card(), steps=len(got),
         batch=DFM_BATCH, losses=losses, ms_per_step=step_ms,
         examples_per_s=DFM_BATCH / step_ms * 1e3,
         peak_device_mb=torch.cuda.max_memory_allocated() / 2**20,
         launches=launches, checks=checks)
    _profile_step("deepfm_train_profile", exe, main, feeds[0], [loss], scope)
    checks.update(phase_deepfm_check(exe, main, loss, init, feeds_np))
    _fail_unless("deepfm_train", checks)
    return launches


def phase_deepfm_check(exe, main, loss, init, feeds):
    """The card against the port's CPU path at full width: bench_deepfm's
    program from the startup weights ``init``, its two feeds, three Adam
    steps.  Returns the checks by name."""
    report, checks, _ = _dfm_card_vs_cpu(exe, main, loss, init, feeds)
    emit(phase="deepfm_check", batch=DFM_BATCH, steps=DFM_CHECK_STEPS,
         tolerance="losses rel %g; each parameter max|card - cpu| <= "
         "max(2 x (card spread + cpu spread), %g); card spread: the "
         "largest max|card - card again| or max|card - card on the "
         "reversed batches| of any parameter; cpu spread: the largest "
         "max|cpu - cpu on the reversed batches|"
         % (DFM_LOSS_RTOL, DFM_PARAM_FLOOR),
         checks=checks, **report)
    return checks


# optimizer runs of deepfm_optimizers: name -> (make the optimizer,
# tweak the program before minimize)
def _tower_clip(main):
    for p in main.global_block().all_parameters():
        if p.name.startswith("fc_"):
            p.gradient_clip_attr = fluid.clip.GradientClipByValue(0.01)


def _tower_clip_and_emb_rate(main):
    _tower_clip(main)
    main.global_block().var("fm_emb").optimize_attr["learning_rate"] = 0.5


def _global_norm_clip(main):
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0),
                                 program=main)


DFM_OPTIMIZERS = {
    "lars_momentum": (lambda: fluid.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9), None),
    "adamax": (lambda: fluid.optimizer.AdamaxOptimizer(1e-3), None),
    "adagrad": (lambda: fluid.optimizer.AdagradOptimizer(1e-2), None),
    "decayed_adagrad": (
        lambda: fluid.optimizer.DecayedAdagradOptimizer(1e-2), None),
    "adadelta": (lambda: fluid.optimizer.AdadeltaOptimizer(1.0), None),
    "rmsprop_centered": (lambda: fluid.optimizer.RMSPropOptimizer(
        1e-3, momentum=0.9, centered=True), None),
    "ftrl": (lambda: fluid.optimizer.FtrlOptimizer(
        1e-2, l1=1e-4, l2=1e-4), None),
    "lamb": (lambda: fluid.optimizer.LambOptimizer(1e-3), None),
    "adam_global_norm_clip": (
        lambda: fluid.optimizer.AdamOptimizer(DFM_LR), _global_norm_clip),
    "sgd_tower_clip_emb_rate": (
        lambda: fluid.optimizer.SGDOptimizer(0.5), _tower_clip_and_emb_rate),
}


def _closed_poly_cycle(t, lr0, ds, end, power):
    decay = ds * np.maximum(np.ceil(t / ds), 1.0)
    return (lr0 - end) * (1.0 - t / decay) ** power + end


# schedule runs: name -> (the rate as a Variable, its closed form at the
# step t = 0, 1, ...); SGD reads it
DFM_SCHEDULES = {
    "exponential_decay": (
        lambda L: L.exponential_decay(0.1, 2, 0.5, staircase=True),
        lambda t: 0.1 * 0.5 ** np.floor(t / 2)),
    "natural_exp_decay": (lambda L: L.natural_exp_decay(0.1, 2, 0.3),
                          lambda t: 0.1 * np.exp(-0.3 * t / 2)),
    "inverse_time_decay": (lambda L: L.inverse_time_decay(0.1, 2, 0.5),
                           lambda t: 0.1 / (1 + 0.5 * t / 2)),
    "polynomial_decay": (
        lambda L: L.polynomial_decay(0.1, 2, 1e-3, power=2.0, cycle=True),
        lambda t: _closed_poly_cycle(t, 0.1, 2, 1e-3, 2.0)),
    "piecewise_decay": (
        lambda L: L.piecewise_decay([1, 2], [0.1, 0.05, 0.01]),
        lambda t: np.array([0.1, 0.05, 0.01])[
            np.searchsorted([1, 2], t, side="right")]),
    "cosine_decay": (lambda L: L.cosine_decay(0.1, 1, 8),
                     lambda t: 0.05 * (np.cos(np.pi * t / 8) + 1)),
    "linear_lr_warmup": (lambda L: L.linear_lr_warmup(0.1, 2, 0.01, 0.1),
                         lambda t: np.where(t < 2, 0.01 + 0.09 * t / 2,
                                            0.1)),
}


def phase_deepfm_optimizers():
    """DeepFM at base_config and batch 512: each of the eight optimizers
    the port adds, Adam with GradientClipByGlobalNorm(1.0), SGD with
    GradientClipByValue(0.01) on the tower and a rate of 0.5 on fm_emb,
    and SGD on each of the seven schedules, for three steps on the card
    and on the port's CPU path from one startup state, held as
    deepfm_check holds Adam; each schedule's fetched rate within
    DFM_LR_RTOL of its closed form.  Any miss fails the run."""
    feeds = _dfm_feeds(_dfm_config(), DFM_OPT_BATCH)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = [(n, make, tweak, None) for n, (make, tweak) in
            DFM_OPTIMIZERS.items()]
    for n, (sched, closed) in DFM_SCHEDULES.items():
        runs.append((n, lambda sched=sched: fluid.optimizer.SGDOptimizer(
            sched(fluid.layers)), None, closed))
    checks = {}
    for name, make, tweak, closed in runs:
        main, startup, loss, opt = _dfm_program(make, tweak)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fetch = [] if closed is None else [opt._global_learning_rate(main)]
        report, ok, card = _dfm_card_vs_cpu(exe, main, loss, scope, feeds,
                                            fetch)
        if closed is not None:
            rates = [g[1] for g in card]
            want = closed(np.arange(len(rates), dtype=np.float64))
            lr_err = float(np.max(np.abs(np.array(rates) - want) / want))
            report.update(learning_rates=rates, lr_max_rel_err=lr_err)
            ok["lr_is_closed_form"] = lr_err <= DFM_LR_RTOL
        ops = main.global_block().ops
        emit(phase="deepfm_optimizers", run=name, batch=DFM_OPT_BATCH,
             steps=DFM_CHECK_STEPS, ops=len(ops),
             clip_ops=sum(op.type in ("clip", "squared_l2_norm") and
                          op.attr("op_role") == fluid.OpRole.Optimize
                          for op in ops), checks=ok, **report)
        checks.update({"%s_%s" % (name, k): v for k, v in ok.items()})
    _fail_unless("deepfm_optimizers", checks)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    bounds = phase_bounds()
    k2 = phase_kernel()
    bwd = phase_kernel_bwd()
    nmt = phase_kernel_nmt()
    k1 = phase_kernel_conv(bounds)
    k6 = phase_kernel_ln(bounds)
    by_path = {"serve": phase_slice()}
    by_path["train"] = phase_train()["launches"]
    by_path["train_bias"] = phase_train_bias()
    phase_train_attn_dropout()
    resnet = phase_resnet_train()
    by_path["resnet_train"] = resnet["launches"]
    by_path["ln_path"] = phase_ln_path()
    by_path["nmt_train"] = phase_nmt_train()
    by_path["nmt_train_flash"] = phase_nmt_train_flash()
    by_path["lenet_train"] = phase_lenet_train()
    by_path["deepfm_train"] = phase_deepfm_train()
    phase_deepfm_optimizers()
    timings = dict(flash_attention_fwd=k2,
                   flash_attention_bwd_dq=bwd["dq"],
                   flash_attention_bwd_dkv=bwd["dkv"],
                   flash_attention_bwd_dbias=bwd["dbias"],
                   conv3x3_bn_relu=k1, layer_norm=k6)
    csrc = "paddle_tpu_torch/csrc/"
    rows = []
    for name, source, replaces in (
            ("flash_attention_fwd", "flash_attention_fwd.cu",
             "pallas_ops.py:44"),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "pallas_ops.py:115"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "pallas_ops.py:152"),
            ("flash_attention_bwd_dbias", "flash_attention_bwd.cu",
             "pallas_ops.py:196"),
            ("conv3x3_bn_relu", "conv3x3_bn_relu.cu", "conv_pallas.py:33"),
            ("layer_norm", "layer_norm.cu", "pallas_ops.py:706")):
        t = timings[name]
        paths = {p: c.get(name, 0) for p, c in by_path.items()}
        rows.append(dict(
            name=name, route="cuda", source=csrc + source,
            replaces="paddle_tpu/fluid/ops/" + replaces,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            **({"ops_peak": t["ops_peak"]} if "ops_peak" in t else {}),
            **({"per": t["per"]} if "per" in t else {})))
        if name == "conv3x3_bn_relu":
            rows[-1]["variants_resnet_train"] = resnet[
                "k1_launches_by_variant"]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        if name == "flash_attention_fwd":
            # the row's numbers are the serving shape's; training
            # launches it with the LSE at BH = 384
            rows[-1]["training_with_lse"] = {
                key: bwd["fwd_with_lse"][key] for key in keys}
        nmt_key = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq":
                   "dq", "flash_attention_bwd_dkv": "dkv"}.get(name)
        if nmt_key:
            # Transformer NMT's shape (BH = 256, S = 256, D = 64; K2 with
            # the LSE), causal and with the pad bias, fp32 and bf16
            rows[-1]["nmt"] = {}
            for case, t in nmt["timings"][nmt_key].items():
                e = nmt["errors"][case]
                err = max(e["dk"], e["dv"]) if nmt_key == "dkv" else \
                    e[nmt_key]
                rows[-1]["nmt"][case] = dict(
                    {key: t[key] for key in keys}, max_abs_err=err)
    emit(kernels=rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
