"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a
non-zero exit (nothing is caught):

1. device: card name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and convolutions.
2. build: every CUDA kernel of the port, from paddle_tpu_torch/csrc/,
   with nvcc (one process per source, started together).
3. bounds: the least time of the TPU kernels not yet ported (K1, K6) at
   the shapes of their own paths, computed from their code.
4. kernel: the flash-attention forward (K2) against its plain PyTorch
   version on the card — BERT-base shapes with a [B,1,S,S] padding bias
   in fp32 and bf16, causal with the LSE, a ragged cross case (S_q=77,
   S_kv=200) and D=128 — then its time beside the plain version, one
   scaled_dot_product_attention call (the yardstick, never used by the
   port) and the bound.
5. kernel_bwd: the backward kernels K3 (dQ), K4 (dK/dV) and K5 (dBias)
   against their plain versions — the BERT-base training shape (BH=384,
   S=128, D=64, [32,1,128,128] padding bias) in fp32 and bf16, causal,
   ragged cross 77 x 200 and D=128 — then their times at the training
   shape beside the plain versions, the SDPA backward and the bounds,
   and K2's with the LSE.
6. slice: BERT-base (12 x 768, 12 heads, S=128, ~109M parameters, random
   weights from a seed) built with the port's layers, cloned for test,
   started on CUDAPlace(0) and served through ServingExecutor(max_batch=8)
   — 24 requests of 1-8 rows with random true lengths — checked against
   the same rows run alone, against the matmul/softmax composition with
   the same weights, and against the port's CPU path on two rows; K2's
   launch count must be 12 per dispatched batch, and no backward kernel
   may launch.  Then a profile.
7. train: BERT-base pretraining (build_pretrain: batch 32, 20 masked
   positions, fp32, Adam lr 1e-4, hidden dropout 0.1, attention dropout
   0) through Executor, 2 warm-up and 8 timed steps on one synthetic
   batch: finite falling losses, 12 K2, 12 K3, 12 K4 and 0 K5 launches
   per step, ms per step, sequences/s, tokens/s, peak memory, one
   profiled step; then fused vs composition path and card vs the port's
   CPU path (batch 2) on the step-1 loss and named gradients.
8. train_bias: an attention layer whose bias is a trainable [1,H,S,S]
   parameter — the path that launches K5 — against the composition path.
9. train_attn_dropout: BERT with attention dropout 0.1 at 2 layers, the
   composition route: finite losses, no flash kernel launched.
10. kernels: one JSON line listing every ported kernel.

The last line is {"ok": true, "device": {...}}.  Exits non-zero, printing
no result, where torch.cuda.is_available() is false.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import _kernels
from paddle_tpu_torch.fluid.ops.attention_ops import (
    attention_delta, attention_reference, dbias_reference, dkv_reference,
    dq_reference, flash_attention, flash_attention_bwd_dbias,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, recompute_p_dp)
from paddle_tpu_torch.models import bert

# H100 SXM published peaks (NVIDIA data sheet): device memory rate, and
# float32 on the CUDA cores (the main path runs fp32 with TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # tensor cores, dense (K1's bound)

SEED = 1234
# every kernel wrapper of the port, by the name the kernels line gives it
KERNELS = {"flash_attention_fwd": flash_attention,
           "flash_attention_bwd_dq": flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
           "flash_attention_bwd_dbias": flash_attention_bwd_dbias}
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
    the spin doubles and the count halves."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 100_000_000                  # GPU cycles, ~50 ms at 2 GHz
    while iters >= 5:
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
    raise SystemExit("could not keep the host ahead of the device while "
                     "timing %r" % (fn,))


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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build():
    t0 = time.perf_counter()
    times = _kernels.build_all()
    wall = time.perf_counter() - t0
    ptxas = {}
    for src in _kernels.sources():
        lines = _kernels.build_log(src.stem).splitlines()
        ptxas[src.stem] = [ln.strip() for ln in lines
                           if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(wall, 3), compiled=times,
         ptxas=ptxas)


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


def phase_kernel():
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    lengths = torch.randint(1, S + 1, (B,), generator=gen,
                            device=dev).tolist()
    base = dict(q=rand(B * H, S, D), k=rand(B * H, S, D),
                v=rand(B * H, S, D), bias=_padding_bias(lengths, torch.float32,
                                                        dev))
    cases = [
        ("bert_base_fp32", base, torch.float32, False),
        ("bert_base_bf16", base, torch.bfloat16, False),
        ("causal_lse_fp32", dict(q=rand(B * H, S, D), k=rand(B * H, S, D),
                                 v=rand(B * H, S, D), bias=None),
         torch.float32, True),
        ("ragged_cross_77x200_fp32",
         dict(q=rand(16, 77, D), k=rand(16, 200, D), v=rand(16, 200, D),
              bias=torch.where(rand(16, 77, 200) < -1.5, -1e4, 0.0)),
         torch.float32, False),
        ("d128_bias_fp32", dict(q=rand(48, S, 128), k=rand(48, S, 128),
                                v=rand(48, S, 128),
                                bias=base["bias"][:4]),
         torch.float32, False),
        ("d128_causal_lse_bf16", dict(q=rand(48, S, 128), k=rand(48, S, 128),
                                      v=rand(48, S, 128), bias=None),
         torch.bfloat16, True),
    ]
    errs = {}
    for name, t, dt, causal in cases:
        args = [None if t[n] is None else t[n].to(dt)
                for n in ("q", "k", "v", "bias")]
        scale = 1.0 / math.sqrt(args[0].shape[-1])
        got, lse = flash_attention(*args, scale, causal=causal,
                                   with_lse=True)
        torch.cuda.synchronize()
        # the plain version in fp32 on the (possibly bf16-rounded) inputs
        ref_args = [None if a is None else a.float() for a in args]
        want, want_lse = attention_reference(*ref_args, scale,
                                             causal=causal, with_lse=True)
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
                                     rtol=BF16_TOL)) and \
                lse_err <= BF16_TOL
            tol = "atol/rtol %g vs fp32 plain of bf16 inputs" % BF16_TOL
        emit(phase="kernel_check", case=name, dtype=str(dt),
             shape=list(args[0].shape), kv=args[1].shape[1], causal=causal,
             max_abs_err=err, masked_rows=int(masked.sum()),
             masked_rows_max_abs_err=masked_err, lse_max_abs_err=lse_err,
             tolerance=tol, finite=finite, ok=ok and finite)
        if not (ok and finite):
            raise SystemExit("flash_attention disagrees with its plain "
                             "version in case %s" % name)
        errs[name] = err

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
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    emit(phase="kernel_time", shape=[B * H, S, D], dtype="float32",
         gflop=flops / 1e9, mbytes=nbytes / 1e6,
         roofline_share=timing["bound_ms"] / ms, **timing)
    return dict(max_abs_err=errs["bert_base_fp32"], **timing)


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
    if not all(checks.values()):
        raise SystemExit("slice checks failed: %s"
                         % [k for k, ok in checks.items() if not ok])
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


def _bound(nbytes, flops):
    """The least time (ms) for fp32 work of ``flops`` moving ``nbytes``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def phase_bounds():
    """Bounds of the TPU kernels not yet ported, at the shapes of their
    own paths, from their code (no device work):
    K1 (conv_pallas.py:80) runs, behind FLAGS_conv_pallas, on every 3x3
    stride-1 pad-1 conv of ResNet-50 training (bench.py bench_resnet:
    batch 256, 224 x 224, pure-bf16): the 3x3 conv of each bottleneck
    block but the first of stages 2-4, 13 convs; forward only.
    K6 (pallas_ops.py:726) backs fused_layer_norm, which no model emits;
    its shape here is BERT-base's hidden state at the training batch,
    x2d [32 * 128, 768] fp32, scale and bias [768]."""
    rows = []
    N, t_ops, t_bytes = 256, 0.0, 0.0
    for hw, c, n in ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2)):
        flops = 2.0 * N * hw * hw * 9 * c * c
        nbytes = 2 * (2 * N * hw * hw * c + 9 * c * c) + 4 * 2 * c
        rows.append(dict(hw=hw, C=c, O=c, convs=n, gflop=flops / 1e9,
                         mbytes=nbytes / 1e6,
                         bound_ms=max(flops / PEAK_BF16_FLOPS,
                                      nbytes / PEAK_BYTES_PER_S) * 1e3))
        t_ops += n * flops / PEAK_BF16_FLOPS
        t_bytes += n * nbytes / PEAK_BYTES_PER_S
    emit(phase="bounds", kernel="K1 conv3x3 (not ported)", dtype="bfloat16",
         batch=N, convs=rows, bound_ms_per_step=max(t_ops, t_bytes) * 1e3,
         bound_by="operations" if t_ops >= t_bytes else "bytes")
    M, Dm = BT * S, H * D
    nbytes = 4 * (2 * M * Dm + 2 * Dm)
    flops = 8.0 * M * Dm            # mean, centre, square, var, scale, shift
    emit(phase="bounds", kernel="K6 layer_norm (not ported)",
         dtype="float32", x2d=[M, Dm], gflop=flops / 1e9,
         mbytes=nbytes / 1e6,
         bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
         * 1e3,
         bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >=
         flops / PEAK_FP32_FLOPS else "operations")


def phase_kernel_bwd():
    """K3, K4 and K5 against their plain versions on the card, then their
    times at the BERT-base training shape (and K2's, with the LSE)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    lengths = torch.randint(S // 2, S + 1, (BT,), generator=gen,
                            device=dev).tolist()
    BH = BT * H
    train = dict(q=rand(BH, S, D), k=rand(BH, S, D), v=rand(BH, S, D),
                 dO=rand(BH, S, D),
                 bias=_padding_bias(lengths, torch.float32, dev))
    cases = [
        ("bert_train_fp32", train, torch.float32, False, True),
        ("bert_padding_rows_fp32", train, torch.float32, False, False),
        ("bert_train_bf16", train, torch.bfloat16, False, True),
        ("causal_fp32", dict(q=rand(96, S, D), k=rand(96, S, D),
                             v=rand(96, S, D), dO=rand(96, S, D),
                             bias=None), torch.float32, True, False),
        ("ragged_cross_77x200_fp32",
         dict(q=rand(16, 77, D), k=rand(16, 200, D), v=rand(16, 200, D),
              dO=rand(16, 77, D),
              bias=torch.where(rand(16, 77, 200) < -1.5, -1e4, 0.0)),
         torch.float32, False, False),
        ("d128_bias_fp32", dict(q=rand(48, S, 128), k=rand(48, S, 128),
                                v=rand(48, S, 128), dO=rand(48, S, 128),
                                bias=train["bias"][:4]),
         torch.float32, False, True),
        ("d128_causal_bf16", dict(q=rand(48, S, 128), k=rand(48, S, 128),
                                  v=rand(48, S, 128), dO=rand(48, S, 128),
                                  bias=None), torch.bfloat16, True, False),
    ]
    kernels = (("dq", flash_attention_bwd_dq),
               ("dkv", flash_attention_bwd_dkv),
               ("dbias", flash_attention_bwd_dbias))
    errs = {}
    for name, t, dt, causal, zero_do in cases:
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
                    if n != "flash_attention_fwd"}
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
                        max_abs_err=real.max().item() if real.numel()
                        else 0.0,
                        masked_rows_max_abs_err=rows[masked].max().item()
                        if masked.any() else 0.0)
                else:
                    rep[n] = dict(max_abs_err=diff.max().item(),
                                  masked_rows_bound_max=bounds[n].max()
                                  .item())
                ok = ok and excess <= 0
            tol = ("atol %g; fully masked rows and their share of dk/dv "
                   "add %g x |p| propagated" % (BWD_FP32_ATOL, MASKED_P_REL))
        else:
            for n in got:
                close = torch.allclose(got[n].float(), want[n].float(),
                                       atol=BF16_TOL, rtol=BF16_TOL)
                rep[n] = dict(max_abs_err=(got[n].float() - want[n].float())
                              .abs().max().item())
                ok = ok and close
            tol = ("atol/rtol %g vs the plain version in bf16 (same "
                   "rounding points)" % BF16_TOL)
        emit(phase="kernel_bwd_check", case=name, dtype=str(dt),
             shape=list(args[0].shape), kv=args[1].shape[1], causal=causal,
             bias=None if args[3] is None else list(args[3].shape),
             dO_zero_on_masked_rows=zero_do, masked_rows=int(masked.sum()),
             launched=launched, errors=rep, tolerance=tol, finite=finite,
             ok=ok)
        if not ok:
            raise SystemExit("flash-attention backward kernels disagree "
                             "with their plain versions in case %s" % name)
        errs[name] = rep

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
                      **_bound(*work[name]))
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
        **_bound(4 * qkv + b.numel() * 4 + lse.numel() * 4,
                     4.0 * sq * D))
    emit(phase="kernel_time", kernel="flash_attention_fwd with_lse",
         shape=[BH, S, D], bias=list(b.shape), dtype="float32",
         roofline_share=k2["bound_ms"] / k2["ms"], **k2)
    return out


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
    from torch.profiler import ProfilerActivity, profile
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
    losses = []
    warm, timed = 2, 8
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                              scope=scope, return_numpy=False)[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    launches = _launches()
    losses = [float(x.item()) for x in losses]
    steps = warm + timed
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

    # one profiled step: device busy share and top kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[out["loss"]], scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev_ms, top = _device_ms(prof, 1)
    busy_ms, _, events = _timeline(prof)
    launch = [e for e in prof.key_averages()
              if e.key.startswith("cudaLaunchKernel")]
    emit(phase="train_profile", wall_ms=wall_ms, kernel_ms=dev_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         device_events=events, launch_calls=sum(e.count for e in launch),
         top_kernels=top)

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
    if not all(checks.values()):
        raise SystemExit("train checks failed: %s"
                         % [k for k, ok in checks.items() if not ok])
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
    if not all(checks.values()):
        raise SystemExit("train_bias checks failed: %s"
                         % [k for k, ok in checks.items() if not ok])
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    phase_bounds()
    k2 = phase_kernel()
    bwd = phase_kernel_bwd()
    by_path = {"serve": phase_slice()}
    by_path["train"] = phase_train()["launches"]
    by_path["train_bias"] = phase_train_bias()
    phase_train_attn_dropout()
    src = "paddle_tpu_torch/csrc/flash_attention_%s.cu"
    timings = dict(flash_attention_fwd=k2,
                   flash_attention_bwd_dq=bwd["dq"],
                   flash_attention_bwd_dkv=bwd["dkv"],
                   flash_attention_bwd_dbias=bwd["dbias"])
    rows = []
    for name, line in (("flash_attention_fwd", 44),
                       ("flash_attention_bwd_dq", 115),
                       ("flash_attention_bwd_dkv", 152),
                       ("flash_attention_bwd_dbias", 196)):
        t = timings[name]
        paths = {p: c[name] for p, c in by_path.items() if c.get(name)}
        rows.append(dict(
            name=name, route="cuda",
            source=src % ("fwd" if name.endswith("fwd") else "bwd"),
            replaces="paddle_tpu/fluid/ops/pallas_ops.py:%d" % line,
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    emit(kernels=rows)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
