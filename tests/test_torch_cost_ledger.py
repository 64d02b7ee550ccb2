"""The device-cost ledger in the port (paddle_tpu_torch/fluid/costmodel.py,
``Executor.cost_record``, ``paddle_tpu_torch/tools/cost_ledger.py``),
held against paddle_tpu's ledger on the CPU with the same probe
programs and numpy feeds:

- per Fluid op, the contraction FLOPs of every ``fluid_mul``,
  ``fluid_matmul`` and ``fluid_*_grad`` entry of the ``mlp_k1`` and
  ``infer_b8`` probes equal JAX ``op_attribution``'s ``flops_est``
  exactly (both count 2·M·N·K, JAX's with each operand's shape read from
  its defining instruction; XLA rewrote no product of these probes);
- ``dp_allreduce``'s wire bytes a step equal JAX's (an all-reduce counted
  as twice its payload in both);
- a window of 16 counts the K=1 step's FLOPs, ``window_flops`` 16x;
- ``FLAGS_cost_ledger=0``: bit-equal fetches, None records, no stamp and
  no added host sync;
- the roofline follows the configured peaks, by the record's dtype;
- serving ``warmup(ledger=True)``: one record a bucket, FLOPs linear in
  the bucket;
- the CLI's ``--check`` fails on an injected regression naming the
  responsible ops, and the checked-in baseline matches the probes;
- ``kernel_work`` pinned for K1 at ResNet-50's four shapes, K2-K5 at
  BERT-base's and NMT's, K6 at [4096, 768] (the values chip_smoke.py's
  bounds used before they read it), and a hand kernel counted once, by
  its work, in a capture;
- attribution of sub-blocks and of a recompute replay, ``timed_steps``'
  detail keys and ``FLAGS_benchmark``'s per-inner-step stats.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import costmodel as jcost

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import costmodel, flags, profiler, telemetry
from paddle_tpu_torch.tools import cost_ledger as tool
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_cost_ledger", os.path.join(REPO, "tools", "cost_ledger.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _contraction_flops_by_op(hlo):
    """JAX ``op_attribution``'s ``flops_est`` per Fluid op, with each dot
    operand's shape resolved from the instruction that defines it.  The
    installed XLA prints operands by name only, so ``op_attribution``
    itself falls back to 2 x the output's size; this is the 2·M·N·K it
    reads when the text carries the operand shapes (as in the checked-in
    tests/cost_baseline.json: 196,608 for mlp_k1's fluid_mul)."""
    import re
    shapes = {}
    for line in hlo.splitlines():
        m = re.match(r"^\s*(?:ROOT\s+)?(%?[\w.-]+)\s*=\s*(\w+)\[([0-9,]*)\]",
                     line)
        if m:
            shapes[m.group(1).lstrip("%")] = [int(d) for d in
                                              m.group(3).split(",") if d]
    out = {}
    for line in hlo.splitlines():
        m = jcost._INSTR_RE.match(line)
        if not m or m.group(2) not in ("dot", "convolution"):
            continue
        name_m = jcost._OPNAME_RE.search(line)
        fluid_m = jcost._FLUID_RE.search(name_m.group(1)) if name_m else None
        key = fluid_m.group(1) if fluid_m else "(unattributed)"
        out_numel = int(np.prod(shapes[re.match(
            r"^\s*(?:ROOT\s+)?%?([\w.-]+)", line).group(1)]))
        lhs = re.search(r"\b%s\((%%?[\w.-]+)" % m.group(2), line).group(1)
        lhs_dims = shapes[lhs.lstrip("%")]
        cm = re.search(r"lhs_contracting_dims=\{(\d+)", line)
        contracted = lhs_dims[int(cm.group(1))] if cm else lhs_dims[-1]
        out[key] = out.get(key, 0) + 2 * out_numel * contracted
    return out


def _jax_record(name):
    """JAX's record and full op attribution of probe ``name`` (its
    tools/cost_ledger.py program), on the CPU."""
    jtool = _jax_tool()
    main, startup, feed, fetch, k = jtool.PROBES[name]()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        rec = exe.cost_record(main, feed=feed, fetch_list=[fetch],
                              steps_per_run=k, stamp=False)
        hlo = exe.compiled_hlo(main, feed=feed, fetch_list=[fetch],
                               steps_per_run=k)
    att = jcost.op_attribution(hlo)
    for op, flops in _contraction_flops_by_op(hlo).items():
        att[op]["flops_est"] = flops
    return rec, att


def _port_record(name, **kw):
    main, startup, feed, fetch, k = tool.PROBES[name]()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rec = exe.cost_record(main, feed=feed, fetch_list=[fetch], scope=scope,
                          steps_per_run=k, stamp=False)
    cap = exe._capture(main, feed, [fetch], scope, k)[0]
    return rec, costmodel.attribution(cap, k or 1), exe, main, scope, feed, \
        fetch


def _compile_records():
    return [e for e in telemetry.step_events() if e.get("kind") == "compile"]


@pytest.mark.parametrize("probe", ["mlp_k1", "infer_b8"])
def test_contraction_flops_per_op_equal_jax_attribution(probe):
    _, jatt = _jax_record(probe)
    _, att, *_ = _port_record(probe)
    names = [op for op in jatt
             if op in ("fluid_mul", "fluid_matmul") or op.endswith("_grad")]
    assert "fluid_mul" in names
    for op in names:
        assert att[op]["flops_est"] == jatt[op]["flops_est"], \
            (op, att[op], jatt[op])
    if probe == "mlp_k1":
        # fc 64->64 on a fed x: no dX product, only dW (x stops the
        # gradient); fc 64->32: dX and dW
        assert att["fluid_mul_grad"]["flops_est"] == \
            2 * 64 * 64 * 16 + 2 * (2 * 16 * 32 * 64)


def test_dp_allreduce_wire_bytes_equal_jax():
    """Both ledgers count an all-reduce as twice its payload (a
    reduce-scatter and an all-gather): the one gradient bucket, W [64,
    64] and b [64] in float32, 2 x 16,640 B.  JAX counts it on its
    8-device mesh, the port in a world of one, where the op is the
    identity and the ledger counts what it would put on the wire."""
    jrec, _ = _jax_record("dp_allreduce")
    rec, *_ = _port_record("dp_allreduce")
    assert rec["collective_bytes"] == jrec["collective_bytes"] == \
        {"allreduce_fp32@dp": 2 * 4 * (64 * 64 + 64)}
    assert rec["collective_bytes_per_step"] == \
        jrec["collective_bytes_per_step"]
    assert rec["collectives"] == {"allreduce": 1}


def test_window_counts_one_inner_step():
    r1, *_ = _port_record("mlp_k1")
    r16, *_ = _port_record("mlp_k16")
    assert r16["k"] == 16 and r16["sig"].endswith(":k16")
    assert r16["flops"] == r1["flops"]
    assert r16["window_flops"] == 16 * r1["flops"]
    assert r16["bytes_accessed"] == pytest.approx(r1["bytes_accessed"],
                                                  rel=1e-3)


def test_record_fields_and_scope_untouched():
    rec, att, exe, main, scope, feed, fetch = _port_record("mlp_k1")
    for f in ("sig", "k", "flops", "transcendentals", "bytes_accessed",
              "window_flops", "argument_bytes", "output_bytes",
              "temp_bytes", "peak_bytes", "collectives", "aten_calls",
              "hand_kernel_calls", "estimated_step_s", "top_ops",
              "peak_dtype"):
        assert f in rec, f
    # the CPU has no allocator peak: the record does not invent one
    assert rec["temp_bytes"] is None and rec["peak_bytes"] is None
    assert rec["top_ops"][0]["op"] == "fluid_mul_grad"
    assert rec["argument_bytes"] == 4 * (16 * 64 + 64 * 64 + 64 + 64 * 32 +
                                         32 + 1)
    step = scope.step_counter
    before = {n: np.array(scope.find_var(n)) for n in scope.var_names()}
    exe.cost_record(main, feed=feed, fetch_list=[fetch], scope=scope)
    assert scope.step_counter == step
    for n, v in before.items():
        np.testing.assert_array_equal(np.array(scope.find_var(n)), v)
    flat = exe.compiled_cost(main, feed=feed, fetch_list=[fetch],
                             scope=scope)
    assert flat["flops"] == rec["flops"]
    assert flat["bytes accessed"] == rec["bytes_accessed"]


def test_dispatch_stamp_and_ledger_off_bit_exact_without_syncs():
    def run(n=3):
        main, startup, feed, loss, _ = tool.PROBES["mlp_k1"]()
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        n0 = len(_compile_records())
        s0 = profiler.host_sync_count()
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
                  for _ in range(n)]
        syncs = profiler.host_sync_count() - s0
        stamped = _compile_records()[n0:]
        rec = exe.cost_record(main, feed=feed, fetch_list=[loss],
                              scope=scope, stamp=False)
        return np.asarray(losses), syncs, stamped, rec

    on_losses, on_syncs, on_stamps, on_rec = run()
    assert len(on_stamps) == 1
    assert on_stamps[0]["source"] == "dispatch"
    assert on_stamps[0]["sig"].endswith(":k1")
    assert on_stamps[0]["compile_s"] > 0 and on_rec is not None
    flags.set_flag("cost_ledger", False)
    try:
        off_losses, off_syncs, off_stamps, off_rec = run()
    finally:
        flags.set_flag("cost_ledger", True)
    np.testing.assert_array_equal(on_losses, off_losses)
    assert on_syncs == off_syncs
    assert off_stamps == [] and off_rec is None


def test_roofline_follows_the_configured_peaks():
    names = ("roofline_peak_flops", "roofline_peak_flops_fp32",
             "roofline_peak_bytes_per_s")
    old = {n: flags.get_flag(n) for n in names}
    assert old == {"roofline_peak_flops": 989e12,
                   "roofline_peak_flops_fp32": 67e12,
                   "roofline_peak_bytes_per_s": 3.35e12}
    flags.set_flag("roofline_peak_flops", 4e6)
    flags.set_flag("roofline_peak_flops_fp32", 1e6)
    flags.set_flag("roofline_peak_bytes_per_s", 1e9)
    try:
        assert costmodel.roofline_seconds(2e6, 1e3, "float32") == \
            pytest.approx(2.0)
        assert costmodel.roofline_seconds(2e6, 1e3, "bfloat16") == \
            pytest.approx(0.5)
        assert costmodel.roofline_seconds(1e3, 5e9) == pytest.approx(5.0)
        rec, *_ = _port_record("mlp_k1")
        assert rec["peak_dtype"] == "float32"
        assert rec["estimated_step_s"] == pytest.approx(
            max(rec["flops"] / 1e6, rec["bytes_accessed"] / 1e9))
    finally:
        for n, v in old.items():
            flags.set_flag(n, v)


def test_serving_warmup_ledger_records_per_bucket():
    from paddle_tpu_torch.fluid.serving import ServingExecutor

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        out = fluid.layers.softmax(fluid.layers.fc(x, size=8))
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    n0 = len(_compile_records())
    sv = ServingExecutor(infer, scope=scope,
                         feed_specs={"x": ((16,), "float32")},
                         fetch_list=[out], place=fluid.CPUPlace(),
                         max_batch=4)
    try:
        compiles = sv._exe.compile_count()
        sv.warmup(ledger=True)
        assert sv._exe.compile_count() - compiles == len(sv.buckets)
        tags = {e["tag"] for e in _compile_records()[n0:]
                if str(e.get("tag", "")).startswith("serving:b")}
        assert tags == {"serving:b%d" % b for b in sv.buckets}
        recs = sv.ledger_records
        assert sorted(recs) == sorted(sv.buckets)
        for b in sv.buckets:
            assert recs[b]["flops"] == b * recs[1]["flops"] == b * 2 * 16 * 8
    finally:
        sv.close()
    flags.set_flag("cost_ledger", False)
    try:
        sv2 = ServingExecutor(infer, scope=scope,
                              feed_specs={"x": ((16,), "float32")},
                              fetch_list=[out], place=fluid.CPUPlace(),
                              max_batch=2)
        try:
            sv2.warmup(ledger=True)
            assert sv2.ledger_records == {}
        finally:
            sv2.close()
    finally:
        flags.set_flag("cost_ledger", True)


def test_injected_regression_names_the_probe_and_the_ops():
    baseline = tool.collect(["mlp_k1"])
    flags.set_flag("check_nan_inf", "skip")
    try:
        current = tool.collect(["mlp_k1"])
    finally:
        flags.set_flag("check_nan_inf", "off")
    regressions, _ = tool.diff(current, baseline)
    assert any(r.startswith("REGRESSION mlp_k1") for r in regressions)
    assert any("responsible ops: (unattributed)" in r for r in regressions)
    assert tool.diff(baseline, baseline)[0] == []
    # an added collective and moved wire bytes are regressions too
    base = tool.collect(["dp_allreduce"])
    moved = json.loads(json.dumps(base))
    moved["dp_allreduce"]["collectives"]["allreduce"] = 2
    moved["dp_allreduce"]["collective_bytes"]["allreduce_fp32@dp"] += 1000
    regs = tool.diff(moved, base)[0]
    assert any("adds collective allreduce" in r for r in regs)
    assert any("collective wire allreduce_fp32@dp" in r for r in regs)


def test_cli_check_exits_nonzero_on_regression():
    env = dict(os.environ, FLAGS_check_nan_inf="skip",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.cost_ledger",
         "--check", "--only", "mlp_k1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "REGRESSION mlp_k1" in proc.stdout
    assert "responsible ops" in proc.stdout


def test_checked_in_baseline_matches_the_probes():
    baseline = tool.load_baseline(tool.DEFAULT_BASELINE)
    assert set(baseline) == set(tool.PROBES)
    current = tool.collect()
    for name, rec in baseline.items():
        for f in ("flops", "bytes_accessed", "aten_calls",
                  "hand_kernel_calls", "collectives"):
            assert current[name][f] == rec[f], (name, f)
    assert tool.diff(current, baseline, ratio=1.0)[0] == []


# ---------------------------------------------------------------------------
# kernel_work: one count of each hand kernel's work
# ---------------------------------------------------------------------------

# (flops, bytes) that chip_smoke.py's bounds computed from their own
# formulas before they read kernel_work
K1_PINNED = {(56, 64): (59190018048.0, 205594624),
             (28, 128): (59190018048.0, 103055360),
             (14, 256): (59190018048.0, 52559872),
             (7, 512): (59190018048.0, 30408704)}


@pytest.mark.parametrize("hw,c", sorted(K1_PINNED))
def test_kernel_work_k1_at_resnet50_shapes(hw, c):
    assert costmodel.kernel_work("K1", n=256, h=hw, w=hw, c=c, o=c,
                                 esz=2) == K1_PINNED[(hw, c)]


@pytest.mark.parametrize("kernel,shape,pinned", [
    # BERT-base serving: BH 96, S 128, D 64, fp32, bias [8, 1, 128, 128]
    ("K2", dict(bh=96, sq=128, sk=128, d=64, esz=4,
                bias_bytes=8 * 128 * 128 * 4), (402653184.0, 13107200)),
    # BERT-base training: BH 384, bias [32, 1, 128, 128], K2 with the LSE
    ("K2", dict(bh=384, sq=128, sk=128, d=64, esz=4,
                bias_bytes=32 * 128 * 128 * 4, lse=True),
     (1610612736.0, 52625408)),
    ("K3", dict(bh=384, sq=128, sk=128, d=64, esz=4,
                bias_bytes=32 * 128 * 128 * 4), (2415919104.0, 65404928)),
    ("K4", dict(bh=384, sq=128, sk=128, d=64, esz=4,
                bias_bytes=32 * 128 * 128 * 4), (3221225472.0, 77987840)),
    ("K5", dict(bh=384, sq=128, sk=128, d=64, esz=4,
                bias_bytes=32 * 128 * 128 * 4), (1610612736.0, 77987840)),
    # Transformer NMT: BH 256, S 256, D 64, fp32; causal, and the
    # [32, 1, 1, 256] pad bias
    ("K2", dict(bh=256, sq=256, sk=256, d=64, esz=4, lse=True,
                causal=True), (2155872256.0, 67371008)),
    ("K3", dict(bh=256, sq=256, sk=256, d=64, esz=4, causal=True),
     (3233808384.0, 84410368)),
    ("K4", dict(bh=256, sq=256, sk=256, d=64, esz=4, causal=True),
     (4311744512.0, 101187584)),
    ("K2", dict(bh=256, sq=256, sk=256, d=64, esz=4, lse=True,
                bias_bytes=32 * 256 * 4), (4294967296.0, 67403776)),
    ("K3", dict(bh=256, sq=256, sk=256, d=64, esz=4,
                bias_bytes=32 * 256 * 4), (6442450944.0, 84443136)),
    ("K4", dict(bh=256, sq=256, sk=256, d=64, esz=4,
                bias_bytes=32 * 256 * 4), (8589934592.0, 101220352)),
    ("K6", dict(m=4096, d=768, esz=4), (25165824.0, 25171968)),
])
def test_kernel_work_pinned(kernel, shape, pinned):
    assert costmodel.kernel_work(kernel, **shape) == pinned


def test_a_hand_kernel_counts_its_work_once():
    """A fused_attention step in a capture: K2 forward, K3 and K4
    backward, each counted as its kernel_work (on the CPU the wrappers
    run their plain versions, whose aten calls the capture leaves out),
    under the Fluid op that launched it."""
    B, H, S, D = 2, 2, 16, 64
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        q, k, v = (fluid.layers.data(n, [H, S, D], dtype="float32")
                   for n in "qkv")
        for t in (q, k, v):
            t.stop_gradient = False
        out = fluid.layers.fused_attention(q, k, v, scale=D ** -0.5)
        loss = fluid.layers.mean(out)
        grads = fluid.gradients(loss, [q, k, v])
    rng = np.random.RandomState(0)
    feed = {n: rng.randn(B, H, S, D).astype(np.float32) for n in "qkv"}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rec = exe.cost_record(main, feed=feed, fetch_list=[loss] + grads,
                          scope=scope, stamp=False)
    hk = rec["hand_kernels"]
    assert sorted(hk) == ["K2", "K3", "K4"]
    shape = dict(bh=B * H, sq=S, sk=S, d=D, esz=4)
    for name, extra in (("K2", dict(lse=True)), ("K3", {}), ("K4", {})):
        flops, nbytes = costmodel.kernel_work(name, **shape, **extra)
        assert hk[name] == {"calls": 1, "flops": flops, "bytes": nbytes}
    assert rec["hand_kernel_calls"] == 3
    att = {t["op"]: t for t in rec["top_ops"]}
    assert att["fluid_fused_attention"]["flops_est"] == \
        costmodel.kernel_work("K2", lse=True, **shape)[0]
    assert att["fluid_fused_attention_grad"]["flops_est"] == \
        hk["K3"]["flops"] + hk["K4"]["flops"]
    assert costmodel._ACTIVE is None


def test_sub_blocks_and_recompute_replay_count_under_the_outer_op():
    def build(recompute):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [32], dtype="float32")
            h = fluid.layers.fc(x, size=32, act="relu")
            h2 = fluid.layers.fc(h, size=32, act="relu")
            loss = fluid.layers.mean(fluid.layers.fc(h2, size=8))
            opt = fluid.optimizer.SGDOptimizer(0.1)
            if recompute:
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints([h2])
            opt.minimize(loss)
        return main, startup, loss

    feed = {"x": np.ones((4, 32), np.float32)}
    recs = {}
    for recompute in (False, True):
        main, startup, loss = build(recompute)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        recs[recompute] = exe.cost_record(main, feed=feed,
                                          fetch_list=[loss], scope=scope,
                                          stamp=False)
    plain, rc = recs[False], recs[True]
    ops = {t["op"]: t for t in rc["top_ops"]}
    assert "fluid_recompute" in ops and "fluid_recompute_grad" in ops
    # the replay: the span's forward products again, in its grad op
    assert rc["flops"] > plain["flops"]
    assert ops["fluid_recompute_grad"]["flops_est"] > \
        ops["fluid_recompute"]["flops_est"]


def test_timed_steps_fills_jax_detail_keys():
    import jax.numpy as jnp
    from paddle_tpu.fluid import timing as jtiming
    from paddle_tpu_torch.fluid import timing
    import torch

    jd, pd = {}, {}
    jtiming.timed_steps(lambda i: [jnp.ones((4,)) * i], 3, warmup=1,
                        detail=jd)
    dt, last = timing.timed_steps(lambda i: [torch.ones(4) * i], 3,
                                  warmup=1, detail=pd)
    assert set(pd) == set(jd)
    assert last == 3.0 and pd["steps"] == 3 and len(pd["dispatch_ts_s"]) == 3
    assert dt == pytest.approx(pd["window_wall_s"] - pd["fence_rtt_s"])


def test_flag_benchmark_times_each_inner_step():
    main, startup, feed, loss, _ = tool.PROBES["mlp_k1"]()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    profiler.reset_benchmark_stats()
    s0 = profiler.host_sync_count("benchmark")
    flags.set_flag("benchmark", True)
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        stacked = {n: np.stack([v] * 4) for n, v in feed.items()}
        exe.run_window(main, feed=stacked, fetch_list=[loss], scope=scope,
                       steps_per_run=4)
    finally:
        flags.set_flag("benchmark", False)
    st = profiler.benchmark_stats()
    assert st["steps"] == 5 and st["last_k"] == 4
    assert st["mean_s"] == pytest.approx(st["total_s"] / 5)
    assert profiler.host_sync_count("benchmark") - s0 == 2
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert profiler.benchmark_stats()["steps"] == 5
    profiler.reset_benchmark_stats()
    assert profiler.benchmark_stats()["steps"] == 0
