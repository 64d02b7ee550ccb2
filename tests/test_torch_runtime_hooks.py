"""The port's runtime instruments and self-healing hooks on the CPU:
``fluid.telemetry``, ``fluid.profiler``, ``fluid.preemption``,
``fluid.watchdog`` and the bad-step rollback of ``train_from_dataset``.

- The telemetry registry renders the same Prometheus text as
  paddle_tpu's for the same instrument calls; the step-event ring keeps
  ``FLAGS_metrics_ring`` events; the JSONL records of a dispatch carry
  the JAX package's field names for the same run.
- ``stop_profiler`` writes a Chrome trace holding host spans and step
  events; ``FLAGS_device_profile=N`` writes a ``torch.profiler`` trace.
- A SIGTERM in mid-epoch, in a subprocess: the process exits 0 after a
  final checkpoint on a window boundary, with no producer thread left.
- The watchdog reports a planted feed stall once, naming the feed phase,
  and says nothing when disarmed.
- Two poisoned batches under ``FLAGS_check_nan_inf=skip`` and
  ``FLAGS_bad_step_rollback=2`` restore the last checkpoint once.
- A preemption stop closes a serving executor's admission; ``close()``
  answers the accepted requests and records a serving drain.
- ``FLAGS_trace_spans`` records dispatch and feed spans; an armed
  watchdog keeps its heartbeat file and ``disarm`` removes it.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid import telemetry as jtelemetry

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import (flags, preemption, profiler, telemetry,
                                    watchdog)
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exercise(tel, tag):
    c = tel.counter("t_%s_calls_total" % tag, "calls")
    c.inc(kind="a")
    c.inc(2, kind="b")
    g = tel.gauge("t_%s_depth" % tag, "depth")
    g.set(3.5)
    h = tel.histogram("t_%s_wait_seconds" % tag, "wait",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    lines = [ln.replace("t_%s_" % tag, "t_")
             for ln in tel.prometheus_text().splitlines()
             if "t_%s_" % tag in ln]
    return lines, c.value(), c.value(kind="b")


def test_registry_renders_the_prometheus_text_of_paddle_tpu():
    got = _exercise(telemetry, "port")
    want = _exercise(jtelemetry, "jax")
    assert got == want
    assert got[1] == 3 and got[2] == 2


def test_step_event_ring_is_bounded():
    prev = flags.get_flag("metrics_ring")
    flags.set_flag("metrics_ring", 5)
    telemetry.reset_step_events()
    try:
        for i in range(12):
            telemetry.record_step_event(step=i, k=1)
        evs = telemetry.step_events()
        assert [e["step"] for e in evs] == list(range(7, 12))
        assert telemetry.step_events_recorded() == 12
    finally:
        flags.set_flag("metrics_ring", prev)
        telemetry.reset_step_events()


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        h = pkg.layers.fc(x, size=3)
        loss = pkg.layers.mean(pkg.layers.log(x) + pkg.layers.mean(h))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _jsonl_keys(pkg, flags_mod, tel, path):
    main, startup, loss = _mlp(pkg)
    flags_mod.set_flag("metrics_jsonl", str(path))
    try:
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        x = np.ones((2, 4), np.float32)
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
        exe.run_window(main, feed={"x": np.stack([x, x])},
                       fetch_list=[loss], scope=scope, steps_per_run=2)
    finally:
        flags_mod.set_flag("metrics_jsonl", "")
        tel.close_jsonl()
    recs = [json.loads(ln) for ln in open(path)]
    return [sorted(r) for r in recs if "kind" not in r]


def test_jsonl_records_carry_the_field_names_of_paddle_tpu(tmp_path):
    got = _jsonl_keys(fluid, flags, telemetry, tmp_path / "port.jsonl")
    want = _jsonl_keys(jfluid, jflags, jtelemetry, tmp_path / "jax.jsonl")
    assert len(got) == len(want) == 3       # startup, run, window
    assert got == want


def test_profiler_writes_chrome_traces(tmp_path):
    main, startup, loss = _mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.ones((2, 4), np.float32)
    profiler.start_profiler()
    with profiler.RecordEvent("host_work"):
        exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
    profiler.stop_profiler(profile_path=str(tmp_path / "prof"))
    trace = json.load(open(str(tmp_path / "prof") + ".chrome_trace.json"))
    names = {e["name"] for e in trace["traceEvents"]}
    assert "host_work" in names and "step" in names
    flags.set_flag("device_profile", 2)
    flags.set_flag("device_profile_dir", str(tmp_path / "dev"))
    profiler.device_profile_reset()
    try:
        for _ in range(3):
            exe.run(main, feed={"x": x}, fetch_list=[loss], scope=scope)
        prof, path = profiler.device_profile_result()
        assert path and os.path.exists(path)
        assert any("addmm" in e.name or "mm" in e.name
                   for e in prof.events())
    finally:
        flags.set_flag("device_profile", 0)
        flags.set_flag("device_profile_dir", "")
        profiler.device_profile_reset()


SIGTERM_SCRIPT = textwrap.dedent('''
    import json, os, signal, sys, threading
    import numpy as np
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import preemption

    d = sys.argv[1]
    rng = np.random.RandomState(0)
    with open(os.path.join(d, "part-0.txt"), "w") as f:
        for _ in range(40):
            f.write("4 %s\\n" % " ".join(
                "%.4f" % v for v in rng.rand(4) + 0.5))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, size=3)
        loss = fluid.layers.mean(fluid.layers.log(x) + fluid.layers.mean(h))
        fluid.optimizer.SGD(0.1).minimize(loss)
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(2)
    ds.set_filelist([os.path.join(d, "part-0.txt")])
    ds.set_use_var([x])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    mgr = fluid.CheckpointManager(os.path.join(d, "ckpt"),
                                  main_program=main, steps_per_run=2,
                                  place=fluid.CPUPlace())
    run_window, calls = exe.run_window, [0]

    def window(*a, **k):
        out = run_window(*a, **k)
        calls[0] += 1
        if calls[0] == 2:       # SIGTERM to ourselves in mid-epoch
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    exe.run_window = window
    preemption.install()
    try:
        stat = exe.train_from_dataset(main, ds, scope=scope,
                                      steps_per_run=2,
                                      checkpoint_manager=mgr)
    finally:
        preemption.uninstall()
    meta = fluid.checkpoint.checkpoint_metadata(mgr.latest_checkpoint())
    print(json.dumps(dict(
        stat=stat, step=scope.step_counter, marker=scope._window_end,
        ckpt_step=meta["step"], ckpt_k=meta["steps_per_run"],
        threads=sorted(t.name for t in threading.enumerate()))))
''')


def test_sigterm_in_mid_epoch_drains_and_exits_0(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", SIGTERM_SCRIPT,
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["stat"] == {"steps": 4, "preempted": True, "rollbacks": 0}
    assert got["step"] == got["marker"] == got["ckpt_step"] == 5
    assert got["ckpt_k"] == 2
    assert "feed-ring-producer" not in got["threads"]
    assert "checkpoint-save" not in got["threads"]


def _stalling_run(stall_at, stall_s, timeout_s=None):
    """A loader-fed pass whose generator sleeps ``stall_s`` before batch
    ``stall_at``; with ``timeout_s`` the watchdog is armed (observe only)
    from the loader's start to the pass end."""
    main, startup, loss = _mlp(fluid)

    def gen():
        for i in range(4):
            if i == stall_at:
                time.sleep(stall_s)
            yield {"x": np.ones((2, 4), np.float32)}
    with fluid.program_guard(main, startup):
        loader = fluid.io.DataLoader.from_generator(
            feed_list=[main.global_block().var("x")], iterable=False)
    loader.set_batch_generator(gen)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    loader.start()
    if timeout_s is not None:
        assert watchdog.arm(timeout_s=timeout_s, abort=False)
    n = 0
    try:
        while True:
            try:
                exe.run(main, fetch_list=[loss], scope=scope)
            except fluid.core.EOFException:
                return n
            n += 1
    finally:
        watchdog.disarm()


def _hangs():
    return [e for e in telemetry.step_events() if e.get("kind") == "hang"]


def test_watchdog_reports_a_planted_stall_once_and_is_silent_disarmed():
    telemetry.reset_step_events()
    assert _stalling_run(stall_at=2, stall_s=1.5, timeout_s=0.4) == 4
    hangs = _hangs()
    assert len(hangs) == 1 and hangs[0]["phase"] == "feed_wait"
    assert watchdog.health()["healthy"] and not watchdog.is_armed()
    telemetry.reset_step_events()
    assert _stalling_run(stall_at=2, stall_s=1.0) == 4
    assert not _hangs()


def test_bad_step_rollback_restores_and_counts(tmp_path):
    good = " ".join(["1.0"] * 4)
    bad = " ".join(["-1.0"] * 4)
    lines = [good] * 4 + [bad] * 4 + [good] * 4     # batches of 2
    path = tmp_path / "part.txt"
    path.write_text("".join("4 %s\n" % ln for ln in lines))
    main, startup, loss = _mlp(fluid)
    ds = fluid.DatasetFactory().create_dataset("FileInstantDataset")
    ds.set_batch_size(2)
    ds.set_filelist([str(path)])
    ds.set_use_var([main.global_block().var("x")])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    mgr = fluid.CheckpointManager(str(tmp_path / "ckpt"), main_program=main,
                                  async_save=False, place=fluid.CPUPlace())
    flags.set_flag("check_nan_inf", "skip")
    flags.set_flag("bad_step_rollback", 2)
    profiler.reset_bad_step_count()
    telemetry.reset_step_events()
    before = telemetry.registry().get("rollback_total").value()
    try:
        stat = exe.train_from_dataset(main, ds, scope=scope,
                                      fetch_list=[loss],
                                      checkpoint_manager=mgr,
                                      checkpoint_period=1)
        assert profiler.bad_step_count() == 2
    finally:
        flags.set_flag("check_nan_inf", "off")
        flags.set_flag("bad_step_rollback", 0)
        profiler.reset_bad_step_count()
    assert stat == {"steps": 6, "preempted": False, "rollbacks": 1}
    assert telemetry.registry().get("rollback_total").value() == before + 1
    rb = [e for e in telemetry.step_events() if e.get("kind") == "rollback"]
    # restored: the save after the first poisoned batch (startup + 3
    # runs), whose state the skip policy had kept
    assert len(rb) == 1 and rb[0]["step"] == 4 and rb[0]["streak"] == 2
    assert np.isfinite(scope.find_var_numpy(
        main.global_block().all_parameters()[0].name)).all()


def test_a_preemption_stop_drains_the_serving_executor():
    """A stop request closes admission (the scheduler's idle waits see
    it through stop_aware_get); close() answers what was accepted and
    records a serving drain; the serving_* metrics count the requests."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=2)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    reg = telemetry.registry()
    req0 = reg.get("serving_requests_total").value()
    sv = fluid.ServingExecutor(infer, feed_specs={"x": ((4,), "float32")},
                               fetch_list=[y], scope=scope,
                               place=fluid.CPUPlace(), max_batch=4)
    futs = [sv.submit({"x": np.ones((2, 4), np.float32)}) for _ in range(3)]
    ev0 = telemetry.step_events_recorded()
    preemption.request_stop("test")
    try:
        with pytest.raises(fluid.serving.ServingClosedError):
            sv.submit({"x": np.ones((1, 4), np.float32)})
        sv.close(timeout=30)
    finally:
        preemption.clear()
    assert all(f.result(timeout=30)[0].shape == (2, 2) for f in futs)
    assert reg.get("serving_requests_total").value() == req0 + 3
    assert reg.get("serving_rejects_total").value(reason="closed") >= 1
    drains = [e for e in telemetry.step_events()[-(
        telemetry.step_events_recorded() - ev0):]
        if e.get("kind") == "preemption"]
    assert len(drains) == 1 and drains[0]["source"] == "serving"


def test_trace_spans_and_the_heartbeat_file(tmp_path):
    """FLAGS_trace_spans records dispatch and feed spans into the ring;
    an armed watchdog keeps its heartbeat file, disarm removes it."""
    main, startup, loss = _mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    beat = tmp_path / "beat"
    flags.set_flag("trace_spans", True)
    telemetry.reset_step_events()
    try:
        assert watchdog.arm(timeout_s=30, heartbeat_file=str(beat),
                            abort=False)
        assert beat.exists()
        loader = fluid.io.DataLoader.from_generator(
            feed_list=[main.global_block().var("x")], capacity=2)
        loader.set_batch_generator(
            lambda: ({"x": np.ones((2, 4), np.float32)} for _ in range(3)),
            places=fluid.CPUPlace())
        for feed in loader():
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        watchdog.disarm()
        flags.set_flag("trace_spans", False)
    assert not beat.exists()
    spans = [e["span"] for e in telemetry.step_events()
             if e.get("kind") == "span"]
    assert spans.count("dispatch") == 3
    assert "feed_stage" in spans and "feed_wait" in spans
