"""Profiler: host spans, runtime counters and the device trace
(counterpart ``paddle_tpu/fluid/profiler.py``; reference
platform/profiler.{h,cc}, python/paddle/fluid/profiler.py and the
tools/timeline.py Chrome-trace export).

Host-side RAII spans mirror ``RecordEvent`` (profiler.h:81);
``stop_profiler`` writes a Chrome trace of them with the executor's step
events on their own track.  The device side is ``torch.profiler`` with
the CPU and CUDA activities (CUPTI, the analogue of
platform/device_tracer.h), where the JAX package used
``jax.profiler.trace``: ``start_profiler(trace_dir=...)`` and
``FLAGS_device_profile=N`` (the next N dispatched steps) both write a
Chrome trace.  A capture of work that ran on the card but holds no CUDA
event raises: the trace tool is missing, and no profile is better than
a profile that silently shows an idle device.

The counters (host syncs, windows, checkpoints, bad-step verdicts) live
in the telemetry registry (``telemetry.py``); the functions here are the
JAX package's views of them, with the same signatures.
"""

import contextlib
import json
import os
import threading
import time

from . import flags
from . import telemetry

_events = []
_enabled = [False]
_lock = threading.Lock()
_session = {"prof": None, "dir": None}


class RecordEvent:
    """RAII span (platform/profiler.h:81)."""

    def __init__(self, name):
        self.name = name
        self.t0 = None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if _enabled[0]:
            t1 = time.perf_counter_ns()
            with _lock:
                _events.append((self.name, self.t0, t1,
                                threading.get_ident()))
        return False


record_event = RecordEvent


def _torch_profile(cuda):
    """A started ``torch.profiler.profile`` over the CPU and, when
    ``cuda``, the CUDA activities."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _cuda_events(prof):
    """Events the profiler recorded on a CUDA device."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _finish_trace(prof, out, tag, cuda, ran_on_card=True):
    """Stop ``prof``, write its Chrome trace under ``out`` and return the
    path.  A capture that was asked for the card, whose work ran there,
    but that holds no CUDA event raises (no CUPTI)."""
    prof.stop()
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "%s.%d.%d.pt.trace.json"
                        % (tag, os.getpid(), time.time_ns()))
    prof.export_chrome_trace(path)
    if cuda and ran_on_card and not _cuda_events(prof):
        raise RuntimeError(
            "torch.profiler recorded no CUDA activity for work that ran "
            "on the card (is CUPTI available?) — trace %s" % path)
    return path


def start_profiler(state="All", trace_dir=None):
    """Start collecting host spans; with ``trace_dir`` also a
    ``torch.profiler`` trace (CUDA activity included when a card is
    present), written there by ``stop_profiler``."""
    _enabled[0] = True
    with _lock:
        # under _lock: loader worker threads append from
        # RecordEvent.__exit__ concurrently
        _events.clear()
    if trace_dir is not None:
        import torch
        _session["prof"] = _torch_profile(torch.cuda.is_available())
        _session["dir"] = trace_dir


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    _enabled[0] = False
    if _session["prof"] is not None:
        import torch
        prof, out = _session["prof"], _session["dir"]
        _session["prof"] = _session["dir"] = None
        _finish_trace(prof, out, "profile", torch.cuda.is_available(),
                      ran_on_card=False)
    # chrome trace export (tools/timeline.py analogue)
    trace = {"traceEvents": []}
    with _lock:
        for name, t0, t1, tid in _events:
            trace["traceEvents"].append({
                "name": name, "ph": "X", "ts": t0 / 1000.0,
                "dur": (t1 - t0) / 1000.0, "pid": os.getpid(), "tid": tid,
                "cat": "host"})
    # executor step-events interleave on their own track: same
    # perf_counter_ns clock as the host spans
    for ev in telemetry.step_events():
        ts = ev.get("ts_ns")
        if ts is None:
            continue
        if ev.get("kind") == "span":     # timed region (FLAGS_trace_spans)
            name = "span:%s" % ev.get("span", "?")
        elif ev.get("kind"):             # preemption/rollback lifecycle
            name = str(ev["kind"])
        elif ev.get("window"):
            name = "window[k=%d]" % ev.get("k", 1)
        else:
            name = "step"
        trace["traceEvents"].append({
            "name": name, "ph": "X", "ts": ts / 1000.0,
            "dur": ev.get("dur_ns", 0) / 1000.0, "pid": os.getpid(),
            "tid": "step-events", "cat": "step",
            "args": {k: v for k, v in ev.items()
                     if k not in ("ts_ns", "dur_ns")}})
    if profile_path:
        os.makedirs(os.path.dirname(profile_path) or ".", exist_ok=True)
        with open(profile_path + ".chrome_trace.json", "w") as f:
            json.dump(trace, f, default=telemetry._json_default)
    # aggregated table, like the reference's PrintProfiler
    agg = {}
    with _lock:
        for name, t0, t1, _ in _events:
            tot, cnt = agg.get(name, (0.0, 0))
            agg[name] = (tot + (t1 - t0) / 1e6, cnt + 1)
    if agg:
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
        print("%-40s %10s %8s" % ("Event", "total_ms", "calls"))
        for name, (tot, cnt) in rows[:50]:
            print("%-40s %10.3f %8d" % (name[:40], tot, cnt))
    return trace


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile"):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*args, **kwargs):  # name kept for API parity
    yield


# -- FLAGS_device_profile: N-step torch.profiler capture ---------------------
# FLAGS_device_profile=N brackets the next N dispatched steps (a K-window
# counts K) in one torch.profiler session, exported as a Chrome trace
# under FLAGS_device_profile_dir.  The executor calls the begin/end hooks
# at each dispatch boundary; with the flag at 0 each hook is one dict
# read.

_device_profile = {"remaining": None, "active": False, "dir": None,
                   "cuda": False, "prof": None, "path": None}


def device_profile_begin(device=None):
    """Start the FLAGS_device_profile trace before the first profiled
    dispatch on ``device`` (a torch.device; CUDA activity is traced when
    it is a card).  No-op when the flag is 0 or the budget is spent."""
    st = _device_profile
    rem = st["remaining"]
    if rem is None:
        n = int(flags.get_flag("device_profile") or 0)
        st["remaining"] = rem = max(0, n)
    if rem <= 0 or st["active"]:
        return
    out = flags.get_flag("device_profile_dir") or \
        os.path.join(os.getcwd(), "device_profile")
    cuda = device is not None and getattr(device, "type", None) == "cuda"
    st["prof"] = _torch_profile(cuda)
    st.update(active=True, dir=out, cuda=cuda)


def device_profile_end(k=1):
    """Account ``k`` inner steps against the FLAGS_device_profile budget
    and stop and export the trace once it is spent."""
    st = _device_profile
    if not st["active"]:
        return
    st["remaining"] -= max(1, int(k))
    if st["remaining"] <= 0:
        st["remaining"] = 0
        st["active"] = False
        if st["cuda"]:
            import torch
            torch.cuda.synchronize()   # the traced kernels must finish
        st["path"] = _finish_trace(st["prof"], st["dir"], "device_profile",
                                   st["cuda"])


def device_profile_reset():
    """Forget cached FLAGS_device_profile state (tests toggling the flag
    via set_flag); stops a live trace first."""
    st = _device_profile
    if st["active"]:
        device_profile_end(st["remaining"] or 1)
    st.update(remaining=None, active=False, dir=None, cuda=False,
              prof=None, path=None)


def device_profile_dir():
    """Directory the current/last FLAGS_device_profile trace wrote to
    (None if no capture started)."""
    return _device_profile["dir"]


def device_profile_result():
    """``(torch.profiler.profile, chrome trace path)`` of the last
    finished FLAGS_device_profile capture, or (None, None)."""
    st = _device_profile
    if st["active"] or st["path"] is None:
        return None, None
    return st["prof"], st["path"]


# -- host-sync accounting ----------------------------------------------------
# Every point where the executor's loop forces a host<->device sync (a
# numpy fetch, a print_period loss pull, the end-of-pass drain) reports
# here; tests hold the no-sync-inside-a-window contract against it.

_m_host_syncs = telemetry.counter(
    "host_syncs_total", "host<->device sync points, labeled by tag")


def record_host_sync(tag="fetch"):
    _m_host_syncs.inc(tag=tag)


def host_sync_count(tag=None):
    if tag is None:
        return int(_m_host_syncs.value())
    return int(_m_host_syncs.value(tag=tag))


def reset_host_sync_count():
    _m_host_syncs.reset()


# -- multi-step window accounting (Executor.run_window) ----------------------
# One K-step run_window call counts as ONE window of K inner steps.

_m_windows = telemetry.counter(
    "window_dispatches_total", "fused multi-step window dispatches")
_m_inner_steps = telemetry.counter(
    "window_inner_steps_total", "inner steps run by fused windows")
_m_last_k = telemetry.gauge(
    "window_last_k", "K of the most recent fused window")


def record_window(k):
    _m_windows.inc()
    _m_inner_steps.inc(int(k))
    _m_last_k.set(int(k))


def window_stats():
    """{'windows': window calls, 'inner_steps': total steps they ran,
    'last_k': K of the most recent window}."""
    return {"windows": int(_m_windows.value()),
            "inner_steps": int(_m_inner_steps.value()),
            "last_k": int(_m_last_k.value() or 0)}


def reset_window_stats():
    _m_windows.reset()
    _m_inner_steps.reset()
    _m_last_k.reset()


# -- checkpoint accounting (checkpoint.py CheckpointManager) ----------------

_m_ckpt_saves = telemetry.counter(
    "checkpoint_saves_total", "committed checkpoint saves")
_m_ckpt_seconds = telemetry.counter(
    "checkpoint_save_seconds_total", "serialize+fsync+commit seconds")
_m_ckpt_bytes = telemetry.counter(
    "checkpoint_bytes_total", "serialized checkpoint bytes written")
_m_ckpt_last_s = telemetry.gauge(
    "checkpoint_last_save_seconds", "duration of the most recent save")
_m_ckpt_last_bytes = telemetry.gauge(
    "checkpoint_last_bytes", "bytes of the most recent save")
_m_ckpt_last_step = telemetry.gauge(
    "checkpoint_last_step", "step of the most recent durable save (RPO)")


def record_checkpoint_save(seconds, nbytes, step):
    _m_ckpt_saves.inc()
    _m_ckpt_seconds.inc(seconds)
    _m_ckpt_bytes.inc(nbytes)
    _m_ckpt_last_s.set(seconds)
    _m_ckpt_last_bytes.set(nbytes)
    _m_ckpt_last_step.set(step)


def checkpoint_stats():
    last_s = _m_ckpt_last_s.value()
    last_b = _m_ckpt_last_bytes.value()
    return {"saves": int(_m_ckpt_saves.value()),
            "total_save_s": float(_m_ckpt_seconds.value()),
            "last_save_s": float(last_s) if last_s is not None else 0.0,
            "total_bytes": int(_m_ckpt_bytes.value()),
            "last_bytes": int(last_b) if last_b is not None else 0,
            "last_step": _m_ckpt_last_step.value()}


def steps_since_checkpoint(current_step):
    """Steps of work at risk if the job died now (None: never saved)."""
    last = _m_ckpt_last_step.value()
    return None if last is None else int(current_step) - int(last)


def reset_checkpoint_stats():
    for m in (_m_ckpt_saves, _m_ckpt_seconds, _m_ckpt_bytes,
              _m_ckpt_last_s, _m_ckpt_last_bytes, _m_ckpt_last_step):
        m.reset()


# -- bad-step accounting (FLAGS_check_nan_inf=skip policy) ------------------
# The executor hands each step's device-side finiteness verdict over
# WITHOUT materializing it — reading it would put a host sync on the hot
# path.  Verdicts pool here and are counted lazily when bad_step_count()
# or bad_step_streak() is read; the pool self-drains past a bound.

_m_bad_steps = telemetry.counter(
    "bad_steps_total", "non-finite steps skipped (check_nan_inf=skip)")
# streak: TRAILING consecutive bad steps across drains — the rollback
# trigger (FLAGS_bad_step_rollback).  One training loop both records and
# drains, so append order is step order.
_bad_steps = {"pending": [], "streak": 0}


def record_bad_step(ok):
    """``ok``: a (possibly device-resident) bool verdict — a 0-d tensor
    for one step, or a [K] vector of per-inner-step verdicts from a
    window.  True means that step was finite and its state was
    committed."""
    with _lock:
        _bad_steps["pending"].append(ok)
        drain = (_bad_steps["pending"]
                 if len(_bad_steps["pending"]) >= 1024 else None)
        if drain is not None:
            _bad_steps["pending"] = []
    if drain is not None:
        _apply_verdicts(drain)


def _host_bools(x):
    import numpy as np
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).ravel()


def _apply_verdicts(verdicts):
    """Materialize drained verdicts (the caller accepts the device sync)
    and fold them into the total counter and the trailing
    consecutive-bad streak, in step order."""
    bad = 0
    with _lock:
        streak = _bad_steps["streak"]
    for x in verdicts:
        for ok in _host_bools(x):
            if bool(ok):
                streak = 0
            else:
                streak += 1
                bad += 1
    with _lock:
        _bad_steps["streak"] = streak
    if bad:
        _m_bad_steps.inc(bad)


def _drain_pending():
    with _lock:
        drain = _bad_steps["pending"]
        _bad_steps["pending"] = []
    if drain:
        _apply_verdicts(drain)


def pending_bad_step_verdicts():
    """Count of verdicts pooled but not yet materialized."""
    with _lock:
        return len(_bad_steps["pending"])


def bad_step_count():
    _drain_pending()
    return int(_m_bad_steps.value())


def bad_step_streak():
    """Trailing count of CONSECUTIVE bad steps (resets to 0 at every
    finite step).  Drains the pending pool first, so reading it reads
    the device verdicts — one host sync per read."""
    _drain_pending()
    with _lock:
        return _bad_steps["streak"]


def reset_bad_step_streak():
    """Restart the consecutive-bad run (a rollback restored known-good
    state)."""
    with _lock:
        _bad_steps["streak"] = 0


def reset_bad_step_count():
    _m_bad_steps.reset()
    with _lock:
        _bad_steps["pending"] = []
        _bad_steps["streak"] = 0


# -- FLAGS_benchmark step timing (JAX profiler.py:414-459) -------------------
# A window's dispatch records ONE entry covering its K inner steps, so
# mean_s stays per inner step across steps_per_run values.

_m_bench_steps = telemetry.counter(
    "benchmark_inner_steps_total", "inner steps timed under FLAGS_benchmark")
_m_bench_seconds = telemetry.counter(
    "benchmark_seconds_total", "synced wall seconds under FLAGS_benchmark")
_m_bench_last_k = telemetry.gauge(
    "benchmark_last_k", "steps_per_run of the most recent timed dispatch")


def record_benchmark_step(seconds, steps=1):
    """``seconds`` of synced wall time covering ``steps`` inner steps
    (1 for a plain run(), K for a run_window dispatch)."""
    _m_bench_steps.inc(int(steps))
    _m_bench_seconds.inc(seconds)
    _m_bench_last_k.set(int(steps))


def benchmark_stats():
    """{'steps': inner steps timed, 'total_s': T, 'mean_s': T/steps,
    'last_k': steps_per_run of the latest dispatch}; mean_s is per inner
    step, so K=1 and K=16 runs of one program compare directly."""
    n = int(_m_bench_steps.value())
    tot = float(_m_bench_seconds.value())
    return {"steps": n, "total_s": tot,
            "mean_s": tot / n if n else 0.0,
            "last_k": int(_m_bench_last_k.value() or 0)}


def reset_benchmark_stats():
    _m_bench_steps.reset()
    _m_bench_seconds.reset()
    _m_bench_last_k.reset()


def reset_profiler():
    """Drop collected span data (reference profiler.py reset_profiler)."""
    reset_benchmark_stats()
    with _lock:
        _events.clear()
