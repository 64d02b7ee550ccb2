"""Shared timing protocol: the one fence every timed loop of the port
uses (counterpart ``paddle_tpu/fluid/timing.py``; ``fluid/benchmark.py``,
``Executor.cost_record``'s step timings and ``chip_smoke.py``'s ledger
phases).

* ``step(i)`` enqueues its work without waiting for it
  (``return_numpy=False`` fetches: live tensors);
* after the timed steps, one read of a scalar of the last step's result
  is the fence: the card's stream runs in order, so that read returns
  only when every enqueued step has finished;
* the fence's own cost (a device-to-host read) is measured on a fresh
  card scalar made by an already-warm operation and subtracted.
"""

import time

import numpy as np
import torch


def _first_scalar(out):
    """Element 0 of ``out[0]`` (a tensor or an array) as a float."""
    v = out[0] if isinstance(out, (list, tuple)) else out
    if isinstance(v, torch.Tensor):
        return float(v.reshape(-1)[0].float().item())
    return float(np.asarray(v).reshape(-1)[0])


def _device_of(out):
    v = out[0] if isinstance(out, (list, tuple)) and out else out
    return v.device if isinstance(v, torch.Tensor) else torch.device("cpu")


def timed_steps(step, steps, warmup=2, fetch=None, detail=None):
    """Run ``steps`` steps of ``step(i)`` after ``warmup`` untimed ones;
    returns (seconds, last), ``last`` the fence's scalar.

    ``fetch(out) -> float`` reads one scalar of a step's result (the
    fence); by default element 0 of ``out[0]``.  ``detail``, a dict, is
    filled with the measurements behind the figure: ``warmup``,
    ``steps``, ``fence_rtt_s``, ``window_wall_s``, ``elapsed_s``,
    ``dispatch_ts_s`` (host enqueue times, not device step times) and
    ``fence_scalar``."""
    if fetch is None:
        fetch = _first_scalar
    out = None
    for i in range(warmup):
        out = step(i)
    dev = _device_of(out) if out is not None else torch.device("cpu")
    if out is not None:
        fetch(out)                                  # drain the queue
    # the fence's own cost: a read of a fresh scalar that a warm op made
    probe = torch.zeros((), dtype=torch.float32, device=dev)
    float((probe + 1).item())
    fresh = probe + 2
    t = time.perf_counter()
    float(fresh.item())
    rtt = time.perf_counter() - t
    t0 = time.perf_counter()
    dispatch_ts = []
    for i in range(steps):
        out = step(warmup + i)
        dispatch_ts.append(time.perf_counter() - t0)
    last = fetch(out)                               # fences the chain
    wall = time.perf_counter() - t0
    dt = wall - rtt
    if detail is not None:
        detail.update({
            "warmup": warmup, "steps": steps,
            "fence_rtt_s": rtt, "window_wall_s": wall, "elapsed_s": dt,
            "dispatch_ts_s": [round(x, 6) for x in dispatch_ts],
            "fence_scalar": last,
        })
    if dt <= 0:
        raise RuntimeError(
            "timed window (%.1f ms) did not exceed the fence RTT "
            "(%.1f ms): raise the step count" % (wall * 1e3, rtt * 1e3))
    return dt, last
