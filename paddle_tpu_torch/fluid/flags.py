"""Global FLAGS_* knobs of the slice (subset of ``paddle_tpu/fluid/flags.py``).

Each flag reads ``FLAGS_<name>`` from the environment once and can be
overridden in-process with :func:`set_flag`.

- ``FLAGS_matmul_precision``: float32 matmul precision of the ``mul`` and
  ``matmul`` ops.  ``default`` leaves PyTorch's process-wide setting as it
  is (full float32 unless the caller allowed TF32); ``high`` allows TF32
  for these products; ``highest`` / ``float32`` forces full float32.
- ``FLAGS_serving_buckets`` / ``FLAGS_serving_max_wait_ms`` /
  ``FLAGS_serving_max_queue``: the serving bucket ladder, latency budget
  and backpressure cap (``serving.py``).
- ``FLAGS_conv_pallas`` / ``FLAGS_conv_layout`` / ``FLAGS_conv_im2col``:
  the ``conv2d`` routes (``ops/nn_ops.py``): the 3x3 implicit-GEMM kernel
  K1, channels-last (``NHWC`` is ``torch.channels_last``), or unfold x
  matmul.  The names keep the JAX package's, ``pallas`` included, so one
  environment drives both packages the same way.
- ``FLAGS_amp_keep_activations``: under AMP, conv/matmul outputs stay in
  the AMP dtype even without ``use_pure_bf16`` (``lowering.amp_operands``).
- The training-loop runtime (JAX ``flags.py:57-192``, the same names and
  defaults): ``check_nan_inf`` (``off | raise | skip``,
  :func:`nan_inf_policy`), ``steps_per_run`` (:func:`steps_per_run_value`),
  ``feed_ring_depth``, the telemetry exporters
  ``metrics_jsonl`` / ``metrics_ring`` / ``trace_spans`` /
  ``metrics_device_memory``, ``bad_step_rollback`` / ``rollback_limit``,
  the watchdog's ``watchdog_*`` and the device trace
  ``device_profile`` / ``device_profile_dir``.
- The pod checkpoints (``checkpoint.py``, ``storage.py``):
  ``checkpoint_commit_timeout_s`` bounds the async pod save's commit poll,
  ``checkpoint_reap_min_age_s`` is the debris reaper's minimum age.
- The device-cost ledger (``costmodel.py``, JAX ``flags.py:178-200``):
  ``cost_ledger`` turns it on or off; ``roofline_peak_flops`` (bf16 and
  fp16), ``roofline_peak_flops_fp32`` and ``roofline_peak_bytes_per_s``
  are the peaks its ``estimated_step_s`` divides by, an H100 SXM's by
  default.  ``benchmark`` (JAX ``flags.py:60``) synchronises the card
  after every dispatch and records its wall time.
- The parameter server's wire (``distributed/rpc.py``, JAX
  ``flags.py:63-64``): ``rpc_deadline`` is a call's deadline in ms,
  ``rpc_retry_times`` how often a call on a broken connection is retried.
"""

import os

_DEFS = {
    "matmul_precision": "default",   # default | high | highest
    "serving_buckets": "",           # serving.py bucket ladder: comma/
                                     # space-separated batch sizes every
                                     # request batch is padded up to;
                                     # "" = powers of two up to
                                     # ServingExecutor(max_batch=)
    "serving_max_wait_ms": 5.0,      # serving latency budget: how long
                                     # the scheduler holds an under-full
                                     # batch open for more requests
                                     # before dispatching
    "serving_max_queue": 256,        # serving backpressure: queued-not-
                                     # yet-dispatched request cap; submit
                                     # beyond it rejects (counted)
    "conv_layout": "NCHW",           # NCHW | NHWC (channels_last)
    "conv_pallas": False,            # 3x3/s1 convs through K1 (fwd; bwd
                                     # stays the library conv) —
                                     # ops/conv_ops.py
    "conv_im2col": "off",            # off | all | 3x3: conv2d as unfold x
                                     # matmul (contraction over C*kh*kw)
    "amp_keep_activations": False,   # AMP: keep conv/matmul outputs bf16
    "check_nan_inf": "off",          # off | raise | skip — non-finite
                                     # policy (nan_inf_policy(); bools
                                     # accepted as in the JAX package)
    "steps_per_run": 1,              # K>1: Executor.run_window runs K
                                     # steps per call (one plan, one
                                     # feed coercion, no fetch sync
                                     # inside); 1 = per-step run()
    "feed_ring_depth": 2,            # input pipeline: the producer
                                     # thread stages up to DEPTH feed
                                     # windows ahead (pinned staging,
                                     # side-stream H2D — reader.FeedRing);
                                     # 0 = synchronous one-batch
                                     # lookahead (A/B control, bit-exact
                                     # same losses)
    "metrics_jsonl": "",             # telemetry.py: append one JSON line
                                     # per executor step-event to this
                                     # path (off = no file I/O)
    "metrics_ring": 1024,            # telemetry.py: step-event ring
                                     # capacity (bounded host memory)
    "trace_spans": False,            # telemetry.span(): record timed
                                     # span events into the ring/JSONL
    "metrics_device_memory": False,  # executor: device_memory_bytes
                                     # {kind=live|peak} gauges from
                                     # torch.cuda.memory_stats at each
                                     # dispatch (host counters, no sync)
    "bad_step_rollback": 0,          # K>0: under FLAGS_check_nan_inf=
                                     # skip, K consecutive bad steps make
                                     # train_from_dataset restore the
                                     # last checkpoint and resume
    "rollback_limit": 3,             # cap on automatic rollbacks per
                                     # train_from_dataset call
    "watchdog_timeout_s": 0.0,       # >0 arms the hang watchdog
                                     # (watchdog.py); 0 = off
    "watchdog_abort": True,          # off: detect, dump and record the
                                     # hang but never os._exit()
    "watchdog_checkpoint_grace_s": 300.0,  # deadline extension while a
                                     # checkpoint save/restore runs
    "checkpoint_commit_timeout_s": 120.0,  # async pod save: how long the
                                     # chief polls storage for the other
                                     # ranks' manifests (and a rank for
                                     # the chief's marker) before it
                                     # abandons the prefix
    "checkpoint_reap_min_age_s": 600.0,  # the debris reaper spares an
                                     # unmarked step-* prefix younger
                                     # than this (its claim lease, else
                                     # the dir mtime): it may be a pod
                                     # save still uploading
    "watchdog_compile_grace_s": 600.0,  # deadline extension around a
                                     # fresh plan's first dispatch
    "device_profile": 0,             # N>0: torch.profiler trace (CPU and
                                     # CUDA activities) of the next N
                                     # dispatched steps, written under
                                     # FLAGS_device_profile_dir; 0 = off
    "device_profile_dir": "",        # "" = ./device_profile
    "rpc_deadline": 180000.0,        # ms, PS rpc call deadline (reference)
    "rpc_retry_times": 3.0,          # call-level retries on broken conns
    "benchmark": False,              # per-dispatch device sync + wall
                                     # timing (profiler.benchmark_stats)
    "cost_ledger": True,             # device-cost ledger (costmodel.py):
                                     # a kind="compile" record per fresh
                                     # plan and Executor.cost_record()
                                     # captures; 0 = fully off, bit-exact,
                                     # zero host syncs
    "roofline_peak_flops": 989e12,   # bf16 dense tensor-core peak of an
                                     # NVIDIA H100 SXM 80GB HBM3 at 700 W
    "roofline_peak_flops_fp32": 67e12,   # fp32 CUDA-core peak, same card
    "roofline_peak_bytes_per_s": 3.35e12,  # HBM3 rate of the same card
}

_cache = {}


def get_flag(name):
    if name in _cache:
        return _cache[name]
    default = _DEFS[name]
    raw = os.environ.get("FLAGS_" + name)
    if raw is None:
        val = default
    elif isinstance(default, bool):
        val = raw.lower() in ("1", "true", "yes")
    elif isinstance(default, float):
        val = float(raw)
    elif isinstance(default, int):
        try:
            val = int(raw)
        except ValueError:
            raise ValueError(
                "FLAGS_%s must be an integer, got %r" % (name, raw))
    else:
        val = raw
    _cache[name] = val
    return val


def set_flag(name, value):
    if name not in _DEFS:
        raise KeyError("Unknown flag %r" % name)
    _cache[name] = value


def matmul_precision():
    """PyTorch float32 matmul precision name for FLAGS_matmul_precision,
    or None for ``default`` (leave the process setting alone)."""
    p = get_flag("matmul_precision")
    table = {"default": None, "high": "high", "float32": "highest",
             "highest": "highest"}
    if p not in table:
        raise ValueError(
            "FLAGS_matmul_precision must be default|high|highest, got %r"
            % (p,))
    return table[p]


def nan_inf_policy():
    """Normalize FLAGS_check_nan_inf to one of ``off``/``raise``/``skip``
    (JAX ``flags.py:263``): a bool or ``1`` means ``raise``."""
    v = get_flag("check_nan_inf")
    if isinstance(v, str):
        v = v.strip().lower()
    if v in (False, None, "", "0", "false", "no", "off"):
        return "off"
    if v in (True, "1", "true", "yes", "on", "raise"):
        return "raise"
    if v == "skip":
        return "skip"
    raise ValueError(
        "FLAGS_check_nan_inf must be off|raise|skip (or a bool), got %r"
        % (v,))


def steps_per_run_value(override=None):
    """Validated window size K of ``Executor.run_window`` (JAX
    ``flags.py:283``): an explicit ``steps_per_run=`` wins over
    ``FLAGS_steps_per_run``; K must be a positive integer.  Raises
    ValueError naming the flag."""
    import numpy as np

    v = get_flag("steps_per_run") if override is None else override
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
        raise ValueError(
            "FLAGS_steps_per_run (steps_per_run=) must be a positive "
            "int, got %r of type %s" % (v, type(v).__name__))
    v = int(v)
    if v < 1:
        raise ValueError(
            "FLAGS_steps_per_run (steps_per_run=) must be a positive "
            "int, got %d" % v)
    return v
