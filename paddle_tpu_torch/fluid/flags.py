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
