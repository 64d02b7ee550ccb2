"""Device-cost ledger: one normalized cost record per executor step
(counterpart ``paddle_tpu/fluid/costmodel.py``).

The JAX package reads XLA's static analyses of a compiled executable.
The port has no compiler, so it counts what one step runs: a capture
(``Executor.cost_record``, ``compiled_cost``, ``tools/cost_ledger.py``,
serving ``warmup(ledger=True)``) runs one step under a
``TorchDispatchMode`` that sees every aten call and adds

- its FLOPs, from the formulas ``torch.utils.flop_counter`` registers
  (matrix products, convolutions and their backward; elementwise work
  counts none, as in ``FlopCounterMode``);
- the bytes of the tensors it reads and writes (each tensor input once,
  each output once; a view moves nothing);
- its transcendentals (the output elements of ``exp``, ``log``,
  ``tanh``, ``erf``, ``sigmoid``, ``rsqrt``, softmax and the like).

The hand-written kernels (K1-K6) are ``ctypes`` launches that no
dispatch mode sees.  Each wrapper is decorated with :func:`hand_kernel`:
while a capture is active it adds :func:`kernel_work` of its shapes and
does not count the aten calls inside it (the plain version on the CPU),
so the CPU and the card count the same work.  With no capture active the
decorator costs one module-level check.

Attribution (JAX ``op_attribution``): every count goes to the Fluid op
that ``lowering.dispatch`` is running, keyed ``fluid_<type>``
(``fluid_mul``, ``fluid_mul_grad``).  The outermost op wins, so a
sub-block's ops count under their control-flow op, and a recompute
span's replay under ``fluid_recompute_grad``, whose
``torch.autograd.grad`` runs it.  Work outside every op (feed views, the
``FLAGS_check_nan_inf=skip`` verdict) goes to ``(unattributed)``.

Per-inner-step contract (JAX :25-30): a ``run_window`` capture runs its
K inner steps and records their sum divided by K, with ``k`` beside it
and ``window_flops = flops * k``.

Record fields keep the JAX names where the meaning holds; where it
differs they are renamed: ``aten_calls`` (JAX ``instructions``),
``hand_kernel_calls`` (JAX ``fusions``); there is no
``generated_code_bytes``.  ``temp_bytes`` and ``peak_bytes`` come from
the CUDA caching allocator around the captured step and are ``None`` on
the CPU, which has no allocator peak.
"""

import contextlib
import functools

from . import flags
from . import telemetry

_m_flops = telemetry.gauge(
    "ledger_flops_per_step",
    "FLOPs a captured step counts (per inner step), by signature")
_m_bytes = telemetry.gauge(
    "ledger_bytes_per_step",
    "bytes a captured step's aten calls and hand kernels read and write "
    "(per inner step), by signature")
_m_peak = telemetry.gauge(
    "ledger_peak_bytes",
    "device peak of a captured step (arguments plus what the step "
    "allocated at its high point), by signature")
_m_kernels = telemetry.gauge(
    "ledger_hand_kernel_calls",
    "hand-kernel launches a captured step counts (per inner step), by "
    "signature")
_m_records = telemetry.counter(
    "cost_ledger_records_total",
    "device-cost ledger records stamped, by source (dispatch|full)")

# the capture being recorded, or None (read on the hot path)
_ACTIVE = None

# the hand kernels: id -> the TPU kernel each one replaces
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def enabled():
    """Is the ledger on?  ``FLAGS_cost_ledger=0`` turns off every stamp
    and makes ``cost_record`` return None; the off path is bit-exact and
    adds no host sync."""
    return bool(flags.get_flag("cost_ledger"))


def signature(fingerprint, k=1):
    """Ledger key of one plan: program-fingerprint prefix and window
    size, e.g. ``"7854f8031c07:k16"``."""
    fp = (fingerprint or "anon")[:12]
    return "%s:k%d" % (fp, max(1, int(k or 1)))


# ---------------------------------------------------------------------------
# The work of the hand kernels
# ---------------------------------------------------------------------------

def causal_share(s_q, s_kv):
    """The share of the score matrix that a causal mask keeps."""
    return (s_q * (s_q + 1) / 2) / (s_q * s_kv)


def kernel_work(kernel, **shape):
    """``(flops, bytes)`` of one launch of hand kernel ``kernel``: each
    input read once and each output written once, the products' 2·M·N·K
    (K1-K5, a causal score matrix counting the half it keeps) or ~8
    operations an entry (K6).

    - K1 (3x3 conv, NHWC): ``n, h, w, c, o, esz``, ``affine`` (scale and
      shift read).
    - K2 (attention forward), K3 (dQ), K4 (dK, dV), K5 (dBias): ``bh,
      sq, sk, d, esz``, ``bias_bytes`` (the bias as stored),
      ``causal``; K2 also ``lse`` (the float32 LSE written).  K3-K5
      read the LSE and delta, float32 ``[bh, sq]`` each.
    - K6 (row layer norm): ``m, d, esz`` (scale and bias float32).
    """
    s = shape
    if kernel == "K1":
        m = s["n"] * s["h"] * s["w"]
        c, o, esz = s["c"], s["o"], s["esz"]
        flops = 2.0 * m * 9 * c * o
        nbytes = esz * (m * c + 9 * c * o + m * o)
        if s.get("affine"):
            nbytes += 2 * 4 * o
        return flops, nbytes
    if kernel in ("K2", "K3", "K4", "K5"):
        bh, sq, sk, d, esz = s["bh"], s["sq"], s["sk"], s["d"], s["esz"]
        share = causal_share(sq, sk) if s.get("causal") else 1.0
        scores = bh * sq * sk * share
        side = s.get("bias_bytes", 0)
        rows = 4 * bh * sq                  # one float32 per query row
        if kernel == "K2":
            return (4.0 * scores * d,
                    esz * bh * d * 2 * (sq + sk) + side +
                    (rows if s.get("lse") else 0))
        side += 2 * rows                    # the LSE and delta read
        if kernel == "K3":
            return 6.0 * scores * d, esz * bh * d * (3 * sq + 2 * sk) + side
        if kernel == "K4":
            return 8.0 * scores * d, esz * bh * d * (2 * sq + 4 * sk) + side
        return (4.0 * scores * d,
                esz * bh * d * 2 * (sq + sk) + side + esz * bh * sq * sk)
    if kernel == "K6":
        m, d, esz = s["m"], s["d"], s.get("esz", 4)
        return 8.0 * m * d, esz * 2 * m * d + 4 * 2 * d
    raise ValueError("unknown hand kernel %r (one of %s)"
                     % (kernel, ", ".join(KERNELS)))


def stored_bytes(t):
    """Bytes of the distinct elements of ``t`` (a broadcast view's
    stride-0 dimensions are stored once), 0 for None."""
    if t is None:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def hand_kernel(kernel, work):
    """Decorator of a hand kernel's wrapper: while a capture is active,
    add ``work(*args, **kwargs)`` (its ``(flops, bytes)``) under
    ``kernel`` and count none of the aten calls inside the wrapper (its
    plain version on the CPU, its output allocations on the card)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            cap = _ACTIVE
            if cap is None:
                return fn(*args, **kwargs)
            flops, nbytes = work(*args, **kwargs)
            cap.suppress += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                cap.suppress -= 1
            dt = getattr(args[0], "dtype", None) if args else None
            cap.add_kernel(kernel, flops, nbytes,
                           str(dt).replace("torch.", "") if dt else None)
            return out
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# Counting aten calls
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = frozenset([
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "erf", "erfc", "erfinv", "rsqrt", "sqrt", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "asinh",
    "acosh", "atanh", "pow", "_softmax", "_log_softmax", "gelu", "silu",
    "softplus", "log_sigmoid_forward", "mish", "elu", "reciprocal",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "tanh_backward", "sigmoid_backward", "gelu_backward",
])

# allocations that write nothing
_NO_BYTES = frozenset(["empty", "empty_like", "empty_strided",
                       "new_empty", "new_empty_strided", "detach",
                       "lift_fresh", "alias"])


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts):
    seen, total = set(), 0
    for t in ts:
        if id(t) in seen:
            continue
        seen.add(id(t))
        total += t.numel() * t.element_size()
    return total


class Capture:
    """The counts of one captured run: totals, per Fluid op, per hand
    kernel, and the FLOPs by the dtype of the product's first operand."""

    def __init__(self, shape_ops=()):
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.aten_calls = 0
        self.hand_kernel_calls = 0
        self.ops = {}
        self.kernels = {}
        self.dtype_flops = {}
        self.comm = []
        self.suppress = 0
        self.op = None
        # (op type, {slot: [shape, ...]}, {output slot: [names]}, attrs)
        # of every op of a type in ``shape_ops`` the run dispatched
        self.shape_ops = frozenset(shape_ops)
        self.op_shapes = []

    def _entry(self):
        key = self.op or "(unattributed)"
        ent = self.ops.get(key)
        if ent is None:
            ent = self.ops[key] = {"flops_est": 0.0, "bytes": 0.0,
                                   "aten_calls": 0}
        return ent

    def add_aten(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", str(func))
        flops = 0.0
        formula = flop_registry.get(packet) if packet is not None else None
        ins = _tensors((args, kwargs))
        if formula is not None:
            flops = float(formula(*args, **(kwargs or {}), out_val=out))
            if flops and ins:
                dt = str(ins[0].dtype).replace("torch.", "")
                self.dtype_flops[dt] = self.dtype_flops.get(dt, 0.0) + flops
        outs = _tensors(out)
        if getattr(func, "is_view", False) or name in _NO_BYTES:
            nbytes = 0
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        trans = sum(t.numel() for t in outs) \
            if name in _TRANSCENDENTAL else 0
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans
        self.aten_calls += 1
        ent = self._entry()
        ent["flops_est"] += flops
        ent["bytes"] += nbytes
        ent["aten_calls"] += 1

    def add_kernel(self, kernel, flops, nbytes, dtype=None):
        self.flops += flops
        self.bytes += nbytes
        self.hand_kernel_calls += 1
        k = self.kernels.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        ent = self._entry()
        ent["flops_est"] += flops
        ent["bytes"] += nbytes
        ent.setdefault("hand_kernel_calls", 0)
        ent["hand_kernel_calls"] += 1
        if dtype is not None:
            self.dtype_flops[dtype] = self.dtype_flops.get(dtype, 0.0) + \
                flops

    def add_comm(self, species, precision, nbytes, axis="dp"):
        """A collective's per-rank wire bytes by the JAX byte model, also
        where a world of one makes the op the identity (the bytes the
        op's program puts on the wire, as JAX counts them at trace
        time)."""
        self.comm.append((species, precision, int(nbytes), axis))

    @contextlib.contextmanager
    def attribute(self, op, env):
        """Count what runs inside under ``fluid_<op.type>`` unless an
        outer op is already being counted."""
        if self.op is not None:
            yield
            return
        self.op = "fluid_" + op.type
        if op.type in self.shape_ops:
            shapes = {slot: [list(env[n].shape) if n in env and
                             hasattr(env[n], "shape") else None
                             for n in names]
                      for slot, names in op.inputs.items()}
            self.op_shapes.append((op.type, shapes, dict(op.outputs),
                                   dict(op.attrs)))
        try:
            yield
        finally:
            self.op = None


def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counter(TorchDispatchMode):
        def __init__(self, cap):
            super().__init__()
            self.cap = cap

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.cap.suppress:
                self.cap.add_aten(func, args, kwargs, out)
            return out

    return _Counter


@contextlib.contextmanager
def capture(shape_ops=()):
    """Count every aten call and hand-kernel launch inside (one capture
    at a time); yields the :class:`Capture`."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a cost capture is already active")
    cap = Capture(shape_ops)
    _ACTIVE = cap
    try:
        with _mode_class()(cap):
            yield cap
    finally:
        _ACTIVE = None


def note_collective(species, precision, nbytes, axis="dp"):
    """A collective op that a world of one runs as the identity tells an
    active capture what it would put on the wire (one check otherwise)."""
    if _ACTIVE is not None:
        _ACTIVE.add_comm(species, precision, nbytes, axis)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

_PEAK_FLAG = {"bfloat16": "roofline_peak_flops",
              "float16": "roofline_peak_flops",
              "float32": "roofline_peak_flops_fp32"}


def roofline_seconds(flops, bytes_accessed, dtype="bfloat16"):
    """Roofline step-time estimate: the larger of ``flops`` over the
    peak of ``dtype`` (``FLAGS_roofline_peak_flops`` for bf16 and fp16,
    ``FLAGS_roofline_peak_flops_fp32`` for fp32) and ``bytes_accessed``
    over ``FLAGS_roofline_peak_bytes_per_s``.  A lower bound: no overlap,
    no launch or collective latency."""
    flag = _PEAK_FLAG.get(dtype, "roofline_peak_flops")
    peak_flops = float(flags.get_flag(flag)) or 1.0
    peak_bw = float(flags.get_flag("roofline_peak_bytes_per_s")) or 1.0
    return max(float(flops) / peak_flops, float(bytes_accessed) / peak_bw)


def peak_dtype(dtype_flops):
    """The dtype that does most of the counted FLOPs (its peak is the
    roofline's), float32 when nothing was counted."""
    if not dtype_flops:
        return "float32"
    return max(sorted(dtype_flops), key=lambda d: dtype_flops[d])


def attribution(cap, k=1):
    """``{fluid_<type>: {flops_est, bytes, aten_calls}}`` of a capture,
    per inner step (totals divided by ``k``)."""
    k = max(1, int(k or 1))
    return {op: {"flops_est": v["flops_est"] / k, "bytes": v["bytes"] / k,
                 "aten_calls": v["aten_calls"] / k}
            for op, v in cap.ops.items()}


def top_ops(attribution, n=6):
    """The n heaviest ops of an attribution table, by FLOPs then bytes:
    the ledger's "name the responsible Fluid ops" payload."""
    ranked = sorted(attribution.items(),
                    key=lambda kv: (kv[1]["flops_est"], kv[1]["bytes"],
                                    kv[0]),
                    reverse=True)
    return [{"op": key, "flops_est": v["flops_est"], "bytes": v["bytes"],
             "aten_calls": v["aten_calls"]} for key, v in ranked[:n]]


def comm_by_key(entries, k=1):
    """``{"<species>_<precision>@<axis>": bytes a step}`` of
    (species, precision, bytes, axis) entries over ``k`` inner steps."""
    out = {}
    for species, precision, nb, axis in entries:
        key = "%s_%s@%s" % (species, precision, axis)
        out[key] = out.get(key, 0) + int(nb)
    k = max(1, int(k or 1))
    return {key: v // k for key, v in sorted(out.items())}


def describe(cap, k=1, sig=None, argument_bytes=0, output_bytes=0,
             peak_allocated=None, tag=None, n_top=8):
    """Normalized ledger record of one capture of ``k`` inner steps.

    ``peak_allocated`` is what the step allocated at its high point on
    the card (``max_memory_allocated`` less what was allocated before
    it), None on the CPU.  Then ``peak_bytes = argument_bytes +
    peak_allocated`` and ``temp_bytes = peak_bytes - argument_bytes -
    output_bytes`` (at least 0)."""
    k = max(1, int(k or 1))
    flops = cap.flops / k
    nbytes = cap.bytes / k
    dtype = peak_dtype(cap.dtype_flops)
    if peak_allocated is None:
        peak = temp = None
    else:
        peak = int(argument_bytes) + int(peak_allocated)
        temp = max(0, peak - int(argument_bytes) - int(output_bytes))
    species = {}
    for sp, _prec, _nb, _ax in cap.comm:
        species[sp] = species.get(sp, 0) + 1
    rec = {
        "sig": sig or "?",
        "k": k,
        "flops": flops,
        "transcendentals": cap.transcendentals / k,
        "bytes_accessed": nbytes,
        "window_flops": flops * k,
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(output_bytes),
        "temp_bytes": temp,
        "peak_bytes": peak,
        "aten_calls": cap.aten_calls / k,
        "hand_kernel_calls": cap.hand_kernel_calls / k,
        "hand_kernels": {name: {"calls": v["calls"] / k,
                                "flops": v["flops"] / k,
                                "bytes": v["bytes"] / k}
                         for name, v in sorted(cap.kernels.items())},
        "collectives": {s: n // k for s, n in sorted(species.items())},
        "peak_dtype": dtype,
        "estimated_step_s": roofline_seconds(flops, nbytes, dtype),
        "top_ops": top_ops(attribution(cap, k), n=n_top),
    }
    if cap.comm:
        rec["collective_bytes"] = comm_by_key(cap.comm, k)
        rec["collective_bytes_per_step"] = int(
            sum(rec["collective_bytes"].values()))
    if tag:
        rec["tag"] = tag
    return rec


def stamp(rec, source="full"):
    """Publish one record: the ``ledger_*`` gauges labelled by signature
    and a ``kind="compile"`` lifecycle record in the step-event ring and
    the metrics JSONL."""
    sig = rec.get("sig") or "?"
    if rec.get("flops") is not None:
        _m_flops.set(float(rec["flops"]), sig=sig)
    if rec.get("bytes_accessed") is not None:
        _m_bytes.set(float(rec["bytes_accessed"]), sig=sig)
    if rec.get("peak_bytes") is not None:
        _m_peak.set(float(rec["peak_bytes"]), sig=sig)
    if rec.get("hand_kernel_calls") is not None:
        _m_kernels.set(float(rec["hand_kernel_calls"]), sig=sig)
    _m_records.inc(source=source)
    telemetry.record_lifecycle_event(kind="compile", source=source, **rec)


def stamp_compile_event(sig, k=1, compile_s=None, comm=None,
                        feed_bytes=None, fetch_count=None, window=False):
    """Dispatch-time stamp of a fresh plan's first run: the host scalars
    the dispatch already has (``comm``: ``{key: bytes a step}``), no
    capture and no device sync."""
    rec = {"sig": sig, "k": max(1, int(k or 1)), "window": bool(window)}
    if compile_s is not None:
        rec["compile_s"] = float(compile_s)
    if comm:
        rec["collective_bytes"] = dict(comm)
        rec["collective_bytes_per_step"] = int(sum(comm.values()))
    if feed_bytes is not None:
        rec["feed_bytes"] = int(feed_bytes)
    if fetch_count is not None:
        rec["fetch_count"] = int(fetch_count)
    _m_records.inc(source="dispatch")
    telemetry.record_lifecycle_event(kind="compile", source="dispatch",
                                     **rec)
