"""Unified runtime telemetry: metrics registry + step-event trace
(counterpart ``paddle_tpu/fluid/telemetry.py``, kept as the port's own
copy: the field names, the JSONL schema and the Prometheus text are the
JAX package's, so one tool reads both packages' files).

Three pieces:

- **Metrics registry** — named :class:`Counter`/:class:`Gauge`/
  :class:`Histogram` instruments with label support.  All operations are
  a dict update under one uncontended lock and NEVER touch the device:
  values handed in must already be host scalars (shapes, attribute
  reads, ``perf_counter`` deltas).  Device-resident values (the
  skip-policy finiteness verdicts) stay in ``profiler``'s lazy pending
  pool and only reach the registry once something reads them — the
  ``record_bad_step`` pattern.
- **Step-event ring buffer** — one bounded record per executor dispatch
  (``record_step_event``): step/window id, plan cache hit/miss, the
  first dispatch's wall time when a plan was built, feed bytes,
  host-sync count, bad-step verdict count, checkpoint overlap.  Bounded
  by ``FLAGS_metrics_ring`` (default 1024 events).
- **Exporters** — ``metrics_snapshot()`` (plain dict),
  ``FLAGS_metrics_jsonl=<path>`` (one JSON line appended per
  step-event; off by default — the only exporter that does work on the
  hot path, and only when asked for), ``dump_prometheus(path)``
  (Prometheus text format), and the Chrome-trace interleave
  (``profiler.stop_profiler`` emits step-events on their own track).
"""

import collections
import contextlib
import json
import os
import threading
import time

from . import flags

# ONE lock for registry + ring mutation: every record is a handful of
# dict ops, so contention is negligible and a single lock keeps
# cross-metric reads (snapshot, exporters) consistent.
_LOCK = threading.Lock()

# multi-process identity (fluid.distributed.init stamps it): every
# step-event carries ``pidx``, the JSONL exporter suffixes its path
# ``.p<idx>`` so N processes sharing one FLAGS_metrics_jsonl value never
# interleave torn lines in one file, and the Prometheus exporter labels
# every sample ``process="<idx>"`` — tools/metrics_report.py merges the
# per-process streams back into one report with a skew column.
_process = {"index": None, "count": 1}


def set_process_index(index, count=None):
    """Declare this process's identity in a multi-process world
    (fluid.distributed.init calls this).  ``None`` resets to the
    single-process default.

    If the JSONL exporter already has a stream open when the identity
    CHANGES (elastic resize re-inits identity mid-process), the open
    handle is closed here so the very next record re-suffixes the path
    (``<path>.p<new idx>``) — records never keep landing in the old
    rank's stream.  Records emitted after a reset to ``None`` go to the
    unsuffixed base path."""
    with _LOCK:
        new = None if index is None else int(index)
        if new != _process["index"] and _jsonl["f"] is not None:
            # deterministic re-suffix point: drop the old stream's handle
            # now, not at some later flag change
            try:
                _jsonl["f"].close()
            except OSError:
                pass
            _jsonl["f"], _jsonl["path"] = None, None
        _process["index"] = new
        _process["count"] = int(count) if count else 1


def process_label():
    """The process index every exporter stamps, or None when
    single-process (no labels added — byte-identical legacy output)."""
    return _process["index"]


def _label_key(labels):
    return tuple(sorted(labels.items()))


def _label_dict(key):
    return dict(key)


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class _Metric:
    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._values = {}   # label-key tuple -> scalar (or histogram state)

    def reset(self):
        with _LOCK:
            self._values.clear()

    def labelsets(self):
        """List of label dicts currently holding a value."""
        with _LOCK:
            return [_label_dict(k) for k in self._values]


class Counter(_Metric):
    """Monotonic counter.  ``value()`` aggregates over every label
    DIMENSION the query leaves out (Prometheus ``sum by`` semantics):
    no labels sums every label set (``host_syncs_total`` without a tag
    is the total), and a partial query like ``value(species="allreduce",
    precision="int8")`` sums across any extra labels a producer added
    (the per-axis split of ``collective_bytes_total{axis}`` never
    changes what coarser queries read)."""

    kind = "counter"

    def inc(self, amount=1, **labels):
        key = _label_key(labels)
        with _LOCK:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels):
        with _LOCK:
            if not labels:
                return sum(self._values.values())
            want = set(labels.items())
            return sum(v for k, v in self._values.items()
                       if want.issubset(k))


class Gauge(_Metric):
    """Last-write-wins scalar.  ``value()`` is None until first set
    (legacy ``checkpoint_stats()['last_step']`` semantics)."""

    kind = "gauge"

    def set(self, value, **labels):
        with _LOCK:
            self._values[_label_key(labels)] = value

    def inc(self, amount=1, **labels):
        key = _label_key(labels)
        with _LOCK:
            self._values[key] = (self._values.get(key) or 0) + amount

    def value(self, **labels):
        with _LOCK:
            return self._values.get(_label_key(labels))


# Default buckets suit host-side dispatch/compile timings (seconds):
# sub-10us dispatch floors through multi-minute first dispatches.
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0, 300.0)


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative-bucket Prometheus semantics):
    per label set keeps bucket counts + sum + count.  Buckets are fixed
    at construction — observation is a linear scan over ~10 floats, no
    allocation."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value, **labels):
        key = _label_key(labels)
        with _LOCK:
            state = self._values.get(key)
            if state is None:
                state = {"buckets": [0] * (len(self.buckets) + 1),
                         "sum": 0.0, "count": 0}
                self._values[key] = state
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            state["buckets"][i] += 1
            state["sum"] += value
            state["count"] += 1

    def value(self, **labels):
        """{'sum', 'count', 'mean'} for one label set; with no labels,
        aggregated across every label set (Counter.value() symmetry)."""
        with _LOCK:
            if labels:
                states = [self._values.get(_label_key(labels))]
            else:
                states = list(self._values.values())
            tot, n = 0.0, 0
            for state in states:
                if state is not None:
                    tot += state["sum"]
                    n += state["count"]
            return {"sum": tot, "count": n,
                    "mean": tot / n if n else 0.0}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.  ``reset()``
    clears VALUES but keeps the instrument objects, so module-level
    references held by producers (executor.py, checkpoint.py, ...) stay
    valid across test resets."""

    def __init__(self):
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with _LOCK:
            m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    "metric %r already registered as %s, requested %s"
                    % (name, m.kind, cls.kind))
            return m
        m = cls(name, help=help, **kwargs)
        with _LOCK:
            # racing creators: first registration wins
            return self._metrics.setdefault(name, m)

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name):
        with _LOCK:
            return self._metrics.get(name)

    def metrics(self):
        with _LOCK:
            return list(self._metrics.values())

    def reset(self):
        for m in self.metrics():
            m.reset()

    def snapshot(self):
        """Plain-dict view of every instrument: ``{name: {"type": ...,
        "values": [{"labels": {...}, "value": ...}, ...]}}``.  Histogram
        values are ``{"sum", "count", "buckets": {le: n}}``."""
        out = {}
        for m in self.metrics():
            items = _copy_items(m)
            vals = []
            for key, v in items:
                if m.kind == "histogram":
                    b = dict(zip([str(u) for u in m.buckets] + ["+Inf"],
                                 v["buckets"]))
                    v = {"sum": v["sum"], "count": v["count"], "buckets": b}
                vals.append({"labels": _label_dict(key), "value": v})
            out[m.name] = {"type": m.kind, "help": m.help, "values": vals}
        return out


def _copy_items(m):
    """Consistent (label-key, value) pairs of one metric, deep-copying
    mutable histogram state UNDER the lock — exporters must never read
    live dicts a concurrent observe() is mutating (torn sum/count)."""
    with _LOCK:
        if m.kind == "histogram":
            return [(k, {"buckets": list(v["buckets"]), "sum": v["sum"],
                         "count": v["count"]})
                    for k, v in m._values.items()]
        return list(m._values.items())


_REGISTRY = MetricsRegistry()


def registry():
    """The process-default registry every runtime module records to."""
    return _REGISTRY


def counter(name, help=""):
    return _REGISTRY.counter(name, help)


def gauge(name, help=""):
    return _REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return _REGISTRY.histogram(name, help, buckets=buckets)


def reset_metrics():
    """Zero every instrument in the default registry (values only — the
    instrument objects and producer references survive)."""
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# Step-event ring buffer
# ---------------------------------------------------------------------------
# One record per executor dispatch — the "why was step N slow" substrate.
# Field schema (docs/observability.md):
#   ts_ns      perf_counter_ns at dispatch start (same clock as the host
#              profiler spans, so Chrome traces interleave)
#   dur_ns     host wall time of the dispatch call (async: excludes
#              device execution beyond what the enqueue waited on —
#              a compile or a full dispatch queue shows up here)
#   step       scope.step_counter at dispatch start (the step/window id)
#   k          inner steps this dispatch ran (1, or steps_per_run)
#   window     True for a fused run_window dispatch
#   plan_hit   True/False for the dispatch-plan path, None on the legacy
#              (FLAGS_dispatch_plan=0 / unhashable-feed) path
#   compile_s  seconds the first-ever call of this executable took
#              (plan build and first-call costs ride it), else None
#   feed_bytes sum of feed array nbytes (attribute reads — no sync)
#   fetch_count fetches requested
#   syncs      host syncs recorded DURING this dispatch (fetch_numpy /
#              benchmark fences; 0 on the async hot path)
#   verdicts   bad-step verdicts handed to the lazy pool (k under
#              FLAGS_check_nan_inf=skip, else 0) — counts, not values:
#              the device arrays are never forced here
#   ckpt_overlap  True when an async checkpoint save was in flight
#   data_wait_s   seconds the consumer waited on the input pipeline
#              (DataLoader queue / feed ring) for THIS dispatch's feed
#              (0.0 when the feed was ready — the overlapped case)
#
# Lifecycle records (record_lifecycle_event) share the ring/JSONL with a
# `kind` field ("preemption" | "rollback" | "resize" | "hang" |
# "ckpt_commit" | "ckpt_abandoned" | "serving" | "compile" — the last is
# the device-cost ledger record, costmodel.py) and k=0 (ledger records
# carry their real window K), so "what happened around step N"
# interleaves with the dispatch stream; consumers that aggregate
# per-step timing must skip records carrying `kind`
# (tools/metrics_report.py does).

_ring = [None]          # lazily sized from FLAGS_metrics_ring
_events_recorded = [0]  # total recorded (ring may have dropped older)
_jsonl = {"path": None, "f": None}


def _get_ring():
    ring = _ring[0]
    if ring is None:
        size = max(1, int(flags.get_flag("metrics_ring")))
        ring = collections.deque(maxlen=size)
        _ring[0] = ring
    return ring


def record_step_event(**fields):
    """Append one dispatch record to the ring (and to the JSONL exporter
    when ``FLAGS_metrics_jsonl`` names a file).  Pure host bookkeeping:
    callers pass only host scalars, nothing here can sync the device.
    In a multi-process world every record is stamped with ``pidx`` (this
    process's index) so merged streams stay attributable."""
    pidx = _process["index"]
    if pidx is not None:
        fields.setdefault("pidx", pidx)
    if _progress["enabled"] and _progress["t"] is not None and \
            "kind" not in fields:
        # watchdog armed: every dispatch record carries how stale the
        # last progress stamp was when it landed (the per-stream
        # ``last_progress_age_s`` column in tools/metrics_report.py)
        fields.setdefault("last_progress_age_s",
                          round(time.monotonic() - _progress["t"], 6))
    with _LOCK:
        _get_ring().append(fields)
        _events_recorded[0] += 1
    path = flags.get_flag("metrics_jsonl")
    if path:
        if pidx is not None:
            # per-process suffix: N processes sharing one flag value
            # each get their own stream (no cross-process interleaving)
            path = "%s.p%d" % (path, pidx)
        _append_jsonl(path, fields)


def record_lifecycle_event(kind, **fields):
    """Append a self-healing lifecycle record (``kind`` = "preemption" /
    "rollback" / "resize" — the last carries old/new world size and
    ``recovery_s``, fluid/elastic.py — / "hang", fluid/watchdog.py:
    last-known phase + staleness at detection) to the step-event ring
    and JSONL exporter.  Stamps
    ``ts_ns`` (perf_counter_ns — the step-event clock) and ``k=0``
    unless the caller supplies them; ``dur_ns`` defaults to 0 so every
    consumer of the ring sees a complete schema."""
    fields.setdefault("ts_ns", time.perf_counter_ns())
    fields.setdefault("dur_ns", 0)
    fields.setdefault("k", 0)
    record_step_event(kind=kind, **fields)


# ---------------------------------------------------------------------------
# Last-progress stamp (hang-detection substrate — fluid/watchdog.py)
# ---------------------------------------------------------------------------
# The runtime stamps "forward progress" at its park-prone boundaries —
# every executor dispatch, feed-ring window staged, checkpoint phase,
# collective-consensus/barrier entry — as ONE monotonic timestamp plus
# the phase name.  The watchdog thread compares the stamp's age against
# FLAGS_watchdog_timeout_s (plus any active phase extension) to turn a
# silent stall into a stack-dumped abort.  Disabled (the default) the
# stamp is a single dict read and an immediate return: the hot path
# pays nothing and records nothing (bit-exact legacy step events).
#
# Plain-dict mutations only, NO lock: record_progress must be callable
# from any thread (feed-ring producers, checkpoint save workers) and
# from contexts that may already hold _LOCK upstream; GIL-atomic dict
# ops suffice for a monotonically-refreshed advisory timestamp.
_progress = {"enabled": False, "t": None, "phase": None, "hook": None}

# Background I/O threads (async checkpoint uploaders) must be INVISIBLE
# to the progress substrate: a stamp from a background thread would mask
# a hung training loop, and a watchdog deadline extension granted from
# one would mask a hung uploader (fluid/watchdog.py).  Threads mark
# themselves with suppress_progress(); record_progress and
# watchdog.extend_deadline both honor the mark.
_quiet_thread = threading.local()


@contextlib.contextmanager
def suppress_progress():
    """Mark the calling thread as a background I/O thread for the body:
    its record_progress calls neither stamp nor fire the hook, and the
    watchdog grants it no deadline extensions.  Nestable."""
    prev = getattr(_quiet_thread, "on", False)
    _quiet_thread.on = True
    try:
        yield
    finally:
        _quiet_thread.on = prev


def progress_suppressed():
    """True when the calling thread is marked as a background I/O
    thread (suppress_progress)."""
    return getattr(_quiet_thread, "on", False)


def enable_progress(on=True):
    """Switch progress stamping on/off (fluid.watchdog.arm/disarm do).
    Off also forgets the last stamp so a later re-arm starts fresh."""
    _progress["enabled"] = bool(on)
    if not on:
        _progress["t"] = None
        _progress["phase"] = None


def set_progress_hook(hook):
    """Install a test hook fired (with the phase name) at every progress
    boundary — the substrate tests/faultinject.py ``hang_at`` parks
    threads on.  Returns the previous hook.  A set hook makes
    boundaries observable even while stamping is disabled."""
    prev = _progress["hook"]
    _progress["hook"] = hook
    return prev


def record_progress(phase):
    """Stamp one unit of forward progress at a named phase boundary.
    The stamp lands BEFORE the hook fires, so a thread a test parks
    here is seen by the watchdog at exactly this phase."""
    if not _progress["enabled"] and _progress["hook"] is None:
        return
    if getattr(_quiet_thread, "on", False):
        # background I/O thread: invisible to the hang-detection
        # substrate — its liveness must never count as training progress
        return
    if _progress["enabled"]:
        _progress["phase"] = phase
        _progress["t"] = time.monotonic()
    hook = _progress["hook"]
    if hook is not None:
        hook(phase)


def last_progress():
    """(monotonic timestamp, phase) of the newest stamp — (None, None)
    when stamping is disabled or nothing has stamped yet."""
    return _progress["t"], _progress["phase"]


def last_progress_age_s():
    """Seconds since the newest progress stamp (None when disabled /
    unstamped) — the staleness /healthz and the watchdog judge."""
    t = _progress["t"]
    return None if t is None else time.monotonic() - t


# ---------------------------------------------------------------------------
# Spans (pod-level tracing — docs/observability.md "Pod-level tracing")
# ---------------------------------------------------------------------------
# A span is one timed region recorded into the SAME step-event ring/JSONL
# as dispatch records, with ``kind="span"`` so per-step aggregators skip
# it.  Spans are emitted at the progress-stamp boundaries (dispatch,
# barrier/consensus entry, feed-ring staging, checkpoint phases) so the
# instrumentation lives in one place: ``span(kind, phase=...)`` stamps
# progress on entry and, when tracing is on, records the region on exit.
#
# Field schema of a span record:
#   kind     "span" (ring/JSONL discriminator)
#   span     the span kind ("dispatch" | "barrier" | "consensus" |
#            "feed_stage" | "feed_wait" | "checkpoint" | "ckpt" | ...)
#   ts_ns    perf_counter_ns at entry (process-local clock — interleaves
#            with this process's dispatch records and profiler spans)
#   dur_ns   exit - entry on the same clock
#   wall_ns  time_ns() at entry — the ONLY cross-process-comparable
#            stamp.  tools/pod_trace.py derives each rank's
#            perf_counter->wall offset from it to merge N per-process
#            streams onto one timeline and compute barrier-entry skew
#            (straggler attribution).
#   k        0 (spans are not dispatches)
# plus any caller labels (e.g. ``name`` for named barriers).
#
# Off (the default) ``span()`` costs a progress stamp (itself a no-op
# unless the watchdog/a hook armed it) and records NOTHING: the hot path
# stays bit-exact with zero added host syncs.  On: two clock reads on
# entry, one on exit, one ring append.  Enable via ``FLAGS_trace_spans``
# or ``enable_spans()``.
#
# The progress stamp fires BEFORE the entry clocks are read.  That
# ordering is what makes injected-straggler tests honest: a thread a
# ``faultinject.hang_at`` hook parks at the boundary gets a LATE wall_ns
# entry stamp, exactly like a rank that genuinely arrived late.
_spans = {"enabled": False}


def enable_spans(on=True):
    """Programmatic switch for span recording (the env path is
    ``FLAGS_trace_spans``)."""
    _spans["enabled"] = bool(on)


def spans_enabled():
    return _spans["enabled"] or bool(flags.get_flag("trace_spans"))


class _SpanCtx:
    __slots__ = ("kind", "phase", "labels", "_t0", "_w0", "_on")

    def __init__(self, kind, phase, labels):
        self.kind, self.phase, self.labels = kind, phase, labels
        self._on = False

    def __enter__(self):
        if self.phase is not None:
            record_progress(self.phase)   # BEFORE the clocks — see above
        if _spans["enabled"] or flags.get_flag("trace_spans"):
            self._on = True
            self._w0 = time.time_ns()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._on:
            t1 = time.perf_counter_ns()
            self.labels.setdefault("k", 0)
            record_step_event(kind="span", span=self.kind,
                              ts_ns=self._t0, dur_ns=t1 - self._t0,
                              wall_ns=self._w0, **self.labels)
        return False


def span(kind, phase=None, **labels):
    """Context manager timing one region as a span record.  ``phase``
    (when given) is stamped via :func:`record_progress` on entry, so a
    call site that previously stamped progress keeps exactly that
    behavior with tracing off."""
    return _SpanCtx(kind, phase, labels)


def record_span(kind, ts_ns, dur_ns, wall_ns=None, **labels):
    """Post-hoc span record for regions whose timing was already
    measured (dispatch, reader feed waits).  ``wall_ns`` defaults to
    the entry wall time derived from ``ts_ns``'s perf_counter stamp
    (now_wall - (now_perf - ts_ns)) — exact regardless of how long
    after the region this is called."""
    if not (_spans["enabled"] or flags.get_flag("trace_spans")):
        return
    ts_ns, dur_ns = int(ts_ns), int(dur_ns)
    if wall_ns is None:
        wall_ns = time.time_ns() - (time.perf_counter_ns() - ts_ns)
    labels.setdefault("k", 0)
    record_step_event(kind="span", span=kind, ts_ns=ts_ns,
                      dur_ns=dur_ns, wall_ns=int(wall_ns), **labels)


# Consumer data-wait accounting: reader.py/FeedRing record each
# starvation wait here; the executor drains the pending pool into the
# next step-event's ``data_wait_s`` field, so per-dispatch timing and
# the wait that preceded it interleave in one stream
# (tools/metrics_report.py reports p50/p99 starvation per K from it).
# THREAD-LOCAL: a feed pull and the dispatch consuming it happen on the
# same consumer thread, so per-thread pools keep attribution right when
# several executors/pipelines run concurrently (an eval executor on
# another thread can never be stamped with the train loop's wait).
_data_wait_pending = threading.local()


def record_data_wait(seconds):
    """Add one consumer starvation wait (host scalar) to the calling
    thread's pool; this thread's next step-event drains it."""
    _data_wait_pending.v = getattr(_data_wait_pending, "v", 0.0) + seconds


def take_pending_data_wait():
    """Drain the calling thread's pending data-wait pool (seconds
    waited since its last dispatch); called by ``Executor._dispatch``."""
    s = getattr(_data_wait_pending, "v", 0.0)
    _data_wait_pending.v = 0.0
    return s


def step_events():
    """Newest-last list of ring contents (copies the deque)."""
    with _LOCK:
        ring = _ring[0]
        return list(ring) if ring is not None else []


def step_events_recorded():
    """Total events ever recorded (>= len(step_events()) once the ring
    wraps)."""
    with _LOCK:
        return _events_recorded[0]


def reset_step_events():
    """Drop the ring (re-sized from FLAGS_metrics_ring on next record)
    and close any open JSONL handle."""
    with _LOCK:
        _ring[0] = None
        _events_recorded[0] = 0
    close_jsonl()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def metrics_snapshot():
    """Plain-dict export: the full registry snapshot plus ring stats —
    the programmatic exporter (no flags, no files)."""
    snap = _REGISTRY.snapshot()
    snap["_step_events"] = {"recorded": step_events_recorded(),
                            "in_ring": len(step_events())}
    return snap


def _append_jsonl(path, fields):
    """Append one JSON line to ``path`` (handle cached across events;
    reopened when the flag changes).  I/O errors disable the exporter
    for the run rather than killing training."""
    with _LOCK:
        if _jsonl["path"] != path:
            if _jsonl["f"] is not None:
                try:
                    _jsonl["f"].close()
                except OSError:
                    pass
            try:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                _jsonl["f"] = open(path, "a", encoding="utf-8")
                _jsonl["path"] = path
            except OSError as e:
                import warnings
                warnings.warn("FLAGS_metrics_jsonl disabled: %s" % (e,))
                _jsonl["f"], _jsonl["path"] = None, path
        f = _jsonl["f"]
        if f is None:
            return
        try:
            f.write(json.dumps(fields, default=_json_default) + "\n")
            f.flush()
        except (OSError, ValueError):
            pass


def _json_default(v):
    # numpy scalars and anything else non-JSON degrade to repr —
    # exporters must never raise into the training loop
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:
        pass
    return repr(v)


def close_jsonl():
    """Flush + close the JSONL exporter handle (tests; atexit safety)."""
    with _LOCK:
        if _jsonl["f"] is not None:
            try:
                _jsonl["f"].close()
            except OSError:
                pass
        _jsonl["f"] = None
        _jsonl["path"] = None


def _prom_labels(labels):
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))


# the text exposition format version prometheus_text() emits — HTTP
# scrape endpoints (tools/metrics_server.py) must declare it in
# Content-Type or scrapers fall back to protobuf negotiation
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_text():
    """Registry rendered in the Prometheus text exposition format.  In a
    multi-process world every sample carries a ``process="<idx>"`` label
    so per-process scrapes aggregate without collision; single-process
    output is byte-identical to the pre-pod format."""
    pidx = _process["index"]
    lines = []
    for m in _REGISTRY.metrics():
        items = _copy_items(m)
        if m.help:
            lines.append("# HELP %s %s" % (m.name, m.help))
        lines.append("# TYPE %s %s" % (m.name, m.kind))
        for key, v in items:
            labels = _label_dict(key)
            if pidx is not None:
                labels.setdefault("process", pidx)
            if m.kind == "histogram":
                cum = 0
                for ub, n in zip(list(m.buckets) + ["+Inf"], v["buckets"]):
                    cum += n
                    ls = dict(labels, le=str(ub))
                    lines.append("%s_bucket%s %s"
                                 % (m.name, _prom_labels(ls), cum))
                lines.append("%s_sum%s %s"
                             % (m.name, _prom_labels(labels), v["sum"]))
                lines.append("%s_count%s %s"
                             % (m.name, _prom_labels(labels), v["count"]))
            else:
                val = v if v is not None else "NaN"
                lines.append("%s%s %s" % (m.name, _prom_labels(labels), val))
    return "\n".join(lines) + "\n"


def dump_prometheus(path):
    """Write ``prometheus_text()`` to ``path`` (atomic replace — a
    scraper never reads a torn file); returns the text."""
    text = prometheus_text()
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)
    return text


def reset_all():
    """Full telemetry reset: every metric value + the step-event ring
    (span recording reverts to the FLAGS_trace_spans default too)."""
    reset_metrics()
    reset_step_events()
    _spans["enabled"] = False
