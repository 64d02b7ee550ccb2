"""Continuous-batching serving executor over a ladder of batch buckets
(counterpart ``paddle_tpu/fluid/serving.py``).

- **Shape buckets** — request batches are padded UP a ladder
  (``FLAGS_serving_buckets``; default powers of two up to ``max_batch``).
  On the card each bucket is one dispatch plan of the executor (and one
  set of cuBLAS shapes); :meth:`ServingExecutor.warmup` builds them all up
  front, and ``stats()["recompiles"]`` pins the contract: after warmup no
  queued dispatch builds a new plan.
- **Continuous batching** — a scheduler thread packs queued requests into
  the smallest bucket that fits, holding an under-full batch open for at
  most ``max_wait_ms``.  Dispatch is asynchronous (``return_numpy=False``):
  the scheduler records a CUDA event on its stream right after enqueueing
  batch N and starts packing batch N+1, while a completion thread waits
  on that event, copies batch N's outputs to the host and slices
  per-request responses out of the padded rows.  Padding rows never leak
  into real rows.
- **Backpressure** rejects (counted) beyond ``max_queue`` queued requests.
- **Production edges** — a preemption stop (``fluid.preemption``:
  SIGTERM through ``install()``, or ``request_stop()``) closes admission
  and drains like ``close()``; every idle wait of the scheduler goes
  through ``reader.stop_aware_get``, which sees the stop.  The JAX
  package's ``serving_*`` metrics land in the telemetry registry.

:meth:`ServingExecutor.from_inference_model` serves a
``save_inference_model`` export of either package.

Usage::

    sv = fluid.serving.ServingExecutor(
        infer_program, feed_specs={"img": ((3, 224, 224), "float32")},
        fetch_list=[prob], scope=scope, max_batch=32)
    sv.warmup()                       # build the whole ladder up front
    fut = sv.submit({"img": batch})   # -> concurrent.futures.Future
    probs, = fut.result()
    sv.close()                        # drain + join threads
"""

import concurrent.futures
import queue
import threading
import time

import numpy as np
import torch

from . import flags
from . import preemption
from . import telemetry
from .data_types import canonical_dtype, np_dtype, to_numpy
from .reader import QUEUE_DRAINED, stop_aware_get

__all__ = ["ServingExecutor", "ServingError", "ServingRejectedError",
           "ServingClosedError", "bucket_ladder"]

# telemetry (the JAX package's names, serving.py:66-112)
_m_requests = telemetry.counter(
    "serving_requests_total", "requests accepted into the serving queue")
_m_responses = telemetry.counter(
    "serving_responses_total", "requests answered (future completed)")
_m_rejects = telemetry.counter(
    "serving_rejects_total",
    "requests rejected before admission, by reason "
    "(queue_full | too_large | closed)")
_m_recompiles = telemetry.counter(
    "serving_recompiles_total",
    "dispatch plans built by a QUEUED serving dispatch — 0 forever "
    "after warmup() is the shape-discipline contract")
_m_batches = telemetry.counter(
    "serving_batches_total", "padded batches dispatched, by bucket")
_m_padded_rows = telemetry.counter(
    "serving_padded_rows_total",
    "padding rows dispatched (bucket minus real rows)")
_m_errors = telemetry.counter(
    "serving_errors_total", "batches whose dispatch/completion raised "
    "(every affected request future carries the exception)")
_m_cancelled = telemetry.counter(
    "serving_cancelled_total",
    "accepted requests dropped at dispatch because the client "
    "cancelled the future while it was queued")
_m_depth = telemetry.gauge(
    "serving_queue_depth", "requests accepted but not yet dispatched")
_m_occupancy = telemetry.gauge(
    "serving_batch_occupancy_frac",
    "real rows / bucket rows of the most recent dispatch (1.0 = no "
    "padding wasted)")
# request latency split: time WAITING for a batch to form vs dispatch to
# outputs on the host
_LAT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 10.0)
_m_queue_wait = telemetry.histogram(
    "serving_queue_wait_seconds",
    "submit-to-dispatch wait per request", buckets=_LAT_BUCKETS)
_m_compute = telemetry.histogram(
    "serving_compute_seconds",
    "dispatch-to-host-output wall per batch", buckets=_LAT_BUCKETS)


def normalize_feed_specs(feed_specs):
    """``{name: (shape, dtype) | example ndarray}`` normalized to
    ``{name: (tuple shape, canonical dtype str)}``, insertion order
    preserved — the caller's order is the positional-request contract
    (private copy of ``paddle_tpu/fluid/aot.py:68``; torch keeps 64-bit
    dtypes, so nothing is narrowed)."""
    specs = {}
    for name, spec in feed_specs.items():
        if isinstance(spec, np.ndarray):
            specs[name] = (tuple(spec.shape), canonical_dtype(spec.dtype))
        else:
            shape, dtype = spec
            specs[name] = (tuple(int(d) for d in shape),
                           canonical_dtype(dtype))
    return specs


class ServingError(RuntimeError):
    """Serving-layer failure (bad request spec, non-batched fetch, dead
    scheduler)."""


class ServingRejectedError(ServingError):
    """Request refused before admission — backpressure (queue_full), an
    over-sized batch (too_large), or a closed/draining executor.  The
    request was NOT accepted: no future exists and nothing will answer
    it, so the client should shed or retry elsewhere."""


class ServingClosedError(ServingRejectedError):
    """The executor is draining (close()) — new admissions are refused
    while accepted requests are answered."""


def _resolve(future, exc, result=None):
    """Resolve a client future, tolerating a concurrent client-side
    ``Future.cancel()``: ``set_result``/``set_exception`` on a cancelled
    future raises ``InvalidStateError``, and an unhandled one would kill
    the serving thread and park every later ``fut.result()`` forever.
    Returns True when the future actually carried the answer."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except concurrent.futures.InvalidStateError:
        return False


def bucket_ladder(max_batch, buckets=None):
    """Resolve the bucket ladder: explicit ``buckets`` >
    ``FLAGS_serving_buckets`` > powers of two up to ``max_batch``
    (inclusive — a non-power-of-two cap becomes the top bucket).
    Returns a sorted, de-duplicated list of positive ints."""
    if buckets is None:
        raw = flags.get_flag("serving_buckets")
        if raw:
            buckets = [int(t) for t in
                       str(raw).replace(",", " ").split()]
    if buckets is not None:
        ladder = sorted(set(int(b) for b in buckets))
        if not ladder or ladder[0] < 1:
            raise ValueError(
                "serving buckets must be positive batch sizes, got %r"
                % (buckets,))
        return ladder
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return sorted(set(ladder))


class _Request:
    __slots__ = ("feeds", "rows", "future", "t_submit", "t_dispatch")

    def __init__(self, feeds, rows, future):
        self.feeds = feeds
        self.rows = rows
        self.future = future
        self.t_submit = time.perf_counter()
        self.t_dispatch = None


class _Dispatched:
    """One in-flight padded batch: the scheduler hands it to the
    completion thread right after the (async) dispatch is enqueued.
    ``ready`` is a CUDA event recorded on the scheduler's stream after
    the batch's last kernel (None on the CPU, where outputs are ready)."""

    __slots__ = ("batch", "rows", "bucket", "fetches", "ready")

    def __init__(self, batch, rows, bucket, fetches, ready):
        self.batch = batch
        self.rows = rows
        self.bucket = bucket
        self.fetches = fetches
        self.ready = ready


class ServingExecutor:
    """Serve an inference ``Program`` through a bucketed-shape,
    continuously-batched request loop.

    feed_specs: ``{name: (per-SAMPLE shape, dtype)}`` (no batch dim) or
        example per-sample ndarrays; insertion order is the positional-
        request order (``submit([a, b])``).
    fetch_list: output Variables/names; every fetch must carry the batch
        dim first (validated at warmup — per-request slicing needs it).
    scope: parameter scope (default: the global scope; the startup
        program must have run there, or the weights been loaded).
    place: default ``CUDAPlace(0)``; pass ``CPUPlace()`` to serve on the
        host.  Ignored when ``executor`` is given.
    max_batch / buckets / max_wait_ms / max_queue: see
        :func:`bucket_ladder`, ``FLAGS_serving_max_wait_ms``,
        ``FLAGS_serving_max_queue``.

    Threads (both started lazily on the first ``submit`` so ``warmup()``
    keeps the executor single-threaded): ``serving-scheduler`` packs the
    queue into padded buckets and dispatches; ``serving-completion``
    waits for each batch's event, copies its outputs to the host and
    fulfills request futures.  The scheduler polls the close flag on
    every idle wait, so shutdown can never park on an empty queue.
    """

    def __init__(self, program, feed_specs=None, fetch_list=None,
                 scope=None, place=None, max_batch=64, buckets=None,
                 max_wait_ms=None, max_queue=None, executor=None):
        from .executor import CUDAPlace, Executor, global_scope

        if not feed_specs:
            raise ServingError(
                "ServingExecutor needs feed_specs ({name: (per-sample "
                "shape, dtype)}) — a program with no feeds has no "
                "request rows to batch")
        self._program = program
        self._specs = {n: (tuple(s), np_dtype(d)) for n, (s, d) in
                       normalize_feed_specs(feed_specs).items()}
        self.feed_names = list(self._specs)
        if fetch_list is None or not list(fetch_list):
            raise ServingError("ServingExecutor needs a fetch_list")
        self._fetch_list = list(fetch_list)
        self._scope = scope if scope is not None else global_scope()
        self._exe = executor if executor is not None else \
            Executor(place if place is not None else CUDAPlace(0))
        self.buckets = bucket_ladder(max_batch, buckets)
        self._max_wait_s = (flags.get_flag("serving_max_wait_ms")
                            if max_wait_ms is None else
                            float(max_wait_ms)) / 1e3
        self._max_queue = int(flags.get_flag("serving_max_queue")
                              if max_queue is None else max_queue)
        self._queue = queue.Queue()
        self._done = queue.Queue()
        self._lock = threading.Lock()
        self._pending = 0            # accepted, not yet dispatched
        self._closed = threading.Event()
        self._admission_closed = False   # set by the scheduler's final
        #                                  sweep, under _lock — closes the
        #                                  submit-vs-shutdown race so an
        #                                  accepted request is ALWAYS
        #                                  answered
        self._scheduler_thread = None
        self._completion_thread = None
        self._failure = None
        self._warmed = False
        # bucket -> its cost-ledger record (warmup(ledger=True))
        self.ledger_records = {}
        self._n_requests = 0
        self._n_responses = 0
        self._n_rejects = 0
        self._n_cancelled = 0
        self._n_recompiles = 0
        self._n_batches = 0
        self._n_rows = 0
        self._n_padded = 0
        self._occ_sum = 0.0

    @classmethod
    def from_inference_model(cls, dirname, place=None, model_filename=None,
                             params_filename=None, **kwargs):
        """Build a ServingExecutor from a ``save_inference_model``
        artifact: the program and parameters load into a private scope on
        ``place`` (default ``CUDAPlace(0)``), feed specs derive from the
        program's data vars (leading dim must be the batch dim), and
        ``feed_names`` follows the saved manifest's feed order — the
        positional-request contract."""
        from . import io as fluid_io
        from .executor import CUDAPlace, Executor, Scope, scope_guard

        exe = Executor(place if place is not None else CUDAPlace(0))
        scope = Scope()
        with scope_guard(scope):
            program, feed_names, fetch_vars = \
                fluid_io.load_inference_model(
                    dirname, exe, model_filename=model_filename,
                    params_filename=params_filename)
        block = program.global_block()
        specs = {}
        for n in feed_names:
            v = block.var(n)
            shape = tuple(v.shape or ())
            if not shape or shape[0] not in (-1, None):
                raise ServingError(
                    "feed %r has shape %s — serving needs a variable "
                    "leading batch dim (shape[0] == -1); pass "
                    "feed_specs= explicitly to override" % (n, shape))
            sample = tuple(int(d) for d in shape[1:])
            if any(d < 0 for d in sample):
                raise ServingError(
                    "feed %r has non-leading dynamic dims %s — the "
                    "bucket ladder only pads the batch dim; pass "
                    "feed_specs= with concrete trailing dims"
                    % (n, shape))
            specs[n] = (sample, v.dtype)
        return cls(program, feed_specs=specs, fetch_list=fetch_vars,
                   scope=scope, executor=exe, **kwargs)

    # -- admission ---------------------------------------------------------
    def _draining(self):
        return self._closed.is_set() or preemption.stop_requested()

    def submit(self, feed):
        """Admit one request; returns a ``concurrent.futures.Future``
        resolving to the list of per-fetch numpy arrays (this request's
        rows only — padding and co-batched requests sliced away).

        ``feed`` is a dict ``{name: [rows, *sample_shape] array}`` or a
        positional sequence following ``self.feed_names``.  All feeds must
        agree on the leading row count; 1 <= rows <= the largest bucket.
        Raises :class:`ServingRejectedError` on backpressure / over-size /
        draining — the request was not accepted.

        The future supports client-side ``cancel()`` while the request
        is still queued: a cancelled request is dropped at dispatch
        time instead of computed; once dispatch claims it, ``cancel()``
        returns False and the result arrives normally."""
        if self._failure is not None:
            raise ServingError(
                "serving executor failed: %s" % (self._failure,)) \
                from self._failure
        feeds, rows = self._validate(feed)
        if rows > self.buckets[-1]:
            self._n_rejects += 1
            _m_rejects.inc(reason="too_large")
            raise ServingRejectedError(
                "request rows %d exceed the largest bucket %d — raise "
                "max_batch/FLAGS_serving_buckets or split the request"
                % (rows, self.buckets[-1]))
        fut = concurrent.futures.Future()
        req = _Request(feeds, rows, fut)
        with self._lock:
            if self._admission_closed or self._draining():
                self._n_rejects += 1
                _m_rejects.inc(reason="closed")
                raise ServingClosedError(
                    "serving executor is draining (close() or a "
                    "preemption stop) — admission is closed")
            if self._pending >= self._max_queue:
                self._n_rejects += 1
                _m_rejects.inc(reason="queue_full")
                raise ServingRejectedError(
                    "serving queue full (%d queued >= max_queue=%d) — "
                    "backpressure; shed or retry"
                    % (self._pending, self._max_queue))
            self._pending += 1
            self._n_requests += 1
            _m_requests.inc()
            _m_depth.set(self._pending)
            # put under the lock: the scheduler's final sweep takes the
            # same lock before closing admission, so a request that
            # passed the checks above is visible to the sweep
            self._queue.put(req)
        self._ensure_threads()
        return fut

    def infer(self, feed, timeout=None):
        """Synchronous convenience: ``submit(feed).result(timeout)``."""
        return self.submit(feed).result(timeout)

    def _validate(self, feed):
        if not isinstance(feed, dict):
            vals = list(feed)
            if len(vals) != len(self.feed_names):
                raise ServingError(
                    "positional request has %d arrays, program feeds "
                    "are %s" % (len(vals), self.feed_names))
            feed = dict(zip(self.feed_names, vals))
        feeds, rows = {}, None
        for n, (sample, dtype) in self._specs.items():
            if n not in feed:
                raise ServingError(
                    "request is missing feed %r (program feeds: %s)"
                    % (n, self.feed_names))
            arr = np.asarray(feed[n])
            if arr.dtype != dtype:
                arr = arr.astype(dtype)
            if arr.ndim != len(sample) + 1 or \
                    tuple(arr.shape[1:]) != sample:
                raise ServingError(
                    "feed %r must be [rows%s] of %s, got shape %s"
                    % (n, "".join(", %d" % d for d in sample), dtype,
                       arr.shape))
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise ServingError(
                    "request feeds disagree on the row count: %r has "
                    "%d rows, %r has %d" % (self.feed_names[0], rows,
                                            n, arr.shape[0]))
            feeds[n] = arr
        if not rows:
            raise ServingError("request must carry at least one row")
        return feeds, rows

    # -- warmup ------------------------------------------------------------
    def _ready_event(self):
        """CUDA event after everything this thread enqueued on the
        executor's device, or None on the CPU."""
        device = self._exe.device
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def warmup(self, ledger=False):
        """Run every bucket once (zero-filled feeds, outputs discarded) so
        each bucket's dispatch plan, cuBLAS heuristics and kernel builds
        happen before traffic.  Returns ``{bucket: seconds}`` (each run
        waited to its end).  Call before serving traffic — warmup
        dispatches on the caller's thread and does not count as a
        recompile.

        ``ledger=True`` also captures one device-cost ledger record per
        bucket (``Executor.cost_record``, tagged ``serving:b<bucket>``,
        kept in ``ledger_records``): the per-bucket FLOPs and memory
        ladder.  A no-op when ``FLAGS_cost_ledger=0``."""
        if self._scheduler_thread is not None:
            raise ServingError(
                "warmup() must run before serving traffic — the "
                "scheduler thread is already dispatching")
        times = {}
        for b in self.buckets:
            feeds = {n: np.zeros((b,) + sample, dtype)
                     for n, (sample, dtype) in self._specs.items()}
            t0 = time.perf_counter()
            fetches = self._exe.run(self._program, feed=feeds,
                                    fetch_list=self._fetch_list,
                                    scope=self._scope,
                                    return_numpy=False)
            self._check_fetch_dims(fetches, b)
            ev = self._ready_event()
            if ev is not None:
                ev.synchronize()
            times[b] = time.perf_counter() - t0
            if ledger:
                rec = self._exe.cost_record(
                    self._program, feed=feeds, fetch_list=self._fetch_list,
                    scope=self._scope, tag="serving:b%d" % b)
                if rec is not None:
                    self.ledger_records[b] = rec
        self._warmed = True
        return times

    def _check_fetch_dims(self, fetches, bucket):
        for i, f in enumerate(fetches):
            shape = tuple(f.shape)
            if not shape or shape[0] != bucket:
                name = self._fetch_list[i]
                name = getattr(name, "name", name)
                raise ServingError(
                    "fetch %r has shape %s for bucket %d — serving "
                    "fetches must be per-row ([batch, ...]) so each "
                    "request's rows can be sliced out; fetch the "
                    "per-row tensor, not a batch reduction"
                    % (name, shape, bucket))

    # -- scheduler / completion threads ------------------------------------
    def _ensure_threads(self):
        if self._scheduler_thread is not None:
            return
        with self._lock:
            if self._scheduler_thread is not None:
                return
            self._scheduler_thread = threading.Thread(
                target=self._scheduler, name="serving-scheduler",
                daemon=True)
            self._completion_thread = threading.Thread(
                target=self._completer, name="serving-completion",
                daemon=True)
            self._scheduler_thread.start()
            self._completion_thread.start()

    def _bucket_for(self, rows):
        for b in self.buckets:
            if b >= rows:
                return b
        return self.buckets[-1]

    def _scheduler(self):
        """Pack the request queue into padded buckets, continuously:
        block (stop-aware) for the first request, hold the batch open
        for up to ``max_wait_ms`` while more arrive, dispatch the
        moment it fills the largest bucket — then immediately start
        forming the next batch while the device computes this one."""
        carry, batch, leftovers = None, [], []
        try:
            while True:
                if carry is not None:
                    req, carry = carry, None
                else:
                    req = stop_aware_get(self._queue, poll_s=0.05,
                                         stopping=self._idle_poll)
                    if req is QUEUE_DRAINED:
                        break
                batch, rows = [req], req.rows
                top = self.buckets[-1]
                deadline = time.perf_counter() + self._max_wait_s
                while rows < top:
                    if self._draining():
                        # drain mode: no latency budget — pack whatever
                        # is already queued and go
                        try:
                            nxt = self._queue.get_nowait()
                        except queue.Empty:
                            break
                    else:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        try:
                            nxt = self._queue.get(
                                timeout=min(left, 0.05))
                        except queue.Empty:
                            continue    # re-check deadline / drain flip
                    if rows + nxt.rows > top:
                        carry = nxt     # head of the NEXT batch
                        break
                    batch.append(nxt)
                    rows += nxt.rows
                self._dispatch_batch(batch)
                batch = []    # dispatched (or answered) — the crash
                #               handler must not re-resolve in-flight
                #               futures and race the completion thread
            # final sweep: close admission under the lock (no submit can
            # slip past it — see submit()), then answer everything that
            # landed before the door shut
            with self._lock:
                self._admission_closed = True
            if carry is not None:
                leftovers.append(carry)
                carry = None    # owned by leftovers now
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            while leftovers:
                batch, rows = [], 0
                while leftovers and \
                        rows + leftovers[0].rows <= self.buckets[-1]:
                    req = leftovers.pop(0)
                    batch.append(req)
                    rows += req.rows
                self._dispatch_batch(batch)
                batch = []
        except BaseException as e:
            self._failure = e
            # close admission FIRST (same lock protocol as the clean
            # sweep) so no submit can land an unanswerable request after
            # the drain below, then answer every popped-but-undispatched
            # request and everything still queued — a scheduler crash
            # must never leave a client parked on fut.result()
            with self._lock:
                self._admission_closed = True
            stranded = batch + leftovers
            if carry is not None:
                stranded.append(carry)
            for r in stranded:
                self._fail_request(r, e)
            if stranded:
                with self._lock:
                    self._pending -= len(stranded)
            self._fail_queued(e)
        finally:
            self._done.put(None)     # completion thread's end sentinel

    def _idle_poll(self):
        """The scheduler's empty-queue poll (stop_aware_get consults it
        each timeout, besides the preemption flag).  An idle server is
        alive, not hung: stamp watchdog progress."""
        telemetry.record_progress("serving_idle")
        return self._closed.is_set()

    def _dispatch_batch(self, batch):
        """Pad to the smallest fitting bucket and dispatch ONE async
        executor call for the whole batch; hand the live fetches and the
        batch's ready event to the completion thread.  Never raises and
        never orphans: every request leaves answered, dropped-as-
        cancelled, or in flight, with its ``_pending`` slot released
        exactly once."""
        if not batch:
            return
        admitted = len(batch)
        released = False    # the batch's _pending slots, freed ONCE
        try:
            # the cancellation fence: claim every future before
            # computing.  set_running_or_notify_cancel() returns False
            # for a future the client cancelled while queued — drop
            # that request — and True pins the future RUNNING so a later
            # cancel() can never race the completion thread's set_result
            live = [r for r in batch
                    if r.future.set_running_or_notify_cancel()]
            self._n_cancelled += admitted - len(live)
            if admitted > len(live):
                _m_cancelled.inc(admitted - len(live))
            batch = live    # the except path must not re-handle
            #                 futures the completed fence dropped
            if not batch:
                with self._lock:
                    self._pending -= admitted
                released = True
                _m_depth.set(self._pending)
                return
            rows = sum(r.rows for r in batch)
            bucket = self._bucket_for(rows)
            pad = bucket - rows
            feeds = {}
            for n, (sample, dtype) in self._specs.items():
                parts = [r.feeds[n] for r in batch]
                if pad:
                    parts.append(np.zeros((pad,) + sample, dtype))
                feeds[n] = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
            t0 = time.perf_counter()
            c0 = self._exe.compile_count()
            fetches = self._exe.run(self._program, feed=feeds,
                                    fetch_list=self._fetch_list,
                                    scope=self._scope,
                                    return_numpy=False)
            ready = self._ready_event()
            compiled = self._exe.compile_count() - c0
            if compiled and self._warmed:
                # the pinned contract: stays 0 forever after warmup()
                self._n_recompiles += compiled
                _m_recompiles.inc(compiled)
            for r in batch:
                r.t_dispatch = t0
            with self._lock:
                self._pending -= admitted
            released = True
            _m_depth.set(self._pending)
            self._n_batches += 1
            self._n_rows += rows
            self._n_padded += pad
            self._occ_sum += rows / float(bucket)
            _m_batches.inc(bucket=bucket)
            _m_padded_rows.inc(pad)
            _m_occupancy.set(round(rows / float(bucket), 4))
            self._done.put(_Dispatched(batch, rows, bucket, fetches, ready))
        except BaseException as e:
            # the batch has NOT reached the completion thread —
            # _done.put is the try's last statement — so claimed and
            # still-pending futures take the exception here
            _m_errors.inc()
            for r in batch:
                self._fail_request(r, e)
            if not released:
                with self._lock:
                    self._pending -= admitted

    def _completer(self):
        """Wait for each dispatched batch's event, copy its outputs to
        the host (the only blocking device reads in the pipeline — off
        the scheduler's path, so packing batch N+1 overlaps batch N's
        device compute) and fulfill per-request futures with
        padding-free slices."""
        while True:
            item = self._done.get()   # scheduler ALWAYS puts the None
            if item is None:          # sentinel before exiting
                break
            try:
                if item.ready is not None:
                    item.ready.synchronize()
                arrays = [to_numpy(f) for f in item.fetches]
            except BaseException as e:
                _m_errors.inc()
                for r in item.batch:
                    _resolve(r.future, e)
                continue
            t_done = time.perf_counter()
            _m_compute.observe(t_done - item.batch[0].t_dispatch)
            off = 0
            for r in item.batch:
                outs = [a[off:off + r.rows].copy() for a in arrays]
                off += r.rows
                _m_queue_wait.observe(r.t_dispatch - r.t_submit)
                if _resolve(r.future, None, outs):
                    self._n_responses += 1
                    _m_responses.inc()

    def _fail_request(self, req, exc):
        """Answer one request with ``exc``; a request the client
        cancelled first folds into the cancelled count instead."""
        if not _resolve(req.future, exc) and req.future.cancelled():
            self._n_cancelled += 1
            _m_cancelled.inc()

    def _fail_queued(self, exc):
        drained = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            drained += 1
            self._fail_request(req, exc)
        if drained:
            with self._lock:
                self._pending -= drained
            _m_depth.set(self._pending)

    # -- shutdown ----------------------------------------------------------
    def close(self, timeout=60.0):
        """Graceful drain: stop admission, answer every accepted
        request, join both threads, flush metrics.  Idempotent; also the
        preemption path — a stop request flips the scheduler into drain
        mode on its own, and ``close()`` then joins and records the
        drain (``preemption.record_drain(source="serving")``).

        Raises :class:`ServingError` if the drain does not finish
        within ``timeout`` — a wedged thread must NOT be reported as a
        clean drain."""
        t0 = time.perf_counter()
        was_stop = preemption.stop_requested()
        self._closed.set()
        sched = self._scheduler_thread
        if sched is not None:
            # one budget across BOTH joins, so close(timeout=T) blocks
            # at most ~T — not 2T — before reporting the wedge
            deadline = t0 + timeout
            sched.join(timeout=timeout)
            self._completion_thread.join(
                timeout=max(0.0, deadline - time.perf_counter()))
            stuck = [t.name for t in (sched, self._completion_thread)
                     if t.is_alive()]
            if stuck:
                raise ServingError(
                    "drain did not finish within %.1fs (%s still "
                    "alive, %d requests pending); call close() again "
                    "to retry" % (timeout, ", ".join(stuck), self._pending))
        _m_depth.set(0)
        if was_stop:
            # the serving analogue of the training drain record:
            # requests answered instead of steps, nothing to checkpoint
            preemption.record_drain(
                step=self._n_responses,
                dur_ns=int((time.perf_counter() - t0) * 1e9),
                saved=False, source="serving")
        telemetry.close_jsonl()
        if self._failure is not None:
            raise ServingError(
                "serving executor failed during drain: %s"
                % (self._failure,)) from self._failure

    def drained(self):
        """True once the scheduler exited with everything answered."""
        t = self._scheduler_thread
        return t is None or not t.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection -----------------------------------------------------
    def stats(self):
        """Per-instance counters: requests/responses/rejects/cancelled,
        batches/rows/padded_rows, mean occupancy, recompiles-after-warmup
        (new dispatch plans built by queued dispatches), live queue depth,
        and the resolved bucket ladder."""
        n = self._n_batches
        return {
            "requests": self._n_requests,
            "responses": self._n_responses,
            "rejects": self._n_rejects,
            "cancelled": self._n_cancelled,
            "recompiles": self._n_recompiles,
            "batches": n,
            "rows": self._n_rows,
            "padded_rows": self._n_padded,
            "occupancy_mean": round(self._occ_sum / n, 4) if n else None,
            "queue_depth": self._pending,
            "buckets": list(self.buckets),
            "warmed": self._warmed,
        }
