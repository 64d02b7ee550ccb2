"""PyReader / DataLoader: the host input pipeline with device prefetch
(counterpart ``paddle_tpu/fluid/reader.py``; reference
``python/paddle/fluid/reader.py`` over the C++ ``LoDTensorBlockingQueue``
and ``operators/reader/buffered_reader.cc``).

Two modes, as in the reference:

- ``iterable=True``: ``for data in loader(): exe.run(feed=data)``;
- ``iterable=False``: ``loader.start(); exe.run()`` — the executor pulls
  batches from the loader bound to the program and raises
  ``fluid.core.EOFException`` when the pass ends.

Staging on the card (:class:`CardStager`, the counterpart of the JAX
package's ``jax.device_put`` from the producer thread): the producer
copies each feed array into a **pinned** host buffer, copies that buffer
to the device with ``non_blocking=True`` on a side ``torch.cuda.Stream``
and records an event there.  The consumer makes its compute stream wait
on the event and calls ``record_stream`` on the device tensors, so the
caching allocator does not hand their memory out again while compute
reads them.  The copy reads the pinned buffer after the call that
issued it has returned, so a pinned buffer goes back to the pool with
its copy's event and is handed out again only once that event has
completed (``_gate``) — the JAX ring's "free the slot on the next pull"
would let a refill overwrite a copy still in flight.

``FLAGS_feed_ring_depth`` (default 2) picks the pipeline: ``depth >= 1``
is :class:`FeedRing`, a producer thread staging up to ``depth`` windows
ahead; ``0`` is the synchronous one-batch lookahead on the consumer's
thread with plain (pageable) copies — the same values, the A/B control.
"""

import queue
import threading
import time
import warnings

import numpy as np
import torch

from . import framework
from . import preemption
from . import telemetry
from .core import EOFException
from .data_feeder import DataFeeder
from .executor import device_for_place, prefetch_ahead

# input-pipeline telemetry (the JAX package's names): batches produced by
# the loader tier, plus the starvation record — how long the consumer
# blocked waiting for the producer
_m_loader_batches = telemetry.counter(
    "loader_batches_total", "feed dicts produced by DataLoader/PyReader")
_m_wait_s = telemetry.counter(
    "data_wait_seconds_total",
    "seconds the consumer blocked on the DataLoader queue")
_m_wait_last = telemetry.gauge(
    "data_wait_last_seconds", "most recent consumer wait (starvation)")
_m_wait_hist = telemetry.histogram(
    "data_wait_seconds",
    "consumer wait for the next ready feed (starvation distribution)",
    buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0))
_m_ring_occ = telemetry.gauge(
    "feed_ring_occupancy",
    "device-resident feed windows ready in the ring (0..depth)")
_m_overlap = telemetry.gauge(
    "h2d_overlap_frac",
    "fraction of feed staging wall time (host fill + H2D issue) hidden "
    "under consumer compute; 1.0 = fully overlapped")
_m_ring_windows = telemetry.counter(
    "feed_ring_windows_total",
    "feed windows staged device-side by feed-ring producer threads")
_m_pinned = telemetry.counter(
    "feed_pinned_copies_total",
    "feed windows copied to the card from pinned staging buffers on a "
    "side stream")


def _record_wait(wait, pending=True):
    """One consumer starvation sample: counter + last-gauge + histogram,
    plus (when ``pending``) the per-dispatch pool the executor drains
    into the next step-event's ``data_wait_s``.  End-of-stream waits
    pass ``pending=False``: no dispatch consumes them."""
    _m_wait_s.inc(wait)
    _m_wait_last.set(wait)
    _m_wait_hist.observe(wait)
    if pending:
        telemetry.record_data_wait(wait)


class DataLoaderWorkerError(RuntimeError):
    """A DataLoader producer died: re-raised to the consumer with
    batch-index and generator attribution."""


class _EndSentinel:
    """End-of-pass marker; carries the producer's exception, if any,
    plus the count of batches delivered before it died."""

    __slots__ = ("err", "batch_index")

    def __init__(self, err=None, batch_index=None):
        self.err = err
        self.batch_index = batch_index


def _reader_name(reader):
    return getattr(reader, "__qualname__", None) or \
        getattr(reader, "__name__", None) or repr(reader)


# sentinel: the queue drained under a stop request — distinct from any
# item a producer could legally enqueue (incl. None)
QUEUE_DRAINED = object()


def stop_aware_get(q, stopping=None, poll_s=0.1):
    """Pull one item from ``q`` without ever parking on a queue nobody
    will fill: poll with a bounded timeout, and give up once a stop is
    requested (``fluid.preemption`` or the extra ``stopping()``
    predicate) with the queue still empty.  One final non-blocking pull
    closes the timed-out-while-the-item-landed race.

    Returns the item, or :data:`QUEUE_DRAINED` when the wait ended on a
    stop with nothing queued.  Every consumer-side queue wait of the
    runtime goes through here (loaders, the feed ring, the serving
    scheduler)."""
    while True:
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            if preemption.stop_requested() or \
                    (stopping is not None and stopping()):
                try:
                    return q.get_nowait()
                except queue.Empty:
                    return QUEUE_DRAINED


class FeedRingError(RuntimeError):
    """Batch-index context for a feed-ring producer failure, attached as
    the ``__cause__`` of the producer's ORIGINAL exception (which the
    consumer re-raises); ``batch_index`` is the item being staged."""

    def __init__(self, msg, batch_index):
        super().__init__(msg)
        self.batch_index = batch_index


# ---------------------------------------------------------------------------
# Staging a host feed dict on the device
# ---------------------------------------------------------------------------

def _gate(event):
    """Block the calling (producer) thread until ``event`` — recorded
    after the H2D copy that reads a pinned buffer — has completed."""
    event.synchronize()


def _h2d(dst, src):
    """The side-stream copy of one pinned buffer into device memory."""
    dst.copy_(src, non_blocking=True)


class _PinnedPool:
    """Pinned host buffers keyed by (shape, dtype).  ``release`` takes a
    buffer back with the event of the copy that reads it; ``acquire``
    hands a free one out only after that event has completed."""

    _MAX_FREE_PER_KEY = 4   # ring depth + in-flight slack; bounds memory

    def __init__(self):
        self._free = {}
        self._lock = threading.Lock()

    def acquire(self, shape, dtype):
        key = (tuple(shape), dtype)
        with self._lock:
            lst = self._free.get(key)
            entry = lst.pop(0) if lst else None
        if entry is None:
            return torch.empty(key[0], dtype=dtype, pin_memory=True)
        buf, event = entry
        _gate(event)
        return buf

    def release(self, buf, event):
        key = (tuple(buf.shape), buf.dtype)
        with self._lock:
            lst = self._free.setdefault(key, [])
            if len(lst) < self._MAX_FREE_PER_KEY:
                lst.append((buf, event))


def _host_tensor(v):
    """A host feed value as a tensor (a tensor passes through)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class StagedFeed:
    """One feed dict staged on the card: device tensors whose copies
    were issued on a side stream, the event recorded after them, and the
    pinned buffers they read."""

    __slots__ = ("feed", "event", "pinned", "pool")

    def __init__(self, feed, event, pinned, pool):
        self.feed = feed
        self.event = event
        self.pinned = pinned
        self.pool = pool

    def consume(self):
        """The feed dict, ready for work queued on the current stream:
        that stream waits for the copies, and each tensor is marked used
        there (``record_stream``)."""
        if self.event is not None:
            dev = next(iter(self.feed.values())).device
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(self.event)
            for t in self.feed.values():
                if t.is_cuda:
                    t.record_stream(cur)
        return self.feed

    def release(self):
        """Return the pinned buffers to their pool, gated on the copies'
        event.  Called once the window that read them has been handed to
        the consumer and a later one is asked for."""
        pinned, self.pinned = self.pinned, ()
        for buf in pinned:
            self.pool.release(buf, self.event)


class CardStager:
    """Stages host feed dicts on one CUDA device.  ``__call__`` is the
    ring's producer-thread path (pinned buffer, ``non_blocking`` copy on
    a side stream, an event; returns a :class:`StagedFeed`); ``sync`` is
    the depth-0 path (plain copies on the caller's current stream;
    returns the dict)."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = _PinnedPool()

    def __call__(self, d):
        feed, pinned = {}, []
        with torch.cuda.stream(self.stream):
            for n, v in d.items():
                t = _host_tensor(v)
                if t.is_cuda:
                    feed[n] = t
                    continue
                buf = self.pool.acquire(t.shape, t.dtype)
                buf.copy_(t)
                dev = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                _h2d(dev, buf)
                feed[n] = dev
                pinned.append(buf)
            event = torch.cuda.Event()
            event.record(self.stream)
        if pinned:
            _m_pinned.inc()
        return StagedFeed(feed, event, pinned, self.pool)

    def sync(self, d):
        return {n: _host_tensor(v).to(self.device) for n, v in d.items()}


class HostStager:
    """The CPU counterpart of :class:`CardStager`: tensors that own
    their memory (never views of a reusable host staging buffer)."""

    def __call__(self, d):
        return {n: _host_tensor(v).clone() for n, v in d.items()}

    sync = __call__


def stager_for(device):
    """The stager of ``device`` (a torch.device)."""
    if device.type == "cuda":
        return CardStager(device)
    return HostStager()


class _LoaderStager:
    """Stages a loader's batches on its target device, read fresh for
    each batch: the explicit place, else the consuming executor's device
    once it has pulled (before that, host dicts pass through and the
    executor copies them at dispatch)."""

    def __init__(self, loader):
        self._loader = loader
        self._explicit = loader._device() \
            if loader._use_double_buffer else None

    def _for_target(self):
        loader = self._loader
        if not loader._use_double_buffer:
            return None
        dev = self._explicit if self._explicit is not None else \
            loader._consumer_device
        if dev is None:
            return None
        st = loader._stagers.get(dev)
        if st is None:
            st = loader._stagers[dev] = stager_for(dev)
        return st

    def __call__(self, d):
        st = self._for_target()
        return d if st is None else st(d)

    def sync(self, d):
        st = self._for_target()
        return d if st is None else st.sync(d)


class FeedRing:
    """Input ring: ``depth`` feed windows staged ahead of the consumer by
    a producer thread (the ``FLAGS_feed_ring_depth`` pipeline).

    The producer iterates ``batches`` (host feed dicts — per-step, or
    stacked ``[K, ...]`` windows from ``dataset.stack_batch_windows``)
    and applies ``put`` (a :class:`CardStager` on the card), so the
    host-side window fill and the H2D copy run off the consumer's
    critical path.  The consumer blocks only when the ring is empty
    (counted in the starvation gauge/histogram).

    Lifecycle contract:

    - a slot returns to the producer when the consumer asks for the NEXT
      window; the pinned buffers of the window handed out before go back
      to their pool then, gated on their copies' event (see the module
      docstring), and a host staging window (``stack_batch_windows``) is
      offered back to its pool;
    - a preemption stop request, an external ``stop_when`` predicate or
      ``close()`` drains the producer — it never stays parked on a full
      ring nobody will drain;
    - a producer exception surfaces on the consumer as the original
      exception with a :class:`FeedRingError` naming the batch index as
      its cause;
    - ``close()`` closes the source iterator and joins the producer.
    """

    def __init__(self, put, batches, depth, stop_when=None):
        self._put = put
        self._batches = batches
        self._depth = max(1, int(depth))
        self._stop_when = stop_when
        self._ready = queue.Queue()   # (staged, host) pairs + end sentinel
        self._slots = threading.Semaphore(self._depth)
        self._closed = threading.Event()
        self._out = None              # window handed out, freed on next pull
        self._staged_ready = 0        # real windows in _ready (gauge src)
        self._occ_lock = threading.Lock()
        self._stage_s = 0.0           # producer staging wall (fill + put)
        self._wait_s = 0.0            # consumer starvation wall
        self._thread = threading.Thread(
            target=self._producer, name="feed-ring-producer", daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _stopping(self):
        return (self._closed.is_set() or preemption.stop_requested() or
                (self._stop_when is not None and self._stop_when()))

    def _producer(self):
        err = None
        staged = 0
        it = iter(self._batches)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    host = next(it)
                except StopIteration:
                    break
                self._stage_s += time.perf_counter() - t0
                acquired = False
                while not self._stopping():
                    if self._slots.acquire(timeout=0.1):
                        acquired = True
                        break
                if not acquired:
                    return
                t0 = time.perf_counter()
                with telemetry.span("feed_stage"):
                    dev = self._put(host)
                self._stage_s += time.perf_counter() - t0
                # each window staged is forward progress of the input
                # pipeline (watchdog.py; no-op when disarmed)
                telemetry.record_progress("feed_ring")
                with self._occ_lock:
                    self._staged_ready += 1
                    occ = self._staged_ready
                self._ready.put((dev, host))
                _m_ring_windows.inc()
                _m_ring_occ.set(occ)
                staged += 1
        except BaseException as e:   # surfaced to the consumer
            err = e
        finally:
            close = getattr(self._batches, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            # the ready queue is unbounded (the semaphore is the bound),
            # so the sentinel can always land even mid-drain
            self._ready.put(_EndSentinel(err, batch_index=staged))

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def _recycle(self):
        """Free the previously handed-out window's slot and return its
        staging buffers to their pools."""
        out, self._out = self._out, None
        if out is None:
            return
        dev, host = out
        self._slots.release()
        if isinstance(dev, StagedFeed):
            dev.release()
            dev = dev.feed
        release = getattr(host, "release", None)
        if release is not None:
            release(dev if isinstance(dev, dict) else None)

    def __next__(self):
        self._recycle()
        # a consumer about to wait for its feed: the phase a stalled
        # input pipeline leaves the watchdog reading
        telemetry.record_progress("feed_wait")
        t0 = time.perf_counter()
        while True:
            if self._closed.is_set():
                raise StopIteration
            try:
                item = self._ready.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stopping():
                    raise StopIteration
        wait = time.perf_counter() - t0
        self._wait_s += wait
        _record_wait(wait, pending=not isinstance(item, _EndSentinel))
        telemetry.record_span("feed_wait", int(t0 * 1e9),
                              int(wait * 1e9))
        if isinstance(item, _EndSentinel):
            self._closed.set()
            _m_ring_occ.set(0)
            self._thread.join(timeout=5.0)
            if item.err is not None:
                raise item.err from FeedRingError(
                    "feed ring producer failed staging item %d (%d "
                    "item(s) staged; one item = one batch, or one "
                    "stacked [K, ...] window on windowed streams)"
                    % (item.batch_index, item.batch_index),
                    item.batch_index)
            raise StopIteration
        with self._occ_lock:
            self._staged_ready -= 1
            occ = self._staged_ready
        _m_ring_occ.set(occ)
        if self._stage_s > 0.0:
            _m_overlap.set(max(0.0, min(
                1.0, 1.0 - self._wait_s / self._stage_s)))
        self._out = item
        dev = item[0]
        return dev.consume() if isinstance(dev, StagedFeed) else dev

    def close(self):
        """Stop the producer, drop staged windows, join the thread.
        Idempotent.  Dropped windows are not recycled: the pinned host
        allocator keeps a buffer alive until the copies that read it
        have run."""
        self._closed.set()
        self._out = None
        try:
            while True:
                self._ready.get_nowait()
        except queue.Empty:
            pass
        with self._occ_lock:
            self._staged_ready = 0
        _m_ring_occ.set(0)
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def __del__(self):
        try:
            if not self._closed.is_set():
                self.close()
        except Exception:
            pass


class GeneratorLoader:
    def __init__(self, feed_list, capacity=8, use_double_buffer=True,
                 iterable=True, return_list=False, steps_per_run=None):
        from . import flags
        # K>1: stage K batches as ONE stacked [K, ...] array per slot
        # (dataset.stack_batch_windows); program-bound loaders then
        # route to Executor.run_window
        self._steps_per_run = 1 if steps_per_run is None else \
            flags.steps_per_run_value(steps_per_run)
        self._feed_list = feed_list
        self._names = [v.name if isinstance(v, framework.Variable) else v
                       for v in feed_list]
        self._capacity = capacity
        self._use_double_buffer = use_double_buffer
        self._iterable = iterable
        self._return_list = return_list
        self._gen = None
        self._src_name = None
        self._places = None
        self._queue = None
        self._thread = None
        self._stop_event = None
        self._ring = None
        self._stagers = {}
        # set by Executor.run on each program-bound pull: with no
        # explicit places, the producer stages later batches on the
        # CONSUMING executor's device
        self._consumer_device = None
        if not iterable:
            # non-iterable: bind to the current program so Executor.run can
            # pull batches (reference py_reader-in-program contract)
            framework.default_main_program()._loader = self

    # -- wiring ------------------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batcher():
            buf = []
            for sample in reader():
                if not isinstance(sample, (list, tuple)):
                    sample = (sample,)
                buf.append(sample)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf and not drop_last:
                yield buf
        self.set_sample_list_generator(batcher, places)
        self._src_name = _reader_name(reader)
        return self

    def set_sample_list_generator(self, reader, places=None):
        feeder = DataFeeder(self._feed_list)

        def to_feed():
            for samples in reader():
                yield feeder.feed(samples)
        self._gen = to_feed
        self._src_name = _reader_name(reader)
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        def to_feed():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield dict(zip(self._names, batch))
        self._gen = to_feed
        self._src_name = _reader_name(reader)
        self._places = places
        return self

    # -- device prefetch ---------------------------------------------------
    def _device(self):
        places = self._places
        if places:
            place = places[0] if isinstance(places, (list, tuple)) else places
            return device_for_place(place)
        return None

    def _stager(self):
        return _LoaderStager(self)

    def _source(self):
        src = self._gen()
        if self._steps_per_run > 1:
            from .dataset import stack_batch_windows
            src = stack_batch_windows(src, self._steps_per_run)
        return src

    def _prefetched(self, stop_when=None, depth=None):
        """Iterator of feed dicts staged ahead of consumption
        (executor.prefetch_ahead — the FLAGS_feed_ring_depth ring, or the
        one-batch lookahead at ``depth=0``)."""
        def counted(it):
            try:
                for d in it:
                    _m_loader_batches.inc()
                    yield d
            finally:
                # generator .close() must reach the ring so its
                # producer thread is joined, not leaked
                if hasattr(it, "close"):
                    it.close()

        return counted(prefetch_ahead(self._stager(), self._source(),
                                      depth=depth, stop_when=stop_when))

    # -- iterable protocol -------------------------------------------------
    def __call__(self):
        assert self._iterable, "non-iterable loader: use start()/reset()"
        assert self._gen is not None, "no generator set"
        if self._return_list:
            return ([d[n] for n in self._names] for d in self._prefetched())
        return self._prefetched()

    __iter__ = __call__

    # -- non-iterable (program-bound) protocol -----------------------------
    def start(self):
        """Start the producer.  At ``FLAGS_feed_ring_depth >= 1`` the
        feed ring's producer thread is the worker; at 0 a worker thread
        fills a ``capacity`` queue with host dicts, which the executor
        copies to the device at dispatch (the synchronous control)."""
        from . import flags
        assert not self._iterable
        self._stop_worker()   # a restart must not leak the previous producer
        if int(flags.get_flag("feed_ring_depth")) > 0:
            self._ring = FeedRing(self._stager(), self._source(),
                                  flags.get_flag("feed_ring_depth"))
            return
        q = queue.Queue(maxsize=self._capacity)
        stop = threading.Event()

        def worker(q=q, stop=stop):
            # a process-wide preemption stop request drains this
            # producer too: the consumer may never pull again
            def stopping():
                return stop.is_set() or preemption.stop_requested()

            err = None
            delivered = 0
            src = self._source()
            try:
                for d in src:
                    while not stopping():
                        try:
                            q.put(d, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stopping():
                        return
                    delivered += 1
            except BaseException as e:  # surfaced to the consumer
                err = e
            finally:
                if hasattr(src, "close"):
                    src.close()
            while not stopping():
                try:
                    q.put(_EndSentinel(err, batch_index=delivered),
                          timeout=0.1)
                    break
                except queue.Full:
                    continue

        self._queue = q
        self._stop_event = stop
        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="dataloader-worker")
        self._thread.start()

    def _stop_worker(self):
        ring, self._ring = self._ring, None
        if ring is not None:
            ring.close()
        thread = self._thread
        if thread is not None:
            self._stop_event.set()
            try:  # unblock a producer stuck in put()
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5.0)
            if thread.is_alive():
                warnings.warn(
                    "DataLoader worker still running after 5s; it will "
                    "exit after its current read. If the data source is "
                    "stateful (shared file handle), records may be lost.")
        self._thread = None
        self._queue = None
        self._stop_event = None

    def reset(self):
        self._stop_worker()

    def _worker_error(self, err, index):
        return DataLoaderWorkerError(
            "DataLoader worker failed around batch %s (%d batch(es) "
            "delivered; feed vars %s; generator %s): %s: %s"
            % (index, index or 0, self._names, self._src_name or "<unset>",
               type(err).__name__, err))

    def next_feed(self):
        """Called by Executor.run when no explicit feed is given."""
        if self._ring is not None:
            return self._next_from_ring()
        if self._queue is None:
            raise RuntimeError(
                "DataLoader not started: call loader.start() before "
                "exe.run() (reference PyReader contract)")
        telemetry.record_progress("feed_wait")
        t0 = time.perf_counter()
        item = stop_aware_get(self._queue)
        if item is QUEUE_DRAINED:
            self._queue = self._thread = self._stop_event = None
            raise EOFException(
                "preemption stop requested: DataLoader drained")
        wait = time.perf_counter() - t0
        _record_wait(wait, pending=not isinstance(item, _EndSentinel))
        if isinstance(item, _EndSentinel):
            self._queue = self._thread = self._stop_event = None
            if item.err is not None:
                raise self._worker_error(item.err, item.batch_index) \
                    from item.err
            raise EOFException(
                "pass end: there is no data in the DataLoader queue")
        return item

    def _next_from_ring(self):
        ring = self._ring
        try:
            return next(ring)
        except StopIteration:
            self._ring = None
            ring.close()
            raise EOFException(
                "pass end: there is no data in the DataLoader ring")
        except Exception as e:
            self._ring = None
            ring.close()
            cause = e.__cause__
            index = getattr(cause, "batch_index", None)
            raise self._worker_error(e, index) from e


class DataLoader:
    """``fluid.io.DataLoader.from_generator`` facade (reference reader.py)."""

    @staticmethod
    def from_generator(feed_list=None, capacity=8, use_double_buffer=True,
                       iterable=True, return_list=False, steps_per_run=None):
        return GeneratorLoader(feed_list, capacity=capacity,
                               use_double_buffer=use_double_buffer,
                               iterable=iterable, return_list=return_list,
                               steps_per_run=steps_per_run)


class PyReader(GeneratorLoader):
    """Reference fluid.io.PyReader — GeneratorLoader with the decorate_*
    method names."""

    def __init__(self, feed_list=None, capacity=8, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(feed_list, capacity=capacity,
                         use_double_buffer=use_double_buffer,
                         iterable=iterable, return_list=return_list)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last=drop_last, places=places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places=places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places=places)
