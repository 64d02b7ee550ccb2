"""Dataset / DataFeed tier: file-driven training input (counterpart
``paddle_tpu/fluid/dataset.py``).

Reference contract: ``python/paddle/fluid/dataset.py`` (DatasetFactory,
InMemoryDataset/QueueDataset), C++ ``framework/data_set.h:40``
DatasetImpl, ``framework/data_feed.h:475`` MultiSlotDataFeed (text slot
parsing) and ``framework/executor.cc:120`` RunFromDataset, driven from
Python by ``Executor.train_from_dataset``.  Reader threads parse shards
into batches; the executor streams them through the input pipeline
(``reader.FeedRing``).  Variable-length (lod_level>=1) slots become
padded arrays plus a ``<name>@len`` companion feed, as in the JAX
package.

Files are MultiSlot text: one instance per line, per slot in use_var
order: ``<count> <count values...>`` (data_feed.cc contract), parsed in
Python (the JAX package's fallback parser).  Not ported yet, both
needing ``paddle_tpu/native`` (ROADMAP queue 1 item 14): ``*.recordio``
shards, which raise ``NotImplementedError``, and the native line parser.
"""

import queue as _queue
import random
import subprocess
import threading
import zlib

import numpy as np

from . import preemption
from . import telemetry
from .data_types import np_dtype

# dataset-tier telemetry (docs/observability.md)
_m_ds_batches = telemetry.counter(
    "dataset_batches_total", "batches assembled by the Dataset tier")
_m_flushes = telemetry.counter(
    "window_flushes_total",
    "stacked K-step windows emitted, by reason "
    "(full | shape_change | trailing)")


def stack_feed_dicts(feed_dicts):
    """Stack K consecutive per-step feed dicts into ONE window feed:
    every slot becomes a ``[K, per-step shape...]`` array — the host-side
    staging step of the multi-step fused training loop
    (``Executor.run_window``), so a whole window moves host→device as
    one transfer per slot.  All dicts must share keys and per-step
    shapes (one window plan per signature); a mismatch
    raises naming the slot (``stack_batch_windows`` flushes windows at
    shape changes so it never trips this)."""
    out = {}
    for k in feed_dicts[0]:
        vals = [np.asarray(d[k]) for d in feed_dicts]
        shapes = {v.shape for v in vals}
        if len(shapes) > 1:
            raise ValueError(
                "steps_per_run window cannot stack slot %r: per-step "
                "shapes differ (%s) — every step of one fused window "
                "must share a static shape (drop_last=True, or let "
                "stack_batch_windows split the window at the shape "
                "change)" % (k, sorted(shapes)))
        out[k] = np.stack(vals)
    return out


class _StagingPool:
    """Reusable host staging buffers for the streaming window fill.

    ``acquire`` hands out a ``[K, per-step shape...]`` buffer (recycled
    when one is free, else freshly allocated); ``release`` returns one
    for reuse.  Reuse is only ever attempted through
    ``_StagedWindow.release``, which proves the buffer is safe to
    overwrite first (no staged tensor shares its memory)."""

    _MAX_FREE_PER_KEY = 4   # ring depth + in-flight slack; bounds memory

    def __init__(self):
        self._free = {}
        self._lock = threading.Lock()

    def acquire(self, key, shape, dtype):
        with self._lock:
            lst = self._free.get(key)
            if lst:
                return lst.pop()
        return np.empty(shape, dtype)

    def release(self, key, buf):
        with self._lock:
            lst = self._free.setdefault(key, [])
            if len(lst) < self._MAX_FREE_PER_KEY:
                lst.append(buf)


def _staging_reusable(base, dev):
    """True when host buffer ``base`` may be overwritten given that
    ``dev`` was staged from (a view of) it: ``dev`` must be a tensor
    that does not share its memory (a card tensor never does — the
    stager copied the host values into its own pinned buffer before
    returning; a CPU stager clones).  Unprovable → False."""
    import torch
    if not isinstance(dev, torch.Tensor):
        return False
    if dev.is_cuda:
        return True
    start = base.ctypes.data
    end = start + base.nbytes
    return not start <= dev.data_ptr() < end


class _StagedWindow(dict):
    """One stacked ``[k, ...]`` window feed whose slot arrays live in
    (views of) pool-owned staging buffers.  The feed-ring consumer calls
    ``release(device_map)`` once the dispatch consuming the window has
    been enqueued; each staging buffer returns to the pool only when
    ``_staging_reusable`` proves overwriting it cannot corrupt the
    device-side copy."""

    def attach(self, pool, bases, keys):
        self._pool = pool
        self._bases = bases      # slot name -> owning staging buffer
        self._keys = keys        # slot name -> pool key
        return self

    def release(self, device_map=None):
        pool = getattr(self, "_pool", None)
        if pool is None:
            return
        for name, base in self._bases.items():
            dev = (device_map or {}).get(name)
            if dev is not None and _staging_reusable(base, dev):
                pool.release(self._keys[name], base)
        self._pool = None


def stack_batch_windows(batches, steps_per_run, staging=None):
    """Group a stream of per-step feed dicts into stacked ``[K, ...]``
    windows (the ``stack_feed_dicts`` layout) by STREAMING each incoming
    batch straight into a reusable host staging buffer — one copy per
    sample instead of the buffer-K-dicts-then-``np.stack`` double
    materialization, and the per-step arrays are released as they land.

    Windows are flushed early when a batch's per-slot shapes/dtypes
    differ from the window under construction (the ragged last batch of
    a drop_last=False epoch), and the trailing partial window is yielded
    with its smaller leading dim — every sample is consumed, every
    window stays static-shaped, and the consumer runs short windows as
    shorter scans.  Yielded windows are ``_StagedWindow`` dicts; a
    feed-ring consumer recycles their staging buffers via
    ``release()``, any other consumer just lets them be garbage."""
    K = int(steps_per_run)
    pool = staging if staging is not None else _StagingPool()
    sig = bufs = keys = None
    filled = 0

    def flush(reason):
        _m_flushes.inc(reason=reason)
        win = _StagedWindow(
            (n, b if filled == K else b[:filled]) for n, b in bufs.items())
        return win.attach(pool, dict(bufs), dict(keys))

    for b in batches:
        b = {n: np.asarray(v) for n, v in b.items()}
        bsig = {n: (v.shape, v.dtype) for n, v in b.items()}
        if filled and bsig != sig:
            yield flush("shape_change")
            bufs, filled = None, 0
        if bufs is None:
            sig = bsig
            # the pool key is the FULL buffer signature incl. K: a pool
            # shared across generators with different steps_per_run must
            # never hand a larger-K buffer to a smaller-K fill (flush
            # would yield stale rows from the other stream)
            keys = {n: (n, (K,) + v.shape, str(v.dtype))
                    for n, v in b.items()}
            bufs = {n: pool.acquire(keys[n], (K,) + v.shape, v.dtype)
                    for n, v in b.items()}
        for n, v in b.items():
            bufs[n][filled] = v
        filled += 1
        if filled == K:
            yield flush("full")
            bufs, filled = None, 0
    if filled:
        yield flush("trailing")


class DatasetFactory:
    """Reference dataset.py:21 — create datasets by class name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "FileInstantDataset":
            return FileInstantDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)


class DatasetBase:
    """Reference dataset.py:63 — config carrier + batch source."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist = []
        self.use_vars = []
        self.pipe_command = "cat"
        self.drop_last = False
        self._hdfs_name = self._hdfs_ugi = None

    # -- configuration (reference setter names kept verbatim) -------------
    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_drop_last(self, drop_last):
        """Drop the trailing partial batch so every step has one shape
        (one dispatch plan)."""
        self.drop_last = bool(drop_last)

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs_name, self._hdfs_ugi = fs_name, fs_ugi

    def _prepare_to_run(self):
        if not self.use_vars:
            raise RuntimeError("dataset.set_use_var(...) was never called")
        if not self.filelist:
            raise RuntimeError("dataset.set_filelist(...) was never called")

    def _finish_to_run(self):
        pass

    def desc(self):
        """Debug-readable config (reference returns the protobuf text)."""
        return ("batch_size: %d\nthread_num: %d\npipe_command: %r\n"
                "files: %r\nslots: %r" %
                (self.batch_size, self.thread_num, self.pipe_command,
                 self.filelist, [v.name for v in self.use_vars]))

    # -- instance parsing --------------------------------------------------
    def _slot_spec(self):
        """[(name, np dtype, per-instance dense size or None-if-variable)]"""
        spec = []
        for v in self.use_vars:
            fixed = None
            if getattr(v, "lod_level", 0) == 0:
                shape = [d for d in v.shape if d != -1]
                fixed = int(np.prod(shape)) if shape else 1
            spec.append((v.name, np_dtype(v.dtype), fixed))
        return spec

    def _file_lines(self, path):
        """Lines of a text shard, optionally piped through pipe_command
        (data_feed pipe reader contract, e.g. 'zcat')."""
        if self.pipe_command and self.pipe_command != "cat":
            with open(path, "rb") as f:
                proc = subprocess.run(
                    self.pipe_command, shell=True, stdin=f,
                    stdout=subprocess.PIPE, check=True)
            for ln in proc.stdout.decode().splitlines():
                if ln.strip():
                    yield ln
        else:
            with open(path) as f:
                for ln in f:
                    if ln.strip():
                        yield ln

    def _parse_text_line(self, line, spec):
        """MultiSlot: per slot ``<count> <values...>`` (data_feed.cc
        MultiSlotDataFeed::ParseOneInstance), in Python."""
        return self._parse_text_line_py(line, spec)

    def _parse_text_line_py(self, line, spec):
        toks = line.split()
        inst, pos = {}, 0
        for name, dtype, fixed in spec:
            if pos >= len(toks):
                raise ValueError("instance line ran out of tokens at slot "
                                 "%r: %r" % (name, line))
            n = int(toks[pos])
            pos += 1
            vals = np.asarray(toks[pos:pos + n], dtype=dtype)
            if len(vals) != n:
                raise ValueError("slot %r declares %d values, line has %d"
                                 % (name, n, len(vals)))
            pos += n
            if fixed is not None and n != fixed:
                raise ValueError(
                    "dense slot %r (shape size %d) got %d values; declare "
                    "the var with lod_level=1 for variable-length slots"
                    % (name, fixed, n))
            inst[name] = vals
        return inst

    def _parse_file(self, path, spec):
        """Yield instance dicts from one shard."""
        if path.endswith(".recordio"):
            raise NotImplementedError(
                "%r: recordio shards need the native recordio scanner, "
                "which is not ported yet (ROADMAP queue 1 item 14)" % path)
        for ln in self._file_lines(path):
            yield self._parse_text_line(ln, spec)

    # -- batching ----------------------------------------------------------
    def _batchify(self, insts, spec):
        """instances → feed dict; variable slots pad to the batch max and
        emit a ``<name>@len`` companion (padded+lengths replaces LoD)."""
        _m_ds_batches.inc()
        feed = {}
        for name, dtype, fixed in spec:
            vals = [np.asarray(i[name], dtype=dtype) for i in insts]
            if fixed is not None:
                var = next(v for v in self.use_vars if v.name == name)
                shape = [d for d in var.shape if d != -1]
                feed[name] = np.stack(vals).reshape([len(insts)] + shape)
            else:
                lens = np.asarray([v.size for v in vals], dtype=np.int64)
                # bucket the pad width to the next power of two: the
                # executor builds one plan per feed shape, so raw
                # per-batch max widths would build almost every batch;
                # buckets bound that to log2(maxlen) plans
                width = 1 << max(0, int(lens.max()) - 1).bit_length()
                pad = np.zeros((len(insts), width), dtype=dtype)
                for r, v in enumerate(vals):
                    pad[r, :v.size] = v.ravel()
                feed[name] = pad
                feed[name + "@len"] = lens.reshape(-1, 1)
        return feed

    def _iter_batches(self):
        raise NotImplementedError

    def __iter__(self):
        return self._iter_batches()


class QueueDataset(DatasetBase):
    """Streaming dataset (reference dataset.py:487): reader threads parse
    shards concurrently into a bounded queue; batches leave in arrival
    order.  No global view, so no shuffle (reference QueueDataset's
    local_shuffle is also a no-op there)."""

    def local_shuffle(self):
        raise RuntimeError(
            "QueueDataset does not support local_shuffle; use "
            "InMemoryDataset (reference dataset.py:507 contract)")

    def global_shuffle(self, fleet=None):
        raise RuntimeError(
            "QueueDataset does not support global_shuffle; use "
            "InMemoryDataset (reference dataset.py:526 contract)")

    def _iter_batches(self):
        self._prepare_to_run()
        spec = self._slot_spec()
        q = _queue.Queue(maxsize=max(64, 4 * self.batch_size))
        files = list(self.filelist)
        lock = threading.Lock()
        errors = []
        stop = threading.Event()

        def put(inst):
            # bounded put with a stop check so abandoned generators don't
            # park workers forever on a full queue (leaking the open
            # shard); a process-wide preemption stop request drains the
            # same way — the consumer is exiting and will never pull
            while not stop.is_set() and not preemption.stop_requested():
                try:
                    q.put(inst, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set() and not preemption.stop_requested():
                with lock:
                    if not files or errors:
                        break
                    path = files.pop(0)
                try:
                    for inst in self._parse_file(path, spec):
                        if not put(inst):
                            return
                except Exception as e:  # surface in the consumer
                    errors.append(e)
                    break

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.thread_num, len(files)) or 1)]
        for t in threads:
            t.start()

        def drain():
            while True:
                try:
                    yield q.get(timeout=0.05)
                except _queue.Empty:
                    if errors:
                        raise errors[0]
                    if not any(t.is_alive() for t in threads):
                        while True:  # flush what landed after last check
                            try:
                                yield q.get_nowait()
                            except _queue.Empty:
                                return

        try:
            batch = []
            for inst in drain():
                batch.append(inst)
                if len(batch) == self.batch_size:
                    yield self._batchify(batch, spec)
                    batch = []
            if errors:
                raise errors[0]
            if batch and not self.drop_last:
                yield self._batchify(batch, spec)
        finally:
            stop.set()


class InMemoryDataset(DatasetBase):
    """Reference dataset.py:224: load once, shuffle in memory, iterate."""

    def __init__(self):
        super().__init__()
        self._memory = None
        self._epoch_seed = 0

    def load_into_memory(self):
        self._prepare_to_run()
        spec = self._slot_spec()
        out, lock = [], threading.Lock()
        files = list(self.filelist)
        errors = []

        def worker():
            while True:
                with lock:
                    if not files or errors:
                        return
                    path = files.pop(0)
                try:
                    insts = list(self._parse_file(path, spec))
                except Exception as e:
                    errors.append(e)
                    return
                with lock:
                    out.extend(insts)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.thread_num, len(files)) or 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self._memory = out

    # preload_* (reference async load) — degenerate synchronous versions
    def preload_into_memory(self):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def release_memory(self):
        self._memory = None

    def get_memory_data_size(self, fleet=None):
        return len(self._memory or [])

    def local_shuffle(self):
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        rng = random.Random(self._epoch_seed)
        self._epoch_seed += 1
        rng.shuffle(self._memory)

    def global_shuffle(self, fleet=None):
        """Cross-trainer repartition + shuffle: each trainer keeps the
        instances hashing to its id (the RPC-exchange outcome of
        data_set.cc GlobalShuffle, computed locally — every trainer loads
        the full filelist and keeps its hash share)."""
        trainer_id, trainer_num = 0, 1
        if fleet is not None:
            trainer_id = fleet.worker_index()
            trainer_num = fleet.worker_num()
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        if trainer_num > 1:
            # crc32, NOT builtin hash(): partitions must agree across
            # trainer processes (hash() is salted per-process)
            def keep(inst):
                h = 0
                for k in sorted(inst):
                    h = zlib.crc32(np.ascontiguousarray(inst[k]).tobytes(),
                                   h)
                return h % trainer_num == trainer_id
            self._memory = [i for i in self._memory if keep(i)]
        self.local_shuffle()

    def get_shuffle_data_size(self, fleet=None):
        return len(self._memory or [])

    def _iter_batches(self):
        if self._memory is None:
            raise RuntimeError(
                "InMemoryDataset: call load_into_memory() before training")
        spec = self._slot_spec()
        n = len(self._memory)
        for i in range(0, n, self.batch_size):
            batch = self._memory[i:i + self.batch_size]
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self._batchify(batch, spec)


class FileInstantDataset(DatasetBase):
    """Reference dataset.py:547 — instant per-file reading, no queue tier.
    Single-threaded sequential scan; shuffle unsupported (parity)."""

    def local_shuffle(self):
        raise RuntimeError("FileInstantDataset does not support shuffle")

    def global_shuffle(self, fleet=None):
        raise RuntimeError("FileInstantDataset does not support shuffle")

    def _iter_batches(self):
        self._prepare_to_run()
        spec = self._slot_spec()
        batch = []
        for path in self.filelist:
            for inst in self._parse_file(path, spec):
                batch.append(inst)
                if len(batch) == self.batch_size:
                    yield self._batchify(batch, spec)
                    batch = []
        if batch and not self.drop_last:
            yield self._batchify(batch, spec)
