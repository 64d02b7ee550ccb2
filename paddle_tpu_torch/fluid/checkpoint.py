"""Fault-tolerant checkpointing (counterpart ``paddle_tpu/fluid/
checkpoint.py``, single process).

A job can be killed at any step, so every write boundary of a save
leaves the checkpoint directory recoverable:

- **Atomic saves**: a save writes ``step-<N>.tmp-<uuid>/`` (one ``.npy``
  per persistable and a ``MANIFEST.json`` with each tensor's shape,
  dtype, byte size and CRC32, all fsync'd), then one ``os.rename``
  commits it as ``step-<N>/`` (``storage.LocalStorage``), or the
  object-store backend writes a marker object last
  (``storage.ObjectStoreStorage``).  Readers never select a ``.tmp-*``
  directory, a torn one or a corrupt one.
- **Async saves** (``async_save=True``, the default): ``save()`` snapshots the
  scope to host memory on the calling thread (``Scope.snapshot``: pinned
  buffers, one device synchronisation), then serializes and commits on a
  background thread, at most one save in flight; a background error
  re-raises on the next ``save()`` or ``wait()``.
- **Auto-resume**: ``latest_checkpoint()`` returns the newest complete
  checkpoint; ``restore()`` is strict and two-phase (everything is read
  and checked before the scope changes) and puts ``scope.step_counter``
  back, so step-keyed dropout masks replay and a resumed run is step for
  step the uninterrupted one.
- **Fault points**: every write boundary calls ``_fault_point(name)``;
  ``set_fault_hook`` installs a hook there that tests use to kill, fail
  or stall a save at each point.

Files are the JAX package's: a checkpoint written by either package
restores into the other.  A bfloat16 tensor is written as its 2-byte
payload (``.npy`` descr ``<V2``) with ``"dtype": "bfloat16"`` in the
manifest, as ``paddle_tpu`` writes it.  ``paddle_tpu`` holds a declared
int64 (float64) variable in 32 bits and saves it so; the port widens
such an entry on restore.

- **Windows** (``steps_per_run=K``): ``Executor.run_window`` runs K
  steps per call, so state exists only at window boundaries; a save off
  the boundary marker the executor stamps (``scope._window_end``)
  raises, K goes into the manifest, and a restore under another K
  warns.
- **Instruments**: the in-flight gauge, the background-error counter
  and the commit-wait histogram of the JAX package, the profiler's
  checkpoint stats, and a watchdog deadline extension
  (``FLAGS_watchdog_checkpoint_grace_s``) around every save and restore.

Not here yet, each raising ``NotImplementedError`` with its ROADMAP
item: the multi-host save and restore and ``reshard=True`` (queue 1
item 10b).  Each manager also keeps the numbers of its last save
(``last_bytes``, ``last_save_s``, ``last_snapshot_ms``).

Single-writer assumption: one process (one ``CheckpointManager``) saves
into a given directory at a time.
"""

import atexit
import contextlib
import io as _io
import json
import os
import re
import shutil
import threading
import time
import uuid
import warnings
import weakref
import zlib

import numpy as np
import torch

from . import flags
from . import profiler
from . import storage as storage_mod
from . import telemetry
from . import watchdog
from .data_types import from_host, host_dtype_name, is_bf16_host, widens
from .executor import CUDAPlace, device_for_place, global_scope
from .framework import default_main_program

# async-save instruments (the JAX package's names, checkpoint.py:84-99);
# the executor's step events read the in-flight gauge as ckpt_overlap
_m_async_inflight = telemetry.gauge(
    "checkpoint_async_in_flight",
    "1 while an async checkpoint save is serializing/committing")
_m_async_errors = telemetry.counter(
    "checkpoint_async_errors_total",
    "background save failures (re-raised on next save()/wait())")
_m_commit_wait = telemetry.histogram(
    "checkpoint_commit_wait_seconds",
    "seconds a caller waited for an in-flight async save to commit")

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
_CKPT_PREFIX = "step-"
_TMP_MARK = ".tmp-"
_CKPT_RE = re.compile(r"^step-(\d+)$")


# ---------------------------------------------------------------------------
# Fault-injection points
# ---------------------------------------------------------------------------
# Every write boundary of a save calls _fault_point(<name>) so a hook can
# emulate SIGKILL (raise a BaseException), I/O failure (raise OSError) or
# a stall (block) exactly there.  Point names:
#   tensor:<var>_begin / _mid / _end     per-tensor file write
#   combine:<file>_begin / _mid / _end   npz / combined-params file
#   model:<file>_begin / _mid / _end     inference-model program file
#   opfile:<file>_begin / _mid / _end    save / save_combine op file
#   manifest_begin / _mid / _end         MANIFEST.json write
#   marker:<dir>_begin / _mid / _end     object-store commit marker
#   before_commit:<dir> / after_commit:<dir>   around the rename
#   after_gc:<dir>                       after retention GC
# Production runs install no hook; the call is a no-op.

_fault_hook = [None]


def set_fault_hook(hook):
    """Install ``hook(point_name)`` at every save write boundary; returns
    the previous hook (callers restore it)."""
    prev = _fault_hook[0]
    _fault_hook[0] = hook
    return prev


def _fault_point(name):
    hook = _fault_hook[0]
    if hook is not None:
        hook(name)


# ---------------------------------------------------------------------------
# Durable low-level writes
# ---------------------------------------------------------------------------

def _fsync_dir(path):
    """fsync a directory so a committed rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file(path, data, point):
    """Write ``data`` bytes to ``path`` with flush+fsync, firing fault
    points before, mid-write (so a kill leaves a *torn* file, the case
    validation must catch), and after."""
    _fault_point(point + "_begin")
    with open(path, "wb") as f:
        half = len(data) // 2
        f.write(data[:half])
        f.flush()
        _fault_point(point + "_mid")
        f.write(data[half:])
        f.flush()
        os.fsync(f.fileno())
    _fault_point(point + "_end")


def npy_bytes(arr):
    """``.npy`` bytes of a host array.  bf16 bits (``V2``) get the header
    numpy writes for ml_dtypes' bfloat16, descr ``'<V2'`` (``'|V2'`` has
    the same length, so the header's padding is unchanged)."""
    arr = np.asarray(arr)
    bio = _io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    data = bio.getvalue()
    if is_bf16_host(arr.dtype):
        data = data.replace(b"'descr': '|V2'", b"'descr': '<V2'", 1)
    return data


def write_array(path, arr, point=None):
    """Serialize ``arr`` to .npy bytes and durably write them; returns
    (crc32, nbytes) of the serialized stream."""
    data = npy_bytes(arr)
    write_file(path, data, point or ("tensor:" + os.path.basename(path)))
    return zlib.crc32(data) & 0xFFFFFFFF, len(data)


def write_file_atomic(path, data, point):
    """Publish a single file atomically: durable write to ``<path>.tmp-*``
    then ``os.replace`` + parent-dir fsync.  An ordinary I/O failure
    unlinks the tmp so repeated failures cannot accumulate debris; a kill
    (BaseException) leaves it, exactly as a real SIGKILL would.  Used by
    the ``save``/``save_combine`` program ops."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + _TMP_MARK + uuid.uuid4().hex[:8]
    try:
        write_file(tmp, data, point)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    _fsync_dir(parent)


def commit_dir(tmp, final):
    """Commit a fully-written tmp directory to its final name.

    Fresh target: one atomic ``os.rename``, the all-or-nothing case the
    CheckpointManager always hits.  Existing target (savers refreshing a
    model dir that may hold other artifacts): per-file ``os.replace`` —
    each file lands atomically and unrelated files are kept, so a crash
    mid-merge leaves every file either old-and-complete or
    new-and-complete, never torn."""
    # the tmp dir's entries must be durable BEFORE the rename, or power
    # loss could persist the commit while losing files inside it
    _fsync_dir(tmp)
    _fault_point("before_commit:" + os.path.basename(final))
    if os.path.isdir(final):
        for fname in sorted(os.listdir(tmp)):
            os.replace(os.path.join(tmp, fname), os.path.join(final, fname))
        os.rmdir(tmp)
        _fsync_dir(final)
    else:
        os.rename(tmp, final)
    _fsync_dir(os.path.dirname(os.path.abspath(final)) or ".")
    _fault_point("after_commit:" + os.path.basename(final))


@contextlib.contextmanager
def atomic_dir(dirname):
    """Crash-safe directory population: yields a ``<dirname>.tmp-<uuid>``
    staging dir; a clean exit commits it via ``commit_dir``.  On an
    exception the staging dir is LEFT BEHIND (what a kill would leave):
    readers never see it, and ``gc_stale_tmp`` / the next
    ``CheckpointManager`` save reap it."""
    final = os.path.abspath(dirname)
    parent = os.path.dirname(final) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = final + _TMP_MARK + uuid.uuid4().hex[:8]
    os.makedirs(tmp)
    yield tmp
    commit_dir(tmp, final)


def gc_stale_tmp(dirname):
    """Remove leftover ``*.tmp-*`` staging dirs of crashed saves."""
    if not os.path.isdir(dirname):
        return
    for entry in os.listdir(dirname):
        path = os.path.join(dirname, entry)
        if _TMP_MARK in entry and os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# Manifest and validation
# ---------------------------------------------------------------------------

def _manifest_crc(body):
    # canonical serialization independent of the on-disk formatting
    return zlib.crc32(
        json.dumps(body, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF


def _read_json_crc(path, what, want_version=None):
    """Parse one JSON doc and check its self-CRC."""
    if not os.path.isfile(path):
        raise ValueError("%s missing: %r" % (what, path))
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError("unparseable %s %r: %s" % (what, path, e))
    if not isinstance(doc, dict) or "crc32" not in doc:
        raise ValueError("%s %r lacks a crc32" % (what, path))
    body = {k: v for k, v in doc.items() if k != "crc32"}
    if _manifest_crc(body) != doc["crc32"]:
        raise ValueError("%s self-CRC mismatch in %r (flipped/garbled "
                         "bytes)" % (what, path))
    if want_version is not None and body.get("version") != want_version:
        raise ValueError("%s version %r in %r unsupported (want %d)"
                         % (what, body.get("version"), path, want_version))
    return body


def read_manifest(ckpt_dir):
    """Parse + integrity-check a checkpoint's MANIFEST.json; raises
    ``ValueError`` on any torn/corrupt/unsupported manifest."""
    return _read_json_crc(os.path.join(ckpt_dir, MANIFEST_NAME),
                          "manifest", want_version=MANIFEST_VERSION)


def _file_crc32(path):
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _default_storage():
    return storage_mod.LocalStorage()


def _invalid_reason(ckpt_dir, check_crc=True, storage=None):
    storage = storage or _default_storage()
    reason = storage.commit_invalid_reason(ckpt_dir)
    if reason is not None:
        return "not committed: " + reason
    try:
        body = read_manifest(ckpt_dir)
    except ValueError as e:
        return str(e)
    if body.get("commit") == "marker" and not os.path.isfile(
            os.path.join(ckpt_dir, storage_mod.MARKER_NAME)):
        # the writer declared marker commitment: a reader whose backend
        # does not enforce markers must still demand it
        return "marker-committed checkpoint without its commit marker"
    if body.get("multihost"):
        return ("multi-host checkpoint: the port restores none yet "
                "(ROADMAP queue 1 item 10b)")
    for name, entry in body.get("tensors", {}).items():
        path = os.path.join(ckpt_dir, entry["file"])
        if not os.path.isfile(path):
            return "tensor file missing for %r" % name
        if os.path.getsize(path) != entry["bytes"]:
            return "tensor file torn for %r" % name
        if check_crc and _file_crc32(path) != entry["crc32"]:
            return "tensor file corrupt for %r" % name
    return None


def validate_checkpoint(ckpt_dir, check_crc=True, storage=None):
    """True iff the checkpoint is complete: the backend's commit protocol
    holds, the manifest parses and its self-CRC holds, and every tensor
    file exists with the manifest's byte size — plus a content CRC32 pass
    unless ``check_crc=False`` (retention GC's cheap form)."""
    return _invalid_reason(ckpt_dir, check_crc=check_crc,
                           storage=storage) is None


def latest_checkpoint(dirname, storage=None):
    """Newest *complete* checkpoint dir under ``dirname`` (or None).
    Torn, corrupt, in-flight ``.tmp-*`` and uncommitted dirs are never
    selected."""
    if not os.path.isdir(dirname):
        return None
    steps = []
    for entry in os.listdir(dirname):
        m = _CKPT_RE.match(entry)
        if m and os.path.isdir(os.path.join(dirname, entry)):
            steps.append((int(m.group(1)), entry))
    for _, entry in sorted(steps, reverse=True):
        path = os.path.join(dirname, entry)
        if validate_checkpoint(path, storage=storage):
            return path
    return None


def _read_entry_file(path, name, info):
    """One CRC-checked tensor file → host array (bf16 as ``V2``)."""
    if "shards" in info:
        raise NotImplementedError(
            "checkpoint tensor %r is sharded over processes: the port "
            "restores no multi-host checkpoint yet (ROADMAP queue 1 item "
            "10)" % name)
    fpath = os.path.join(path, info["file"])
    with open(fpath, "rb") as f:
        data = f.read()
    if len(data) != info["bytes"] or \
            (zlib.crc32(data) & 0xFFFFFFFF) != info["crc32"]:
        raise RuntimeError(
            "checkpoint tensor file %r for variable %r is torn/corrupt "
            "(CRC mismatch)" % (fpath, name))
    return np.load(_io.BytesIO(data), allow_pickle=False)


def checkpoint_metadata(path, storage=None, check_crc=False):
    """Inspect a checkpoint WITHOUT loading tensors: ``step``,
    ``step_counter``, ``timestamp``, ``steps_per_run``, ``tensor_count`` and
    ``total_bytes``.  Raises ``ValueError`` with the reason when the
    checkpoint is torn, corrupt or uncommitted."""
    reason = _invalid_reason(path, check_crc=check_crc, storage=storage)
    if reason is not None:
        raise ValueError("checkpoint %r is not restorable: %s"
                         % (path, reason))
    body = read_manifest(path)
    tensors = body.get("tensors", {})
    return {"path": os.path.abspath(path), "step": int(body["step"]),
            "step_counter": int(body.get("step_counter", body["step"])),
            "timestamp": body.get("timestamp"),
            "steps_per_run": body.get("steps_per_run"),
            "tensor_count": len(tensors),
            "total_bytes": sum(int(e["bytes"]) for e in tensors.values())}


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

_live_managers = weakref.WeakSet()
_atexit_registered = [False]


def wait_all():
    """Join every live manager's in-flight async save, re-raising the
    first background error."""
    errs = []
    for mgr in list(_live_managers):
        try:
            mgr.wait()
        except BaseException as e:
            errs.append(e)
    if errs:
        raise errs[0]


class CheckpointManager:
    """Owns the save/restore lifecycle of one training job's checkpoint
    directory: atomic manifest-committed saves, optional async
    serialization, keep-last-N retention, and strict auto-resume.

    ``save()`` captures every persistable variable of the program
    (parameters, optimizer moments, learning rate and counters) plus
    ``scope.step_counter``; ``restore()``/``resume()`` put them back
    exactly, so a resumed run is step for step an uninterrupted one.

    ``place`` is where a restore puts a variable that the scope does not
    hold yet (one it holds stays on its device): default
    ``CUDAPlace(0)``.

    The numbers of the last save: ``snapshots`` and ``saves`` (counts of
    snapshots taken and saves committed), ``last_snapshot_ms``,
    ``last_bytes`` (serialized tensor bytes) and ``last_save_s`` (from
    the start of the write to the commit).
    """

    def __init__(self, dirname, max_to_keep=5, async_save=True,
                 scope=None, main_program=None, steps_per_run=None,
                 storage=None, process_index=None, process_count=None,
                 barrier=None, consensus=None, place=None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(
                "max_to_keep must be >= 1 (or None to keep all), got %r —"
                " retention may never delete the only complete checkpoint"
                % (max_to_keep,))
        # windows (Executor.run_window): state exists only at window
        # boundaries, so save() enforces the boundary and K is stamped
        # into the manifest for the resumed job to check
        if steps_per_run is not None:
            steps_per_run = flags.steps_per_run_value(steps_per_run)
        self.steps_per_run = steps_per_run
        if (process_count is not None and int(process_count) > 1) or \
                barrier is not None or consensus is not None:
            raise NotImplementedError(
                "the multi-host checkpoint save is not ported yet "
                "(ROADMAP queue 1 item 10b)")
        self.dirname = os.path.abspath(dirname)
        self.max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        self._scope = scope
        self._program = main_program
        self._place = place
        self._thread = None
        self._error = None
        self.last_step = None
        self.saves = self.snapshots = 0
        self.last_bytes = self.last_save_s = self.last_snapshot_ms = None
        self.storage = storage or _default_storage()
        os.makedirs(self.dirname, exist_ok=True)
        # a script that exits right after an async save() must neither
        # lose the in-flight snapshot nor swallow its error
        _live_managers.add(self)
        if not _atexit_registered[0]:
            _atexit_registered[0] = True
            atexit.register(wait_all)

    # -- helpers -----------------------------------------------------------
    def _resolve(self, scope, main_program):
        scope = scope or self._scope or global_scope()
        program = main_program or self._program or default_main_program()
        return scope, program

    @staticmethod
    def _persistable_names(program):
        from .io import _is_persistable
        return [v.name for v in program.list_vars() if _is_persistable(v)]

    # -- save --------------------------------------------------------------
    def save(self, step=None, scope=None, main_program=None, sync=None):
        """Checkpoint the job's persistable state.

        Synchronous part: waits out any in-flight save (re-raising its
        error), then snapshots the scope to host memory (one device
        synchronisation).  After that the scope may change freely.  With
        ``async_save`` (or ``sync=False``) serialization, fsync and
        commit run on a background thread; ``wait()`` blocks on
        durability.  ``sync=True`` forces a synchronous save.  Returns
        the (future) committed checkpoint path."""
        self.wait()
        scope, program = self._resolve(scope, main_program)
        step = int(scope.step_counter if step is None else step)
        K = self.steps_per_run
        # a windowed job checkpoints only AT a window boundary: the
        # counter must sit where the last run_window left it (the marker
        # the executor stamps).  The marker, not step % K, is the
        # invariant — the startup run and per-step runs before the
        # windows offset the counter.  No marker yet (nothing windowed
        # ran) is trivially a boundary.
        marker = getattr(scope, "_window_end", None)
        if K is not None and K > 1 and marker is not None and \
                step != int(marker):
            raise ValueError(
                "checkpoint step %d is not a window boundary (last "
                "window ended at step %d): with steps_per_run=%d "
                "(FLAGS_steps_per_run) state only exists at window "
                "boundaries — save right after Executor.run_window "
                "returns, before any per-step run() calls"
                % (step, int(marker), K))
        meta = {"step": step, "step_counter": int(scope.step_counter),
                "timestamp": time.time()}
        if K is not None:
            meta["steps_per_run"] = K
        final = os.path.join(self.dirname, _CKPT_PREFIX + str(step))
        # entering a save is forward progress; the snapshot (and a
        # synchronous write) may take long on a big model
        with watchdog.extend_deadline(
                "checkpoint_save",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            t0 = time.perf_counter()
            snap = scope.snapshot(self._persistable_names(program))
            self.snapshots += 1
            self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3
            if self.async_save if sync is None else not sync:
                _m_async_inflight.set(1)
                self._thread = threading.Thread(
                    target=self._save_worker, args=(snap, meta, final),
                    name="checkpoint-save", daemon=True)
                self._thread.start()
            else:
                self._write_and_commit(snap, meta, final)
        return final

    def _save_worker(self, snap, meta, final):
        try:
            # a background uploader is invisible to the watchdog: its
            # liveness is not training progress
            with telemetry.suppress_progress():
                self._write_and_commit(snap, meta, final)
        except BaseException as e:  # re-raised on next save()/wait()
            _m_async_errors.inc()
            self._error = e
        finally:
            _m_async_inflight.set(0)

    def _write_and_commit(self, snap, meta, final):
        t0 = time.perf_counter()
        store = self.storage
        stage = store.begin(final)
        tensors = {}
        total = 0
        for name in sorted(snap):
            arr = snap[name]
            fname = name.replace("/", "__") + ".npy"
            data = npy_bytes(arr)
            store.put(stage, fname, data, "tensor:" + name)
            tensors[name] = {"file": fname, "shape": list(arr.shape),
                             "dtype": host_dtype_name(arr.dtype),
                             "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                             "bytes": len(data)}
            total += len(data)
        body = {"version": MANIFEST_VERSION, "step": meta["step"],
                "step_counter": meta["step_counter"],
                "timestamp": meta["timestamp"], "tensors": tensors}
        if "steps_per_run" in meta:
            body["steps_per_run"] = meta["steps_per_run"]
        if store.commit_via_marker:
            # a generic reader must demand the marker for this dir
            body["commit"] = "marker"
        doc = dict(body, crc32=_manifest_crc(body))
        manifest_data = json.dumps(doc, sort_keys=True, indent=1).encode()
        store.put(stage, MANIFEST_NAME, manifest_data, "manifest")
        store.finalize(stage, final, manifest_data=manifest_data)
        self.last_step = meta["step"]
        self.saves += 1
        self.last_bytes = total
        self.last_save_s = time.perf_counter() - t0
        profiler.record_checkpoint_save(self.last_save_s, total,
                                        meta["step"])
        self.gc()
        _fault_point("after_gc:" + os.path.basename(final))

    def wait(self):
        """Join any in-flight async save; re-raise its error, if any."""
        thread, self._thread = self._thread, None
        if thread is not None:
            t0 = time.perf_counter()
            with watchdog.extend_deadline(
                    "checkpoint_wait",
                    flags.get_flag("watchdog_checkpoint_grace_s")):
                thread.join()
            _m_commit_wait.observe(time.perf_counter() - t0)
        err, self._error = self._error, None
        if err is not None:
            raise err

    # -- retention ---------------------------------------------------------
    def gc(self):
        """Keep-last-N retention + stale-tmp reaping.  Only *complete*
        checkpoints count toward (and are eligible for) deletion, so the
        newest complete checkpoint always survives; torn/corrupt committed
        dirs are left for post-mortem.  Completeness here is manifest +
        file-size level (no content CRC); readers CRC-check fully."""
        self.storage.gc_stale(self.dirname)
        if self.max_to_keep is None:
            return
        complete = []
        for entry in os.listdir(self.dirname):
            m = _CKPT_RE.match(entry)
            path = os.path.join(self.dirname, entry)
            if m and os.path.isdir(path) and validate_checkpoint(
                    path, check_crc=False, storage=self.storage):
                complete.append((int(m.group(1)), path))
        complete.sort(reverse=True)
        for _, path in complete[self.max_to_keep:]:
            shutil.rmtree(path, ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def latest_checkpoint(self):
        """Newest complete checkpoint of this manager's directory."""
        return latest_checkpoint(self.dirname, storage=self.storage)

    def restore(self, path=None, scope=None, main_program=None,
                strict=True, reshard=False):
        """Load a checkpoint into the scope.

        Strict (default): every persistable variable of the program must
        be present with a matching shape and dtype (a 32-bit entry of a
        declared 64-bit variable is widened), else a ``RuntimeError``
        names the tensor — and the scope is left untouched, since every
        tensor is read and checked before any is set.  Restores
        ``scope.step_counter`` so step-keyed RNG (dropout) replays
        identically.  Returns the manifest metadata dict."""
        if reshard:
            raise NotImplementedError(
                "restore(reshard=True): the port restores no resharded "
                "checkpoint yet (ROADMAP queue 1 item 10b)")
        with watchdog.extend_deadline(
                "checkpoint_restore",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            return self._restore(path, scope, main_program, strict)

    def _restore(self, path, scope, main_program, strict):
        scope, program = self._resolve(scope, main_program)
        if path is None:
            path = self.latest_checkpoint()
            if path is None:
                raise RuntimeError(
                    "no complete checkpoint found in %r" % self.dirname)
        body = read_manifest(path)
        if body.get("multihost") or body.get("shard_degree"):
            raise NotImplementedError(
                "checkpoint %r was saved by a multi-host or sharded job: "
                "the port restores neither yet (ROADMAP queue 1 item 10b)"
                % path)
        tensors = body.get("tensors", {})
        from .io import _is_persistable
        staged = {}
        for var in program.list_vars():
            if not _is_persistable(var):
                continue
            entry = tensors.get(var.name)
            if entry is None:
                if strict:
                    raise RuntimeError(
                        "checkpoint %r has no tensor for persistable "
                        "variable %r — the checkpoint is incomplete for "
                        "this program (pass strict=False to skip)"
                        % (path, var.name))
                continue
            arr = _read_entry_file(path, var.name, entry)
            vshape = tuple(var.shape or ())
            if vshape and (len(vshape) != arr.ndim or
                           any(d not in (None, -1) and int(d) != s
                               for d, s in zip(vshape, arr.shape))):
                if strict:
                    raise RuntimeError(
                        "checkpoint tensor %r has shape %s but the "
                        "program declares %s — refusing to restore a "
                        "mismatched variable (pass strict=False to skip)"
                        % (var.name, tuple(arr.shape), vshape))
                continue
            have = host_dtype_name(arr.dtype)
            if var.dtype is not None and have != var.dtype and \
                    not widens(var.dtype, arr.dtype):
                if strict:
                    raise RuntimeError(
                        "checkpoint tensor %r has dtype %s but the "
                        "program declares %s — refusing to restore a "
                        "mismatched variable (pass strict=False to skip)"
                        % (var.name, have, var.dtype))
                continue
            staged[var.name] = (arr, var.dtype)
        for name, (arr, dtype) in staged.items():
            scope.set_var(name, from_host(arr, self._device(scope, name),
                                          dtype))
        scope.step_counter = int(body.get("step_counter", body["step"]))
        # the restored state IS a window boundary (save enforced it):
        # re-stamp the marker so the job may save before its next window
        scope._window_end = scope.step_counter
        K = self.steps_per_run
        saved_k = body.get("steps_per_run")
        if K is not None and saved_k is not None and saved_k != K:
            warnings.warn(
                "checkpoint %r was written with steps_per_run=%d but "
                "this manager is configured with steps_per_run=%d — "
                "resuming is numerically fine, but window boundaries "
                "shift" % (path, saved_k, K), stacklevel=3)
        return {"path": path, "step": int(body["step"]),
                "step_counter": scope.step_counter,
                "timestamp": body.get("timestamp"),
                "steps_per_run": saved_k}

    def _device(self, scope, name):
        held = scope.find_var(name)
        if isinstance(held, torch.Tensor):
            return held.device
        return device_for_place(self._place if self._place is not None
                                else CUDAPlace(0))

    def resume(self, scope=None, main_program=None, strict=True,
               reshard=False):
        """Auto-resume: restore the newest complete checkpoint if one
        exists, else return None (fresh start)."""
        path = self.latest_checkpoint()
        if path is None:
            return None
        return self.restore(path, scope=scope, main_program=main_program,
                            strict=strict, reshard=reshard)
