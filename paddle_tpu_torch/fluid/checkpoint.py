"""Fault-tolerant checkpointing (counterpart ``paddle_tpu/fluid/
checkpoint.py``).

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

- **Pod checkpoints** (a world of several ranks, ``fluid.distributed``):
  every rank saves.  The chief writes the replicated tensors, each rank
  the shard of every weight-update-sharded state var it holds
  (``<var>.p<rank>.0.npy`` with its index range) and its own
  ``MANIFEST.p<rank>.json``; the chief merges them into ``MANIFEST.json``
  and commits with the object store's marker (a ``LocalStorage`` manager
  switches to the marker protocol, which several writers need).  The
  async save (the default) agrees through storage alone: the chief's
  claim lease, the chief polling for every rank's manifest
  (``FLAGS_checkpoint_commit_timeout_s``), the ranks polling for the
  marker; a dead rank costs one abandoned prefix.  ``save(sync=True)``
  runs the barriered protocol, and one rank's failed upload aborts the
  save on every rank.  A restore reassembles each sharded var from its
  shard files and keeps this rank's slice.
- **Elastic restore** (``reshard=True``): a checkpoint saved at
  weight-update-sharding degree N restores into a program built at
  degree M; each padded flat buffer is re-sliced (the logical bucket of
  B elements kept, the pad re-zeroed), after checking that both layouts
  hold the same B.  Without it a different degree is refused.
  ``checkpoint_metadata`` says what world wrote a checkpoint.

Each manager also keeps the numbers of its last save (``last_bytes``,
``last_save_s``, ``last_snapshot_ms``).
"""

import atexit
import contextlib
import io as _io
import json
import os
import re
import shutil
import sys
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
    "seconds a caller waited for an in-flight async save to commit (and "
    "an async pod save's commit poll)")
_m_inflight_phase = telemetry.gauge(
    "checkpoint_in_flight",
    "1 while this rank's async pod save sits in {phase} "
    "(phase=upload|commit_wait)")
_m_commit_abandoned = telemetry.counter(
    "checkpoint_commit_abandoned_total",
    "async pod saves abandoned after the commit poll timed out "
    "(FLAGS_checkpoint_commit_timeout_s) — prefix left as reaper debris")

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1
_CKPT_PREFIX = "step-"
_TMP_MARK = ".tmp-"
_CKPT_RE = re.compile(r"^step-(\d+)$")


def process_manifest_name(process_index):
    """Per-rank shard manifest of a pod checkpoint: ``MANIFEST.p<idx>.json``
    beside the chief's merged MANIFEST.json."""
    return "MANIFEST.p%d.json" % int(process_index)


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
#   lease:<dir>_begin / _mid / _end      the chief's claim lease
#   pmanifest:p<rank>_begin / _mid / _end   a rank's pod shard manifest
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


def _invalid_reason(ckpt_dir, check_crc=True, storage=None, body_out=None):
    storage = storage or _default_storage()
    reason = storage.commit_invalid_reason(ckpt_dir)
    if reason is not None:
        return "not committed: " + reason
    try:
        body = read_manifest(ckpt_dir)
    except ValueError as e:
        return str(e)
    if body_out is not None:
        body_out.append(body)
    if body.get("commit") == "marker" and not os.path.isfile(
            os.path.join(ckpt_dir, storage_mod.MARKER_NAME)):
        # the writer declared marker commitment: a reader whose backend
        # does not enforce markers must still demand it
        return "marker-committed checkpoint without its commit marker"
    mh = body.get("multihost")
    if mh:
        # a pod checkpoint is committed by the chief's marker alone, and
        # every rank's manifest must have landed before it
        if not os.path.isfile(os.path.join(ckpt_dir,
                                           storage_mod.MARKER_NAME)):
            return "multi-host checkpoint without its commit marker"
        for fname in mh.get("manifests", []):
            try:
                _read_json_crc(os.path.join(ckpt_dir, fname),
                               "per-process manifest",
                               want_version=MANIFEST_VERSION)
            except ValueError as e:
                return str(e)
    for name, entry in body.get("tensors", {}).items():
        if "shards" in entry:
            for sh in entry["shards"]:
                path = os.path.join(ckpt_dir, sh["file"])
                if not os.path.isfile(path):
                    return "shard file missing for %r" % name
                if os.path.getsize(path) != sh["bytes"]:
                    return "shard file torn for %r" % name
                if check_crc and _file_crc32(path) != sh["crc32"]:
                    return "shard file corrupt for %r" % name
            continue
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
    """One CRC-checked tensor or shard file → host array (bf16 as
    ``V2``)."""
    fpath = os.path.join(path, info["file"])
    with open(fpath, "rb") as f:
        data = f.read()
    if len(data) != info["bytes"] or \
            (zlib.crc32(data) & 0xFFFFFFFF) != info["crc32"]:
        raise RuntimeError(
            "checkpoint tensor file %r for variable %r is torn/corrupt "
            "(CRC mismatch)" % (fpath, name))
    return np.load(_io.BytesIO(data), allow_pickle=False)


def snapshot_addressable(scope, names, program, rank, want_full=True):
    """The pod save's snapshot: ``(full, shards)``.  ``full`` maps every
    name this rank writes whole (the chief passes ``want_full=True``;
    the others skip the copy), ``shards`` maps each state var that
    weight-update sharding splits over N > 1 ranks to ``(global shape,
    dtype name, {index ranges: this rank's host slice})``: the scope
    holds rank r's ``S`` elements of the ``(Bp,)`` buffer, ``[r*S,
    (r+1)*S)``.  One ``Scope.snapshot`` (one device synchronisation)."""
    degree = program._wus_degree or 1
    sharded = program._dp_sharded_state if degree > 1 else ()
    take = [n for n in names if n in sharded or want_full]
    snap = scope.snapshot(take)
    full, shards = {}, {}
    block = program.global_block()
    for n, arr in snap.items():
        if n not in sharded:
            full[n] = arr
            continue
        gshape = tuple(int(d) for d in block.var(n).shape)
        local = int(arr.shape[0])
        if arr.ndim != 1 or local * degree != gshape[0]:
            raise RuntimeError(
                "sharded state %r: this rank holds %s, not 1/%d of the "
                "declared %s" % (n, tuple(arr.shape), degree, gshape))
        shards[n] = (gshape, host_dtype_name(arr.dtype),
                     {((rank * local, (rank + 1) * local),): arr})
    return full, shards


def _load_manifest_entry(path, name, entry):
    """Materialize one manifest tensor entry as the full global array:
    a single-file entry loads directly; a pod ``shards`` entry
    reassembles every rank's slices into the global shape (each
    restoring rank reads ALL shards, then keeps its own slice)."""
    if "shards" not in entry:
        return _read_entry_file(path, name, entry)
    shape = tuple(int(d) for d in entry["shape"])
    out = filled = None
    for sh in entry["shards"]:
        arr = _read_entry_file(path, name, sh)
        if out is None:
            out = np.empty(shape, dtype=arr.dtype)
            filled = np.zeros(shape, dtype=bool) if shape else None
        index = tuple(slice(int(b), int(e)) for b, e in sh["index"])
        out[index] = arr
        if filled is not None:
            filled[index] = True
    if filled is not None and not filled.all():
        raise RuntimeError(
            "checkpoint tensor %r: shard files do not cover the full "
            "global shape %s — a per-process manifest is missing slices"
            % (name, shape))
    return out


def _reshard_flat(name, arr, want_shape, numels, saved_deg, cur_deg,
                  path):
    """Re-slice one degree-dependent padded flat buffer (a coalesced
    WUS optimizer-moment buffer or bucket EF residual) from the degree
    it was saved at onto this program's degree.  Both layouts are the
    SAME logical bucket ``B`` padded up to a multiple of their shard
    unit, so the leading ``B`` elements are the state and the tail is
    pad lanes whose updated values the all-gather split discards —
    copy the common prefix, re-zero the rest.  Anything that is not a
    rank-1 pad-length change is a genuine layout difference (different
    bucketing / optimizer config), refused loudly."""
    saved_numel, cur_numel = numels
    if arr.ndim != 1 or len(want_shape) != 1 or \
            any(d in (None, -1) for d in want_shape):
        raise RuntimeError(
            "cannot reshard checkpoint tensor %r from shape %s (saved "
            "at weight_update_sharding degree %s) to %s (this program, "
            "degree %s): only the flat coalesced-bucket layout "
            "reshards — rebuild the program with the same bucketing as "
            "the checkpointed job (checkpoint: %r)"
            % (name, tuple(arr.shape), saved_deg or 0,
               tuple(want_shape), cur_deg or 0, path))
    if saved_numel is not None and cur_numel is not None and \
            int(saved_numel) != int(cur_numel):
        raise RuntimeError(
            "cannot reshard checkpoint tensor %r: the checkpoint's "
            "coalesced bucket holds %d logical elements but this "
            "program's holds %d — the bucket layouts differ (different "
            "fuse_grad_size_mb / parameter set / optimizer), so a "
            "re-slice would scramble state; rebuild the program with "
            "the checkpointed job's bucketing (checkpoint: %r)"
            % (name, int(saved_numel), int(cur_numel), path))
    want = int(want_shape[0])
    logical = saved_numel if saved_numel is not None else cur_numel
    if logical is not None and want < int(logical):
        raise RuntimeError(
            "cannot reshard checkpoint tensor %r: this program's "
            "padded length %d is shorter than the logical bucket (%d "
            "elements) — the layouts cannot both pad the same bucket "
            "(checkpoint: %r)" % (name, want, int(logical), path))
    if logical is not None and arr.shape[0] < int(logical):
        # a same-layout checkpoint always pads to >= the logical bucket
        # size; a shorter saved buffer means the layouts differ (a
        # pre-sharded_numel checkpoint whose bucketing drifted) — zero-
        # filling the tail would silently corrupt optimizer state
        raise RuntimeError(
            "cannot reshard checkpoint tensor %r: the saved buffer "
            "holds %d elements but this program's logical bucket needs "
            "%d — the bucket layouts differ; rebuild the program with "
            "the checkpointed job's bucketing (checkpoint: %r)"
            % (name, int(arr.shape[0]), int(logical), path))
    out = np.zeros((want,), dtype=arr.dtype)
    n = min(want, arr.shape[0])
    if logical is not None:
        # only the logical prefix carries state — never copy the saved
        # buffer's pad lanes, whatever either padded length is (nonzero
        # pad lanes would e.g. perturb an int8 EF residual's shared
        # block scales)
        n = min(n, int(logical))
    out[:n] = arr[:n]
    return out


def checkpoint_metadata(path, storage=None, check_crc=False):
    """Inspect a checkpoint WITHOUT loading tensors: walk the commit
    protocol plus the (multihost) manifest chain and return the
    checkpoint's identity metadata — the elastic driver's first
    question ("what world wrote this?").

    Returns a dict with ``step``, ``step_counter``, ``shard_degree``
    (weight-update-sharding degree, None when unsharded),
    ``sharded_vars``, ``process_count`` (the pod world size that saved
    it, 1 for single-host), ``multihost``, ``steps_per_run``,
    ``timestamp``, ``tensor_count``, and ``total_bytes`` (serialized
    tensor bytes per the manifest).  Validation is structural — commit
    marker/dialect, manifest chain self-CRCs, file presence + sizes —
    not a full content-CRC pass unless ``check_crc=True``
    (``validate_checkpoint``'s deep walk, one pass); raises
    ``ValueError`` with the reason when the checkpoint is torn,
    corrupt, or uncommitted.

    ``storage`` defaults to the mixed-dialect reader
    (``storage.MixedProtocolReader``), which judges each directory by
    its own commit protocol — callers need not know which backend
    wrote it."""
    storage = storage or storage_mod.MixedProtocolReader()
    parsed = []
    reason = _invalid_reason(path, check_crc=check_crc, storage=storage,
                             body_out=parsed)
    if reason is not None:
        raise ValueError(
            "checkpoint %r is not restorable: %s" % (path, reason))
    body = parsed[0] if parsed else read_manifest(path)
    mh = body.get("multihost") or {}
    total = 0
    for entry in body.get("tensors", {}).values():
        if "shards" in entry:
            total += sum(int(sh["bytes"]) for sh in entry["shards"])
        else:
            total += int(entry["bytes"])
    deg = body.get("shard_degree")
    return {
        "path": os.path.abspath(path),
        "step": int(body["step"]),
        "step_counter": int(body.get("step_counter", body["step"])),
        "timestamp": body.get("timestamp"),
        "steps_per_run": body.get("steps_per_run"),
        "shard_degree": int(deg) if deg else None,
        "sharded_vars": sorted(body.get("sharded_vars") or ()),
        "process_count": int(mh.get("process_count", 1)),
        "multihost": bool(mh),
        "tensor_count": len(body.get("tensors", {})),
        "total_bytes": total,
    }


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


# manifest keys a save copies from its metadata when present
_META_KEYS = ("steps_per_run", "shard_degree", "sharded_vars",
              "sharded_numel")


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

    In a world of several ranks every rank builds its manager on the same
    directory and calls ``save()`` at the same steps: a pod checkpoint
    (module docstring).  ``process_index``/``process_count``/``barrier``/
    ``consensus`` pin a simulated world instead of ``fluid.distributed``
    (threads standing for ranks, in tests).

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
        # the pod's identity, from fluid.distributed at save time unless
        # pinned here
        self._mh_index = process_index
        self._mh_count = process_count
        self._mh_barrier = barrier
        self._mh_consensus = consensus
        self._mh_storage_cache = None
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

    def _world(self):
        """(rank, world size, barrier, consensus) of the save protocol:
        ``fluid.distributed`` unless the constructor pinned a simulated
        world.  ``consensus(flag)`` is the global OR by which every rank
        learns that one rank's phase failed."""
        from . import distributed as dist
        idx = dist.process_index() if self._mh_index is None \
            else int(self._mh_index)
        cnt = dist.process_count() if self._mh_count is None \
            else int(self._mh_count)
        barrier = self._mh_barrier or dist.barrier
        consensus = self._mh_consensus or dist.any_process
        return idx, cnt, barrier, consensus

    def _shared_prefix_storage(self):
        """The storage of a pod save: several ranks put objects under one
        ``step-N/`` prefix and the chief's marker commits it.  A
        ``LocalStorage`` manager switches to the object store's marker
        protocol (one rename cannot merge N writers' staging dirs)."""
        if self.storage.supports_shared_prefix:
            return self.storage
        if self._mh_storage_cache is None:
            warnings.warn(
                "multi-host checkpointing: %s cannot host concurrent "
                "per-process shard uploads — committing via the "
                "object-store marker protocol instead"
                % type(self.storage).__name__, stacklevel=3)
            self._mh_storage_cache = storage_mod.ObjectStoreStorage()
        return self._mh_storage_cache

    def _reader_storage(self):
        """The storage that validates and selects checkpoints.  After a
        ``LocalStorage`` manager switched to the marker protocol the
        directory holds both dialects, so the mixed reader judges each
        dir by its own (and reaps only ``.tmp-*`` debris)."""
        if self._mh_storage_cache is not None:
            return storage_mod.MixedProtocolReader(self._mh_storage_cache)
        return self.storage

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
        # weight-update sharding: the padded flat layout of the sharded
        # state is a function of the degree, so the degree, the sharded
        # vars and each padded buffer's logical bucket size go into the
        # manifest (the elastic restore's gate and layout identity)
        degree = program._wus_degree
        if degree:
            meta["shard_degree"] = int(degree)
            meta["sharded_vars"] = sorted(program._dp_sharded_state)
            if program._wus_padded_numel:
                meta["sharded_numel"] = {
                    n: int(b)
                    for n, b in sorted(program._wus_padded_numel.items())}
        final = os.path.join(self.dirname, _CKPT_PREFIX + str(step))
        do_async = self.async_save if sync is None else not sync
        idx, cnt, barrier, consensus = self._world()
        if cnt > 1:
            # a pod save: the async default commits through storage
            # alone; sync=True (drains, shutdown) runs the barriered
            # protocol, whose fences prove durability before it returns
            if do_async:
                return self._save_multihost_async(scope, program, meta,
                                                  final, idx, cnt)
            return self._save_multihost(scope, program, meta, final, idx,
                                        cnt, barrier, consensus)
        if (degree or 1) > 1 and program._dp_sharded_state:
            raise RuntimeError(
                "the program's optimizer state is sharded over %d ranks "
                "but this save runs in a world of one: only a pod save "
                "(every rank saving) writes each rank's shard" % degree)
        # entering a save is forward progress; the snapshot (and a
        # synchronous write) may take long on a big model
        with watchdog.extend_deadline(
                "checkpoint_save",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            t0 = time.perf_counter()
            snap = scope.snapshot(self._persistable_names(program))
            self.snapshots += 1
            self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3
            if do_async:
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
        for key in _META_KEYS:
            if key in meta:
                body[key] = meta[key]
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

    # -- pod save (a world of several ranks) --------------------------------
    def _pod_snapshot(self, scope, program, idx):
        t0 = time.perf_counter()
        full, shards = snapshot_addressable(
            scope, self._persistable_names(program), program, idx,
            want_full=(idx == 0))
        self.snapshots += 1
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3
        return full, shards

    def _save_multihost(self, scope, program, meta, final, idx, cnt,
                        barrier, consensus):
        """The barriered pod save (JAX checkpoint.py:899): (1) the chief
        claims the ``step-N/`` prefix; (2) every rank uploads its part
        and its ``MANIFEST.p<idx>.json``; (3) after a barrier the chief
        writes the merged ``MANIFEST.json`` and the marker, the one
        visibility point; (4) a last barrier, so no rank returns before
        the commit is decided.  An ordinary failure on one rank (a full
        disk, retries spent) is caught, carried through the phase's
        barrier and turned into an abort on every rank by ``consensus``;
        a kill (BaseException) goes straight through, leaving unmarked
        debris."""
        store = self._shared_prefix_storage()
        tag = os.path.basename(final)
        with watchdog.extend_deadline(
                "checkpoint_save",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            err = None
            try:
                if idx == 0:
                    store.begin(final)
            except Exception as e:   # noqa: BLE001 — re-raised below
                err = e
            with telemetry.span("ckpt", phase="ckpt_barrier:begin",
                                name="begin"):
                barrier("ckpt-begin-%s" % tag)
            self._mh_abort(consensus, err, tag, "begin")
            try:
                with telemetry.span("ckpt", name="upload"):
                    full, shards = self._pod_snapshot(scope, program, idx)
                    self._mh_write_local(store, final, idx, full, shards,
                                         meta)
            except Exception as e:   # noqa: BLE001 — re-raised below
                err = e
            with telemetry.span("ckpt", phase="ckpt_barrier:shards",
                                name="shards"):
                barrier("ckpt-shards-%s" % tag)
            self._mh_abort(consensus, err, tag, "shard upload")
            if idx == 0:
                try:
                    self._mh_commit(store, final, cnt, meta)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    err = e
            with telemetry.span("ckpt", phase="ckpt_barrier:commit",
                                name="commit"):
                barrier("ckpt-commit-%s" % tag)
            self._mh_abort(consensus, err, tag, "commit")
            self.last_step = meta["step"]
            self.saves += 1
            if idx == 0:
                self.gc()
                _fault_point("after_gc:" + tag)
            return final

    def _save_multihost_async(self, scope, program, meta, final, idx, cnt):
        """The pod save without collectives (JAX checkpoint.py:974).  On
        the calling thread: the chief claims the prefix (``begin()``
        clears debris and writes the claim lease) and every rank takes
        its snapshot.  On a background thread: every rank uploads its
        part and manifest (the others first wait for the chief's lease of
        THIS step), the chief polls storage until every rank's manifest
        has landed, merges and writes the marker last, and the others
        poll for the marker.  A rank that dies or wedges costs one
        abandoned prefix (``checkpoint_commit_abandoned_total``) after
        ``FLAGS_checkpoint_commit_timeout_s``; ``last_step`` then stays
        unset, so a drain saves again."""
        store = self._shared_prefix_storage()
        with watchdog.extend_deadline(
                "checkpoint_save",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            if idx == 0:
                store.begin(final)
            full, shards = self._pod_snapshot(scope, program, idx)
        _m_async_inflight.set(1)
        _m_inflight_phase.set(1, phase="upload")
        self._thread = threading.Thread(
            target=self._mh_async_worker,
            args=(store, final, idx, cnt, full, shards, meta),
            name="checkpoint-save", daemon=True)
        self._thread.start()
        return final

    def _mh_async_worker(self, store, final, idx, cnt, full, shards, meta):
        try:
            with telemetry.suppress_progress():
                self._mh_async_body(store, final, idx, cnt, full, shards,
                                    meta)
        except BaseException as e:  # re-raised on next save()/wait()
            _m_async_errors.inc()
            self._error = e
        finally:
            _m_inflight_phase.set(0, phase="upload")
            _m_inflight_phase.set(0, phase="commit_wait")
            _m_async_inflight.set(0)

    def _mh_async_body(self, store, final, idx, cnt, full, shards, meta):
        step = meta["step"]
        tag = os.path.basename(final)
        timeout = float(flags.get_flag("checkpoint_commit_timeout_s"))
        if idx != 0:
            # never race the chief's begin(): upload once its lease for
            # THIS step is visible
            def lease_ready():
                lease = storage_mod.lease_info(final)
                return lease is not None and lease.get("step") == step

            if not self._poll(lease_ready, timeout):
                self._abandon(tag, idx, step,
                              "chief claim lease for step %d not seen "
                              "within %.1fs" % (step, timeout))
                return
        with telemetry.span("ckpt", name="upload"):
            self._mh_write_local(store, final, idx, full, shards, meta)
        _m_inflight_phase.set(0, phase="upload")
        _m_inflight_phase.set(1, phase="commit_wait")
        t0 = time.monotonic()
        if idx == 0:
            manifests = [process_manifest_name(r) for r in range(cnt)]

            def siblings_landed():
                for fname in manifests:
                    try:
                        pbody = _read_json_crc(
                            os.path.join(final, fname),
                            "per-process manifest",
                            want_version=MANIFEST_VERSION)
                    except ValueError:
                        return False   # absent or torn mid-put: wait
                    if pbody.get("step") != step:
                        return False   # a stale upload, not this save's
                return True

            if not self._poll(siblings_landed, timeout):
                self._abandon(tag, idx, step,
                              "sibling manifests incomplete after %.1fs "
                              "commit poll" % timeout)
                return
            self._mh_commit(store, final, cnt, meta)
            wait_s = time.monotonic() - t0
            _m_commit_wait.observe(wait_s)
            telemetry.record_lifecycle_event(
                "ckpt_commit", step=step, prefix=tag,
                wait_s=round(wait_s, 3), process_count=cnt)
            self.last_step = step
            self.saves += 1
            self.gc()
            _fault_point("after_gc:" + tag)
        else:
            if not self._poll(lambda: store.is_committed(final), timeout):
                self._abandon(tag, idx, step,
                              "commit marker not observed within %.1fs"
                              % timeout)
                return
            _m_commit_wait.observe(time.monotonic() - t0)
            # set only once the marker is seen: an abandoned commit
            # leaves the drain's "already saved?" check false
            self.last_step = step
            self.saves += 1

    @staticmethod
    def _poll(pred, timeout_s, interval=0.05):
        """Poll ``pred`` until true (True) or ``timeout_s`` elapses
        (False); at least one check runs."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            if pred():
                return True
            remain = deadline - time.monotonic()
            if remain <= 0:
                return False
            time.sleep(min(interval, remain))

    def _abandon(self, tag, idx, step, why):
        """Give up on this save's commit without raising: the prefix is
        unmarked debris, training goes on, the previous checkpoint stays
        the latest."""
        _m_commit_abandoned.inc()
        telemetry.record_lifecycle_event(
            "ckpt_abandoned", step=step, prefix=tag, process_index=idx,
            reason=why)
        sys.stderr.write(
            "[checkpoint] abandoned async pod save %s on process %d: %s — "
            "prefix left for the debris reaper, previous checkpoint "
            "remains the latest\n" % (tag, idx, why))

    @staticmethod
    def _mh_abort(consensus, err, tag, phase):
        """Agree on every rank whether ``phase`` failed anywhere; if so
        every rank raises (its own error where it has one) and no marker
        is written."""
        if not consensus(err is not None):
            return False
        if err is not None:
            raise err
        raise RuntimeError(
            "multi-host checkpoint %s aborted: a sibling process failed "
            "its %s phase — no marker was committed, the previous "
            "checkpoint remains the latest" % (tag, phase))

    def _mh_write_local(self, store, final, idx, full, shards, meta):
        """This rank's uploads: the whole tensors (the chief), its slice
        of every sharded var, and its manifest listing exactly what it
        wrote."""
        t0 = time.perf_counter()
        tensors = {}
        total = 0
        for name in sorted(full):
            arr = full[name]
            fname = name.replace("/", "__") + ".npy"
            data = npy_bytes(arr)
            store.put(final, fname, data, "tensor:" + name)
            tensors[name] = {"file": fname, "shape": list(arr.shape),
                             "dtype": host_dtype_name(arr.dtype),
                             "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                             "bytes": len(data)}
            total += len(data)
        for name in sorted(shards):
            gshape, dtype, slices = shards[name]
            entry = {"shape": list(gshape), "dtype": dtype, "shards": []}
            for j, (index, arr) in enumerate(sorted(slices.items())):
                fname = "%s.p%d.%d.npy" % (name.replace("/", "__"), idx, j)
                data = npy_bytes(arr)
                store.put(final, fname, data, "tensor:" + name)
                entry["shards"].append(
                    {"file": fname, "process": idx,
                     "index": [list(r) for r in index],
                     "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                     "bytes": len(data)})
                total += len(data)
            tensors[name] = entry
        body = {"version": MANIFEST_VERSION, "process_index": idx,
                "step": meta["step"], "tensors": tensors}
        doc = dict(body, crc32=_manifest_crc(body))
        store.put(final, process_manifest_name(idx),
                  json.dumps(doc, sort_keys=True, indent=1).encode(),
                  "pmanifest:p%d" % idx)
        self.last_bytes = total
        self.last_save_s = time.perf_counter() - t0
        profiler.record_checkpoint_save(self.last_save_s, total,
                                        meta["step"])

    def _mh_commit(self, store, final, cnt, meta):
        """The chief's commit: merge every rank's manifest into one
        MANIFEST.json, then write the marker.  A missing, torn or stale
        rank manifest aborts the commit: the marker never shows while a
        rank's shards may still be uploading."""
        manifests = [process_manifest_name(r) for r in range(cnt)]
        tensors = {}
        for r in range(cnt):
            pbody = _read_json_crc(os.path.join(final, manifests[r]),
                                   "per-process manifest",
                                   want_version=MANIFEST_VERSION)
            if pbody.get("step") != meta["step"]:
                raise RuntimeError(
                    "multi-host commit aborted: %s is for step %r, "
                    "expected %r — a stale upload is mixed into this "
                    "prefix" % (manifests[r], pbody.get("step"),
                                meta["step"]))
            for name, entry in pbody.get("tensors", {}).items():
                if "shards" in entry:
                    merged = tensors.setdefault(
                        name, {"shape": entry["shape"],
                               "dtype": entry["dtype"], "shards": []})
                    if "shards" not in merged:
                        raise RuntimeError(
                            "multi-host commit aborted: %r is sharded on "
                            "process %d but full elsewhere" % (name, r))
                    merged["shards"].extend(entry["shards"])
                else:
                    tensors[name] = entry
        body = {"version": MANIFEST_VERSION, "step": meta["step"],
                "step_counter": meta["step_counter"],
                "timestamp": meta["timestamp"], "tensors": tensors,
                "multihost": {"process_count": cnt,
                              "manifests": manifests}}
        for key in _META_KEYS:
            if key in meta:
                body[key] = meta[key]
        doc = dict(body, crc32=_manifest_crc(body))
        manifest_data = json.dumps(doc, sort_keys=True, indent=1).encode()
        store.put(final, MANIFEST_NAME, manifest_data, "manifest")
        store.finalize(final, final, manifest_data=manifest_data)

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
        store = self._reader_storage()
        store.gc_stale(self.dirname)
        if self.max_to_keep is None:
            return
        complete = []
        for entry in os.listdir(self.dirname):
            m = _CKPT_RE.match(entry)
            path = os.path.join(self.dirname, entry)
            if m and os.path.isdir(path) and validate_checkpoint(
                    path, check_crc=False, storage=store):
                complete.append((int(m.group(1)), path))
        complete.sort(reverse=True)
        for _, path in complete[self.max_to_keep:]:
            shutil.rmtree(path, ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def latest_checkpoint(self):
        """Newest complete checkpoint of this manager's directory.  A
        pod save still in flight under a newer prefix is invisible until
        its marker and every rank's manifest have landed."""
        return latest_checkpoint(self.dirname,
                                 storage=self._reader_storage())

    def restore(self, path=None, scope=None, main_program=None,
                strict=True, reshard=False):
        """Load a checkpoint into the scope.

        Strict (default): every persistable variable of the program must
        be present with a matching shape and dtype (a 32-bit entry of a
        declared 64-bit variable is widened), else a ``RuntimeError``
        names the tensor — and the scope is left untouched, since every
        tensor is read and checked before any is set.  Restores
        ``scope.step_counter`` so step-keyed RNG (dropout) replays
        identically.  Returns the manifest metadata dict.

        A pod checkpoint's sharded vars are reassembled from every rank's
        shard files; a program built with weight-update sharding over N
        ranks then keeps this rank's 1/N slice of each of its sharded
        vars.  A checkpoint saved at another sharding degree (or none) is
        refused unless ``reshard=True``, which re-slices each padded flat
        buffer onto this program's layout (``_reshard_flat``), in both
        directions, a pod checkpoint into a world of one included."""
        with watchdog.extend_deadline(
                "checkpoint_restore",
                flags.get_flag("watchdog_checkpoint_grace_s")):
            return self._restore(path, scope, main_program, strict,
                                 reshard)

    def _restore(self, path, scope, main_program, strict, reshard):
        scope, program = self._resolve(scope, main_program)
        if path is None:
            path = self.latest_checkpoint()
            if path is None:
                raise RuntimeError(
                    "no complete checkpoint found in %r" % self.dirname)
        body = read_manifest(path)
        tensors = body.get("tensors", {})
        saved_deg = int(body.get("shard_degree") or 0) or None
        cur_deg = int(program._wus_degree or 0) or None
        degree_changed = saved_deg != cur_deg and bool(saved_deg or cur_deg)
        if degree_changed and not reshard:
            raise RuntimeError(
                "checkpoint %r holds optimizer state sharded over %s "
                "rank(s) (weight_update_sharding) but this program expects "
                "%s — a different world size.  Pass reshard=True to "
                "restore()/resume() to re-slice the sharded state onto "
                "this world (elastic restore), or inspect the checkpoint "
                "first with fluid.checkpoint.checkpoint_metadata(path)"
                % (path, saved_deg or "0 (unsharded)",
                   cur_deg or "0 (unsharded)"))
        # the reshardable set: every degree-dependent padded flat buffer
        # either side knows about (the manifest's sharded vars and the
        # program's padded map, which also holds the replicated
        # reduce-scatter residual)
        reshardable = {}
        if reshard and degree_changed:
            cur_numel = dict(program._wus_padded_numel)
            saved_numel = body.get("sharded_numel") or {}
            for n in set(body.get("sharded_vars") or ()) | set(cur_numel):
                reshardable[n] = (saved_numel.get(n), cur_numel.get(n))
        # this rank keeps its 1/N slice of each of the program's sharded
        # vars
        rank = self._world()[0]
        local = program._dp_sharded_state if (cur_deg or 1) > 1 else ()
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
            arr = _load_manifest_entry(path, var.name, entry)
            vshape = tuple(var.shape or ())
            if var.name in reshardable and vshape:
                # even when the two padded lengths coincide the re-slice
                # runs: it checks the layouts and re-zeroes the pad
                arr = _reshard_flat(var.name, arr, vshape,
                                    reshardable[var.name], saved_deg,
                                    cur_deg, path)
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
            if var.name in local:
                shard = arr.shape[0] // cur_deg
                arr = arr[rank * shard:(rank + 1) * shard]
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
        mh = body.get("multihost") or {}
        return {"path": path, "step": int(body["step"]),
                "step_counter": scope.step_counter,
                "timestamp": body.get("timestamp"),
                "steps_per_run": saved_k,
                "shard_degree": saved_deg,
                "process_count": int(mh.get("process_count", 1)),
                "resharded": bool(reshardable)}

    def _device(self, scope, name):
        held = scope.find_var(name)
        if isinstance(held, torch.Tensor):
            return held.device
        return device_for_place(self._place if self._place is not None
                                else CUDAPlace(0))

    def resume(self, scope=None, main_program=None, strict=True,
               reshard=False):
        """Auto-resume: restore the newest complete checkpoint if one
        exists, else return None (fresh start).  ``reshard=True`` also
        takes a checkpoint saved at another sharding degree (``restore``)."""
        path = self.latest_checkpoint()
        if path is None:
            return None
        return self.restore(path, scope=scope, main_program=main_program,
                            strict=strict, reshard=reshard)
