"""Checkpoint storage backends: where the bytes land and how a
checkpoint becomes *visible*.

``checkpoint.CheckpointManager`` writes through a :class:`Storage`
object so the atomicity story is a per-backend protocol instead of a
hard-coded POSIX assumption:

- :class:`LocalStorage` — today's semantics: stage every file into a
  ``step-<N>.tmp-<uuid>/`` dir (fsync'd) and commit with ONE
  ``os.rename``.  Rename is atomic on POSIX, so directory existence IS
  the commit marker.
- :class:`ObjectStoreStorage` — a GCS/S3-style store has **no rename**:
  objects upload one by one under their final ``step-<N>/`` prefix and
  become listable immediately, so "the directory exists" means nothing.
  Commitment is granted only by a **marker object**
  (``_COMMITTED.json``, written last, carrying a self-CRC plus the
  manifest's content CRC32) that ``latest_checkpoint()`` /
  ``validate_checkpoint()`` require before a checkpoint may be
  selected.  Transient I/O errors (the HTTP 429/5xx class) are retried
  with bounded exponential backoff.

This is the port's copy of ``paddle_tpu/fluid/storage.py``, single
process, with its retry counters (``storage_retry_total{backend}``,
``storage_retry_exhausted_total``) and the watchdog's deadline extension
around a retry's sleep.  Left for later: ``MixedProtocolReader``, the claim lease that pod saves write first and
the debris reaper's minimum-age guard, all of which exist for several
writers under one prefix (item 10b).

The object-store backend here SIMULATES that contract over a local
directory — uploads may be torn mid-write by a kill (strictly weaker
than a real store's atomic-per-object put, so safety proofs transfer),
and nothing is ever renamed.  A production GCS client implements the
same four methods against the real API; the checkpoint layer cannot
tell the difference, which is the point.

Fault points (``checkpoint.set_fault_hook``): per-object writes reuse the
``tensor:*`` / ``manifest*`` points; the marker write fires
``marker:<dir>_begin/_mid/_end`` so the kill matrix covers
"crashed between shard upload and marker commit" explicitly.
"""

import json
import os
import re
import shutil
import time
import zlib

from . import telemetry
from . import watchdog

_m_retries = telemetry.counter(
    "storage_retry_total",
    "transient storage I/O errors retried, by backend")
_m_retry_exhausted = telemetry.counter(
    "storage_retry_exhausted_total",
    "storage operations that failed after the whole retry budget")


MARKER_NAME = "_COMMITTED.json"
MARKER_VERSION = 1
_STEP_RE = re.compile(r"^step-(\d+)$")


class TransientStorageError(OSError):
    """An explicitly-retryable storage failure — the HTTP 429/5xx
    analogue.  Plain ``OSError`` is treated as transient too on the
    object-store backend (flaky networks dominate there); a
    ``BaseException`` kill (SimulatedCrash/SIGKILL) is never retried."""


class Storage:
    """Write/commit/validate protocol of one checkpoint backend.

    A save is always: ``stage = begin(final)`` → ``put(stage, fname,
    data, point)`` per file (manifest last) → ``finalize(stage, final,
    manifest_data)``.  Readers ask ``commit_invalid_reason(dir)`` — None
    means the checkpoint is committed and its files may be trusted as
    far as the commit protocol goes (content CRCs are still the
    manifest's job).  ``gc_stale(dirname)`` reaps debris a crashed save
    left behind, never anything committed."""

    name = "abstract"
    # True when commitment is the marker object, not an atomic rename.
    # Writers stamp it into the manifest (``"commit": "marker"``) so a
    # reader demands the marker for dirs this backend wrote instead of
    # guessing the dialect from file presence — a markerless dir is only
    # trustable when a RENAME-committed writer made it visible
    commit_via_marker = False

    def begin(self, final):
        raise NotImplementedError

    def put(self, stage, fname, data, point):
        raise NotImplementedError

    def finalize(self, stage, final, manifest_data=None):
        raise NotImplementedError

    def commit_invalid_reason(self, ckpt_dir):
        raise NotImplementedError

    def is_committed(self, ckpt_dir):
        return self.commit_invalid_reason(ckpt_dir) is None

    def gc_stale(self, dirname):
        raise NotImplementedError


class LocalStorage(Storage):
    """POSIX rename commit: a staged
    tmp dir becomes the checkpoint in one ``os.rename``, so any
    committed (non-``.tmp-*``) directory is by construction complete as
    far as the commit protocol is concerned."""

    name = "local"

    def begin(self, final):
        import uuid
        from .checkpoint import _TMP_MARK
        parent = os.path.dirname(os.path.abspath(final)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = final + _TMP_MARK + uuid.uuid4().hex[:8]
        os.makedirs(tmp)
        return tmp

    def put(self, stage, fname, data, point):
        from .checkpoint import write_file
        write_file(os.path.join(stage, fname), data, point)

    def finalize(self, stage, final, manifest_data=None):
        from .checkpoint import commit_dir
        commit_dir(stage, final)

    def commit_invalid_reason(self, ckpt_dir):
        # the rename IS the marker: a visible step dir was committed
        # whole (in-flight saves live under .tmp-* names readers skip)
        return None

    def gc_stale(self, dirname):
        from .checkpoint import gc_stale_tmp
        gc_stale_tmp(dirname)


class ObjectStoreStorage(Storage):
    """GCS-style backend: per-object uploads under the final prefix, a
    marker object as the commit point, retry-with-backoff on transient
    errors: ``retries`` retries, the first after ``backoff_s`` seconds."""

    name = "object_store"
    commit_via_marker = True

    def __init__(self, retries=3, backoff_s=0.05):
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)

    # -- retry-with-backoff ------------------------------------------------
    def _retrying(self, fn):
        """Run ``fn`` with up to ``retries`` retries on OSError (backoff
        doubling from ``backoff_s``).  A retry re-runs the whole write —
        object puts are idempotent, a torn attempt is simply
        overwritten.  Kills (BaseException) propagate untouched."""
        delay = self.backoff_s
        last = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except OSError as e:
                last = e
                if attempt >= self.retries:
                    break
                _m_retries.inc(backend=self.name)
                # a retry backoff is the runtime coping with a flaky
                # store, not a hang: the deadline stretches by the sleep
                # plus headroom for the re-attempt
                with watchdog.extend_deadline("storage_retry",
                                              2.0 * delay + 1.0):
                    time.sleep(delay)
                delay *= 2
        _m_retry_exhausted.inc(backend=self.name)
        raise last

    # -- write/commit protocol ---------------------------------------------
    def begin(self, final):
        os.makedirs(os.path.dirname(os.path.abspath(final)) or ".",
                    exist_ok=True)
        if os.path.isdir(final):
            # re-saving an existing step (post-rollback replay) or
            # reclaiming crashed-upload debris.  If the old prefix was
            # COMMITTED, withdraw the commit FIRST — deleting the marker
            # is one object op, so a kill anywhere in the overwrite
            # leaves an unmarked debris prefix, never a committed-but-
            # torn checkpoint.  (There is no rename to hide behind: this
            # is the honest object-store overwrite protocol, and readers
            # fall back to the previous committed step meanwhile.)
            marker = os.path.join(final, MARKER_NAME)
            if os.path.isfile(marker):
                self._retrying(lambda: os.unlink(marker))
            shutil.rmtree(final, ignore_errors=True)
        os.makedirs(final, exist_ok=True)
        return final   # no staging area: objects land under their prefix

    def put(self, stage, fname, data, point):
        from .checkpoint import write_file
        self._retrying(
            lambda: write_file(os.path.join(stage, fname), data, point))

    def finalize(self, stage, final, manifest_data=None):
        """Commit by writing the marker object LAST.  The marker pins
        the manifest's content CRC32, so a marker paired with a
        torn/stale manifest (crash-reordered uploads, a half-overwritten
        retry) never validates."""
        from .checkpoint import write_file
        body = {"version": MARKER_VERSION,
                "manifest_crc32":
                    (zlib.crc32(manifest_data) & 0xFFFFFFFF)
                    if manifest_data is not None else None}
        doc = dict(body, crc32=_marker_crc(body))
        data = json.dumps(doc, sort_keys=True).encode("utf-8")
        point = "marker:" + os.path.basename(final)
        self._retrying(
            lambda: write_file(os.path.join(final, MARKER_NAME), data,
                               point))

    # -- read/validate protocol ----------------------------------------------
    def commit_invalid_reason(self, ckpt_dir):
        from .checkpoint import MANIFEST_NAME
        path = os.path.join(ckpt_dir, MARKER_NAME)
        if not os.path.isfile(path):
            return "no commit marker (upload never finalized)"
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (ValueError, UnicodeDecodeError, OSError) as e:
            return "unreadable commit marker: %s" % (e,)
        if not isinstance(doc, dict) or "crc32" not in doc:
            return "commit marker lacks a crc32"
        body = {k: v for k, v in doc.items() if k != "crc32"}
        if _marker_crc(body) != doc["crc32"]:
            return "commit marker self-CRC mismatch (flipped/torn bytes)"
        if body.get("version") != MARKER_VERSION:
            return "commit marker version %r unsupported" % (
                body.get("version"),)
        want = body.get("manifest_crc32")
        if want is not None:
            mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
            try:
                with open(mpath, "rb") as f:
                    have = zlib.crc32(f.read()) & 0xFFFFFFFF
            except OSError:
                return "manifest missing/unreadable under a valid marker"
            if have != want:
                return "manifest does not match the committed marker"
        return None

    def gc_stale(self, dirname):
        """Reap step prefixes whose upload never reached the marker —
        under the single-writer contract those are crashed-save debris.
        A marker that exists but fails validation is KEPT for
        post-mortem (bit-rot after commit is evidence, not debris).

        No markerless prefix here can be a live upload: the one writer
        waits out its save in flight before it starts another, and runs
        this after its commit.  (The JAX package's pod saves spare young
        prefixes behind a claim lease; that waits for ROADMAP queue 1
        item 10b.)"""
        if not os.path.isdir(dirname):
            return
        for entry in os.listdir(dirname):
            path = os.path.join(dirname, entry)
            if not (_STEP_RE.match(entry) and os.path.isdir(path)):
                continue
            if os.path.isfile(os.path.join(path, MARKER_NAME)):
                continue
            shutil.rmtree(path, ignore_errors=True)


def _marker_crc(body):
    return zlib.crc32(
        json.dumps(body, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF

