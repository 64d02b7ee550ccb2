"""Training watchdog: turn silent stalls into survivable crashes
(counterpart ``paddle_tpu/fluid/watchdog.py``, the port's own copy).

The recovery machinery — drain-on-SIGTERM, rollback, a launcher's
relaunch — reacts to a process that *exits*.  The
dominant pod failure mode at MLPerf scale is a rank that *stalls*: a
peer dies mid-collective and the survivors park forever in gloo, a feed
producer wedges, a checkpoint barrier never completes.  Such a job
burns its allocation silently.  This module converts "no forward
progress" into the crash the existing elastic path already survives
(the health-watching-supervisor pattern of the MLPerf pod and
TensorFlow papers, PAPERS.md).

Three cooperating pieces:

- **Progress stamps** (``telemetry.record_progress``) — the runtime
  stamps a monotonic last-progress timestamp at every park-prone
  boundary: executor dispatch, feed-ring window staged, checkpoint
  phase, collective-consensus/barrier entry, preemption drain.  With
  the watchdog off (``FLAGS_watchdog_timeout_s=0``, the default) the
  stamp is one dict read + return — bit-exact zero-overhead hot path.
- **The watchdog thread** (:func:`arm`) — polls the stamp's age.  Once
  ``FLAGS_watchdog_timeout_s`` (+ any active phase extension) elapses
  with no progress it dumps ALL thread stacks via ``faulthandler``,
  emits a ``kind="hang"`` lifecycle record naming the last-known
  phase, flushes the metrics JSONL, and hard-aborts with
  ``os._exit(EXIT_HANG)``.  Hard abort is the only correct recovery: a
  thread cannot interrupt a wedged CUDA call or collective —
  no exception, no signal handler will ever run in the parked thread.
  The launcher answers the nonzero exit with its relaunch machinery.
- **Heartbeat file** — the watchdog thread mtime-touches a per-child
  heartbeat file (``PADDLE_HEARTBEAT_FILE``, exported by
  ``distributed/launch.py --heartbeat_timeout``) every poll.  That
  covers the one failure the in-process watchdog cannot: an
  interpreter so wedged (a C extension parked holding the GIL) that
  the watchdog thread itself never runs — the mtime goes stale and the
  launcher kills the group from outside.  With ``FLAGS_watchdog_abort``
  off (observe-only mode) a detected hang also STOPS the heartbeat
  touches, deliberately handing the kill decision to the launcher.

**Phase-aware grace** (:func:`extend_deadline`): checkpoint uploads,
object-store retry backoffs, and first dispatches legitimately
exceed any sane step timeout.  The slow paths wrap themselves in
``with watchdog.extend_deadline(phase, seconds):`` — while active, the
effective deadline is ``timeout + max(active extensions)`` (concurrent
extensions don't sum; the longest wins) and the phase is stamped on
entry/exit, so a slow-but-alive save never false-positives while a
truly wedged one still aborts once the bounded grace runs out.

**Preemption interplay** (fluid/preemption.py): the watchdog stays
armed through a graceful drain — the drain's own boundaries (window
dispatches, the final checkpoint save) keep stamping progress, so a
healthy drain never trips it, while a drain wedged inside a dead
collective is aborted with ``EXIT_HANG`` instead of waiting for the
scheduler's SIGKILL.  The watchdog never touches signal dispositions:
the operator's second SIGTERM/Ctrl-C remains the immediate kill it
always was.

Usage (each training process)::

    from paddle_tpu_torch.fluid import watchdog
    watchdog.arm()            # no-op unless FLAGS_watchdog_timeout_s>0
    ...train...
    watchdog.disarm()         # tests / clean shutdown (optional)

Exit-code contract (docs/distributed.md "Hang detection and
recovery"): ``EXIT_HANG`` (117) = watchdog abort, distinct from every
crash/drain code so launcher post-mortems can tell the root-cause
hung rank from gloo abort-cascade victims.
"""

import contextlib
import faulthandler
import os
import sys
import threading
import time

from . import flags
from . import telemetry

# Dedicated abort code — chosen clear of the codes the runtime already
# produces (0 drain, 1 generic crash, 2 usage, signal deaths 128+n) so
# "hung" is readable straight off a launcher log or scheduler record.
# the JAX package's watchdog and launcher use the same value.
EXIT_HANG = 117

_m_hangs = telemetry.counter(
    "watchdog_hangs_total",
    "hangs detected (no progress past the deadline), by last phase")
_m_armed = telemetry.gauge(
    "watchdog_armed", "1 while the watchdog thread is running")

_state = {
    "thread": None,          # the poll thread (daemon)
    "stop": None,            # threading.Event stopping it
    "timeout_s": 0.0,
    "abort": True,
    "heartbeat": None,       # heartbeat file path or None
    "armed_at": None,        # monotonic arm time (progress floor)
    "stalled": False,        # deadline currently blown (observe mode)
}

# active deadline extensions: token -> seconds.  A plain dict under one
# small lock — extensions are entered on slow paths only (saves,
# retries, compiles), never per hot-path step.
_ext = {}
_ext_lock = threading.Lock()


def is_armed():
    return _state["thread"] is not None and _state["thread"].is_alive()


def extension_s():
    """The currently-active deadline extension in seconds (0.0 when
    none): the MAX of the active grants — concurrent slow phases
    overlap the same wall clock, they don't stack it."""
    with _ext_lock:
        return max(_ext.values(), default=0.0)


@contextlib.contextmanager
def extend_deadline(phase, seconds):
    """Grant the watchdog ``seconds`` of extra deadline while the body
    runs, stamping ``phase`` as progress on entry and exit.  Used by
    storage retry backoffs, checkpoint saves/uploads, and fresh-
    executable compiles (FLAGS_watchdog_*_grace_s).  Nestable and
    thread-safe; a no-op-priced pair of dict ops when disarmed.

    On a progress-suppressed thread (``telemetry.suppress_progress``,
    i.e. a background checkpoint uploader) this is inert: no stamp, no
    grant — a slow background upload must never stretch the deadline
    guarding the training thread, and a hung uploader is detected by
    whoever waits on it (``CheckpointManager.wait`` holds its own
    foreground grace) rather than masked."""
    if telemetry.progress_suppressed():
        yield
        return
    telemetry.record_progress(phase)
    token = object()
    with _ext_lock:
        _ext[token] = float(seconds)
    try:
        yield
    finally:
        # stamp BEFORE dropping the grant: popping first would open a
        # window where the poll thread sees the pre-grace stamp with
        # zero grace and falsely aborts a phase that just finished
        telemetry.record_progress(phase)
        with _ext_lock:
            _ext.pop(token, None)


def _touch_heartbeat(create=False):
    path = _state["heartbeat"]
    if not path:
        return
    try:
        if create or not os.path.exists(path):
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                f.write(str(os.getpid()))
        else:
            os.utime(path, None)
    except OSError:
        pass   # liveness reporting must never kill the trainer


def _report_hang(phase, age, budget):
    """The detection sequence: stderr banner + all-thread stack dump
    (the post-mortem payload — which frame every thread is parked in),
    one ``kind="hang"`` lifecycle record + counter, metrics JSONL
    flushed durable.  Returns after writing; the caller decides abort."""
    phase = phase or "unarmed"
    draining = False
    try:
        from . import preemption
        draining = bool(preemption.stop_requested())
    except Exception:
        pass
    sys.stderr.write(
        "[watchdog] HANG: no progress for %.1fs (deadline %.1fs, last "
        "phase %r, pid %d%s) — dumping all thread stacks\n"
        % (age, budget, phase, os.getpid(),
           ", during preemption drain" if draining else ""))
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except Exception:
        pass
    sys.stderr.flush()
    _m_hangs.inc(phase=phase)
    telemetry.record_lifecycle_event(
        "hang", phase=phase, age_s=round(age, 3),
        timeout_s=_state["timeout_s"], budget_s=round(budget, 3),
        draining=draining, aborting=bool(_state["abort"]),
        pid=os.getpid())
    # the JSONL exporter's handle is flushed+closed so the hang record
    # is durable before (and despite) os._exit; a later record reopens
    telemetry.close_jsonl()


def _poll_loop(stop):
    while True:
        timeout = _state["timeout_s"]
        if stop.wait(max(0.02, min(1.0, timeout / 5.0))):
            return
        t, phase = telemetry.last_progress()
        if t is None:
            t = _state["armed_at"]
        budget = timeout + extension_s()
        age = time.monotonic() - t
        if age <= budget:
            _state["stalled"] = False
            _touch_heartbeat()
            continue
        if _state["stalled"]:
            # observe-only mode, stall persisting: heartbeat stays
            # untouched (the launcher's staleness clock keeps running);
            # a released hang re-enters the healthy branch above
            continue
        _state["stalled"] = True
        _report_hang(phase, age, budget)
        if _state["abort"]:
            # a thread cannot interrupt a wedged dispatch/collective —
            # hard abort, no atexit/finally (they could park too); the
            # launcher relaunches and the job reshard-restores
            os._exit(EXIT_HANG)


def arm(timeout_s=None, heartbeat_file=None, abort=None):
    """Arm hang detection: start the watchdog thread and enable
    progress stamping.  ``timeout_s`` defaults to
    ``FLAGS_watchdog_timeout_s`` — 0 (the flag's default) leaves the
    watchdog off and returns False, so callers may arm unconditionally.
    ``heartbeat_file`` defaults to ``PADDLE_HEARTBEAT_FILE`` (exported
    by ``launch.py --heartbeat_timeout``).  Re-arming updates the
    parameters in place.  Returns True when armed."""
    if timeout_s is None:
        timeout_s = float(flags.get_flag("watchdog_timeout_s"))
    if timeout_s <= 0:
        disarm()
        return False
    if heartbeat_file is None:
        heartbeat_file = os.environ.get("PADDLE_HEARTBEAT_FILE") or None
    if abort is None:
        abort = bool(flags.get_flag("watchdog_abort"))
    _state.update(timeout_s=float(timeout_s), abort=bool(abort),
                  heartbeat=heartbeat_file,
                  armed_at=time.monotonic(), stalled=False)
    telemetry.enable_progress(True)
    _touch_heartbeat(create=True)
    if is_armed():
        return True
    stop = threading.Event()
    thread = threading.Thread(target=_poll_loop, args=(stop,),
                              name="fluid-watchdog", daemon=True)
    _state["stop"] = stop
    _state["thread"] = thread
    thread.start()
    _m_armed.set(1)
    return True


def disarm():
    """Stop the watchdog thread, disable progress stamping (restoring
    the zero-overhead hot path), remove the heartbeat file.  Idempotent;
    safe to call when never armed."""
    stop, thread = _state["stop"], _state["thread"]
    _state["thread"] = None
    _state["stop"] = None
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive() and \
            thread is not threading.current_thread():
        thread.join(timeout=5.0)
    telemetry.enable_progress(False)
    _state["stalled"] = False
    path, _state["heartbeat"] = _state["heartbeat"], None
    if path:
        try:
            os.unlink(path)
        except OSError:
            pass
    _m_armed.set(0)


def health():
    """Liveness verdict for /healthz (tools/metrics_server.py) and
    operator introspection: ``{"armed", "timeout_s", "budget_s",
    "age_s", "phase", "stalled", "healthy"}``.  Unarmed is healthy
    (nothing is watching, nothing can be stale)."""
    armed = is_armed()
    t, phase = telemetry.last_progress()
    if t is None:
        t = _state["armed_at"]
    budget = _state["timeout_s"] + extension_s() if armed else None
    age = (time.monotonic() - t) if (armed and t is not None) else None
    healthy = (not armed) or (age is not None and age <= budget and
                              not _state["stalled"])
    return {"armed": armed, "timeout_s": _state["timeout_s"] if armed
            else None, "budget_s": budget, "age_s": age, "phase": phase,
            "stalled": bool(_state["stalled"]), "healthy": healthy}
