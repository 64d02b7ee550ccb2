"""Preemption-safe shutdown: turn SIGTERM/SIGINT into a graceful stop
(counterpart ``paddle_tpu/fluid/preemption.py``, the port's own copy).

At pod scale preemption is the steady state (checkpoint.py's fault
model): the scheduler sends SIGTERM, waits a grace period, then
SIGKILLs.  This module converts that signal into a *stop request* the
training loop honors at the next step/window boundary —
``Executor.train_from_dataset`` drains the in-flight window, takes a
final ``CheckpointManager.save(sync=True)`` — forced synchronous even
for async-configured managers, pod protocol included: the process
exits right after the drain, so the final checkpoint must be
COMMITTED, not in flight — waits out any async save, and returns, so
the process exits 0 with zero lost work instead of dying mid-write.

Design constraints:

- **Async-signal-safe handler.**  The handler only mutates a plain dict
  (atomic under the GIL) — it must not touch telemetry's lock (the main
  thread might be holding it when the signal lands) or any
  ``threading`` primitive.  Counters are flushed on the next
  ``stop_requested()`` poll, which runs in normal context.
- **Second signal = now.**  A second receipt of the same signal
  restores the previous disposition and re-raises it, so an insistent
  scheduler (or an operator's double Ctrl-C) still gets an immediate
  kill instead of a process that "traps" its own shutdown.
- **Producers drain too.**  DataLoader worker threads (reader.py) and
  dataset shard readers (dataset.py) poll ``stop_requested()`` so a
  stop request can never leave a producer parked on a full queue the
  consumer will no longer drain.
- **Watchdog interplay** (fluid/watchdog.py).  An armed watchdog stays
  armed through the drain: the drain's own boundaries (window
  dispatches, the final checkpoint save with its phase grace) keep
  stamping progress, so a healthy drain never trips it — while a drain
  wedged inside a dead collective is hard-aborted with
  ``watchdog.EXIT_HANG`` instead of waiting for the scheduler's
  SIGKILL (the hang record carries ``draining=True``).  The watchdog
  never touches signal dispositions, so the **second signal = now**
  contract below is unchanged: an insistent operator still wins.

Usage::

    from paddle_tpu_torch.fluid import preemption
    preemption.install()                    # once, in the main thread
    exe.train_from_dataset(main, dataset, checkpoint_manager=mgr, ...)
    if preemption.stop_requested():         # we were preempted
        sys.exit(0)                         # ckpt already durable

Telemetry: ``preemption_signals_total{signal}``,
``preemption_stops_total`` (drains completed), the
``preemption_requested`` gauge, and one ``kind="preemption"`` lifecycle
record in the step-event ring/JSONL per drain
(docs/observability.md).
"""

import os
import signal

from . import telemetry

_m_signals = telemetry.counter(
    "preemption_signals_total",
    "stop-requesting signals received, by signal name")
_m_stops = telemetry.counter(
    "preemption_stops_total",
    "graceful drains completed (window drained, final checkpoint durable)")
_m_requested = telemetry.gauge(
    "preemption_requested", "1 from stop request until clear()")

# handler-side state: plain dict mutations only (async-signal-safe); the
# pending list defers counter increments out of handler context
_flag = {"stop": False, "reason": None}
_pending = []
_prev_handlers = {}


def _handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = "SIG%d" % signum
    if _flag["stop"]:
        # second signal while already draining: restore the previous
        # disposition and re-deliver — the sender wants us gone NOW
        prev = _prev_handlers.get(signum, signal.SIG_DFL)
        if not callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
            prev = signal.SIG_DFL
        signal.signal(signum, prev)
        signal.raise_signal(signum)
        return
    _pending.append(name)
    _flag["reason"] = name
    _flag["stop"] = True


def _flush_pending():
    flushed = False
    while _pending:
        try:
            name = _pending.pop(0)
        except IndexError:
            break
        _m_signals.inc(signal=name)
        _m_requested.set(1)
        flushed = True
    if flushed:
        # normal (non-handler) context: the drain now beginning is
        # forward progress — restart the watchdog's age clock so the
        # grace window is measured from the stop, not the last step
        telemetry.record_progress("preemption_drain")


def install(signals=(signal.SIGTERM, signal.SIGINT)):
    """Install the graceful-stop handler for ``signals`` (main thread
    only — CPython's signal contract).  Idempotent; returns the list of
    signals actually hooked (empty when called off the main thread)."""
    hooked = []
    for sig in signals:
        try:
            prev = signal.signal(sig, _handler)
        except (ValueError, OSError):   # non-main thread / unsupported
            continue
        if sig not in _prev_handlers and prev is not _handler:
            _prev_handlers[sig] = prev
        hooked.append(sig)
    return hooked


def uninstall():
    """Restore the pre-``install()`` signal dispositions (tests; does
    NOT clear an already-pending stop request — see ``clear()``)."""
    for sig, prev in list(_prev_handlers.items()):
        try:
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        del _prev_handlers[sig]


def request_stop(reason="api"):
    """Programmatic stop request — same effect as receiving SIGTERM
    (the loop drains at its next boundary).  Callable from any
    thread."""
    _flag["reason"] = reason
    _flag["stop"] = True
    _m_signals.inc(signal=reason)
    _m_requested.set(1)


def stop_requested():
    """True once a stop has been requested (signal or API).  The
    per-boundary poll of the training loop and every producer thread —
    a dict read plus, at most, a one-time counter flush."""
    if _pending:
        _flush_pending()
    return _flag["stop"]


def stop_reason():
    """Signal name / reason string of the first stop request (None if
    none pending)."""
    return _flag["reason"]


def clear():
    """Forget the stop request (after a completed drain, or tests)."""
    _flag["stop"] = False
    _flag["reason"] = None
    _m_requested.set(0)


def record_drain(step, dur_ns, saved, reason=None, source="train"):
    """Account one completed graceful drain: bumps
    ``preemption_stops_total`` and appends a ``kind="preemption"``
    lifecycle record to the step-event ring/JSONL (so
    ``tools/metrics_report.py`` and the chrome trace see where the job
    was preempted).  ``source`` says which loop drained: ``"train"``
    (train_from_dataset's window drain) or ``"serving"`` (the serving
    scheduler answering its accepted requests; ``step`` carries the
    response count there)."""
    _flush_pending()
    _m_stops.inc()
    telemetry.record_progress("preemption_drain")
    telemetry.record_lifecycle_event(
        "preemption", step=int(step), dur_ns=int(dur_ns),
        saved=bool(saved), source=source,
        reason=reason if reason is not None
        else _flag["reason"], pid=os.getpid())
