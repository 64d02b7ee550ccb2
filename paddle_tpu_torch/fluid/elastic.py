"""Elastic training: survive a change of the world's size (counterpart
``paddle_tpu/fluid/elastic.py``).

A job that loses a rank must come back as a recovery driven by its
checkpoint's metadata, at whatever world is left.  This module is the
driver loop that composes the pieces into that path:

1. **Stop consensus**: ``train_from_dataset`` drains every rank at the
   same window boundary and takes a durable final save.
2. **Re-init with the survivors**: the process either exits 0 and is
   relaunched by ``python -m paddle_tpu_torch.distributed.launch`` at the
   survivor count (``--max_restarts`` / ``--elastic_min_nproc``: a
   ``torch.distributed`` world cannot take back a member that died, so
   the whole pack restarts at a fresh rendezvous port), or, in-process,
   ``fluid.distributed.shutdown()`` destroys the process group (and with
   it an NCCL communicator) and ``init()`` joins the next world at the
   address the caller names.
3. **Reshard-restore**: :func:`resume_resharded` restores the newest
   checkpoint whatever world wrote it (``CheckpointManager.restore(
   reshard=True)`` reassembles every sharded var from its shard files
   and re-slices the padded buffers onto this world), and a
   ``kind="resize"`` lifecycle record carries the old and new world
   sizes and the recovery time in seconds.

Usage (each launched process)::

    from paddle_tpu_torch.fluid import elastic

    def build(ctx):
        # build the program FOR THIS WORLD (ctx.process_count), e.g.
        # GradAllReduce(weight_update_sharding=True).transpile(...)
        exe.run(startup, scope=scope)
        mgr = fluid.CheckpointManager(ckdir, ...)
        return mgr, scope, main_program

    def train(ctx):
        preemption.install()
        return exe.train_from_dataset(ctx.program, dataset,
                                      scope=ctx.scope,
                                      checkpoint_manager=ctx.manager, ...)

    status = elastic.run_elastic(build, train)
    sys.exit(0)          # preempted or done: the final save is durable
"""

import os
import time

from . import preemption
from . import telemetry

_m_resizes = telemetry.counter(
    "elastic_resizes_total",
    "topology changes absorbed by a reshard-restore (world size or "
    "sharding degree differed from the checkpoint's)")
_m_cycles = telemetry.counter(
    "elastic_cycles_total",
    "world incarnations the elastic driver ran (build + restore + train)")
_m_recovery = telemetry.gauge(
    "elastic_last_recovery_seconds",
    "wall seconds of the last reshard-restore recovery (build-to-"
    "restored when driven by run_elastic)")


def world_env():
    """(attempt, prev_nproc) from the env the launcher exports on a
    relaunch (``paddle_tpu_torch/distributed/launch.py``):
    ``PADDLE_ELASTIC_ATTEMPT`` counts pack relaunches (0 on the first
    launch), ``PADDLE_ELASTIC_PREV_NPROC`` is the previous attempt's
    world size (None on the first launch)."""
    attempt = int(os.environ.get("PADDLE_ELASTIC_ATTEMPT", "0") or 0)
    prev = os.environ.get("PADDLE_ELASTIC_PREV_NPROC", "").strip()
    return attempt, (int(prev) if prev else None)


class ElasticContext:
    """One world incarnation of the elastic driver: identity of the
    current world plus the pieces ``build`` constructed for it and the
    restore metadata (None on a fresh start)."""

    __slots__ = ("cycle", "attempt", "process_index", "process_count",
                 "manager", "scope", "program", "restored")

    def __init__(self, cycle, attempt, process_index, process_count):
        self.cycle = cycle
        self.attempt = attempt
        self.process_index = process_index
        self.process_count = process_count
        self.manager = None
        self.scope = None
        self.program = None
        self.restored = None


def resume_resharded(manager, scope=None, main_program=None,
                     strict=True, t_start_ns=None):
    """Reshard-aware auto-resume and its resize record: restore the newest
    complete checkpoint WHATEVER world size or sharding degree wrote it
    (``CheckpointManager.restore(reshard=True)``), and when the
    topology changed — the pod process count or the weight-update-
    sharding degree differs from the checkpoint's — append one
    ``kind="resize"`` lifecycle record to the step-event ring/JSONL
    carrying ``old_world``/``new_world``, ``old_degree``/``new_degree``,
    and ``recovery_s`` (seconds from ``t_start_ns`` — or from this
    call — to the restored state being back in the scope).

    Returns the restore metadata dict with ``resized``/``old_world``/
    ``new_world`` added, or None when the directory holds no complete
    checkpoint (fresh start)."""
    from . import distributed as dist

    t0 = time.perf_counter_ns() if t_start_ns is None else int(t_start_ns)
    # the restore's I/O runs under the watchdog's checkpoint grace
    # (CheckpointManager.restore)
    meta = manager.resume(scope=scope, main_program=main_program,
                          strict=strict, reshard=True)
    if meta is None:
        return None
    _scope, program = manager._resolve(scope, main_program)
    # the restore meta already carries the CHECKPOINT's identity
    # (shard_degree/process_count) — no separate metadata walk needed
    old_world = int(meta["process_count"])
    new_world = int(dist.process_count())
    old_deg = int(meta["shard_degree"] or 0)
    new_deg = int(program._wus_degree or 0)
    dur_ns = time.perf_counter_ns() - t0
    resized = (old_world, old_deg) != (new_world, new_deg)
    meta["resized"] = resized
    meta["old_world"] = old_world
    meta["new_world"] = new_world
    if resized:
        _m_resizes.inc()
        _m_recovery.set(dur_ns / 1e9)
        telemetry.record_lifecycle_event(
            "resize", step=int(meta["step"]), dur_ns=int(dur_ns),
            recovery_s=round(dur_ns / 1e9, 6),
            old_world=old_world, new_world=new_world,
            old_degree=old_deg, new_degree=new_deg,
            pid=os.getpid())
    return meta


def run_elastic(build, train, max_cycles=32, next_world=None):
    """The elastic driver loop: init the world, build the program FOR
    that world, reshard-restore, train until done or preempted.

    ``build(ctx)`` runs after ``fluid.distributed.init()`` and returns
    ``(checkpoint_manager, scope, main_program)`` built for
    ``ctx.process_count`` processes (run the startup program inside —
    the restore overwrites its values).  ``train(ctx)`` runs the
    training loop (typically ``train_from_dataset(...,
    checkpoint_manager=ctx.manager)``, which drains + final-saves on a
    preemption stop); its return value lands in the status dict.

    After ``train`` returns, the driver asks the pod-wide stop
    consensus (every process reaches this point at the same boundary —
    the drain is collective):

    - **No stop**: training completed; return.
    - **Stop, production** (``next_world=None``): return with
      ``preempted=True`` — the caller exits 0 behind its durable final
      save, and the launcher relaunches the pack at the survivor count
      (``--max_restarts N --elastic_min_nproc M``); the fresh processes
      re-enter this driver and reshard-restore.
    - **Stop, in-process resize** (``next_world`` given): call
      ``next_world(ctx)`` for the next world spec — a (possibly empty)
      dict of ``fluid.distributed.init`` kwargs (a new
      ``coordinator_address``, ``num_processes``, ``process_id``,
      ``backend``) to continue with, or None to stop looping.  The
      driver then ``distributed.shutdown()``s (the process group and
      its communicator go), clears the stop flag, re-inits, and loops:
      build → reshard-restore → train in the new world.

    Returns ``{"cycles", "resizes", "preempted", "restored_step",
    "last"}``.
    """
    from . import distributed as dist
    from . import watchdog

    status = {"cycles": 0, "resizes": 0, "preempted": False,
              "restored_step": None, "last": None}
    # hang detection rides the driver: with FLAGS_watchdog_timeout_s>0
    # every elastic incarnation is watched (a rank that stalls instead
    # of crashing is aborted with watchdog.EXIT_HANG, which the
    # launcher answers exactly like the crash path this driver already
    # survives); the flag's default 0 keeps this a no-op
    watchdog.arm()
    init_kwargs = {}
    while True:
        t0 = time.perf_counter_ns()
        telemetry.record_progress("elastic_cycle")
        rank, world = dist.init(**init_kwargs)
        ctx = ElasticContext(cycle=status["cycles"],
                             attempt=world_env()[0],
                             process_index=rank, process_count=world)
        ctx.manager, ctx.scope, ctx.program = build(ctx)
        ctx.restored = resume_resharded(
            ctx.manager, scope=ctx.scope, main_program=ctx.program,
            t_start_ns=t0)
        if ctx.restored is not None:
            status["restored_step"] = ctx.restored["step"]
            if ctx.restored.get("resized"):
                status["resizes"] += 1
        _m_cycles.inc()
        status["last"] = train(ctx)
        status["cycles"] += 1
        if isinstance(status["last"], dict) and \
                "preempted" in status["last"]:
            # train returned train_from_dataset's status: "preempted"
            # is already the pod-wide consensus verdict — no extra
            # collective round needed
            stopped = bool(status["last"]["preempted"])
        else:
            # pod-wide agreement whether this ending was a drain: every
            # process exits the training loop at the same boundary (the
            # in-loop stop consensus), so this is a deterministic
            # collective point
            stopped = preemption.stop_requested()
            if world > 1:
                stopped = dist.any_process(stopped)
        status["preempted"] = bool(stopped)
        if not stopped or next_world is None or \
                status["cycles"] >= int(max_cycles):
            return status
        spec = next_world(ctx)
        if spec is None:
            return status
        # explicit checkpoint fence ahead of the shutdown fence
        # (defense in depth): this incarnation's manager may still be
        # uploading an async save — join it HERE so a background save
        # error surfaces to the driver (raises) instead of being
        # demoted to shutdown()'s teardown warning
        if ctx.manager is not None:
            ctx.manager.wait()
        dist.shutdown()
        preemption.clear()
        # the spec is applied by the loop-top init — an explicit
        # identity must not fight the (stale) launcher env a second
        # argless init would autodetect from
        init_kwargs = spec
