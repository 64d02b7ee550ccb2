"""Executor, places and scopes (reference ``python/paddle/fluid/executor.py``;
counterpart ``paddle_tpu/fluid/executor.py``).

``Executor.run`` resolves (program, feed signature, fetch list) to a
dispatch plan once — which scope vars the block reads and writes, how
each feed is coerced — and then runs the block's ops eagerly on the
place's torch device.  There is no compiler behind it: ``compile_count``
counts plan builds, one per (program, feed signature), so "no new plan
after warmup" keeps the meaning "no recompile" has in the JAX package.

Entry points run on the card unless the caller asks for the CPU:
``Executor()`` is ``Executor(CUDAPlace(0))``, and a ``CUDAPlace`` raises
when PyTorch sees no CUDA device instead of falling back to the host.
"""

import contextlib
import time

import numpy as np
import torch

from . import distributed
from . import flags
from . import framework
from . import preemption
from . import profiler
from . import telemetry
from . import watchdog
from .data_types import BF16_HOST, np_dtype, to_numpy, torch_dtype
from .lowering import ExecState, plan_release, plan_tape, run_block

_NULL_CTX = contextlib.nullcontext()

# telemetry instruments (the JAX package's names, executor.py:47-101)
_m_plan = telemetry.counter(
    "executor_plan_lookups_total", "dispatch-plan cache lookups, by result")
_m_compile_s = telemetry.histogram(
    "executor_compile_seconds",
    "wall seconds of a fresh plan's first dispatch")
_m_dispatch_s = telemetry.histogram(
    "executor_dispatch_host_seconds",
    "host wall seconds per dispatch, by kind",
    buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0))
_m_ckpt_inflight = telemetry.gauge(
    "checkpoint_async_in_flight",
    "1 while an async checkpoint save is serializing/committing")
_m_rollbacks = telemetry.counter(
    "rollback_total",
    "automatic rollback-to-last-checkpoint restores "
    "(FLAGS_bad_step_rollback)")
_m_rollback_step = telemetry.gauge(
    "rollback_last_step", "step the most recent rollback restored to")
_m_device_mem = telemetry.gauge(
    "device_memory_bytes",
    "device bytes held by the caching allocator at dispatch boundaries "
    "(FLAGS_metrics_device_memory): kind=live now, kind=peak the most "
    "since the process started")
_mem_peak = [0]
_m_comm_bytes = telemetry.counter(
    "collective_bytes_total",
    "collective wire payload bytes per rank, by species, wire precision "
    "and axis — always dp, one process per rank (an all-reduce counted "
    "as its two phases, reduce-scatter and all-gather; "
    "ops/collective_ops.py)")


class Place:
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


def device_for_place(place):
    """torch.device of a place.  A CUDAPlace with no CUDA device raises:
    the port never silently computes on the host."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if not isinstance(place, CUDAPlace):
        raise TypeError("place must be CPUPlace or CUDAPlace, got %r"
                        % (place,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "%r needs a CUDA device and PyTorch sees none; pass "
            "CPUPlace() explicitly to run on the host" % (place,))
    n = torch.cuda.device_count()
    if place.device_id >= n:
        raise RuntimeError("%r: only %d CUDA device(s) visible"
                           % (place, n))
    return torch.device("cuda", place.device_id)


# ---------------------------------------------------------------------------
# Scope (reference: framework/scope.h; pybind _global_scope)
# ---------------------------------------------------------------------------

class Scope:
    """name → torch tensor, with parent lookup."""

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent
        self.step_counter = 0

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        return self.find_var(name) is not None

    def set_var(self, name, value):
        self.vars[name] = value

    def var_names(self):
        return list(self.vars)

    def new_scope(self):
        return Scope(parent=self)

    def find_var_numpy(self, name):
        v = self.find_var(name)
        return None if v is None else to_numpy(v)

    def snapshot(self, names=None):
        """Host snapshot of named vars, the checkpoint extraction point
        (checkpoint.py): ``{name: ndarray}``, each bfloat16 tensor as its
        bits (``data_types.BF16_HOST``).  Device tensors are copied into
        pinned host buffers with ``non_blocking=True`` and the copies
        are fenced by ONE ``torch.cuda.synchronize()``; host tensors are
        copied too.  The arrays own their memory, so the caller may go on
        training (and update the scope in place) at once.  Names missing
        from the scope are skipped."""
        if names is None:
            names = self.var_names()
        bufs, on_card = {}, False
        for n in names:
            v = self.find_var(n)
            if v is None:
                continue
            src = v.detach()
            if src.dtype == torch.bfloat16:
                src = src.view(torch.int16)
            on_card = on_card or src.is_cuda
            buf = torch.empty(src.shape, dtype=src.dtype,
                              pin_memory=src.is_cuda)
            buf.copy_(src, non_blocking=src.is_cuda)
            bufs[n] = (buf, v.dtype == torch.bfloat16)
        if on_card:
            torch.cuda.synchronize()
        # numpy() shares the buffer and keeps it alive
        return {n: buf.numpy().view(BF16_HOST) if bf16 else buf.numpy()
                for n, (buf, bf16) in bufs.items()}


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = prev


# ---------------------------------------------------------------------------
# Block analysis: which scope vars a block reads/writes
# ---------------------------------------------------------------------------

def _block_reads_writes(block, feed_names):
    """(reads-before-write, writes) over the block's op slots, in order."""
    reads, writes = [], []
    written = set(feed_names)
    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        for names in op.inputs.values():
            for n in names:
                if n and n not in written:
                    reads.append(n)
                    written.add(n)
        for names in op.outputs.values():
            for n in names:
                if n:
                    writes.append(n)
                    written.add(n)
    return list(dict.fromkeys(reads)), list(dict.fromkeys(writes))


def _feed_coercer(want, device):
    """Feed value → tensor of the declared dtype on ``device``."""
    want_np = np_dtype(want) if want not in (None, "bfloat16") else None
    want_t = torch_dtype(want) if want is not None else None

    def coerce(val):
        if isinstance(val, torch.Tensor):
            return val.to(device=device, dtype=want_t or val.dtype)
        arr = np.ascontiguousarray(np.asarray(val, dtype=want_np))
        t = torch.from_numpy(arr)
        if want_t is not None and t.dtype != want_t:
            t = t.to(want_t)
        return t.to(device)
    return coerce


def _feed_sig(val):
    if isinstance(val, (torch.Tensor, np.ndarray)):
        return (tuple(val.shape), str(val.dtype))
    a = np.asarray(val)
    return (a.shape, str(a.dtype))




def prefetch_ahead(put, batches, depth=None, stop_when=None):
    """Input staging ahead of consumption — the ONE entry point of the
    DataLoader producer (reader.py) and ``train_from_dataset``.

    ``depth`` (default ``FLAGS_feed_ring_depth``) selects the pipeline:

    - ``depth >= 1`` — :class:`reader.FeedRing`: a producer thread applies
      ``put`` (a ``reader.CardStager`` on the card: pinned buffer,
      side-stream copy, event) up to ``depth`` windows ahead, so the host
      fill and the H2D copy overlap the consumer's device work;
    - ``depth == 0`` — the synchronous one-batch lookahead: ``put.sync``
      (``put`` itself if it has none) is applied to the NEXT batch
      before the current one is yielded, on the consumer's own thread.
      The same values; the A/B control.

    The returned iterator supports ``close()``: it closes the source
    iterator and, on the ring path, joins the producer thread.
    ``stop_when`` is an extra drain predicate threaded to the ring."""
    if depth is None:
        depth = int(flags.get_flag("feed_ring_depth"))
    if depth and depth > 0:
        from .reader import FeedRing
        return FeedRing(put, batches, depth, stop_when=stop_when)
    return _prefetch_ahead_sync(getattr(put, "sync", put), batches)


def _prefetch_ahead_sync(put, batches):
    """The depth-0 path of ``prefetch_ahead`` (see there)."""
    it = iter(batches)
    try:
        try:
            ahead = put(next(it))
        except StopIteration:
            return
        for nxt in it:
            nxt = put(nxt)
            yield ahead
            ahead = nxt
        yield ahead
    finally:
        # generator .close() / GC must release the source too
        if hasattr(it, "close"):
            it.close()


def _nbytes(v):
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(getattr(v, "nbytes", 0) or 0)


def _finite_verdict(fetches, new_state):
    """FLAGS_check_nan_inf=skip's verdict of one step, computed on the
    device (JAX ``_make_skip_fn``, executor.py:442): every float value of
    the updated persistable state and every SCALAR float fetch (a
    non-scalar fetch may legitimately hold -inf, e.g. an attention
    mask) must be finite.  A 0-d bool tensor; nothing is read back."""
    scan = [f for f in fetches
            if isinstance(f, torch.Tensor) and f.numel() == 1]
    scan += list(new_state)
    flags_ = [torch.isfinite(x).all() for x in scan
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not flags_:
        return None
    return torch.stack(flags_).all()


def _raise_non_finite(log):
    """FLAGS_check_nan_inf=raise: ``log`` holds (op type, output name,
    0-d finiteness tensor) for every float output of every op the
    dispatch ran; one read-back, then raise naming the first op whose
    output is not finite (operator.cc:953-984)."""
    if not log:
        return
    profiler.record_host_sync("check_nan_inf")
    ok = torch.stack([f for _, _, f in log]).cpu()
    if bool(ok.all()):
        return
    i = int((~ok).nonzero()[0, 0])
    op_type, name, _ = log[i]
    raise RuntimeError("Operator %s output %s contains Inf or Nan"
                       % (op_type, name))


def _comm_fields(comm_log):
    """The step event's collective fields from the dispatch's comm log,
    counted into ``collective_bytes_total`` (JAX executor.py:1500-1523)."""
    if not comm_log:
        return dict(comm_bytes=0, comm_by=None, comm_by_axis=None,
                    comm_buckets=0)
    by, total, buckets = {}, 0, 0
    for species, precision, nb, bucket in comm_log:
        _m_comm_bytes.inc(nb, species=species, precision=precision,
                          axis="dp")
        key = "%s_%s" % (species, precision)
        by[key] = by.get(key, 0) + nb
        total += nb
        buckets += bucket
    return dict(comm_bytes=total, comm_by=by, comm_by_axis={"dp": total},
                comm_buckets=buckets)


def _stop_consensus(world):
    """The stream-end stop check (JAX executor.py:685): the local stop
    request, or in a world of several ranks the OR over every rank
    (each rank's stream ended at the same count, so all arrive here)."""
    local = preemption.stop_requested()
    if world <= 1:
        return local
    return distributed.any_process(local)


class _CompiledProgramProxy:
    """Marker base of ``compiler.CompiledProgram``: ``Executor.run`` and
    ``run_window`` hand such a program its own ``_run``/``_run_window``
    (JAX executor.py has the same marker)."""


class _DispatchPlan:
    """Everything ``run``/``run_window`` resolves once per (program, feed
    signature, fetch list, K): the state the block reads and writes and
    one coercer per feed.  ``steps_per_run`` > 1 (or ``window``) marks a
    run_window plan: feeds arrive stacked ``[K, ...]``, are coerced once
    per window, and inner step i reads the view ``v[i]``."""

    def __init__(self, program, feed_names, fetch_names, device,
                 steps_per_run=1, window=False):
        block = program.global_block()
        reads, writes = _block_reads_writes(block, feed_names)
        state_in = []
        for n in reads:
            var = block._find_var_recursive(n)
            if var is None or var.persistable or n in fetch_names:
                state_in.append(n)
            else:
                raise RuntimeError(
                    "Op input %r is neither fed, produced by a prior op, nor "
                    "persistable — the program reads an undefined temporary."
                    % n)
        write_set = set(writes)
        for n in fetch_names:
            if n not in write_set and n not in feed_names and \
                    n not in state_in:
                state_in.append(n)
        self.block = block
        self.state_in = state_in
        self.state_out = [n for n in writes
                          if getattr(block._find_var_recursive(n),
                                     "persistable", False)]
        self.fetch_names = list(fetch_names)
        self.bind = [(n, _feed_coercer(block._find_var_recursive(n).dtype
                                       if block.has_var(n) else None,
                                       device))
                     for n in feed_names]
        # forward ops that record on the tape for their _grad op; empty
        # for a program without grad ops (inference records nothing)
        self.taped = plan_tape(block)
        # temporaries leave the environment after their last op, so a
        # step holds only what is still to be read (and what the tape
        # saved), not every activation and gradient until run() ends
        self.release = plan_release(
            block, set(self.state_out) | set(self.fetch_names))
        self.steps_per_run = int(steps_per_run)
        self.is_window = bool(window)
        # the first dispatch of a plan carries its first-call costs; the
        # step event stamps its wall time as compile_s, then clears this
        self.fresh = True


class Executor:
    """Run programs on one place (reference executor.py:294 contract)."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_for_place(self.place)
        self._plans = {}
        self._compile_count = 0
        self._last_plan_hit = None

    def compile_count(self):
        """Dispatch plans built so far, one per (program, feed signature,
        fetch list, window size).  A delta of 0 across dispatches proves
        no new shape reached the executor — the serving executor's
        zero-recompile contract reads it."""
        return self._compile_count

    def _plan(self, program, feed, fetch_names, steps_per_run=None):
        names = tuple(sorted(feed))
        key = (program.fingerprint, names,
               tuple(_feed_sig(feed[n]) for n in names), tuple(fetch_names))
        if steps_per_run is not None:
            key = key + ("__window__", steps_per_run)
        plan = self._plans.get(key)
        if plan is None:
            self._compile_count += 1
            self._last_plan_hit = False
            _m_plan.inc(result="miss")
            plan = _DispatchPlan(program, names, fetch_names, self.device,
                                 steps_per_run=steps_per_run or 1,
                                 window=steps_per_run is not None)
            self._plans[key] = plan
        else:
            self._last_plan_hit = True
            _m_plan.inc(result="hit")
        return plan

    @staticmethod
    def _fetch_names(fetch_list):
        return [v.name if isinstance(v, framework.Variable) else v
                for v in (fetch_list or ())]

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program`` once.  ``feed``: {name: ndarray | tensor};
        ``fetch_list``: Variables or names.  Returns a list of numpy
        arrays, or with ``return_numpy=False`` the live device tensors
        (kernels may still be running: materialize them on the stream
        they were produced on, or after an event recorded there).

        With no feed and a non-iterable DataLoader bound to the program
        (``DataLoader.from_generator(iterable=False)``, ``py_reader``),
        the run pulls its feed from the loader, and a loader that stages
        ``[K, ...]`` windows runs them through ``run_window``; the pass
        end raises ``fluid.core.EOFException``."""
        program = program or framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        if isinstance(program, _CompiledProgramProxy):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        if not feed and getattr(program, "_loader", None) is not None:
            return self._loader_fed_run(
                program._loader,
                lambda f: self._run_resolved(program, f, fetch_list, scope,
                                             return_numpy),
                lambda f, k: self.run_window(program, feed=f,
                                             fetch_list=fetch_list,
                                             scope=scope, steps_per_run=k,
                                             return_numpy=False))
        return self._run_resolved(program, feed, fetch_list, scope,
                                  return_numpy)

    def _run_resolved(self, program, feed, fetch_list, scope, return_numpy):
        feed = feed or {}
        fetch_names = self._fetch_names(fetch_list)
        plan = self._plan(program, feed, fetch_names)
        return self._dispatch(program, plan, scope, feed, return_numpy)

    def run_window(self, program=None, feed=None, fetch_list=None,
                   scope=None, steps_per_run=None, return_numpy=False):
        """Run K training steps in ONE call (JAX ``Executor.run_window``,
        executor.py:1280).  ``feed`` values are stacked ``[K, per-step
        shape...]`` (``dataset.stack_batch_windows`` builds them);
        fetches come back stacked ``[K, ...]`` as live tensors.  State
        behaves exactly as over K consecutive ``run`` calls: carried
        state is read from the previous inner step, read-only state
        stays at its scope value, write-only state keeps its last inner
        step's value, and the scope is written once, at the end.  Inner
        step i runs at step ``step0 + i`` (the step-keyed dropout and
        random streams), so a window is bit-equal to K ``run`` calls;
        ``scope.step_counter`` advances by K.  One plan per (program,
        feed signature, fetches, K); each feed is coerced once per
        window and inner step i reads the view ``v[i]``; nothing inside
        the window reads the device back.  ``steps_per_run`` defaults
        to ``FLAGS_steps_per_run``."""
        K = flags.steps_per_run_value(steps_per_run)
        program = program or framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        if isinstance(program, _CompiledProgramProxy):
            return program._run_window(self, feed, fetch_list, scope, K,
                                       return_numpy)
        feed = dict(feed or {})
        for n, v in feed.items():
            shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
            if not shape or shape[0] != K:
                raise ValueError(
                    "run_window(steps_per_run=%d): feed %r must be "
                    "stacked [K, per-step shape...] with leading dim %d, "
                    "got shape %s" % (K, n, K, shape))
        fetch_names = self._fetch_names(fetch_list)
        plan = self._plan(program, feed, fetch_names, steps_per_run=K)
        return self._dispatch(program, plan, scope, feed, return_numpy)

    def _loader_fed_run(self, loader, run_step, run_window):
        """Pull one staged batch from a program-bound loader and dispatch
        it (JAX executor.py:1329).  Binds this executor's device first so
        the producer stages later batches there.  A loader staging
        stacked ``[K, ...]`` windows routes to ``run_window(feed, k)``
        (the trailing window may be shorter); per-step loaders go
        through ``run_step(feed)``.  Raises ``core.EOFException`` at
        the pass end."""
        loader._consumer_device = self.device
        feed = loader.next_feed()
        if getattr(loader, "_steps_per_run", 1) > 1:
            k = int(next(iter(feed.values())).shape[0]) if feed else 1
            return run_window(feed, k)
        return run_step(feed)

    def _state(self, plan, scope):
        vals = {}
        for n in plan.state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    "variable %r is read by the program but not in the "
                    "scope — run the startup program (or load the "
                    "parameters) first" % n)
            if v.device != self.device:
                raise RuntimeError(
                    "variable %r lives on %s but this executor runs on %s"
                    % (n, v.device, self.device))
            vals[n] = v
        return vals

    def _execute(self, program, plan, scope, feeds, step0):
        """The inner-step loop of one dispatch from step ``step0``:
        returns (per-step fetch lists, final state, verdicts or None).
        The scope's variables are not touched."""
        state_vals = self._state(plan, scope)
        K = plan.steps_per_run
        policy = flags.nan_inf_policy()
        nan_log = [] if policy == "raise" else None
        carry, fetches, oks, comm = {}, [], [], []
        rank = distributed.process_index()
        for i in range(K):
            env = {n: carry.get(n, v) for n, v in state_vals.items()}
            if plan.is_window:
                env.update((n, v[i]) for n, v in feeds.items())
            else:
                env.update(feeds)
            # AMP: contrib.mixed_precision.decorate tags the program, as
            # the JAX executor reads it (executor.py:1972-1988)
            state = ExecState(program.blocks, step0 + i, program.random_seed,
                              self.device, is_test=program._is_test,
                              amp_dtype=program._amp_dtype,
                              amp_keep=program._amp_keep, nan_log=nan_log,
                              rank=rank)
            # only taped forward ops turn autograd on, inside run_block
            try:
                with torch.no_grad():
                    run_block(plan.block, env, state, plan.taped,
                              plan.release)
            finally:
                state.tape.clear()
            comm.extend(state.comm_log)
            missing = [n for n in plan.fetch_names if n not in env]
            if missing:
                raise KeyError("fetch targets %s were not produced by the "
                               "program" % missing)
            got = [env[n] for n in plan.fetch_names]
            new = {n: env[n] for n in plan.state_out}
            if policy == "skip":
                ok = _finite_verdict(got, new.values())
                if ok is None:
                    ok = torch.ones((), dtype=torch.bool, device=self.device)
                for n, v in new.items():
                    old = carry.get(n, state_vals.get(n))
                    # a write-only persistable has no old value: it
                    # commits unconditionally
                    if old is not None:
                        new[n] = torch.where(ok, v, old)
                oks.append(ok)
            carry.update(new)
            fetches.append(got)
        if nan_log is not None:
            _raise_non_finite(nan_log)
        verdicts = None
        if oks:
            verdicts = torch.stack(oks) if plan.is_window else oks[0]
        return fetches, carry, verdicts, comm

    def _check_collective(self, program):
        """A transpiled program runs only in a world of exactly the ranks
        it was transpiled for (JAX executor.py:2281), and under NCCL only
        on this rank's card."""
        nranks = getattr(program, "_collective_nranks", None)
        world = distributed.process_count()
        if nranks and nranks != world:
            raise RuntimeError(
                "the program was transpiled for nranks=%d but this process "
                "is in a world of %d rank(s): launch %d processes "
                "(python -m paddle_tpu_torch.distributed.launch) and call "
                "fluid.distributed.init() before running it"
                % (nranks, world, nranks))
        if distributed.backend() == "nccl":
            card = torch.device("cuda", torch.cuda.current_device())
            if self.device != card:
                raise RuntimeError(
                    "this rank's NCCL world runs on %s but the executor "
                    "runs on %s: use Executor(CUDAPlace(%d))"
                    % (card, self.device, card.index))

    def _dispatch(self, program, plan, scope, feed, return_numpy):
        k = plan.steps_per_run
        if plan.is_window and k > 1 and return_numpy:
            raise RuntimeError(
                "steps_per_run=%d runs %d steps in one call; per-step "
                "numpy fetches would put a host sync back inside the "
                "window — pass return_numpy=False and read the stacked "
                "[K, ...] fetches when you need the numbers" % (k, k))
        if getattr(program, "_use_collective", False):
            self._check_collective(program)
        feeds = {n: coerce(feed[n]) for n, coerce in plan.bind}
        step = scope.step_counter
        scope.step_counter += k
        if plan.is_window:
            # window-boundary marker: a windowed CheckpointManager saves
            # only here (checkpoint.py)
            scope._window_end = scope.step_counter
        fresh = plan.fresh
        syncs0 = profiler.host_sync_count()
        # hang-detection stamp before the work: a dispatch that parks is
        # the hang the watchdog names "dispatch" (a dict read when off)
        telemetry.record_progress("dispatch")
        profiler.device_profile_begin(self.device)
        t0 = time.perf_counter_ns()
        with watchdog.extend_deadline(
                "compile", flags.get_flag("watchdog_compile_grace_s")) \
                if fresh else _NULL_CTX:
            per_step, new_state, verdicts, comm = self._execute(
                program, plan, scope, feeds, step)
        t1 = time.perf_counter_ns()
        profiler.device_profile_end(k)
        for n in plan.state_out:
            scope.set_var(n, new_state[n])
        if plan.is_window:
            profiler.record_window(k)
        if verdicts is not None:
            profiler.record_bad_step(verdicts)
        compile_s = None
        if fresh:
            plan.fresh = False
            compile_s = (t1 - t0) / 1e9
            _m_compile_s.observe(compile_s, kind="dispatch")
        if plan.is_window:
            fetches = [torch.stack([s[j] for s in per_step])
                       for j in range(len(plan.fetch_names))]
        else:
            fetches = per_step[0]
        if return_numpy:
            if fetches:
                profiler.record_host_sync("fetch_numpy")
            out = [to_numpy(f) for f in fetches]
        else:
            out = list(fetches)
        feed_bytes = int(sum(_nbytes(v) for v in feeds.values()))
        _m_dispatch_s.observe((t1 - t0) / 1e9,
                              kind="window" if plan.is_window else "step")
        # the JAX package's step-event schema, field for field; the
        # optimizer-sharding field is 0 (no weight-update sharding)
        telemetry.record_step_event(
            ts_ns=t0, dur_ns=t1 - t0, step=int(step), k=k,
            window=plan.is_window, plan_hit=self._last_plan_hit,
            compile_s=compile_s, feed_bytes=feed_bytes,
            fetch_count=len(plan.fetch_names),
            syncs=profiler.host_sync_count() - syncs0,
            verdicts=k if verdicts is not None else 0,
            ckpt_overlap=bool(_m_ckpt_inflight.value()),
            data_wait_s=telemetry.take_pending_data_wait(),
            opt_state_bytes=0, **_comm_fields(comm))
        telemetry.record_span("dispatch", t0, t1 - t0, step=int(step),
                              k=k, window=plan.is_window)
        if flags.get_flag("metrics_device_memory") and \
                self.device.type == "cuda":
            # the caching allocator's host-side counters: no device sync
            stats = torch.cuda.memory_stats(self.device)
            live = int(stats.get("allocated_bytes.all.current", 0))
            _mem_peak[0] = max(_mem_peak[0], live)
            _m_device_mem.set(live, kind="live")
            _m_device_mem.set(_mem_peak[0], kind="peak")
        return out

    # -- dataset training ----------------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           steps_per_run=None, checkpoint_manager=None,
                           checkpoint_period=None, rollback_reseed=False):
        """Consume every sample of ``dataset`` through the program (JAX
        ``train_from_dataset``, executor.py:1610; reference
        executor.py:926 → executor.cc:120 RunFromDataset), one process.

        ``thread`` sets the dataset's reader threads.  Batches go through
        the input pipeline (``prefetch_ahead``: the feed ring, or the
        depth-0 lookahead) and the only reads of the device are the
        ``print_period`` pulls (one per window) and the final drain.
        ``steps_per_run=K`` (default ``FLAGS_steps_per_run``) stacks K
        batches into one window run by ``run_window``; a trailing window
        of fewer batches runs as a shorter window.

        With a ``checkpoint_manager`` the loop saves every
        ``checkpoint_period`` steps (on window boundaries by
        construction); a preemption stop request
        (``fluid.preemption.install()`` / ``request_stop()``) drains the
        window in flight, takes a final synchronous save and returns;
        under ``FLAGS_check_nan_inf=skip`` with ``FLAGS_bad_step_rollback
        =N``, N consecutive bad steps restore the last checkpoint and
        resume (``rollback_reseed=True`` also derives a fresh program
        seed), at most ``FLAGS_rollback_limit`` times.

        In a world of several ranks (``fluid.distributed``) the stop and
        rollback verdicts are the world's (JAX executor.py:1700-1760):
        ONE all-reduce of both flags at every ``16 // K``-th window
        boundary and after the stream ends, so a stop requested on one
        rank drains every rank at the same window and nobody parks in a
        collective whose peer has left.  Batches are then staged on the
        consumer's thread (the depth-0 lookahead): the feed ring drains
        itself on a local stop, which would end one rank's stream early.
        Every rank must feed the same number of batches.

        Returns ``{"steps", "preempted", "rollbacks"}``."""
        if dataset is None:
            raise RuntimeError("dataset is need and should be initialized")
        world = distributed.process_count()
        if world > 1 and checkpoint_manager is not None:
            raise NotImplementedError(
                "train_from_dataset(checkpoint_manager=) in a world of %d "
                "ranks needs the multi-host checkpoint save, which is not "
                "ported yet (ROADMAP queue 1 item 10b)" % world)
        K = flags.steps_per_run_value(steps_per_run)
        program = program or framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        manager = checkpoint_manager
        roll_k = int(flags.get_flag("bad_step_rollback") or 0)
        if roll_k:
            if manager is None:
                raise ValueError(
                    "FLAGS_bad_step_rollback=%d needs a "
                    "checkpoint_manager= to restore from" % roll_k)
            if flags.nan_inf_policy() != "skip":
                raise ValueError(
                    "FLAGS_bad_step_rollback needs FLAGS_check_nan_inf="
                    "skip — no other policy produces the bad-step "
                    "verdicts it counts")
        roll_limit = int(flags.get_flag("rollback_limit"))
        rollbacks = 0
        preempted = False
        if thread:
            dataset.set_thread(thread)
        fetch_names = self._fetch_names(fetch_list)
        fetch_info = fetch_info or fetch_names
        dataset._prepare_to_run()
        source = iter(dataset)
        if K > 1:
            from .dataset import stack_batch_windows
            source = stack_batch_windows(source, K)
        from .reader import stager_for
        # the dataset yields the declared dtypes; the dispatch coerces
        # anything else on the device
        batches = prefetch_ahead(stager_for(self.device), source,
                                 depth=0 if world > 1 else None)
        consensus_every = max(1, 16 // K)
        boundary = 0
        n = 0
        try:
            t0 = time.perf_counter()
            for batch in batches:
                if K > 1:
                    k = int(next(iter(batch.values())).shape[0]) \
                        if batch else K
                    out = self.run_window(program, feed=batch,
                                          fetch_list=fetch_names,
                                          scope=scope, steps_per_run=k,
                                          return_numpy=False)
                else:
                    k = 1
                    out = self.run(program, feed=batch,
                                   fetch_list=fetch_names, scope=scope,
                                   return_numpy=False)
                prev, n = n, n + k
                boundary += 1
                save_due = (manager is not None and checkpoint_period and
                            n // checkpoint_period !=
                            prev // checkpoint_period)
                stop = preemption.stop_requested()
                streak, roll_hit = 0, False
                rolled = False
                if roll_k:
                    # reading the streak reads the pending verdicts (the
                    # one device read of the policy, per boundary), BEFORE
                    # the periodic save: a poisoned streak is never saved
                    streak = profiler.bad_step_streak()
                    roll_hit = streak >= roll_k
                if world > 1:
                    # the world's verdict, at boundaries every rank
                    # counts the same
                    if save_due or boundary % consensus_every == 0:
                        stop, roll_hit = distributed.consensus_flags(
                            stop, roll_hit)
                    else:
                        stop = roll_hit = False
                if roll_hit:
                    rollbacks += 1
                    self._rollback_restore(manager, scope, program,
                                           streak, rollbacks,
                                           roll_limit, rollback_reseed)
                    rolled = True
                if save_due and not rolled:
                    # right after a dispatch, so windowed jobs are at
                    # their boundary marker; snapshot sync, I/O async
                    manager.save(scope=scope, main_program=program)
                if stop:
                    preempted = True
                    break
                if fetch_names and n // print_period != prev // print_period:
                    # one read per window, even when the window crosses
                    # a print boundary
                    profiler.record_host_sync("print_period")
                    vals = [to_numpy(v) for v in out]
                    if K > 1:   # last inner step's value
                        vals = [v[-1] for v in vals]
                    msg = ", ".join("%s=%s" % (k2, np.ravel(v)[:8])
                                    for k2, v in zip(fetch_info, vals))
                    print("[train_from_dataset] batch %d: %s" % (n, msg))
                if debug and n // print_period != prev // print_period:
                    dt = time.perf_counter() - t0
                    print("[train_from_dataset] %d batches, %.1f batch/s"
                          % (n, n / dt))
            # drain the device so scope state is materialized
            if self.device.type == "cuda":
                profiler.record_host_sync("drain")
                torch.cuda.synchronize(self.device)
            if not preempted and _stop_consensus(world):
                # a stop that landed while the consumer waited on the
                # (drained) feed ring ends the stream without reaching
                # the per-batch check: it still drains and saves
                preempted = True
            if preempted:
                t_d0 = time.perf_counter_ns()
                if manager is not None:
                    manager.wait()
                    if manager.last_step != int(scope.step_counter):
                        # the process exits after the drain: the final
                        # save must be committed, not in flight
                        manager.save(scope=scope, main_program=program,
                                     sync=True)
                        manager.wait()
                preemption.record_drain(
                    step=scope.step_counter,
                    dur_ns=time.perf_counter_ns() - t_d0,
                    saved=manager is not None)
        finally:
            if hasattr(batches, "close"):
                # stop the staging stack now, so producer threads see
                # their stop, not at GC time
                batches.close()
            dataset._finish_to_run()
        return {"steps": int(n), "preempted": bool(preempted),
                "rollbacks": int(rollbacks)}

    def _rollback_restore(self, manager, scope, program, streak, attempt,
                          limit, reseed):
        """Restore the last complete checkpoint after ``streak``
        consecutive bad steps (FLAGS_bad_step_rollback; JAX
        executor.py:1832), at most ``limit`` times per call."""
        t0 = time.perf_counter_ns()
        if attempt > limit:
            raise RuntimeError(
                "bad-step rollback limit reached: %d rollback(s) "
                "(FLAGS_rollback_limit) did not clear the %d-consecutive"
                "-bad-step condition (FLAGS_bad_step_rollback) — the "
                "input stream or model is persistently poisoned"
                % (limit, streak))
        manager.wait()
        meta = manager.resume(scope=scope, main_program=program)
        if meta is None:
            raise RuntimeError(
                "bad-step rollback triggered (%d consecutive bad steps) "
                "but %r holds no complete checkpoint to restore — save "
                "one before relying on FLAGS_bad_step_rollback (e.g. "
                "checkpoint_period=, or an explicit save at start)"
                % (streak, manager.dirname))
        if reseed:
            # a bit-exact replay of the poisoned trajectory would fail
            # again; a fresh program seed re-keys every step-keyed
            # random stream from the restored step on
            program.random_seed = \
                (program.random_seed * 1000003 + attempt) % (2 ** 31 - 1)
            program._bump_version()
        profiler.reset_bad_step_streak()
        _m_rollbacks.inc()
        _m_rollback_step.set(int(meta["step"]))
        telemetry.record_lifecycle_event(
            "rollback", step=int(meta["step"]), streak=int(streak),
            attempt=int(attempt), dur_ns=time.perf_counter_ns() - t0,
            reseeded=bool(reseed), remote=False)
        return meta

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           steps_per_run=None):
        """Inference twin of train_from_dataset (reference
        executor.py:849): the same streaming loop over an inference
        program."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period,
                                       steps_per_run=steps_per_run)

    def close(self):
        self._plans.clear()
