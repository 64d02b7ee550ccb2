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

import numpy as np
import torch

from . import framework
from .data_types import BF16_HOST, np_dtype, to_numpy, torch_dtype
from .lowering import ExecState, plan_release, plan_tape, run_block


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


class _DispatchPlan:
    """Everything ``run`` resolves once per (program, feed signature,
    fetch list): the state the block reads and writes and one coercer
    per feed."""

    def __init__(self, program, feed_names, fetch_names, device):
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


class Executor:
    """Run programs on one place (reference executor.py:294 contract)."""

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_for_place(self.place)
        self._plans = {}
        self._compile_count = 0

    def compile_count(self):
        """Dispatch plans built so far, one per (program, feed signature,
        fetch list).  A delta of 0 across dispatches proves no new shape
        reached the executor — the serving executor's zero-recompile
        contract reads it."""
        return self._compile_count

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program`` once.  ``feed``: {name: ndarray | tensor};
        ``fetch_list``: Variables or names.  Returns a list of numpy
        arrays, or with ``return_numpy=False`` the live device tensors
        (kernels may still be running: materialize them on the stream
        they were produced on, or after an event recorded there)."""
        program = program or framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in (fetch_list or ())]
        names = tuple(sorted(feed))
        key = (program.fingerprint, names,
               tuple(_feed_sig(feed[n]) for n in names), tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            self._compile_count += 1
            plan = _DispatchPlan(program, names, fetch_names, self.device)
            self._plans[key] = plan
        return self._dispatch(program, plan, scope, feed, return_numpy)

    def _dispatch(self, program, plan, scope, feed, return_numpy):
        env = {}
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
            env[n] = v
        for n, coerce in plan.bind:
            env[n] = coerce(feed[n])
        step = scope.step_counter
        scope.step_counter += 1
        # AMP: contrib.mixed_precision.decorate tags the program, as the
        # JAX executor reads it (paddle_tpu/fluid/executor.py:1972-1988)
        state = ExecState(program.blocks, step, program.random_seed,
                          self.device, is_test=program._is_test,
                          amp_dtype=program._amp_dtype,
                          amp_keep=program._amp_keep)
        # only taped forward ops turn autograd on, inside run_block
        try:
            with torch.no_grad():
                run_block(plan.block, env, state, plan.taped, plan.release)
        finally:
            state.tape.clear()
        for n in plan.state_out:
            scope.set_var(n, env[n])
        missing = [n for n in plan.fetch_names if n not in env]
        if missing:
            raise KeyError("fetch targets %s were not produced by the "
                           "program" % missing)
        fetches = [env[n] for n in plan.fetch_names]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def close(self):
        self._plans.clear()
