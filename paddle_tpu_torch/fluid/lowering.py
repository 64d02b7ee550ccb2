"""Block → torch execution.

Every op's registered lowering rule consumes and produces torch tensors in
a name→tensor environment (the functional image of the reference's
``Scope``).  Where ``paddle_tpu`` traces a block once and hands it to XLA,
the port runs the same rules eagerly, op by op, on the executor's device;
the kernels the TPU package wrote in Pallas are CUDA kernels here
(``ops/attention_ops.py``).

Gradients (counterpart ``generic_grad_lower``, paddle_tpu/fluid/
lowering.py:332).  The JAX package replays a forward rule under
``jax.vjp`` inside its ``_grad`` op and counts on XLA to merge the
replay with the forward.  Eager torch would run every forward twice, so
the port keeps a per-run **tape** instead: a forward op whose ``_grad``
op is in the block runs under ``torch.enable_grad()`` on detached inputs
(``requires_grad`` on the float inputs its grad op asks a gradient for)
and leaves ``(leaves, outputs)`` on the tape under its output names; the
``_grad`` op pops that entry and calls ``torch.autograd.grad``.  Each
op's autograd graph is local to the op, the environment only ever holds
detached tensors, and the executor clears the tape when ``run`` ends,
also when it raises.
"""

import contextlib

import torch

from . import costmodel, distributed, flags
from .data_types import torch_dtype
from .framework import op_sub_block_indices
from .registry import OP_DEFS, get_op_def

# Op types consumed by the executor itself rather than lowered.
_STRUCTURAL_OPS = frozenset(["feed", "fetch"])


class ExecState:
    """Per-run execution state threaded through lowerings."""

    def __init__(self, blocks, step, seed, device, is_test=False,
                 amp_dtype=None, amp_keep=False, nan_log=None, rank=0,
                 hierarchical=None, parallel=None):
        self.blocks = blocks    # program blocks
        self.step = step        # host int, increments per run
        self.seed = seed        # program random seed
        self.device = device    # torch.device every op computes on
        self.is_test = is_test
        # AMP (contrib.mixed_precision.decorate): the compute dtype of the
        # conv/matmul rules, and whether their outputs stay in it
        self.amp_dtype = amp_dtype
        self.amp_keep = amp_keep
        # tape key -> [(leaves, outputs)] of taped forward ops whose
        # _grad op has not run yet (tape_grad_lower pops them)
        self.tape = {}
        # FLAGS_check_nan_inf=raise: a list the run appends (op type,
        # output name, 0-d finiteness tensor) to for every float output
        # of every op; the executor reads it back once, after the run
        self.nan_log = nan_log
        # this process's rank in a torch.distributed world (0 without
        # one): folded into every random op's seed, so replicas draw
        # different dropout masks and rank 0 keeps the world-of-one
        # stream
        self.rank = int(rank)
        # the program's hierarchical_allreduce_nnodes (the transpiler's
        # _collective_hierarchical): > 1 makes every ring two-level
        self.hierarchical = int(hierarchical or 0)
        # (species, precision, bytes, grad bucket, axis) of every
        # collective the run issued (ops/collective_ops.py)
        self.comm_log = []
        # {axis: mesh_utils.Coords} of the program's model-parallel
        # degrees in this world (fluid/model_parallel.py); the random
        # ops of replicated computation fold ``rank``, the dp rank, and
        # ops running on shards the global rank
        self.parallel = parallel or {}
        # ring 0 of such a program with more than one dp replica: its dp
        # group (None: the world)
        self.dp_group = next((c.dp_group for c in self.parallel.values()
                              if c.dp_size > 1), None)
        # a pipeline's microbatch (fluid/pipeline.py): folded into every
        # random op's seed, so each microbatch draws its own masks and
        # the backward's recompute of a microbatch replays them
        self.stream = None

    def ring_group(self, ring_id):
        """The process group of ``ring_id`` in this run: ring 0 is the dp
        group of a model-parallel program with more than one replica (its
        ``GradAllReduce`` averages over the replicas only), the world
        otherwise; any other ring is ``distributed.ring_group``'s.  Only
        this run sees the dp group: the process's ring table is left as
        it is for every other program."""
        if not int(ring_id or 0) and self.dp_group is not None:
            return self.dp_group
        return distributed.ring_group(ring_id)

    def ring_size(self, ring_id=0):
        """Ranks in ring ``ring_id`` of this run (1 without a world)."""
        d = distributed._dist()
        return 1 if d is None else d.get_world_size(self.ring_group(ring_id))

    def record_comm(self, species, precision, nbytes, grad_bucket=False,
                    axis="dp", sizes=None):
        """Log one collective's per-rank wire bytes (JAX
        ``ExecState.record_comm``, lowering.py:80); ``grad_bucket`` marks
        a transpiled gradient exchange (the ``__grad_bucket__`` attr).

        A tuple ``axis`` is the hierarchical two-level ring, ``("dcn",
        "ici")`` with the level ``sizes`` (nodes, ranks per node): the
        bytes are split per level as the JAX package splits them — the
        inner level moves the full payload, each outer level the 1/n
        shard the levels inside it leave, the shares normalized to sum to
        ``nbytes``; a level of size 1 moves nothing and gets no entry."""
        total = int(nbytes)
        if not isinstance(axis, tuple):
            self.comm_log.append((species, precision, total,
                                  bool(grad_bucket), axis))
            return
        weights, shard = [], 1.0
        for ax, n in zip(reversed(axis), reversed(sizes)):
            if n > 1:
                weights.append((ax, shard))
            shard /= max(n, 1)
        if not weights:
            weights = [(axis[-1], 1.0)]
        wsum = sum(w for _ax, w in weights)
        acc = 0
        for i, (ax, w) in enumerate(weights):
            b = total - acc if i == len(weights) - 1 \
                else int(round(total * w / wsum))
            acc += b
            self.comm_log.append((species, precision, b,
                                  bool(grad_bucket), ax))


def amp_operands(state, *vals):
    """AMP helper of the conv/matmul rules (paddle_tpu/fluid/lowering.py:127,
    the same decisions): with an AMP dtype on the program, float32
    operands are cast to it, and the rule gets back the dtype to produce
    its output in — None keeps the AMP dtype (pure bf16, or
    ``FLAGS_amp_keep_activations``), float32 otherwise.  Operands of
    another dtype, or already all in the AMP dtype, are left alone (None).
    Returns ``vals + (acc_dtype,)``."""
    dt = state.amp_dtype
    if not dt:
        return vals + (None,)
    cdt = torch_dtype(dt)
    if any(v.dtype not in (torch.float32, cdt) for v in vals) or \
            all(v.dtype == cdt for v in vals):
        return vals + (None,)
    cast = tuple(v.to(cdt) for v in vals)
    if state.amp_keep or flags.get_flag("amp_keep_activations"):
        return cast + (None,)
    return cast + (torch.float32,)


class LowerCtx:
    """Per-op view of the environment handed to lowering rules."""

    __slots__ = ("env", "op", "state", "block")

    def __init__(self, env, op, state, block):
        self.env = env
        self.op = op
        self.state = state
        self.block = block

    # -- inputs ------------------------------------------------------------
    def i(self, slot, idx=0):
        names = self.op.input(slot)
        return self.env[names[idx]]

    def i_opt(self, slot, idx=0):
        names = self.op.input(slot)
        if len(names) <= idx or not names[idx]:
            return None
        return self.env.get(names[idx])

    # -- outputs -----------------------------------------------------------
    def set(self, slot, value, idx=0):
        names = self.op.output(slot)
        if names and names[idx]:
            self.env[names[idx]] = value

    # -- misc --------------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attr(name, default)

    def generator(self):
        """Explicit per-op ``torch.Generator`` on the run's device (Philox
        on the card): deterministic given (op ``seed`` attr, also 0 when
        ``fix_seed`` is set) or else (program seed, op seed, step), with
        the rank folded in on ranks other than 0 (the JAX package folds
        the replica's axis index into every per-op key,
        paddle_tpu/fluid/lowering.py:193-205), and a pipeline's
        microbatch (``ExecState.stream``) after it.  The streams differ from JAX's ``jax.random`` keys (paddle_tpu/fluid/
        lowering.py), so the two packages' random draws never match;
        tests carry weights across instead (convert.py) and compare
        random ops by statistics."""
        seed = int(self.op.attr("seed", 0) or 0)
        if not (seed or self.op.attr("fix_seed", False)):
            seed = ((int(self.state.seed) * 1000003 +
                     int(self.op.attr("__op_seed__", 0))) * 1000003 +
                    int(self.state.step)) % (2 ** 63)
        if self.state.rank:
            seed = (seed * 1000003 + self.state.rank) % (2 ** 63)
        if self.state.stream is not None:
            seed = (seed * 1000003 + self.state.stream + 1) % (2 ** 63)
        gen = torch.Generator(device=self.state.device)
        gen.manual_seed(seed)
        return gen


def run_block(block, env, state, taped=None, release=None, shard=None):
    """Run every op of ``block`` through its lowering rule, in order.
    ``taped`` ({op index: input names}, from :func:`plan_tape`) names
    the forward ops that record on the tape; None or empty runs no op
    with autograd (inference).  ``release`` ({op index: names}, from
    :func:`plan_release`) drops temporaries from ``env`` after the last
    op that names them.  ``shard`` (``model_parallel.ShardPlan``) says
    how each op of a tensor- or sequence-parallel program runs on this
    rank."""
    taped = taped or {}
    release = release or {}
    nan_log = state.nan_log
    planned = shard.ops if shard is not None else {}
    for i, op in enumerate(block.ops):
        dispatch(op, env, state, block, taped.get(i), planned.get(i))
        if nan_log is not None:
            _log_finite(op, env, nan_log)
        for n in release.get(i, ()):
            env.pop(n, None)


def _log_finite(op, env, log):
    """FLAGS_check_nan_inf=raise (JAX lowering.py:284): the finiteness
    of every float output of ``op``, as 0-d tensors on the device — no
    read-back here."""
    for names in op.outputs.values():
        for n in names:
            v = env.get(n) if n else None
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                log.append((op.type, n, torch.isfinite(v).all()))


def plan_release(block, keep):
    """{op index: names} of the variables whose last mention (as an input
    or an output) is that op, except those in ``keep`` (fetches, state
    written back to the scope).  Dropping them from the environment there
    frees a temporary as soon as nothing can read it again; a tensor that
    a taped op saved for its grad op stays alive through the tape until
    that grad op has run.  A control-flow op mentions every name its
    sub-block's ops mention, so nothing its step block reads leaves
    before it has run."""
    def mentions(op):
        for slots in (op.inputs, op.outputs):
            for names in slots.values():
                yield from (n for n in names if n)
        for sub_idx in op_sub_block_indices(op):
            for sub_op in block.program.blocks[sub_idx].ops:
                yield from mentions(sub_op)

    last = {}
    for i, op in enumerate(block.ops):
        for n in mentions(op):
            last[n] = i
    out = {}
    for n, i in last.items():
        if n not in keep:
            out.setdefault(i, []).append(n)
    return out


def dispatch(op, env, state, block, diff_names=None, plan=None):
    """Run one op: taped (``diff_names``, the inputs its grad op asks a
    gradient for), as a grad op, or plainly.  ``plan``
    (``model_parallel.OpPlan``) runs it as the rank's shard plan says,
    through :func:`_run_taped` whether taped or not."""
    if op.type in _STRUCTURAL_OPS:
        return
    if plan is not None:
        op = plan.op
    cap = costmodel._ACTIVE
    if cap is not None:
        # a cost capture: count this op's work under fluid_<type>
        with cap.attribute(op, env):
            _dispatch(op, env, state, block, diff_names, plan)
        return
    _dispatch(op, env, state, block, diff_names, plan)


def _dispatch(op, env, state, block, diff_names, plan):
    ctx = LowerCtx(env, op, state, block)
    try:
        if diff_names is not None or plan is not None:
            _run_taped(ctx, op, diff_names, plan)
        elif op.type.endswith("_grad") and op.type not in OP_DEFS:
            tape_grad_lower(ctx, op)
        else:
            get_op_def(op.type).lower(ctx, op)
    except Exception as e:
        _enrich_op_error(e, op, env)
        raise


# ---------------------------------------------------------------------------
# The tape
# ---------------------------------------------------------------------------

def tape_key(outputs):
    """Tape key of a forward op: its output slot map, as the grad op
    carries it in ``__fwd_outputs__``."""
    return tuple(sorted((slot, tuple(names))
                        for slot, names in outputs.items()))


def _grad_targets(op, fwd_def):
    """(slot, idx, name) of the forward inputs the grad op ``op`` asks a
    gradient for: a non-empty ``<slot>@GRAD`` output name and a slot the
    op def does not declare non-differentiable (JAX lowering.py:350-366;
    the float check happens at run time)."""
    targets = []
    for slot, names in op.attr("__fwd_inputs__").items():
        if slot in fwd_def.nondiff_inputs:
            continue
        gnames = op.output(slot + "@GRAD")
        for idx, name in enumerate(names):
            if idx < len(gnames) and gnames[idx] and name:
                targets.append((slot, idx, name))
    return targets


def plan_tape(block):
    """{op index: input names to differentiate} for every forward op of
    ``block`` whose ``_grad`` op is in the block; {} when there is none
    (the executor then runs the block as inference)."""
    wants = {}
    for op in block.ops:
        if not op.type.endswith("_grad") or \
                op.attr("__fwd_outputs__") is None:
            continue
        fwd_def = get_op_def(op.type[:-len("_grad")])
        names = wants.setdefault(tape_key(op.attr("__fwd_outputs__")), [])
        for _, _, name in _grad_targets(op, fwd_def):
            if name not in names:
                names.append(name)
    if not wants:
        return {}
    return {i: tuple(wants[tape_key(op.outputs)])
            for i, op in enumerate(block.ops)
            if not op.type.endswith("_grad") and
            tape_key(op.outputs) in wants}


def _run_taped(ctx, op, diff_names, plan=None):
    """Run a forward op with autograd on, on detached inputs, and leave
    its (leaves, outputs) on the tape; the environment gets the outputs
    detached.

    ``plan`` (``model_parallel.OpPlan``) adds the rank's transforms
    inside the op's autograd graph: ``xin`` on the inputs (``copy_to``,
    ``scatter_to``, ``gather_from``) and ``xout`` on the outputs
    (``reduce_from``); an op running on shards (``plan.rank`` set) draws
    its random numbers with that global rank folded in.  A planned op
    with ``diff_names`` None runs without autograd and records
    nothing."""
    env, state = ctx.env, ctx.state
    sub = {}
    for names in op.inputs.values():
        for n in names:
            if n:
                sub[n] = env[n]
    # an output's earlier value: a not-taken conditional_block keeps it
    for names in op.outputs.values():
        for n in names:
            if n and n not in sub and n in env:
                sub[n] = env[n]
    leaves = {}
    if diff_names:
        # ops sharing a tape key share diff_names: only this op's inputs
        ins = _op_inputs(op)
        for n in diff_names:
            if n in ins and sub[n].is_floating_point():
                leaves[n] = sub[n] = sub[n].detach().requires_grad_()
    xin, xout = (plan.xin, plan.xout) if plan is not None else ({}, {})
    saved = state.rank
    if plan is not None and plan.rank is not None:
        state.rank = plan.rank
    try:
        with torch.enable_grad() if diff_names is not None \
                else contextlib.nullcontext():
            for n, fn in xin.items():
                sub[n] = fn(sub[n])
            get_op_def(op.type).lower(LowerCtx(sub, op, state, ctx.block),
                                      op)
            for n, fn in xout.items():
                if n in sub:
                    sub[n] = fn(sub[n])
    finally:
        state.rank = saved
    outs = {}
    for names in op.outputs.values():
        for n in names:
            if n and n in sub:
                outs[n] = sub[n]
                env[n] = sub[n].detach() if diff_names is not None \
                    else sub[n]
    if diff_names is not None:
        state.tape.setdefault(tape_key(op.outputs), []).append(
            (leaves, outs))


def _op_inputs(op):
    return {n for names in op.inputs.values() for n in names if n}


def tape_grad_lower(ctx, op):
    """The ``_grad`` op of any forward op: pop the forward's tape entry and
    pull the output gradients in the environment back through its
    autograd graph with ``torch.autograd.grad``.  Outputs with no
    gradient in the environment contribute nothing (the JAX package
    seeds them with zeros, lowering.py:386-399, which is the same sum);
    an input that reaches no differentiated output gets zeros.  A name
    that fills two differentiated slots gets its whole gradient in the
    first and zeros in the others, so their ``sum`` counts it once, as
    the JAX replay does."""
    fwd_def = get_op_def(op.type[:-len("_grad")])
    fwd_outputs = op.attr("__fwd_outputs__")
    key = tape_key(fwd_outputs)
    stack = ctx.state.tape.get(key)
    if not stack:
        raise RuntimeError(
            "%s: its forward op left no tape entry (forward outputs %s); "
            "a grad op runs only after its forward op in the same run"
            % (op.type, fwd_outputs))
    leaves, outs = stack.pop()
    if not stack:
        del ctx.state.tape[key]
    env = ctx.env
    ys, gys = [], []
    for slot, names in fwd_outputs.items():
        gnames = op.input(slot + "@GRAD")
        for idx, name in enumerate(names):
            gname = gnames[idx] if idx < len(gnames) else None
            y = outs.get(name)
            if not gname or gname not in env or y is None or \
                    not y.requires_grad:
                continue
            g = env[gname].to(y.dtype)
            if g.shape != y.shape:
                # e.g. a (1,)-shaped loss grad seeding a 0-d output
                g = g.reshape(y.shape)
            ys.append(y)
            gys.append(g)
    xs = list(leaves.values())
    grads = torch.autograd.grad(ys, xs, gys, allow_unused=True) \
        if ys and xs else [None] * len(xs)
    gmap = dict(zip(leaves, grads))
    done = set()
    for slot, idx, name in _grad_targets(op, fwd_def):
        leaf = leaves.get(name)
        if leaf is None:            # an integer input: no gradient
            continue
        g = gmap[name]
        if g is None or name in done:
            g = torch.zeros_like(leaf, requires_grad=False)
        done.add(name)
        env[op.output(slot + "@GRAD")[idx]] = g


def _enrich_op_error(e, op, env):
    """Attach op context to lowering failures (the reference's
    PADDLE_ENFORCE messages carry the op type + var names) — once, at the
    op that actually failed."""
    if getattr(e, "_op_context_added", False):
        return
    def fmt(slots):
        parts = []
        for slot, names in slots.items():
            if not names:
                continue
            shapes = []
            for n in names:
                v = env.get(n)
                shapes.append("%s%s" % (n, list(v.shape))
                              if hasattr(v, "shape") else n)
            parts.append("%s=%s" % (slot, shapes))
        return ", ".join(parts)
    note = ("\n[operator %s] inputs: {%s} -> outputs: {%s}"
            % (op.type, fmt(op.inputs), fmt(op.outputs)))
    e._op_context_added = True
    if e.args and isinstance(e.args[0], str):
        e.args = (e.args[0] + note,) + e.args[1:]
    else:
        e.args = e.args + (note,)
