"""Pipeline parallelism: ``device_guard``, ``PipelineOptimizer`` and the
GPipe schedule (counterpart ``paddle_tpu/fluid/pipeline.py``; reference
``python/paddle/fluid/optimizer.py:2664``).

Ops are assigned to stages with ``fluid.device_guard("pp:<k>")``, which
stamps ``pipeline_stage`` on every op appended inside (``framework``).
``PipelineOptimizer`` wraps an inner optimizer and tags the program with
``_pipeline_config``; ``Executor.run`` then runs the program's step as
a GPipe schedule.

The JAX package runs the whole schedule as one XLA computation under
``shard_map`` over a ``pp`` mesh axis.  The port runs one process per
rank (``fluid/distributed.py``), so a stage is a rank: the world is laid
out row-major over ``("dp", "pp", "mp"[, "sp"][, "ep"])`` as the JAX
mesh lays out its devices (``model_parallel.context``), and the rank
at ``pp`` coordinate ``s`` runs stage ``s``.  A step on that rank:

- **microbatches** — each feed ``[B, ...]`` is cut into M microbatches
  ``[B/M, ...]``; when every feed's batch divides by dp·M, each dp
  replica first takes its contiguous 1/dp of the batch (the JAX
  package's ``dp_feeds`` rule);
- **forward** — the stage's ops run on each microbatch in turn without
  autograd; the boundary variables go to the next stage's rank by
  ``torch.distributed`` send/recv over the pp group (each variable in
  its own dtype, one message a microbatch, a card tensor staged through
  the host on gloo); only float variables of 32 bits or fewer may cross
  a cut;
- **backward** — each microbatch, in order, is recomputed from the
  stage's stashed input with autograd on (the rematerialisation of the
  JAX package's ``jax.vjp`` per stage: no stage holds more than one
  microbatch's graph), pulled back from the cotangents the next stage
  sent, and its input's cotangent sent to the previous stage; the last
  stage starts from ``loss / M``;
- **storage** — with ``shard_params`` (the default), a parameter whose
  dim 0 divides by S and that has no model-parallel annotation, and each
  same-shaped accumulator of one, is held as the rank's 1/S slice on
  dim 0: only the parameters the stage's ops read are gathered over pp,
  for its forward and backward;
- **merge** — parameter gradients, summed over the microbatches, are
  summed over the pp group (a parameter two stages read, such as BERT's
  tied word embedding, gets both contributions; one the stage does not
  read adds zeros), a sharded parameter's by a reduce-scatter to the
  rank's slice, and averaged over dp when the feeds were dp-sharded;
  the loss is the microbatch losses summed over pp, divided by M;
- **post phase** — the optimizer, LR, clip and regularization ops run on
  every rank on the merged gradients, on the slices of the sharded
  state: an elementwise op (an elementwise optimizer rule, ``scale``,
  ``sum``, ...) runs on the slices, ``squared_l2_norm`` sums its
  slice's partial norm over pp (global-norm clipping stays exact up to
  the order of the sum), and any other op reading a slice reads the
  whole value, all-gathered for that op.

Random ops fold the microbatch into their seed (``ExecState.stream``),
and the dp rank when the feeds are dp-sharded, so the recompute replays
the forward's dropout mask bit for bit.  Inside a stage an mp/sp/ep
degree runs the per-op plan of ``fluid/model_parallel.py`` over the
groups of the rank's (dp, pp) cell.  State written only inside the
schedule (batch-norm statistics) keeps its previous value, as in the
JAX package.

With spans on (``FLAGS_trace_spans``), each step records host spans
``pipeline_gather``, ``pipeline_forward``, ``pipeline_backward``,
``pipeline_merge`` and ``pipeline_update`` (labels: step, stage).
"""

import contextlib
import time

import torch

from . import framework, telemetry
from .framework import OpRole, OP_ROLE_KEY
from .lowering import ExecState, dispatch
from .registry import get_op_def


# ---------------------------------------------------------------------------
# device_guard: stage annotation (modern fluid.device_guard contract)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def device_guard(device=None):
    """``with fluid.device_guard("pp:1"):`` — ops appended inside are
    assigned to pipeline stage 1."""
    prog = framework.default_main_program()
    stage = None
    if device is not None:
        name = str(device)
        stage = int(name.split(":")[1]) if ":" in name else 0
    prev = getattr(prog, "_current_pipeline_stage", None)
    prog._current_pipeline_stage = stage
    try:
        yield
    finally:
        prog._current_pipeline_stage = prev


# the attr framework.Block._insert_op stamps from device_guard's
# _current_pipeline_stage
STAGE_ATTR = "pipeline_stage"


# ---------------------------------------------------------------------------
# stage partition
# ---------------------------------------------------------------------------

class PipelinePlan:
    def __init__(self, num_stages, num_microbatches, stage_ops, post_ops,
                 boundaries, feed_stage, grad_name_of_param):
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.stage_ops = stage_ops          # stage -> [op]
        self.post_ops = post_ops            # optimizer/LR/clip ops (in order)
        self.boundaries = boundaries        # stage -> [var names] passed on
        self.feed_stage = feed_stage        # feed name -> stage
        self.grad_name_of_param = grad_name_of_param  # param -> grad var name


def _op_stage(op, default=0):
    return op.attr(STAGE_ATTR, default)


def _forward_ops(program):
    fwd, post = [], []
    for op in program.global_block().ops:
        role = op.attr(OP_ROLE_KEY, OpRole.Forward)
        if role & OpRole.Backward:
            continue          # the recompute's autograd derives them
        if role & (OpRole.Optimize | OpRole.LRSched):
            post.append(op)
            continue
        fwd.append(op)
    return fwd, post


def num_stages(program):
    """The number of distinct stages of the program's forward ops."""
    return len({_op_stage(op) for op in _forward_ops(program)[0]})


def build_plan(program, feed_names, num_microbatches):
    """Partition the program's forward ops into stages and validate the
    stage chain (the cut_list validation of the reference, :2700 area)."""
    fwd_ops, post_ops = _forward_ops(program)
    stages = sorted({_op_stage(op) for op in fwd_ops})
    if stages != list(range(len(stages))):
        raise ValueError("pipeline stages must be 0..S-1, got %s" % stages)
    S = len(stages)
    stage_ops = {s: [op for op in fwd_ops if _op_stage(op) == s]
                 for s in range(S)}

    # producer map over forward ops
    produced_by = {}
    for op in fwd_ops:
        for n in op.output_arg_names():
            produced_by[n] = _op_stage(op)

    feed_stage = {}
    boundaries = {s: [] for s in range(S - 1)}
    for s in range(S):
        for op in stage_ops[s]:
            for n in op.input_arg_names():
                if not n:
                    continue
                if n in feed_names:
                    prev = feed_stage.setdefault(n, s)
                    if prev != s:
                        raise ValueError(
                            "feed %r consumed by stages %d and %d — a feed "
                            "may enter exactly one stage" % (n, prev, s))
                    continue
                src = produced_by.get(n)
                if src is None:
                    continue  # persistable/param — handled as state
                if src == s:
                    continue
                if src != s - 1:
                    raise ValueError(
                        "var %r produced in stage %d is read in stage %d; "
                        "pipeline cuts must form a chain (insert forwarding "
                        "vars or move the op)" % (n, src, s))
                if n not in boundaries[src]:
                    boundaries[src].append(n)

    # param -> RAW grad name (what the recompute's autograd produces):
    # append_backward's grad-name map.  The optimizer op's Grad slot may
    # instead name the output of clip/regularization ops — those run in
    # the post phase and derive from the raw grad, so seeding must target
    # the raw name.
    grad_map = getattr(program, "_grad_name_map", {})
    grad_name_of_param = {}
    for op in post_ops:
        p = op.input("Param")
        g = op.input("Grad")
        if p and g:
            grad_name_of_param[p[0]] = grad_map.get(
                p[0], framework.grad_var_name(p[0]))
    for n in feed_names:
        feed_stage.setdefault(n, 0)
    return PipelinePlan(S, num_microbatches, stage_ops, post_ops, boundaries,
                        feed_stage, grad_name_of_param)


_BOUNDARY_DTYPES = frozenset(["float32", "bfloat16", "float16"])


def _check_boundary_dtype(name, dtype):
    """Only <=32-bit floats cross a cut (JAX ``_pack``: its flat buffer
    round-trips through f32, which would lose an int >= 2^24)."""
    if str(dtype) not in _BOUNDARY_DTYPES:
        raise TypeError(
            "pipeline stage-boundary var has dtype %s; only <=32-bit "
            "float activations may cross a pipeline cut. Keep integer "
            "inputs (ids, masks) on the stage that consumes them by "
            "feeding them there (device_guard)." % dtype)


# ---------------------------------------------------------------------------
# PipelineOptimizer
# ---------------------------------------------------------------------------

class PipelineOptimizer:
    """Reference optimizer.py:2664 contract: wrap an inner optimizer; the
    program trains M microbatches per step through the stage pipeline."""

    def __init__(self, optimizer, num_microbatches=1, cut_list=None,
                 place_list=None, concurrency_list=None, queue_size=None,
                 start_cpu_core_id=None, shard_params=True):
        # queue/concurrency knobs are section-worker tuning in the
        # reference; a stage is a process here, with no host queues —
        # accepted, unused.  shard_params: keep params/grad-accums/opt-
        # state sharded 1/S over the pp group between steps (the
        # per-stage-memory benefit the reference gets from SectionWorker
        # ownership, device_worker.h:240)
        self._inner = optimizer
        self._num_microbatches = num_microbatches
        self._shard_params = shard_params

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self._inner.minimize(loss, startup_program, parameter_list,
                                      no_grad_set)
        program = loss.block.program
        program._pipeline_config = {
            "num_microbatches": self._num_microbatches,
            "loss_name": loss.name,
            "shard_params": self._shard_params,
        }
        return result


# ---------------------------------------------------------------------------
# Refusals the JAX package makes at compile time
# ---------------------------------------------------------------------------

def _island_sig(program, ops):
    """The collective islands a stage issues, with every discriminator
    that picks which island lowers (JAX pipeline.py:291-320)."""
    block = program.global_block()
    prog_is_test = bool(getattr(program, "_is_test", False))

    def var_shape(names):
        n = (names or [None])[0]
        v = block._find_var_recursive(n) if n else None
        return tuple(v.shape) if v is not None and v.shape else None

    sig = []
    for o in ops:
        if o.type == "fused_attention" and o.attr("sp_axis", None):
            dropout = float(o.attr("attn_dropout", 0.0) or 0.0)
            if prog_is_test or o.attr("is_test", False):
                dropout = 0.0
            sig.append(("sp_attn",
                        var_shape(o.inputs.get("Q")),
                        var_shape(o.inputs.get("K")),
                        bool(dropout),
                        o.attr("sp_mode", "ring")))
        if o.type == "switch_moe" and \
                o.attr("moe_dispatch", "dense") == "a2a":
            sig.append("moe_a2a")
    return tuple(sig)


def check_program(program, plan, degrees, fetch_names):
    """The JAX package's refusals, word for word: stages issuing
    different collective islands under sp/ep, the a2a MoE dispatch, a
    fetch other than the loss, and (the port checks it before any rank
    runs, from the declared dtypes) a boundary var that is not a float
    of 32 bits or fewer."""
    S = plan.num_stages
    if degrees.get("sp", 1) > 1 or degrees.get("ep", 1) > 1:
        sigs = {st: _island_sig(program, plan.stage_ops[st])
                for st in range(S)}
        if len(set(sigs.values())) > 1:
            raise ValueError(
                "pipeline x sp/ep needs every stage to carry the SAME "
                "sequence of collective islands (got per-stage %s) — "
                "asymmetric stages deadlock the in-branch collectives; "
                "balance the stages or drop sp_degree/dispatch='a2a' "
                "for this model" % (sigs,))
        if any("moe_a2a" in sig for sig in sigs.values()):
            raise ValueError(
                "moe_dispatch='a2a' does not compose with the pipeline "
                "— use the dense dispatch (default) for pipelined MoE "
                "programs")
    loss_name = program._pipeline_config["loss_name"]
    for n in fetch_names:
        if n != loss_name:
            raise NotImplementedError(
                "pipeline runs fetch only the loss (%r); got %r"
                % (loss_name, n))
    block = program.global_block()
    for s in range(S - 1):
        for n in plan.boundaries[s]:
            v = block._find_var_recursive(n)
            _check_boundary_dtype(n, v.dtype if v is not None else None)


# ---------------------------------------------------------------------------
# State: which values a rank holds as its 1/S slice
# ---------------------------------------------------------------------------

def param_names(program):
    """Every name that denotes a parameter (as opposed to optimizer
    state): Parameter instances, vars marked parameter-backed, and
    anything a structural state link points at (JAX executor.py:716)."""
    gb = program.global_block()
    names = {p.name for p in gb.all_parameters()}
    names.update(v.name for v in gb.vars.values()
                 if getattr(v, "is_parameter", False))
    names.update((getattr(program, "_opt_state_of", None) or {}).values())
    return names


def resolve_state_param(name, params, program):
    """The parameter of an optimizer-state var: its structural link
    (``program._opt_state_of``), else the longest ``<param>_`` prefix of
    its name that is a parameter (JAX executor.py:731-761)."""
    link = (getattr(program, "_opt_state_of", None) or {}).get(name)
    if link is not None:
        return link if link in params else None
    base = name
    while True:
        cut = base.rfind("_")
        if cut <= 0:
            return None
        base = base[:cut]
        if base in params:
            return base


def sharded_names(program, names, S):
    """State vars stored as the rank's 1/S slice on dim 0 (JAX
    ``_sharded_names``): parameters whose declared dim 0 divides by S,
    and accumulators of the same declared shape as their parameter; none
    with an ``_mp_shardings`` annotation (theirs, or their parameter's)
    or with ``shard_params=False``."""
    if not program._pipeline_config.get("shard_params", True) or S < 2:
        return set()
    block = program.global_block()
    params = param_names(program)
    annotated = set(getattr(program, "_mp_shardings", {}) or {})

    def shape(n):
        v = block._find_var_recursive(n)
        return tuple(v.shape or ()) if v is not None else ()

    out = set()
    for n in names:
        sh = shape(n)
        if not sh or sh[0] < S or sh[0] % S:
            continue
        base = n if n in params else resolve_state_param(n, params, program)
        if n in annotated or (base is not None and base in annotated):
            continue
        if n in params or (base is not None and shape(base) == sh):
            out.add(n)
    return out


# ---------------------------------------------------------------------------
# The wire: one message a microbatch between neighbouring stages
# ---------------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _dist():
    import torch.distributed as dist
    return dist


class _Wire:
    """Point-to-point traffic of one rank along its pp line: the tensors
    of a message are packed byte for byte into one buffer (each in its
    own dtype, so bf16 arrives bit-equal), staged through host memory for
    a card tensor on gloo.  Sends are non-blocking and are waited for at
    :meth:`drain`.  Every message counts its payload in ``comm``
    (``tensor_parallel.comm`` under ("send", "pp")) and in the step's
    comm log."""

    def __init__(self, coords, device, log):
        from ..parallel import tensor_parallel
        self.c = coords
        self.device = device
        self.log = log
        self.count = tensor_parallel.count
        self.pending = []

    def _peer(self, stage):
        return self.c.group_ranks[stage]

    def _staged(self, t):
        from .quantized_collectives import staged
        return staged(self.c.group, t)

    def send(self, stage, tensors):
        flat = torch.cat([t.detach().contiguous().reshape(-1)
                          .view(torch.uint8) for t in tensors]) \
            if tensors else torch.empty(0, dtype=torch.uint8,
                                        device=self.device)
        if self._staged(flat):
            flat = flat.cpu()
        work = _dist().isend(flat, dst=self._peer(stage), group=self.c.group)
        self.pending.append((work, flat))
        self.count("send", "pp", flat.numel())
        self.log.record_comm("send", "raw", flat.numel(), axis="pp")

    def recv(self, stage, specs):
        """The tensors of ``specs`` ([(shape, dtype)]) from ``stage``."""
        sizes = []
        for shape, dtype in specs:
            n = 1
            for d in shape:
                n *= int(d)
            sizes.append(n * torch.empty((), dtype=dtype).element_size())
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=self.device)
        host = buf.cpu() if self._staged(buf) else buf
        _dist().recv(host, src=self._peer(stage), group=self.c.group)
        if host is not buf:
            buf.copy_(host)
        out, off = [], 0
        for (shape, dtype), nb in zip(specs, sizes):
            out.append(buf[off:off + nb].view(dtype).reshape(shape))
            off += nb
        return out

    def send_specs(self, stage, tensors):
        """The shapes and dtypes of a plan's boundary tensors, sent once
        (every microbatch of every step of a plan has the same)."""
        head = [len(tensors)]
        for t in tensors:
            head += [_DTYPES.index(t.dtype), t.dim()] + list(t.shape)
        h = torch.tensor(head, dtype=torch.int64)
        _dist().send(torch.tensor([h.numel()], dtype=torch.int64),
                     dst=self._peer(stage), group=self.c.group)
        _dist().send(h, dst=self._peer(stage), group=self.c.group)

    def recv_specs(self, stage):
        n = torch.empty(1, dtype=torch.int64)
        _dist().recv(n, src=self._peer(stage), group=self.c.group)
        h = torch.empty(int(n[0]), dtype=torch.int64)
        _dist().recv(h, src=self._peer(stage), group=self.c.group)
        head, specs, i = h.tolist(), [], 1
        for _ in range(head[0]):
            dtype, nd = _DTYPES[head[i]], head[i + 1]
            specs.append((tuple(head[i + 2:i + 2 + nd]), dtype))
            i += 2 + nd
        return specs

    def drain(self):
        for work, _buf in self.pending:
            work.wait()
        self.pending = []


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _reads(block, ops):
    """Every name the ops read, their sub-blocks' ops included."""
    out = set()
    for op in ops:
        out.update(n for n in op.input_arg_names() if n)
        for idx in framework.op_sub_block_indices(op):
            out |= _reads(block, block.program.blocks[idx].ops)
    return out


class PipelineStep:
    """The GPipe step of one dispatch plan on this rank (see the module
    docstring).  Built once per (program, feed signature, fetch list);
    ``run`` executes one step."""

    def __init__(self, program, plan, par, shard, feed_names, state_names):
        cfg = program._pipeline_config
        self.program = program
        self.block = program.global_block()
        self.plan = plan
        self.M = int(cfg["num_microbatches"])
        self.loss_name = cfg["loss_name"]
        self.S = S = plan.num_stages
        self.pp = par.get("pp")
        if S > 1 and self.pp is None:
            raise RuntimeError(
                "this rank lies outside the pipeline's layout of %s: the "
                "world's first dp x pp x mp x sp x ep ranks run it" %
                dict(next(iter(par.values())).layout if par else {}))
        self.par = par
        self.shard = shard
        self.stage = self.pp.rank if self.pp is not None else 0
        self.dp = self.pp.dp_size if self.pp is not None else 1
        self.dp_rank = self.pp.dp_rank if self.pp is not None else 0
        self.dp_group = self.pp.dp_group if self.pp is not None else None
        self.sharded = sharded_names(program, state_names, S)
        index = {id(op): i for i, op in enumerate(self.block.ops)}
        s = self.stage
        self.ops = [(index[id(op)], op) for op in plan.stage_ops[s]]
        self.feeds = [n for n in feed_names if plan.feed_stage.get(n) == s]
        reads = _reads(self.block, plan.stage_ops[s])
        self.grad_params = sorted(plan.grad_name_of_param)
        self.stage_params = [p for p in self.grad_params if p in reads]
        # the sharded state each stage's ops read, gathered for its step
        self.stage_sharded = [
            sorted(n for n in self.sharded
                   if n in _reads(self.block, plan.stage_ops[t]))
            for t in range(S)]
        self.ins = plan.boundaries.get(s - 1, []) if s > 0 else []
        self.outs = plan.boundaries.get(s, []) if s < S - 1 else []
        self.diff_ins = [n for n in self.ins if self._differentiable(n)]
        self.diff_outs = [n for n in self.outs if self._differentiable(n)]
        # outputs whose gradient stops there (a stop_gradient var, an op
        # declared non-differentiable): detached in the recompute, as
        # append_backward never differentiates through them
        self.stop = set()
        for _i, op in self.ops:
            stop_op = get_op_def(op.type).stop_gradient
            for n in op.output_arg_names():
                v = self.block._find_var_recursive(n)
                if n and (stop_op or (v is not None and v.stop_gradient)):
                    self.stop.add(n)
        # the boundary inputs' [(shape, dtype)], received with the plan's
        # first microbatch; the outputs' sent with it
        self.in_specs = None
        self.specs_sent = not self.outs

    def _differentiable(self, n):
        v = self.block._find_var_recursive(n)
        return v is None or not v.stop_gradient

    # -- state -------------------------------------------------------------
    def _declared(self, n):
        v = self.block._find_var_recursive(n)
        return tuple(v.shape) if v is not None and v.shape else None

    def _gather(self, vals, names, log, to=None):
        """{name: whole value} of ``names``, sharded state held as slices
        in ``vals``, by one collective over pp a dtype: an all-gather,
        or with ``to`` a gather to stage ``to``'s rank ({} on the
        others; a card tensor staged through the host on gloo)."""
        from ..parallel.tensor_parallel import count
        from .quantized_collectives import exchange, staged
        full = {}
        for dtype in sorted({vals[n].dtype for n in names}, key=str):
            group = [n for n in names if vals[n].dtype == dtype]
            flat = torch.cat([vals[n].reshape(-1) for n in group])
            if to is None:
                species = "allgather"
                out = flat.new_empty((self.S, flat.numel()))
                exchange("all_gather", out.view(-1), flat, self.pp.group)
            else:
                species = "gather"
                src = flat.cpu() if staged(self.pp.group, flat) else flat
                parts = [torch.empty_like(src) for _ in range(self.S)] \
                    if to == self.stage else None
                _dist().gather(src, parts, dst=self.pp.group_ranks[to],
                               group=self.pp.group)
                if to != self.stage:
                    continue
                out = torch.stack(parts).to(flat.device)
            nb = out.numel() * out.element_size()
            count(species, "pp", nb)
            log.record_comm(species, "raw", nb, axis="pp")
            off = 0
            for n in group:
                v = vals[n]
                k = v.numel()
                full[n] = out[:, off:off + k].reshape(
                    (v.shape[0] * self.S,) + tuple(v.shape[1:]))
                off += k
        return full

    def _slice(self, n, v):
        chunk = v.shape[0] // self.S
        return v.narrow(0, self.stage * chunk, chunk).clone()

    # -- the merge ---------------------------------------------------------
    _BUCKET_BYTES = 32 << 20

    def _buckets(self, vals):
        """[(params, scatter)]: the gradients merged in one collective,
        of one dtype, all sharded (``scatter``) or all whole, up to
        ``_BUCKET_BYTES`` of full-size gradient each."""
        out = []
        for scatter in (True, False):
            names = [p for p in self.grad_params
                     if (p in self.sharded) == scatter]
            for dtype in sorted({vals[p].dtype for p in names}, key=str):
                cur, size = [], 0
                for p in names:
                    v = vals[p]
                    if v.dtype != dtype:
                        continue
                    nb = v.numel() * v.element_size() * \
                        (self.S if scatter else 1)
                    if cur and size + nb > self._BUCKET_BYTES:
                        out.append((cur, scatter))
                        cur, size = [], 0
                    cur.append(p)
                    size += nb
                if cur:
                    out.append((cur, scatter))
        return out

    def _merge(self, grads, vals, dp_feeds, log):
        """{param: its gradient summed over pp, and averaged over dp when
        the feeds were dp-sharded}, at the shape the rank holds the
        parameter: a sharded one's is reduce-scattered to the rank's
        slice, the others' are all-reduced whole.  A parameter the
        stage does not read adds zeros."""
        from ..parallel.tensor_parallel import all_reduce_, count
        from .quantized_collectives import exchange
        S = self.S
        out = {}
        for bucket, scatter in self._buckets(vals):
            parts = []
            for p in bucket:
                g = grads.get(p)
                if g is None:
                    v = vals[p]
                    shape = ((v.shape[0] * S,) + tuple(v.shape[1:])) \
                        if scatter else tuple(v.shape)
                    g = torch.zeros(shape, dtype=v.dtype, device=v.device)
                parts.append(g.reshape(S, -1) if scatter else g.reshape(-1))
            if scatter:
                flat = torch.cat(parts, dim=1).reshape(-1)
                mine = flat.new_empty((flat.numel() // S,))
                exchange("reduce_scatter", mine, flat, self.pp.group)
                nb = flat.numel() * flat.element_size()
                count("reducescatter", "pp", nb)
                log.record_comm("reducescatter", "raw", nb, axis="pp")
                del flat
            else:
                mine = torch.cat(parts)
                if S > 1:
                    all_reduce_(mine, self.pp.group, "pp")
                    log.record_comm("allreduce", "raw",
                                    2 * mine.numel() * mine.element_size(),
                                    axis="pp")
            del parts
            if dp_feeds:
                all_reduce_(mine, self.dp_group, "dp")
                mine /= self.dp
            off = 0
            for p in bucket:
                k = vals[p].numel()
                out[p] = mine[off:off + k].view(vals[p].shape)
                off += k
        return out

    # -- the post phase ----------------------------------------------------
    # ops that run on the slices of sharded state elementwise (a scalar
    # input broadcast), besides the elementwise optimizer rules; and ops
    # that sum over their one input, whose slices' partial sums are then
    # summed over pp.  Any other op reading a slice reads the whole value.
    # (the regularizers' scale / sign / sum, the clips' clip and
    # elementwise_mul)
    _ELEMENTWISE = frozenset(["scale", "sum", "sign", "clip",
                              "elementwise_mul"])
    _SUMS = frozenset(["squared_l2_norm"])

    def _local(self, op, names, env, sliced, shape):
        """{input: the rank's part of it} to run ``op`` on the slices of
        shape ``shape``, or None when the op cannot run there."""
        from .optimizer import elementwise_state_slots
        if op.type not in self._ELEMENTWISE and \
                elementwise_state_slots(op.type) is None:
            return None
        whole = (shape[0] * self.S,) + shape[1:]
        local = {}
        for n in names:
            v = env.get(n)
            if n in sliced:
                if tuple(v.shape) != shape:
                    return None
            elif isinstance(v, torch.Tensor) and v.numel() > 1:
                if tuple(v.shape) != whole:
                    return None
                local[n] = v.narrow(0, self.stage * shape[0], shape[0])
        return local

    def _post_op(self, op, env, st, sliced, log):
        """Run one post-phase op with the sharded state as slices
        (``sliced``: the names whose value in ``env`` is the rank's
        slice), keeping ``sliced`` true of its outputs."""
        from ..parallel.tensor_parallel import all_reduce_
        names = sorted(_reads(self.block, [op]))
        cut = [n for n in names if n in sliced]
        outs = op.output_arg_names()
        if not cut:
            dispatch(op, env, st, self.block)
            sliced.difference_update(outs)
            return
        shape = tuple(env[cut[0]].shape)
        if op.type in self._SUMS and len(names) == 1:
            dispatch(op, env, st, self.block)
            for o in outs:
                all_reduce_(env[o], self.pp.group, "pp")
                log.record_comm("allreduce", "raw",
                                2 * env[o].numel() * env[o].element_size(),
                                axis="pp")
            sliced.difference_update(outs)
            return
        local = self._local(op, names, env, sliced, shape)
        on_slices = local is not None
        if not on_slices:
            local = self._gather(env, cut, log)
        before = {n: env[n] for n in set(cut) | set(local)}
        env.update(local)
        dispatch(op, env, st, self.block)
        for n, v in local.items():
            if env.get(n) is v:
                env[n] = before[n]        # read, not written
        for o in set(outs) | set(cut):
            v = env.get(o)
            if o in before and v is before[o]:
                continue                  # unchanged
            sliced.discard(o)
            if not isinstance(v, torch.Tensor):
                continue
            if o in self.sharded and tuple(v.shape) == self._declared(o):
                env[o] = self._slice(o, v)
                sliced.add(o)
            elif on_slices and tuple(v.shape) == shape and \
                    self._declared(o) != shape:
                sliced.add(o)

    # -- one stage run -----------------------------------------------------
    def _state(self, step, k, rank, device, comm):
        p = self.program
        st = ExecState(p.blocks, step, p.random_seed, device,
                       is_test=p._is_test, amp_dtype=p._amp_dtype,
                       amp_keep=p._amp_keep, rank=rank,
                       hierarchical=getattr(p, "_collective_hierarchical",
                                            None), parallel=self.par)
        st.stream = k
        st.comm_log = comm
        return st

    def _run_stage(self, env, st):
        planned = self.shard.ops if self.shard is not None else {}
        for i, op in self.ops:
            dispatch(op, env, st, self.block, None, planned.get(i))
            if torch.is_grad_enabled():
                for n in op.output_arg_names():
                    if n in self.stop and isinstance(env.get(n),
                                                     torch.Tensor):
                        env[n] = env[n].detach()

    def _mb_feeds(self, mb, k):
        out = {}
        for n in self.feeds:
            v = mb[n][k]
            if self.shard is not None and n in self.shard.feeds:
                v = self.shard.slice_feed(n, v)
            out[n] = v
        return out

    # -- the step ----------------------------------------------------------
    def run(self, state_vals, feeds, step, device, state_out):
        """One step: (the loss as a [1] tensor, {state_out name: value as
        the scope holds it}, the step's comm log)."""
        M, S, s = self.M, self.S, self.stage
        log = ExecState(self.program.blocks, step, 0, device)
        comm = log.comm_log
        wire = _Wire(self.pp, device, log) if S > 1 else None
        t0 = [time.perf_counter_ns()]

        def span(name):
            now = time.perf_counter_ns()
            telemetry.record_span("pipeline_" + name, t0[0], now - t0[0],
                                  step=int(step), stage=s)
            t0[0] = now

        # the sharded state as the rank's slices (the scope holds it
        # whole before the first step), the stage's reads gathered whole
        vals = {n: self._slice(n, v) if n in self.sharded and
                tuple(v.shape) == self._declared(n) else v
                for n, v in state_vals.items()}
        full = dict(vals)
        for t, names in enumerate(self.stage_sharded):
            full.update(self._gather(vals, names, log, to=t))
        span("gather")
        dp_feeds = self.dp > 1 and all(
            v.dim() >= 1 and v.shape[0] and v.shape[0] % (self.dp * M) == 0
            for v in feeds.values())
        rank = self.dp_rank if dp_feeds else 0
        mb = {}
        for n, v in feeds.items():
            if dp_feeds:
                v = v.chunk(self.dp)[self.dp_rank]
            B = v.shape[0]
            if B % M:
                raise ValueError(
                    "batch %d not divisible by num_microbatches %d"
                    % (B, M))
            mb[n] = v.split(B // M)

        # ---------------- forward: M microbatches, no autograd ----------
        stash = []
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        with torch.no_grad():
            for k in range(M):
                env = dict(full)
                if self.ins:
                    if self.in_specs is None:
                        self.in_specs = wire.recv_specs(s - 1)
                    ins = dict(zip(self.ins, wire.recv(s - 1,
                                                       self.in_specs)))
                    env.update(ins)
                    stash.append(ins)
                env.update(self._mb_feeds(mb, k))
                self._run_stage(env, self._state(step, k, rank, device,
                                                 comm))
                if self.outs:
                    outs = [env[n] for n in self.outs]
                    if not self.specs_sent:
                        for n, t in zip(self.outs, outs):
                            if t.dtype not in _DTYPES:
                                _check_boundary_dtype(n, t.dtype)
                        wire.send_specs(s + 1, outs)
                        self.specs_sent = True
                    wire.send(s + 1, outs)
                if s == S - 1:
                    loss_sum = loss_sum + env[self.loss_name].reshape(
                        ()).float()
                del env
            if wire is not None:
                wire.drain()
        span("forward")

        # ---------------- backward: recompute, pull back ----------------
        grads = {p: torch.zeros_like(full[p]) for p in self.stage_params}
        for k in range(M):
            env = dict(full)
            leaves_p = {p: full[p].detach().requires_grad_()
                        for p in self.stage_params
                        if full[p].is_floating_point()}
            env.update(leaves_p)
            leaves_in = {}
            if self.ins:
                ins = stash[k]
                for n in self.ins:
                    t = ins[n]
                    if n in self.diff_ins:
                        t = t.detach().requires_grad_()
                        leaves_in[n] = t
                    env[n] = t
            env.update(self._mb_feeds(mb, k))
            with torch.enable_grad():
                self._run_stage(env, self._state(step, k, rank, device,
                                                 comm))
                if s == S - 1:
                    ys = [env[self.loss_name].reshape(()).float() / M]
                    gys = [torch.ones((), dtype=torch.float32,
                                      device=device)]
                else:
                    outs = [env[n] for n in self.diff_outs]
                    cots = wire.recv(s + 1, [(tuple(t.shape), t.dtype)
                                             for t in outs]) if outs else []
                    ys, gys = [], []
                    for y, g in zip(outs, cots):
                        if y.requires_grad:
                            ys.append(y)
                            gys.append(g)
            xs = list(leaves_in.values()) + list(leaves_p.values())
            gs = torch.autograd.grad(ys, xs, gys, allow_unused=True) \
                if ys and xs else [None] * len(xs)
            del env, ys, gys
            gin, gp = gs[:len(leaves_in)], gs[len(leaves_in):]
            if self.diff_ins:
                wire.send(s - 1, [g if g is not None else
                                  torch.zeros_like(x)
                                  for g, x in zip(gin, leaves_in.values())])
            for p, g in zip(leaves_p, gp):
                if g is not None:
                    grads[p] += g
        if wire is not None:
            wire.drain()
        stash.clear()
        del leaves_p, leaves_in, xs, gs, gin, gp
        span("backward")

        # ---------------- merge over pp (and dp) ------------------------
        del full
        merged = self._merge(grads, vals, dp_feeds, log)
        del grads
        from ..parallel.tensor_parallel import all_reduce_
        loss = loss_sum.reshape(1)
        if S > 1:
            all_reduce_(loss, self.pp.group, "pp")
        loss = loss / M
        if dp_feeds:
            all_reduce_(loss, self.dp_group, "dp")
            loss = loss / self.dp
        span("merge")

        # ---------------- post phase: optimizer ops on the slices ------
        env = dict(vals)
        gname = self.plan.grad_name_of_param
        for p, g in merged.items():
            env[gname[p]] = g.to(vals[p].dtype)
        env[self.loss_name] = loss
        sliced = {n for n in self.sharded if n in env}
        sliced.update(gname[p] for p in merged if p in self.sharded)
        st = self._state(step, None, rank, device, comm)
        with torch.no_grad():
            for op in self.plan.post_ops:
                self._post_op(op, env, st, sliced, log)
        # state written only inside the schedule (e.g. BN running stats)
        # keeps its previous value — the schedule's per-microbatch writes
        # are not merged back
        new = {}
        missing = []
        for n in state_out:
            v = env.get(n)
            if v is None:
                missing.append(n)
                continue
            new[n] = v
        if missing:
            raise RuntimeError(
                "pipeline cannot produce state vars %s" % missing)
        span("update")
        return loss, new, comm

