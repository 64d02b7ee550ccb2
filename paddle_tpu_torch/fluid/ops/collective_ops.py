"""The c_* collective ops over ``torch.distributed`` (counterpart
``paddle_tpu/fluid/ops/collective_ops.py``; reference
``paddle/fluid/operators/collective/``).

Each rank is a process (``fluid/distributed.py``), so an op issues its
collective on the process group of its ``ring_id``: ring 0 is the world,
and ``c_comm_init`` builds a ``new_group`` for each further ring.  NCCL
serves tensors on the card, gloo tensors on the host (and, on the card,
``broadcast`` and ``all_reduce`` only).  With no process group the world
is one rank and every op is the identity, as the JAX ops are outside a
mapped context.

Wire precision (the ``precision`` attr, or the older ``use_bf16`` bool):
``fp32`` is exact; ``bf16`` casts the payload to bf16 and back, and the
prod all-reduce sends bf16 logs (fp32 ``log``/``exp``), as the JAX ops
do; ``int8`` and a ``Residual`` input (error feedback) are ROADMAP queue
1 item 10b and raise.  max/min all-reduces and broadcasts stay exact at
every precision.

Streams: every call is synchronous (``async_op=False``).  torch enqueues
an NCCL collective on its own stream behind an event of the current
stream and makes the current stream wait for it before returning, so no
later op reads a tensor before its collective lands and no collective
reads a tensor before the op that wrote it.  ``c_sync_calc_stream`` and
``c_sync_comm_stream`` are therefore pass-throughs.

Every collective issued counts one in ``calls[op type]`` (read and reset
by the chip check) and logs its per-rank wire bytes on the run's state
(``ExecState.record_comm``): the executor adds them to
``collective_bytes_total{species, precision, axis}`` and the step event,
under the JAX package's names and byte model (an all-reduce moves twice
its payload: a reduce-scatter and an all-gather).
"""

import collections

import torch

from .. import distributed
from ..registry import register_op

PRECISIONS = ("fp32", "bf16", "int8")

# op type -> collectives issued on a process group (identity runs and
# worlds of one do not count)
calls = collections.Counter()

# the tiled collectives under the names both torch 2.11 and 2.13 have,
# chosen once (2.13 deprecates the *_tensor names for *_single)
_ALL_GATHER = None
_REDUCE_SCATTER = None


def reset_calls():
    calls.clear()


def resolve_precision(precision=None, use_bf16=False):
    """Wire precision from the ``precision`` knob, with the older
    ``use_bf16`` bool as fallback (JAX quantized_collectives.py:59)."""
    if precision in (None, "", False):
        return "bf16" if use_bf16 else "fp32"
    if precision not in PRECISIONS:
        raise ValueError("allreduce_precision must be one of %s, got %r"
                         % (PRECISIONS, precision))
    return precision


def _tiled():
    global _ALL_GATHER, _REDUCE_SCATTER
    if _ALL_GATHER is None:
        import torch.distributed as dist
        _ALL_GATHER = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        _REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
    return _ALL_GATHER, _REDUCE_SCATTER


def _world(ctx):
    """(torch.distributed, group, world size) of the op's ring, or None
    without a process group (a world of one: the op is the identity)."""
    d = distributed._dist()
    if d is None:
        return None
    group = distributed.ring_group(ctx.attr("ring_id", 0))
    return d, group, d.get_world_size(group)


def _precision(ctx):
    p = resolve_precision(ctx.attr("precision", None),
                          ctx.attr("use_bf16", False))
    if p == "int8":
        raise NotImplementedError(
            "%s: the int8 wire (block-scaled quantized collectives) is not "
            "ported yet (ROADMAP queue 1 item 10b)" % ctx.op.type)
    return p


def _no_residual(ctx):
    if ctx.op.input("Residual"):
        raise NotImplementedError(
            "%s: error-feedback residuals are not ported yet (ROADMAP "
            "queue 1 item 10b)" % ctx.op.type)


def _castable(x, precision):
    return precision != "fp32" and x.is_floating_point() and \
        x.dtype != torch.bfloat16


def _payload(x, precision):
    """A contiguous tensor of its own to hand to an in-place collective
    (the environment may share ``x`` with another name), cast to bf16 on
    the bf16 wire."""
    if _castable(x, precision):
        return x.to(torch.bfloat16).contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def _count(ctx, species, precision, nbytes, grad_bucket=False):
    calls[ctx.op.type] += 1
    ctx.state.record_comm(species, precision, nbytes,
                          grad_bucket=grad_bucket)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group, differentiable: the adjoint of a
    sum over ranks is the sum over ranks of the incoming gradients, so
    the backward all-reduces them too (sync batch norm's statistics and a
    forward ``c_allreduce_sum`` are replayed by grad ops through
    autograd)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """``x`` summed over ``group``'s ranks (differentiable)."""
    return _AllReduceSum.apply(x, group)


@register_op("c_allreduce_sum")
def _c_allreduce_sum(ctx, op):
    x = ctx.i("X")
    _no_residual(ctx)
    precision = _precision(ctx)
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    d, group, _n = w
    bucket = bool(ctx.attr("__grad_bucket__", False))
    if _castable(x, precision):
        y = x.to(torch.bfloat16).contiguous()
        d.all_reduce(y, group=group)
        ctx.set("Out", y.to(x.dtype))
        _count(ctx, "allreduce", "bf16", 2 * 2 * x.numel(), bucket)
        return
    ctx.set("Out", all_reduce_sum(x, group))
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel(),
           bucket)


def _minmax(ctx, which):
    """max/min all-reduce, always exact: rounding is monotonic, so a bf16
    wire would return bf16(max) for no saving worth having."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    d, group, _n = w
    y = _payload(x, "fp32")
    d.all_reduce(y, op=getattr(d.ReduceOp, which), group=group)
    ctx.set("Out", y)
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel())


@register_op("c_allreduce_max")
def _c_allreduce_max(ctx, op):
    _minmax(ctx, "MAX")


@register_op("c_allreduce_min")
def _c_allreduce_min(ctx, op):
    _minmax(ctx, "MIN")


@register_op("c_allreduce_prod")
def _c_allreduce_prod(ctx, op):
    """Product over the ranks: the exact product (the reference's
    ncclProd) on the fp32 wire; on the bf16 wire the JAX package's
    exp(sum(log x)), logs and exp in float32 and only the summed logs
    sent as bf16."""
    x = ctx.i("X")
    precision = _precision(ctx)
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    d, group, _n = w
    if _castable(x, precision):
        logs = torch.log(x.float()).to(torch.bfloat16)
        d.all_reduce(logs, group=group)
        ctx.set("Out", torch.exp(logs.float()).to(x.dtype))
        _count(ctx, "allreduce", "bf16", 2 * 2 * x.numel())
        return
    y = _payload(x, "fp32")
    d.all_reduce(y, op=d.ReduceOp.PRODUCT, group=group)
    ctx.set("Out", y)
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel())


def _broadcast(ctx, op):
    """Root's X on every rank, exact at every precision: it moves
    parameters (the startup sync), which must be bit-identical on every
    rank."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    d, group, _n = w
    root = int(ctx.attr("root", 0))
    y = _payload(x, "fp32")
    src = root if group is None else d.get_global_rank(group, root)
    d.broadcast(y, src=src, group=group)
    ctx.set("Out", y)
    _count(ctx, "broadcast", "fp32", 2 * x.element_size() * x.numel())


register_op("c_broadcast")(_broadcast)


@register_op("c_allgather")
def _c_allgather(ctx, op):
    """The ranks' X stacked along dim 0 ([N * d0, ...]), in rank order.
    Its wire bytes count the gathered size, as the JAX op does."""
    x = ctx.i("X")
    _no_residual(ctx)
    precision = _precision(ctx)
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    _d, group, n = w
    src = _payload(x, precision)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _tiled()[0](out, src, group=group)
    ctx.set("Out", out.to(x.dtype))
    _count(ctx, "allgather", "bf16" if _castable(x, precision) else "fp32",
           n * x.numel() * src.element_size())


@register_op("c_reducescatter")
def _c_reducescatter(ctx, op):
    """The sum over the ranks of X, split along dim 0: rank r keeps the
    r-th of N equal parts."""
    x = ctx.i("X")
    _no_residual(ctx)
    precision = _precision(ctx)
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    _d, group, n = w
    if x.shape[0] % n:
        raise ValueError("c_reducescatter: dim0=%d not divisible by world "
                         "size %d" % (x.shape[0], n))
    src = _payload(x, precision)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _tiled()[1](out, src, group=group)
    ctx.set("Out", out.to(x.dtype))
    _count(ctx, "reducescatter",
           "bf16" if _castable(x, precision) else "fp32",
           x.numel() * src.element_size(),
           bool(ctx.attr("__grad_bucket__", False)))


@register_op("c_shard_slice", stop_gradient=True)
def _c_shard_slice(ctx, op):
    """This rank's 1/N contiguous dim-0 shard of X (no wire traffic)."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    d, group, n = w
    if x.shape[0] % n:
        raise ValueError("c_shard_slice: dim0=%d not divisible by world "
                         "size %d" % (x.shape[0], n))
    shard = x.shape[0] // n
    r = d.get_rank(group)
    ctx.set("Out", x[r * shard:(r + 1) * shard])


def _pass_through(ctx, op):
    if op.input("X"):
        ctx.set("Out", ctx.i("X"))


# stream fences: every collective above already orders against the
# current stream (see the module docstring)
register_op("c_sync_calc_stream")(_pass_through)
register_op("c_sync_comm_stream")(_pass_through)
register_op("c_wait_compute")(_pass_through)


@register_op("c_gen_nccl_id", stop_gradient=True)
def _c_gen_nccl_id(ctx, op):
    """The rendezvous (``fluid.distributed.init``'s tcp:// store) has
    exchanged the ids already; the output is a placeholder."""
    ctx.set("Out", torch.zeros((1,), dtype=torch.int32,
                               device=ctx.state.device))


@register_op("c_comm_init", stop_gradient=True)
def _c_comm_init(ctx, op):
    """Build the op's ring on the world that ``fluid.distributed.init``
    joined: ring 0 is the world, ring k a group over every rank.  A
    program transpiled for ``nranks`` > 1 in a process with another world
    raises (the executor checks it first: executor._check_collective)."""
    d = distributed._dist()
    nranks = int(ctx.attr("nranks", 0) or 0)
    world = d.get_world_size() if d is not None else 1
    if nranks and nranks != world:
        raise RuntimeError(
            "c_comm_init: the program was transpiled for nranks=%d but "
            "the world has %d rank(s)" % (nranks, world))
    ring = int(ctx.attr("ring_id", 0))
    if d is not None and ring and ring not in distributed._rings:
        distributed.register_ring(ring, d.new_group(ranks=list(range(world))))


@register_op("barrier", stop_gradient=True)
def _barrier(ctx, op):
    w = _world(ctx)
    if w is not None:
        d, group, _n = w
        d.barrier(group=group)
        calls[op.type] += 1
    if op.output("Out"):
        ctx.set("Out", ctx.i("X") if op.input("X") else
                torch.zeros((1,), dtype=torch.float32,
                            device=ctx.state.device))


@register_op("local_sgd_sync", stop_gradient=True)
def _local_sgd_sync(ctx, op):
    """LocalSGD's parameter average (transpiler/collective.py): at every
    k-th step X becomes the mean over the ranks, else it keeps its local
    value.  The step is the host's, so off steps issue nothing."""
    x = ctx.i("X")
    w = _world(ctx)
    k = int(ctx.attr("k_steps", 1))
    if w is None or ctx.state.step % k != k - 1:
        ctx.set("Out", x)
        return
    d, group, n = w
    y = _payload(x, "fp32")
    d.all_reduce(y, group=group)
    ctx.set("Out", y / torch.tensor(n, dtype=y.dtype, device=y.device))
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel())


# the legacy single-op collectives (operators/distributed_ops/
# allreduce_op.cc, broadcast_op.cc): the same rules
register_op("allreduce")(_c_allreduce_sum)
register_op("broadcast")(_broadcast)


@register_op("c_alltoall")
def _c_alltoall(ctx, op):
    raise NotImplementedError(
        "c_alltoall belongs to the model-parallel family, which is not "
        "ported yet (ROADMAP queue 1 item 11)")


@register_op("ring_attention")
def _ring_attention(ctx, op):
    raise NotImplementedError(
        "ring_attention belongs to the model-parallel family, which is "
        "not ported yet (ROADMAP queue 1 item 11)")
