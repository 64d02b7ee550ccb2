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
do; ``int8`` runs the block-scaled two-phase exchange of
``quantized_collectives`` on ``c_allreduce_sum``, and its standalone
halves on a 1-D ``c_reducescatter`` (numel a multiple of N x block) and
``c_allgather`` (numel a multiple of the block), with an optional
error-feedback residual through the ``Residual``/``ResidualOut`` slots.
Every other int8 request (another shape, a hierarchical ring) becomes
the bf16 cast, and a non-float payload stays exact, as in the JAX ops.
max/min all-reduces and broadcasts stay exact at every precision.

Hierarchical rings (``hierarchical_allreduce_nnodes`` > 1 on the
program, the JAX package's ("dcn", "ici") mesh): an all-reduce sums
within each node onto the node's first rank, all-reduces across those
first ranks and broadcasts back within the node (reference
nccl_helper.h:246); the other ops run on the whole ring.  Their wire
bytes are split per level under the JAX package's level names.

A card tensor on a gloo group goes through host memory for every
collective gloo does not run on the card (reduce-scatter, all-gather,
all-to-all, reduce): the group's backend chooses the route
(``quantized_collectives.staged``), and under NCCL nothing is staged.

Streams: every call is synchronous (``async_op=False``).  torch enqueues
an NCCL collective on its own stream behind an event of the current
stream and makes the current stream wait for it before returning, so no
later op reads a tensor before its collective lands and no collective
reads a tensor before the op that wrote it.  ``c_sync_calc_stream`` and
``c_sync_comm_stream`` are therefore pass-throughs.

``c_alltoall`` (the tiled exchange, fp32/bf16/int8 wire) and
``ring_attention`` (over the run's sp group, named by ``axis_name``)
complete the family.

Every collective issued counts one in ``calls[op type]`` (read and reset
by the chip check) and logs its per-rank wire bytes on the run's state
(``ExecState.record_comm``): the executor adds them to
``collective_bytes_total{species, precision, axis}`` and the step event,
under the JAX package's names and byte model (an all-reduce moves twice
its payload: a reduce-scatter and an all-gather).
"""

import collections

import torch

from .. import costmodel, distributed
from ..quantized_collectives import (DEFAULT_BLOCK_SIZE,
                                     allreduce_wire_bytes, exchange,
                                     phase_wire_bytes, quantized_all_gather,
                                     quantized_psum,
                                     quantized_reduce_scatter,
                                     resolve_precision, staged)
from ..registry import register_op

# op type -> collectives issued on a process group (identity runs and
# worlds of one do not count)
calls = collections.Counter()

LEVELS = ("dcn", "ici")


def reset_calls():
    calls.clear()


def _world(ctx):
    """(torch.distributed, group, world size) of the op's ring, or None
    without a process group (a world of one: the op is the identity)."""
    d = distributed._dist()
    if d is None:
        return None
    group = ctx.state.ring_group(ctx.attr("ring_id", 0))
    return d, group, d.get_world_size(group)


def _levels(ctx):
    """The ring's two levels when the program runs hierarchical
    allreduce, else None."""
    nnodes = ctx.state.hierarchical
    if nnodes <= 1:
        return None
    return distributed.ring_levels(ctx.attr("ring_id", 0), nnodes)


def _precision(ctx):
    return resolve_precision(ctx.attr("precision", None),
                             ctx.attr("use_bf16", False))


def _block_size(ctx):
    return int(ctx.attr("quant_block_size", 0) or DEFAULT_BLOCK_SIZE)


def _pass_residual(ctx):
    residual = ctx.i_opt("Residual")
    if residual is not None:
        ctx.set("ResidualOut", residual)


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


def _count(ctx, species, precision, nbytes, grad_bucket=False, lv=None):
    calls[ctx.op.type] += 1
    if lv is None:
        ctx.state.record_comm(species, precision, nbytes,
                              grad_bucket=grad_bucket)
    else:
        ctx.state.record_comm(species, precision, nbytes,
                              grad_bucket=grad_bucket, axis=LEVELS,
                              sizes=(lv.nnodes, lv.per_node))


def _two_level_sum(d, y, group, lv):
    """``y`` summed over the ring in place, level by level: a reduce onto
    the node's first rank, an all-reduce across the first ranks, a
    broadcast within the node."""
    t = y.cpu() if staged(group, y) else y
    if lv.per_node > 1:
        d.reduce(t, dst=lv.root, group=lv.intra)
    if lv.inter is not None and lv.nnodes > 1:
        d.all_reduce(t, group=lv.inter)
    if lv.per_node > 1:
        d.broadcast(t, src=lv.root, group=lv.intra)
    if t is not y:
        y.copy_(t)
    return y


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
    """Gradient all-reduce at the op's wire precision: fp32 exact, bf16
    the payload cast, int8 the quantized two-phase exchange with its
    error-feedback residual (JAX ops/collective_ops.py:60)."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        _pass_residual(ctx)
        if costmodel._ACTIVE is not None:
            # a cost capture counts what the op puts on the wire per
            # rank in a world of several, as the JAX package counts its
            # collectives at trace time
            precision = _precision(ctx)
            if not x.is_floating_point():
                precision = "fp32"
            costmodel.note_collective(
                "allreduce", precision, allreduce_wire_bytes(
                    x.numel(), precision, _block_size(ctx),
                    itemsize=x.element_size()))
        return
    d, group, n = w
    lv = _levels(ctx)
    precision = _precision(ctx)
    bucket = bool(ctx.attr("__grad_bucket__", False))
    if precision == "int8" and x.is_floating_point() and lv is None:
        bs = _block_size(ctx)
        residual = ctx.i_opt("Residual")
        out, new_res = quantized_psum(x, group, block_size=bs,
                                      residual=residual)
        ctx.set("Out", out)
        if residual is not None:
            ctx.set("ResidualOut", new_res)
        _count(ctx, "allreduce", "int8",
               allreduce_wire_bytes(x.numel(), "int8", bs, world_size=n),
               bucket)
        return
    # a hierarchical ring and a non-float payload turn an int8 request
    # into the bf16 cast and the exact sum respectively
    _pass_residual(ctx)
    if _castable(x, precision):
        y = x.to(torch.bfloat16).contiguous()
        if lv is None:
            d.all_reduce(y, group=group)
        else:
            _two_level_sum(d, y, group, lv)
        ctx.set("Out", y.to(x.dtype))
        _count(ctx, "allreduce", "bf16", 2 * 2 * x.numel(), bucket, lv)
        return
    if lv is None:
        ctx.set("Out", all_reduce_sum(x, group))
    else:
        ctx.set("Out", _two_level_sum(d, _payload(x, "fp32"), group, lv))
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel(),
           bucket, lv)


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
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel(),
           lv=_levels(ctx))


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
        _count(ctx, "allreduce", "bf16", 2 * 2 * x.numel(),
               lv=_levels(ctx))
        return
    y = _payload(x, "fp32")
    d.all_reduce(y, op=d.ReduceOp.PRODUCT, group=group)
    ctx.set("Out", y)
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel(),
           lv=_levels(ctx))


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
    _count(ctx, "broadcast", "fp32", 2 * x.element_size() * x.numel(),
           lv=_levels(ctx))


register_op("c_broadcast")(_broadcast)


@register_op("c_allgather")
def _c_allgather(ctx, op):
    """The ranks' X stacked along dim 0 ([N * d0, ...]), in rank order.
    int8 on a 1-D X whose numel divides by the block size is the
    quantized gather (weight-update sharding's parameter delta, with an
    optional sharded residual); other int8 requests are the bf16 cast.
    Its wire bytes count the gathered size, as the JAX op does."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        _pass_residual(ctx)
        return
    _d, group, n = w
    lv = _levels(ctx)
    precision = _precision(ctx)
    bs = _block_size(ctx)
    if precision == "int8" and x.is_floating_point() and lv is None and \
            x.dim() == 1 and x.numel() % bs == 0:
        residual = ctx.i_opt("Residual")
        out, new_res = quantized_all_gather(x, group, block_size=bs,
                                            residual=residual)
        ctx.set("Out", out)
        if residual is not None:
            ctx.set("ResidualOut", new_res)
        _count(ctx, "allgather", "int8",
               phase_wire_bytes(x.numel() * n, "int8", bs))
        return
    _pass_residual(ctx)
    src = x.to(torch.bfloat16) if _castable(x, precision) else x
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    exchange("all_gather", out, src, group)
    ctx.set("Out", out.to(x.dtype))
    _count(ctx, "allgather", "bf16" if _castable(x, precision) else "fp32",
           n * x.numel() * src.element_size(), lv=lv)


@register_op("c_reducescatter")
def _c_reducescatter(ctx, op):
    """The sum over the ranks of X, split along dim 0: rank r keeps the
    r-th of N equal parts.  int8 on a 1-D X whose numel divides by N x
    the block size is phase 1 of the quantized exchange (the gradient
    half of weight-update sharding, with an optional residual); other
    int8 requests are the bf16 cast."""
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        _pass_residual(ctx)
        return
    _d, group, n = w
    lv = _levels(ctx)
    precision = _precision(ctx)
    bs = _block_size(ctx)
    bucket = bool(ctx.attr("__grad_bucket__", False))
    if precision == "int8" and x.is_floating_point() and lv is None and \
            x.dim() == 1 and x.numel() % (bs * n) == 0:
        residual = ctx.i_opt("Residual")
        out, new_res = quantized_reduce_scatter(x, group, block_size=bs,
                                                residual=residual)
        ctx.set("Out", out)
        if residual is not None:
            ctx.set("ResidualOut", new_res)
        _count(ctx, "reducescatter", "int8",
               phase_wire_bytes(x.numel(), "int8", bs), bucket)
        return
    if x.shape[0] % n:
        raise ValueError("c_reducescatter: dim0=%d not divisible by world "
                         "size %d" % (x.shape[0], n))
    _pass_residual(ctx)
    src = x.to(torch.bfloat16) if _castable(x, precision) else x
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    exchange("reduce_scatter", out, src, group)
    ctx.set("Out", out.to(x.dtype))
    _count(ctx, "reducescatter",
           "bf16" if _castable(x, precision) else "fp32",
           x.numel() * src.element_size(), bucket, lv)


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
    if d is not None and ctx.state.hierarchical > 1:
        # the ring's two levels, built here with every rank present
        distributed.ring_levels(ring, ctx.state.hierarchical)


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
    _count(ctx, "allreduce", "fp32", 2 * x.element_size() * x.numel(),
           lv=_levels(ctx))


# the legacy single-op collectives (operators/distributed_ops/
# allreduce_op.cc, broadcast_op.cc): the same rules
register_op("allreduce")(_c_allreduce_sum)
register_op("broadcast")(_broadcast)


@register_op("c_alltoall")
def _c_alltoall(ctx, op):
    """All-to-all over the op's ring (split dim 0, concat dim 0), the
    collective behind Ulysses-style sequence parallelism (JAX
    collective_ops.py:389), at the wire precision: int8 quantizes each
    token (last-dim row) against its own scale with no error feedback,
    a 1-D payload takes bf16 instead, a non-float payload stays exact.
    Differentiable: the gradient takes the same exchange back."""
    from ...parallel.expert_parallel import all_to_all
    from ..quantized_collectives import alltoall_wire_bytes
    x = ctx.i("X")
    w = _world(ctx)
    if w is None:
        ctx.set("Out", x)
        return
    _d, group, _n = w
    precision = _precision(ctx)
    if precision == "int8" and x.dim() < 2:
        precision = "bf16"     # per-token scales need a feature axis
    eff = precision if x.is_floating_point() else "fp32"
    ctx.set("Out", all_to_all(x, group, 0, 0, eff, axis="dp"))
    _count(ctx, "a2a", eff, alltoall_wire_bytes(x.shape, eff,
                                                itemsize=x.element_size()))


@register_op("ring_attention")
def _ring_attention(ctx, op):
    """Exact attention over a sequence sharded on a NAMED axis (JAX
    collective_ops.py:415): Q/K/V ``[B, T_local, H, D]``.  The axis comes
    from the ``axis_name`` attr (default ``sp``), never from the ring id,
    so a data-parallel ring is never mistaken for a sequence shard; with
    an sp group of more than one rank in this run the op is ring
    attention over it (``parallel.ring_attention``), otherwise
    single-rank local attention."""
    from ...parallel.sequence_parallel import local_attention, ring_attention
    q, k, v = ctx.i("Q"), ctx.i("K"), ctx.i("V")
    causal = bool(ctx.attr("causal", False))
    want = ctx.attr("axis_name", "sp")
    par = (getattr(ctx.state, "parallel", None) or {}).get(want)
    if par is not None and par.degree > 1:
        ctx.set("Out", ring_attention(q, k, v, par.group, causal=causal))
        calls[op.type] += 1
    else:
        ctx.set("Out", local_attention(q, k, v, causal=causal))
