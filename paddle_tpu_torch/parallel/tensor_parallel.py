"""Tensor (model) parallelism: Megatron's column/row-parallel rules as
explicit autograd functions over a process group (counterpart
``paddle_tpu/parallel/tensor_parallel.py``).

The JAX package annotates weights and lets GSPMD insert the one
all-reduce per Megatron pair.  The port runs one process per rank, so a
rank executes its share explicitly, through four differentiable
collectives over the model-parallel group (Shoeybi et al.,
arXiv:1909.08053):

- :func:`copy_to` — identity forward, all-reduce of the gradient
  backward: a replicated tensor entering computation that runs on
  shards (the input of a column-parallel matmul, a weight applied to a
  rank's sequence shard) gets back the sum of every rank's part of its
  gradient;
- :func:`reduce_from` — all-reduce forward, identity backward: the
  partial products of a row-parallel matmul become the replicated
  output;
- :func:`gather_from` — all-gather along a dim forward, this rank's
  slice of the gradient backward: a shard handed to computation that
  every rank repeats on the whole tensor;
- :func:`scatter_to` — this rank's slice forward, all-gather of the
  gradient backward.

Under these rules every rank holds the exact gradient of what it holds:
the whole gradient of a replicated tensor, its shard's part of a sharded
one.  Nothing else needs a collective: the optimizer updates each rank's
shard of a sharded weight and the whole of a replicated one.

On a gloo group a card tensor goes through host memory for the
collectives gloo does not run on the card
(``fluid.quantized_collectives.exchange``).  Every collective counts one
call and its per-rank wire bytes in :data:`comm` under ``(species,
axis)`` (an all-reduce moves twice its payload, as
``quantized_collectives.allreduce_wire_bytes`` counts it).
"""

import collections

import torch

# (species, axis) -> [calls, per-rank wire bytes]; read and reset by the
# chip check and the tests
comm = collections.defaultdict(lambda: [0, 0])


def reset_comm():
    comm.clear()


def count(species, axis, nbytes):
    entry = comm[(species, axis)]
    entry[0] += 1
    entry[1] += int(nbytes)


def _dist():
    import torch.distributed as dist
    return dist


def group_size(group):
    return _dist().get_world_size(group)


def group_rank(group):
    return _dist().get_rank(group)


def global_rank(group, rank):
    """The world rank of ``group``'s member ``rank``."""
    if group is None:
        return rank
    return _dist().get_global_rank(group, rank)


def all_reduce_(t, group, axis="mp"):
    """Sum ``t`` over ``group`` in place (gloo sums card tensors too)."""
    _dist().all_reduce(t, group=group)
    count("allreduce", axis, 2 * t.numel() * t.element_size())
    return t


def all_gather(x, group, dim, axis="mp"):
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    from ..fluid.quantized_collectives import exchange
    n = group_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    exchange("all_gather", out, src, group)
    count("allgather", axis, out.numel() * out.element_size())
    return out.movedim(0, dim)


def reduce_scatter(x, group, dim, axis="mp"):
    """The sum of the group's ``x``, this rank's 1/N slice along ``dim``."""
    from ..fluid.quantized_collectives import exchange
    n = group_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    exchange("reduce_scatter", out, src, group)
    count("reducescatter", axis, src.numel() * src.element_size())
    return out.movedim(0, dim)


def split(x, group, dim):
    """This rank's 1/N slice of ``x`` along ``dim`` (no traffic)."""
    n, r = group_size(group), group_rank(group)
    if x.shape[dim] % n:
        raise ValueError("dim %d of size %d does not split over %d ranks"
                         % (dim, x.shape[dim], n))
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce_(g, ctx.group, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        y = x.clone(memory_format=torch.contiguous_format)
        return all_reduce_(y, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.group, ctx.dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return split(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim, ctx.axis), None, None, None


class _GatherReduceScatter(torch.autograd.Function):
    """All-gather forward, reduce-scatter of the gradient backward: a
    shard gathered for computation that stays on shards (the k/v memory
    of a rank's own q rows), whose gradient is every rank's part."""

    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis = group, dim, axis
        return all_gather(x, group, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim, ctx.axis), None, \
            None, None


def copy_to(x, group, axis="mp"):
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyTo.apply(x, group, axis)


def reduce_from(x, group, axis="mp"):
    """``x`` summed over ``group``; the gradient passes unchanged."""
    return _ReduceFrom.apply(x, group, axis)


def gather_from(x, group, dim, axis="mp"):
    """The group's shards of ``x`` concatenated along ``dim``; backward
    keeps this rank's slice of the gradient."""
    return _GatherFrom.apply(x, group, dim, axis)


def scatter_to(x, group, dim, axis="mp"):
    """This rank's slice of ``x`` along ``dim``; backward all-gathers the
    gradient."""
    return _ScatterTo.apply(x, group, dim, axis)


def gather_reduce_scatter(x, group, dim, axis="sp"):
    """All-gather forward, reduce-scatter backward (see the class)."""
    return _GatherReduceScatter.apply(x, group, dim, axis)


# -- the JAX module's primitives ---------------------------------------------

def column_parallel_matmul(x, w_shard, group=None, axis="mp"):
    """x replicated ``[.., K]``; ``w_shard`` this rank's ``[K, N/mp]``
    slice → the local ``[.., N/mp]`` output; backward sums the input's
    gradient over the group."""
    return torch.matmul(copy_to(x, group, axis), w_shard)


def row_parallel_matmul(x_shard, w_shard, group=None, axis="mp"):
    """``x_shard [.., K/mp]`` (a column-parallel output); ``w_shard
    [K/mp, N]`` → the full ``[.., N]`` through one all-reduce."""
    return reduce_from(torch.matmul(x_shard, w_shard), group, axis)


def mlp_block(x, w1_shard, w2_shard, group=None, act=torch.relu,
              axis="mp"):
    """The Megatron MLP: column-parallel expand, activation,
    row-parallel contract; one all-reduce forward, one backward."""
    h = act(column_parallel_matmul(x, w1_shard, group, axis))
    return row_parallel_matmul(h, w2_shard, group, axis)


def attention_heads_split(qkv, n_heads, axis_size):
    """With Q/K/V column-sharded each rank holds ``n_heads / mp`` heads:
    ``[B, S, H/mp]`` → ``[B, S, heads per rank, D]``."""
    B, S, H = qkv.shape
    local_heads = n_heads // axis_size if n_heads % axis_size == 0 else 1
    return qkv.reshape(B, S, local_heads, H // local_heads)


def vocab_parallel_embedding(ids, table_shard, group=None, axis="mp"):
    """Megatron's vocab-parallel embedding: the ``[V, D]`` table row-
    sharded over the group; each rank looks up the ids in its range
    (zeros elsewhere) and one all-reduce assembles the activations."""
    r = group_rank(group) if group is not None or _dist().is_initialized() \
        else 0
    per = table_shard.shape[0]
    local = ids - r * per
    in_range = (local >= 0) & (local < per)
    emb = table_shard[local.clamp(0, per - 1)]
    emb = torch.where(in_range.unsqueeze(-1), emb, torch.zeros_like(emb))
    return reduce_from(emb, group, axis)


# -- Fluid layer functions (the JAX module's annotation-only pair) -----------

def fc_column_parallel(input, size, mesh_axis="mp", num_partitions=1,
                       param_attr=None, act=None, name=None):
    """fc (no bias) whose weight is marked column-sharded over
    ``mesh_axis`` (``w.mesh_sharding``, as the JAX function marks it).
    The mark is an annotation only, in both packages: sharding comes from
    ``TensorParallelTranspiler`` (``program._mp_shardings``)."""
    from ..fluid.layers import nn as nn_layers
    out = nn_layers.fc(input, size, param_attr=param_attr, act=act,
                       name=name, bias_attr=False)
    w = out.block.program.global_block().all_parameters()[-1]
    w.mesh_sharding = {"axis": mesh_axis, "dim": 1}
    return out


def fc_row_parallel(input, size, mesh_axis="mp", num_partitions=1,
                    param_attr=None, act=None, name=None):
    """fc (no bias) whose weight is marked row-sharded (see
    :func:`fc_column_parallel`)."""
    from ..fluid.layers import nn as nn_layers
    out = nn_layers.fc(input, size, param_attr=param_attr, act=act,
                       name=name, bias_attr=False)
    w = out.block.program.global_block().all_parameters()[-1]
    w.mesh_sharding = {"axis": mesh_axis, "dim": 0}
    return out
