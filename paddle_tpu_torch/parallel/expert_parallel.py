"""Expert parallelism: switch-style MoE with the all-to-all dispatch over
the expert-parallel process group (counterpart
``paddle_tpu/parallel/expert_parallel.py``; GShard arXiv:2006.16668,
Switch arXiv:2101.03961).

Tokens are top-1 routed (:func:`route_tokens`, the one routing function
every formulation shares, fp32, first-index tie-break, capacity slots in
token order), dispatched to the rank owning their expert by one
all-to-all, run through that rank's expert FFNs, and returned by a
second all-to-all; the gate reweights the combined output.

:func:`all_to_all` is the tiled exchange of ``lax.all_to_all(...,
tiled=True)`` over a process group, differentiable (its transpose is
the exchange with split and concat swapped) and with the wire in fp32,
bf16 or int8 (``fluid.quantized_collectives.quantized_all_to_all``).
"""

import math

import torch
import torch.nn.functional as F

from .tensor_parallel import (all_gather, copy_to, gather_from,
                              group_rank, group_size, reduce_from,
                              scatter_to)

ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _exchange(x, group, split_axis, concat_axis):
    """One tiled all-to-all: ``x`` cut into P chunks along
    ``split_axis``, chunk j sent to rank j, the received chunks
    concatenated along ``concat_axis`` in rank order."""
    from ..fluid.quantized_collectives import exchange
    P = group_size(group)
    if P == 1:
        return x
    n = x.shape[split_axis]
    if n % P:
        raise ValueError("all_to_all: dim %d of size %d does not split over "
                         "%d ranks" % (split_axis, n, P))
    xs = x.movedim(split_axis, 0)
    rest = tuple(xs.shape[1:])
    xs = xs.reshape((P, n // P) + rest).contiguous()
    out = torch.empty_like(xs)
    exchange("all_to_all", out, xs, group)
    parts = [c.movedim(0, split_axis) for c in out.unbind(0)]
    return torch.cat(parts, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, precision, axis):
        from ..fluid.quantized_collectives import quantized_all_to_all
        ctx.args = (group, split_axis, concat_axis, precision, axis)
        return quantized_all_to_all(x, group, split_axis, concat_axis,
                                    precision, axis=axis)

    @staticmethod
    def backward(ctx, g):
        from ..fluid.quantized_collectives import quantized_all_to_all
        group, split_axis, concat_axis, precision, axis = ctx.args
        # a permutation: its transpose swaps split and concat; the
        # gradient crosses the wire at the same precision
        return quantized_all_to_all(g.contiguous(), group, concat_axis,
                                    split_axis, precision, axis=axis), \
            None, None, None, None, None


def all_to_all(x, group, split_axis=0, concat_axis=0, precision="fp32",
               axis="ep"):
    """Differentiable tiled all-to-all over ``group`` at the wire
    ``precision``; counts one call and its wire bytes under
    ``("a2a", axis)``."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, precision,
                           axis)


def route_tokens(xf, router_w, E, capacity, offset=None):
    """Top-1 switch routing in float32: ``(gates [N, E], expert [N],
    gate [N], onehot [N, E], combine [N, E, C])``.  Ties go to the first
    expert (``argmax``); a token takes the next free slot of its expert
    in token order, after the slots ``offset(onehot)`` [E] says tokens
    ahead of these took (None: none), and is dropped past
    ``capacity``."""
    gates = torch.softmax(xf.float() @ router_w.float(), dim=-1)
    expert = torch.argmax(gates, dim=-1)
    gate = torch.gather(gates, 1, expert.unsqueeze(1)).squeeze(1)
    onehot = F.one_hot(expert, E).to(torch.float32)
    pos = torch.cumsum(onehot, dim=0) - 1.0
    if offset is not None:
        pos = pos + offset(onehot)
    pos = pos * onehot
    keep = (pos < capacity).to(torch.float32) * onehot
    slot = F.one_hot(pos.to(torch.int64).clamp(0, capacity - 1),
                     capacity).to(torch.float32)
    combine = keep.unsqueeze(-1) * slot
    return gates, expert, gate, onehot, combine


def aux_load_balance_loss(gates, expert):
    """Switch aux loss: ``E · Σ_e (fraction routed to e) · (mean gate e)``."""
    E = gates.shape[-1]
    onehot = F.one_hot(expert, E).to(gates.dtype)
    return E * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))


def switch_moe(x, router_w, w1, w2, group=None, capacity_factor=1.0,
               act=torch.relu):
    """One expert per rank (``switch_moe``, expert_parallel.py:46):
    ``x [Bl, D]`` this rank's tokens, ``router_w [D, E]`` with E the
    group size, ``w1 [D, H]``, ``w2 [H, D]`` this rank's expert.
    Returns ``[Bl, D]``."""
    E = group_size(group)
    Bl, D = x.shape
    C = int(Bl * capacity_factor)
    _g, _e, gate, _o, combine = route_tokens(x, router_w, E, C)
    combine = combine.to(x.dtype)
    dispatch = torch.einsum("bec,bd->ecd", combine, x)
    routed = all_to_all(dispatch, group, 0, 0).reshape(E * C, D)
    out_tok = act(routed @ w1) @ w2
    returned = all_to_all(out_tok.reshape(E, C, D), group, 0, 0)
    out = torch.einsum("bec,ecd->bd", combine, returned)
    return out * gate.to(out.dtype).unsqueeze(1)


def switch_moe_sharded(x, router_w, w1_local, w2_local, group=None,
                       capacity_factor=1.25, act=torch.relu,
                       dispatch_precision="fp32", stat_group="same",
                       dp_group=None):
    """The GShard island (``switch_moe_sharded``, expert_parallel.py:80):
    several experts per rank and the all-to-all dispatch.

    ``x [Nl, D]`` this rank's tokens; ``router_w [D, E]`` replicated;
    ``w1_local [E_l, D, F]``, ``w2_local [E_l, F, D]`` this rank's
    ``E_l = E / ep`` experts (rank j owns experts ``j·E_l`` to
    ``(j+1)·E_l - 1``).  Capacity is per (shard, expert),
    ``C = ceil(cf · Nl / E)``.  The two exchanges move ``[E, C, D]`` slot
    tensors at ``dispatch_precision``.  The aux statistics are summed
    over ``stat_group`` (default: ``group``), so the load-balance loss is
    global, and over ``dp_group`` too when the dp replicas' tokens share
    one routing: there the sum's gradient is summed over the replicas
    as well, because their averaged gradients each carry the loss.
    Returns ``(out [Nl, D], aux scalar)``."""
    ep = group_size(group)
    Nl, D = x.shape
    E = w1_local.shape[0] * ep
    C = max(1, int(math.ceil(capacity_factor * Nl / E)))
    gates, _e, gate, onehot, combine = route_tokens(x, router_w, E, C)
    combine = combine.to(x.dtype)
    dispatch = torch.einsum("nec,nd->ecd", combine, x)          # [E, C, D]
    # split the expert dim over the ranks, gather every rank's slots for
    # this rank's experts along the slot dim: [E, C, D] -> [E_l, ep·C, D]
    routed = all_to_all(dispatch, group, 0, 1, dispatch_precision)
    hidden = act(torch.einsum("ecd,edf->ecf", routed, w1_local))
    out_tok = torch.einsum("ecf,efd->ecd", hidden, w2_local)
    returned = all_to_all(out_tok, group, 1, 0, dispatch_precision)
    out = torch.einsum("nec,ecd->nd", combine, returned)
    out = out * gate.to(out.dtype).unsqueeze(1)
    sg = group if stat_group == "same" else stat_group
    n_tot = float(Nl * group_size(sg))
    frac = reduce_from(onehot.sum(dim=0), sg, "ep")
    prob = reduce_from(gates.sum(dim=0), sg, "ep")
    if dp_group is not None:
        n_tot *= group_size(dp_group)
        frac, prob = (copy_to(reduce_from(t, dp_group, "dp"), dp_group,
                              "dp") for t in (frac, prob))
    return out, E * torch.sum((frac / n_tot) * (prob / n_tot))


def switch_moe_dense(xf, router_w, w1, w2, cf, act, group=None, ep=1,
                     dp_group=None):
    """The dense global formulation (``moe_ops._switch_moe``'s einsums)
    with the expert dim over ``group``: routing, capacity
    ``ceil(cf · N / E)`` and the ``[E, C, D]`` dispatch are computed on
    every rank from all N tokens; each rank runs its ``E/ep`` experts
    (``w1 [E_l, D, F]``, ``w2 [E_l, F, D]``) on its slice of the slots,
    and the expert outputs are all-gathered back.  ``ep`` 1 is one rank
    holding every expert.

    With ``dp_group`` the replicas' tokens are one batch, rank-major, as
    GSPMD sees the JAX package's global batch: N counts every replica's
    tokens, a token's slot follows those its expert took on the lower
    replicas (their per-expert counts all-gathered), and the slots are
    summed over the replicas (each holds one token, so the sum is
    exact; its gradient passes unchanged, since a rank's loss reads only
    its own tokens' slots).  Dispatch and combine stay on this rank's
    tokens.  Returns ``(out, gates, onehot)`` of this rank's tokens."""
    N = xf.shape[0]
    E = router_w.shape[-1]
    dp = group_size(dp_group) if dp_group is not None else 1
    C = max(1, int(math.ceil(cf * N * dp / E)))

    def lower_replicas(onehot):
        with torch.no_grad():
            counts = all_gather(onehot.sum(dim=0), dp_group, 0, axis="dp")
            return counts.view(dp, E)[:group_rank(dp_group)].sum(dim=0)

    gates, _e, gate, onehot, combine = route_tokens(
        xf, router_w, E, C, lower_replicas if dp > 1 else None)
    combine = combine.to(xf.dtype)
    dispatch = torch.einsum("nec,nd->ecd", combine, xf)        # [E, C, D]
    if dp > 1:
        dispatch = reduce_from(dispatch, dp_group, "dp")
    if ep > 1:
        dispatch = scatter_to(dispatch, group, 0, axis="ep")
    hidden = act(torch.einsum("ecd,edf->ecf", dispatch, w1))
    out_tok = torch.einsum("ecf,efd->ecd", hidden, w2)
    if ep > 1:
        out_tok = gather_from(out_tok, group, 0, axis="ep")
    out = torch.einsum("nec,ecd->nd", combine, out_tok)
    return out * gate.unsqueeze(1).to(out.dtype), gates, onehot

