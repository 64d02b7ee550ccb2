"""Mixture-of-experts ops: switch routing (counterpart
``paddle_tpu/fluid/ops/moe_ops.py``; GShard arXiv:2006.16668, Switch
arXiv:2101.03961).

The lowering is the dense global formulation: top-1 routing as one-hot
dispatch/combine einsums with capacity ``C = ceil(cf · N / E)`` over all
N tokens of the batch, the same math at every ep degree.  Under expert
parallelism (``ExpertParallelTranspiler``: an ``ep_axis`` attr, and a
world with an ep group) each rank holds ``E/ep`` experts; every rank
routes all tokens, runs its experts on its slice of the ``[E, C, D]``
slots, and the expert outputs are all-gathered
(``parallel.switch_moe_dense``).  ``moe_dispatch='a2a'`` takes the GShard
island instead (``parallel.switch_moe_sharded``): each rank routes its
1/ep of the tokens with capacity per shard, and two all-to-alls of
``[E, C_local, D]`` slots at ``moe_dispatch_precision`` carry them to the
experts and back; their wire bytes are recorded as the JAX op records
them (``2 · alltoall_wire_bytes``).  When the tokens or experts do not
divide over the ep group the island cannot engage: the op warns and
takes the dense layout, as the JAX op does.

In a data-parallel run (a ``GradAllReduce`` transpile stamps the op
``__dp_tokens__``) the replicas' tokens are routed together, as GSPMD
routes the JAX package's global batch.  The dense layout keeps each
rank's tokens where they are: only the per-expert counts (for the slot
positions) and the ``[E, C, D]`` slots cross ring 0, with the
load-balance statistics; the a2a island shards the tokens over (dp, ep)
jointly, its capacity per shard, its statistics summed over both.
"""

import math
import warnings

from ...parallel.expert_parallel import (ACTS, switch_moe_dense,
                                         switch_moe_sharded)
from ...parallel.tensor_parallel import (copy_to, gather_from,
                                        group_size, reduce_from,
                                        scatter_to)
from ..quantized_collectives import alltoall_wire_bytes
from ..registry import register_op


def _ep_coords(ctx):
    """The ep group's coordinates when the op is stamped for expert
    parallelism and the run has an ep group of more than one rank."""
    if not ctx.attr("ep_axis", None):
        return None
    par = getattr(ctx.state, "parallel", None) or {}
    c = par.get("ep")
    return c if c is not None and c.degree > 1 else None


def _dp_group(ctx):
    """Ring 0's group when the op routes a data-parallel run's tokens
    together and the ring has more than one rank, else None."""
    if not ctx.attr("__dp_tokens__", False):
        return None
    from .. import distributed
    d = distributed._dist()
    if d is None:
        return None
    g = ctx.state.ring_group(0)
    if g is None:
        g = d.group.WORLD
    return g if d.get_world_size(g) > 1 else None


@register_op("switch_moe")
def _switch_moe(ctx, op):
    """X [..., D]; RouterW [D, E]; W1 [E, D, F]; W2 [E, F, D] (this
    rank's ``E/ep`` experts under expert parallelism) → Out [..., D],
    AuxLoss [1] (the switch load-balance loss).  Tokens past an expert's
    capacity pass through with zero expert output."""
    x = ctx.i("X")
    router_w = ctx.i("RouterW")
    w1 = ctx.i("W1")
    w2 = ctx.i("W2")
    cf = float(ctx.attr("capacity_factor", 1.25))
    act = ACTS[ctx.attr("act", "relu")]
    ep = _ep_coords(ctx)
    dpg = _dp_group(ctx)
    D = x.shape[-1]
    E = router_w.shape[-1]
    N = 1
    for d in x.shape[:-1]:
        N *= int(d)
    xf = x.reshape(N, D)

    if ep is not None and ctx.attr("moe_dispatch", "dense") == "a2a":
        precision = ctx.attr("moe_dispatch_precision", "fp32") or "fp32"
        if N % ep.degree == 0 and E % ep.degree == 0:
            g = ep.group
            xl = scatter_to(xf, g, 0, axis="ep")
            out_l, aux = switch_moe_sharded(
                xl, copy_to(router_w, g, "ep"), w1, w2, g,
                capacity_factor=cf, act=act, dispatch_precision=precision,
                dp_group=dpg)
            out = gather_from(out_l, g, 0, axis="ep")
            C = max(1, int(math.ceil(cf * (N // ep.degree) / E)))
            ctx.state.record_comm(
                "a2a", precision,
                2 * alltoall_wire_bytes((E, C, D), precision,
                                        itemsize=x.element_size()),
                axis="ep")
            ctx.set("Out", out.reshape(x.shape).to(x.dtype))
            if op.output("AuxLoss"):
                ctx.set("AuxLoss", aux.reshape(1))
            return
        warnings.warn(
            "moe_dispatch='a2a' requested but the island cannot engage "
            "(tokens=%d / experts=%d must divide the ep group of %d) — "
            "falling back to the dense dispatch layout (comm scales with "
            "global tokens)" % (N, E, ep.degree), stacklevel=2)

    out, gates, onehot = switch_moe_dense(
        xf, router_w, w1, w2, cf, act,
        *((ep.group, ep.degree) if ep is not None else (None, 1)),
        dp_group=dpg)
    ctx.set("Out", out.reshape(x.shape).to(x.dtype))
    if op.output("AuxLoss"):
        # E · Σ_e frac_e · prob_e in float32, like the router; over the
        # replicas' tokens the sums' gradient is summed too, because
        # each replica's loss carries the one global aux loss
        if dpg is None:
            frac, prob = onehot.mean(dim=0), gates.mean(dim=0)
        else:
            n = float(N * group_size(dpg))
            frac, prob = (copy_to(reduce_from(t.sum(dim=0), dpg, "dp"),
                                  dpg, "dp") / n for t in (onehot, gates))
        aux = E * (frac * prob).sum()
        ctx.set("AuxLoss", aux.reshape(1))
