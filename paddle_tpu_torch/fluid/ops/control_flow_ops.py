"""The ``recurrent``, ``conditional_block`` and ``recompute`` ops and
the sub-block traversals (counterpart ``paddle_tpu/fluid/ops/
control_flow_ops.py``; ``while``, ``cond`` and the tensor arrays are
ROADMAP item 13c).

A ``recurrent`` op runs its step block once per time step: the JAX rule
is one ``lax.scan``, the port's a Python loop that runs the step
block's ops through :func:`lowering.run_block`.  In a training run the
op is taped like any other forward op: its inputs are the autograd
leaves, the loop runs under autograd with no inner op on the tape, and
``recurrent_grad`` pulls the gradients of Inputs, Initials and every
float ``Params`` back through the unrolled steps.  ``StaticRNN``
declares every outer read of the step block as ``Params``, so the step
environment is built from the op's own inputs.

A ``conditional_block`` runs its block when its predicate holds.  The
JAX rule is one ``lax.cond``; eager torch reads the predicate on the
host, one synchronisation per run of the op on the card (recorded as
the ``conditional_block`` host sync), and runs the block only when it
is taken.  A ``recompute`` op runs its span of forward ops under
non-reentrant ``torch.utils.checkpoint``: the span keeps no
intermediate, and its grad op's ``torch.autograd.grad`` runs the span
again to rebuild them.
"""

import torch
import torch.utils.checkpoint

from .. import profiler
from ..framework import op_bound_var_names, op_sub_block_indices
from ..registry import register_op


def _block_writes(block):
    """Names written by the ops of ``block``, in order (one level; a
    nested control-flow op surfaces its writes through its own output
    slots)."""
    out, seen = [], set()
    for op in block.ops:
        for names in op.outputs.values():
            for n in names:
                if n and n not in seen:
                    seen.add(n)
                    out.append(n)
    return out


def block_reads(block, blocks):
    """The names ``block`` reads before any op of it writes them,
    recursing into the sub-blocks its control-flow ops name (the names
    such an op binds are not reads)."""
    reads = []

    def visit(blk, written):
        for op in blk.ops:
            for names in op.inputs.values():
                for n in names:
                    if n and n not in written and n not in reads:
                        reads.append(n)
            for sub_idx in op_sub_block_indices(op):
                visit(blocks[sub_idx], set(written) | op_bound_var_names(op))
            for names in op.outputs.values():
                written.update(n for n in names if n)

    visit(block, set())
    return reads


@register_op("recurrent")
def _recurrent(ctx, op):
    """control_flow_ops.py:297: run the step block over the leading
    (time) axis of every Inputs array ``[T, ...]``, in order or with
    ``reverse`` backwards.  Each step binds ``step_input_vars`` to the
    step's slices and ``pre_state_vars`` to the carry (from Initials),
    and after the step reads the new carry from ``state_vars`` (cast
    back to the carry's dtype) and the step's outputs from
    ``step_output_vars``; Outputs are those stacked ``[T, ...]``,
    FinalStates the last carry."""
    from ..lowering import run_block

    state = ctx.state
    sub = state.blocks[ctx.attr("sub_block")]
    env = ctx.env
    in_vars = ctx.attr("step_input_vars", [])
    pre_vars = ctx.attr("pre_state_vars", [])
    post_vars = ctx.attr("state_vars", [])
    out_vars = ctx.attr("step_output_vars", [])
    xs = [env[n] for n in op.input("Inputs")]
    carry = [env[n] for n in op.input("Initials")]
    outer = {n: env[n] for n in op.input("Params") if n}
    T = xs[0].shape[0]
    steps = range(T - 1, -1, -1) if ctx.attr("reverse", False) \
        else range(T)
    ys = [[None] * T for _ in out_vars]
    for t in steps:
        step_env = dict(outer)
        step_env.update(zip(in_vars, (x[t] for x in xs)))
        step_env.update(zip(pre_vars, carry))
        run_block(sub, step_env, state)
        carry = [step_env[n].to(c.dtype) for n, c in zip(post_vars, carry)]
        for y, n in zip(ys, out_vars):
            y[t] = step_env[n]
    for n, y in zip(op.output("Outputs"), ys):
        env[n] = torch.stack(y)
    for n, v in zip(op.output("FinalStates"), carry):
        env[n] = v


def _read_predicate(pred):
    """``bool(pred)``: a read-back, counted as the ``conditional_block``
    host sync, when ``pred`` lies on a device other than the CPU."""
    if isinstance(pred, torch.Tensor) and pred.device.type != "cpu":
        profiler.record_host_sync("conditional_block")
    return bool(pred)


@register_op("conditional_block", nondiff_inputs=("Cond",))
def _conditional_block(ctx, op):
    """control_flow_ops.py:256: run the block when every Cond holds
    (their conjunction, read on the host); otherwise each Out keeps its
    value, or is zeros where it had none.  Every name the block writes
    that its parent knows is an Out, so the persistables it updates (an
    optimizer's parameters, moments and beta powers) reach the scope."""
    from ..lowering import run_block
    state = ctx.state
    sub = state.blocks[ctx.attr("sub_block")]
    env = ctx.env
    out_names = [n for n in op.output("Out") if n]
    conds = [ctx.env[n].reshape(()).to(torch.bool)
             for n in op.input("Cond")]
    if _read_predicate(torch.stack(conds).all() if conds else True):
        inner = dict(env)
        run_block(sub, inner, state)
        for n in out_names:
            env[n] = inner[n]
        return
    missing = [n for n in out_names if n not in env]
    if missing:
        # zeros shaped as one run of the block, on a copy of the
        # environment, gives them (JAX takes the branch's eval_shape)
        inner = dict(env)
        run_block(sub, inner, state)
        for n in missing:
            env[n] = torch.zeros_like(inner[n])


@register_op("recompute")
def _recompute(ctx, op):
    """control_flow_ops.py:350: the forward span in the sub-block, run on
    the inputs ``X`` (bound to ``input_vars``), exposing ``output_vars``.
    Taped (its grad op in the block, so autograd is on), the span runs
    under ``torch.utils.checkpoint(use_reentrant=False,
    preserve_rng_state=False)``: it saves no intermediate, and the grad
    op's ``torch.autograd.grad`` replays it to rebuild them.  The replay
    is the same computation: a random op's generator is built afresh
    from (program seed, op seed, step) on each call
    (``LowerCtx.generator``), so dropout draws the same mask, and every
    rule writes into the span's own environment, a new dict per call,
    so a state update (batch norm's running statistics) reaches the
    outputs once, from the forward.  The names in
    ``stop_gradient_vars`` are detached where they enter or are written,
    as ``append_backward`` cuts the gradient there without recompute."""
    from ..lowering import dispatch
    state = ctx.state
    sub = state.blocks[ctx.attr("sub_block")]
    in_names = ctx.attr("input_vars")
    out_names = ctx.attr("output_vars")
    stop = set(ctx.attr("stop_gradient_vars", []) or [])
    xs = [ctx.env[n] for n in op.input("X")]

    def cut(env, names):
        for n in names:
            if n in stop and n in env:
                env[n] = env[n].detach()

    def segment(*vals):
        inner = dict(zip(in_names, vals))
        cut(inner, in_names)
        for sub_op in sub.ops:
            dispatch(sub_op, inner, state, sub)
            for names in sub_op.outputs.values():
                cut(inner, names)
        return tuple(inner[n] for n in out_names)

    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        outs = torch.utils.checkpoint.checkpoint(
            segment, *xs, use_reentrant=False, preserve_rng_state=False)
    else:
        outs = segment(*xs)
    for n, v in zip(op.output("Out"), outs):
        ctx.env[n] = v
