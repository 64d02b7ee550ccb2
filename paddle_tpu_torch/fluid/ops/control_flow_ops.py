"""The ``recurrent`` op and the sub-block traversals (counterpart
``paddle_tpu/fluid/ops/control_flow_ops.py``; ``while``,
``conditional_block`` and the tensor arrays are ROADMAP item 13c).

A ``recurrent`` op runs its step block once per time step: the JAX rule
is one ``lax.scan``, the port's a Python loop that runs the step
block's ops through :func:`lowering.run_block`.  In a training run the
op is taped like any other forward op: its inputs are the autograd
leaves, the loop runs under autograd with no inner op on the tape, and
``recurrent_grad`` pulls the gradients of Inputs, Initials and every
float ``Params`` back through the unrolled steps.  ``StaticRNN``
declares every outer read of the step block as ``Params``, so the step
environment is built from the op's own inputs.
"""

import torch

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
