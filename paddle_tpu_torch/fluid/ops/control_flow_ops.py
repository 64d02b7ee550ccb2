"""Control-flow ops (counterpart ``paddle_tpu/fluid/ops/
control_flow_ops.py``): the tensor arrays, ``while``, ``cond``,
``conditional_block``, ``recurrent``, ``recompute`` and ``print``, and
the sub-block traversals.

The JAX rules trace their sub-blocks into ``lax`` control flow; the port
runs them eagerly, op by op, through :func:`lowering.run_block`, and
reads a predicate on the host where JAX's ``lax.cond`` or
``lax.while_loop`` decides on the device.  Each such read is one
synchronisation on the card, recorded as a host sync under the op's
type (``conditional_block``, ``cond``, ``while``; CPU tensors need
none): a ``while`` of N iterations reads its condition N + 1 times.

A tensor array (:class:`TensorArray`, the static-shape LoDTensorArray of
the JAX package) is a ``[max_len, ...]`` buffer, allocated at the first
write, and an int32 length tensor on the array's device.  A write at an
index past the capacity lands at the last row and the length still
grows past it, as JAX's ``dynamic_update_index_in_dim`` clamps the index
and its length does not (JAX :43-52); a read clamps the same way.
Every write makes a new buffer, so an array value read earlier never
changes.

A ``recurrent`` op runs its step block once per time step.  In a
training run it is taped like any other forward op: its inputs are the
autograd leaves, the loop runs under autograd with no inner op on the
tape, and ``recurrent_grad`` pulls the gradients of Inputs, Initials and
every float ``Params`` back through the unrolled steps.  ``StaticRNN``
declares every outer read of the step block as ``Params``, so the step
environment is built from the op's own inputs.

``conditional_block`` and ``cond`` run the taken block only.  Taped,
their grad ops (``conditional_block_grad``, ``cond_grad``) differentiate
the branch that ran: the leaves are the op's float ``Input``, a
not-taken block leaves its ``Out`` at its earlier value, which no leaf
produced, so the leaves get zeros.  The gradient of an ``Out`` the block
overwrote still reaches the op that wrote it before (an ``assign_grad``
reads the same ``Out@GRAD``), as in the JAX package.  ``while`` has no
gradient, as in the JAX package.

A ``recompute`` op runs its span of forward ops under non-reentrant
``torch.utils.checkpoint``: the span keeps no intermediate, and its grad
op's ``torch.autograd.grad`` runs the span again to rebuild them.
"""

import torch
import torch.utils.checkpoint

from .. import profiler
from ..framework import op_bound_var_names, op_sub_block_indices
from ..registry import register_op

DEFAULT_ARRAY_CAPACITY = 128


# ---------------------------------------------------------------------------
# Tensor arrays (JAX :29-131)
# ---------------------------------------------------------------------------

class TensorArray:
    """Fixed-capacity tensor array: ``buffer`` ``[max_len, ...]`` (None
    until the first write fixes the element shape and dtype) and
    ``length``, an int32 ``()`` tensor on ``device``."""

    __slots__ = ("buffer", "length", "max_len", "device")

    def __init__(self, buffer, length, max_len, device):
        self.buffer = buffer
        self.length = length
        self.max_len = int(max_len)
        self.device = device

    @classmethod
    def empty(cls, max_len, device):
        return cls(None, torch.zeros((), dtype=torch.int32, device=device),
                   max_len, device)

    def _row(self, i):
        """The index as a ``[1]`` int64 tensor clamped into the
        capacity, and the unclamped int32 index."""
        i = torch.as_tensor(i, device=self.device).reshape(())
        i32 = i.to(torch.int32)
        return i32.clamp(0, self.max_len - 1).to(torch.int64).reshape(1), \
            i32

    def write(self, i, x):
        row, i32 = self._row(i)
        buf = self.buffer
        if buf is None:
            buf = torch.zeros((self.max_len,) + tuple(x.shape),
                              dtype=x.dtype, device=x.device)
        buf = buf.index_copy(0, row, x.to(buf.dtype).unsqueeze(0))
        length = torch.maximum(self.length, i32 + 1)
        return TensorArray(buf, length, self.max_len, self.device)

    def read(self, i):
        if self.buffer is None:
            raise ValueError("read from an empty tensor array")
        row, _ = self._row(i)
        return self.buffer.index_select(0, row)[0]


@register_op("create_array", stop_gradient=True)
def _create_array(ctx, op):
    ctx.set("Out", TensorArray.empty(
        ctx.attr("max_len", DEFAULT_ARRAY_CAPACITY), ctx.state.device))


@register_op("write_to_array", nondiff_inputs=("I",), stop_gradient=True)
def _write_to_array(ctx, op):
    """X the value, I the index, Out the array variable (read, modify,
    write, as the reference's scope-resident LoDTensorArray)."""
    arr = ctx.env.get(op.output("Out")[0])
    if not isinstance(arr, TensorArray):
        arr = TensorArray.empty(
            ctx.attr("max_len", DEFAULT_ARRAY_CAPACITY), ctx.state.device)
    ctx.set("Out", arr.write(ctx.i("I"), ctx.i("X")))


@register_op("read_from_array", nondiff_inputs=("I",), stop_gradient=True)
def _read_from_array(ctx, op):
    ctx.set("Out", ctx.i("X").read(ctx.i("I")))


@register_op("lod_array_length", stop_gradient=True)
def _lod_array_length(ctx, op):
    """The length, a ``[1]`` int32 tensor (JAX asks for int64, which JAX
    without x64 makes int32)."""
    ctx.set("Out", ctx.i("X").length.reshape(1).clone())


@register_op("tensor_array_to_tensor", stop_gradient=True)
def _tensor_array_to_tensor(ctx, op):
    """The whole buffer as one tensor: stacked along ``axis``
    (``use_stack``) or concatenated; rows past the length are the zeros
    of the fixed capacity, and OutIndex is the length, ``[1]`` int32."""
    arr = ctx.i("X")
    axis = ctx.attr("axis", 0)
    buf = arr.buffer
    if buf is None:
        raise ValueError("tensor_array_to_tensor on an empty array")
    if ctx.attr("use_stack", True):
        out = torch.movedim(buf, 0, axis) if axis else buf
    else:
        out = torch.cat(list(buf.unbind(0)), dim=axis)
    ctx.set("Out", out)
    ctx.set("OutIndex", arr.length.reshape(1).clone())


@register_op("is_empty", stop_gradient=True)
def _is_empty(ctx, op):
    """JAX misc_ops5.py:19: ``[1]`` bool, whether X has no element."""
    x = ctx.i("X")
    ctx.set("Out", torch.full((1,), x.numel() == 0, dtype=torch.bool,
                              device=x.device))


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


def _read_predicate(pred, tag="conditional_block"):
    """``bool(pred)``: a read-back, counted as the ``tag`` host sync, when
    ``pred`` lies on a device other than the CPU."""
    if isinstance(pred, torch.Tensor) and pred.device.type != "cpu":
        profiler.record_host_sync(tag)
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


# ---------------------------------------------------------------------------
# while, cond and print (JAX :187-253, :342)
# ---------------------------------------------------------------------------

@register_op("while", stop_gradient=True)
def _while(ctx, op):
    """JAX :187: run the block while Condition holds.  The carry is the
    condition and every name the block writes that has a value before
    the loop; only those reach the environment after it.  The condition
    is read on the host before each iteration and once after the last
    (the ``while`` host sync on the card)."""
    from ..lowering import run_block
    state = ctx.state
    sub = state.blocks[ctx.attr("sub_block")]
    env = ctx.env
    cond_name = op.input("Condition")[0]
    carried = []
    for n in [cond_name] + _block_writes(sub):
        if n in env and n not in carried:
            carried.append(n)
    missing = [n for n in op.output("Out") if n and n not in env]
    if missing:
        raise ValueError(
            "while-loop outputs %s have no value before the loop; "
            "initialize them (e.g. fill_constant) before the While block "
            "so the loop carry has an init" % missing)
    while _read_predicate(env[cond_name].reshape(()).to(torch.bool),
                          "while"):
        inner = dict(env)
        run_block(sub, inner, state)
        for n in carried:
            env[n] = inner[n]


@register_op("cond", nondiff_inputs=("Cond",))
def _cond(ctx, op):
    """JAX :233: run ``true_block`` or ``false_block`` as Cond says (read
    on the host, the ``cond`` host sync on the card); each Out takes the
    branch's value, or keeps its own where the branch did not write
    it."""
    from ..lowering import run_block
    state = ctx.state
    pred = _read_predicate(ctx.i("Cond").reshape(()).to(torch.bool), "cond")
    blk = state.blocks[ctx.attr("true_block" if pred else "false_block")]
    inner = dict(ctx.env)
    run_block(blk, inner, state)
    for n in op.output("Out"):
        if n:
            ctx.env[n] = inner[n]


@register_op("print", stop_gradient=True)
def _print(ctx, op):
    """JAX :342: print the message and the value on the host (a read-back,
    the ``print`` host sync on the card); Out is In."""
    x = ctx.i("In")
    if x.device.type != "cpu":
        profiler.record_host_sync("print")
    v = x.detach().cpu()
    if v.dtype == torch.bfloat16:       # numpy has no bfloat16
        v = v.float()
    print(ctx.attr("message", "") + str(v.numpy()), flush=True)
    ctx.set("Out", x)


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
