"""Control-flow layers (counterpart paddle_tpu/fluid/layers/control_flow.py;
reference ``python/paddle/fluid/layers/control_flow.py``): ``increment``,
the comparisons, the tensor arrays (``create_array``, ``array_write``,
``array_read``, ``array_length``), ``Print``, ``BlockGuard``, ``While``,
``cond``, ``ConditionalBlock``, ``Switch``, ``IfElse``, ``StaticRNN``,
``DynamicRNN``, ``reorder_lod_tensor_by_rank`` and ``is_empty``; each
emits the JAX layer's ops.

The builders open a sub-block of the main program, let user code append
ops into it, and on exit emit one control-flow op whose block attr names
it (``while``, ``cond``, ``conditional_block``, ``recurrent``).  The
sub-block's outer reads become the op's inputs, so the executor's read
analysis, the tape and ``append_backward`` see them; the names it writes
that an enclosing block declares become its outputs.

The reference's LoD DynamicRNN (lod_rank_table, reorder by length) is
replaced, as in the JAX package, by padded ``[batch, time, ...]`` inputs
and a lengths mask: a step past a row's length leaves its memory
unchanged and emits zeros.  ``IfElse`` merges its branches' outputs
with a ``where`` over the whole batch, as the JAX layer does.
"""

import contextlib

from ..data_types import canonical_dtype
from ..framework import default_main_program
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = ["While", "Switch", "IfElse", "cond", "StaticRNN", "DynamicRNN",
           "increment", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "array_write",
           "array_read", "array_length", "create_array", "Print",
           "BlockGuard", "ConditionalBlock", "reorder_lod_tensor_by_rank",
           "is_empty"]


def increment(x, value=1.0, in_place=True):
    """``x + value`` (JAX control_flow.py:36), into ``x`` itself unless
    ``in_place`` is false."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out


def _compare(op_type, x, y, cond=None):
    """``x <op> y`` elementwise, a bool Variable (JAX control_flow.py:44)."""
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def create_array(dtype, max_len=None):
    """A fixed-capacity tensor array (JAX control_flow.py:78)."""
    from ..ops.control_flow_ops import DEFAULT_ARRAY_CAPACITY
    helper = LayerHelper("array")
    arr = helper.create_variable(
        name=helper.name, dtype=canonical_dtype(dtype), type="tensor_array")
    helper.append_op("create_array", outputs={"Out": [arr]},
                     attrs={"max_len": int(max_len or DEFAULT_ARRAY_CAPACITY)})
    return arr


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array", inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    out.stop_gradient = True
    helper.append_op("lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def Print(input, first_n=-1, message=None, summarize=-1, **kwargs):
    """Print ``message`` and the value when the op runs; returns a copy
    of ``input`` (JAX control_flow.py:115)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", inputs={"In": [input]}, outputs={"Out": [out]},
                     attrs={"message": message or ""})
    return out


def _external_reads(sub_block, blocks):
    """Names the sub-block reads from enclosing blocks (declared as op
    inputs so autodiff and the op's rule see them)."""
    from ..ops.control_flow_ops import block_reads
    local = set(sub_block.vars)
    reads = []
    for n in block_reads(sub_block, blocks):
        if n not in local and n not in reads:
            reads.append(n)
    return reads


class BlockGuard:
    """Enter a new sub-block of the main program (reference BlockGuard)."""

    def __init__(self, main_program=None):
        self.main_program = main_program or default_main_program()

    def __enter__(self):
        self.block = self.main_program._create_block()
        return self.block

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program._rollback()
        return False


class ConditionalBlock:
    """Builder of one ``conditional_block`` op (reference
    ConditionalBlock; JAX control_flow.py:257): ``with cb.block():``
    fills a sub-block, whose external reads become the op's ``Input``
    and whose writes of names an enclosing block declares its ``Out``
    (block-local temporaries stay inside)."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        self.inputs = inputs
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        from ..ops.control_flow_ops import _block_writes
        prog = self.helper.main_program
        parent = prog.current_block()
        with BlockGuard(prog) as sub:
            yield
        cond_names = {v.name for v in self.inputs}
        reads = [n for n in _external_reads(sub, prog.blocks)
                 if n not in cond_names]
        writes = [n for n in _block_writes(sub)
                  if n not in sub.vars
                  and parent._find_var_recursive(n) is not None]
        parent.append_op(
            "conditional_block",
            inputs={"Cond": [v.name for v in self.inputs], "Input": reads},
            outputs={"Out": writes, "Scope": []},
            attrs={"sub_block": sub.idx, "is_scalar_condition": True})


def _block_writes(sub_block):
    from ..ops.control_flow_ops import _block_writes as bw
    return bw(sub_block)


class While:
    """``while cond:`` over a sub-block (reference control_flow.py While;
    JAX :163).  ``cond`` is a ``[1]`` bool Variable that the body must
    update (e.g. ``less_than(..., cond=cond)``)."""

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        parent = prog.current_block()
        with BlockGuard(prog) as sub:
            yield
        reads = _external_reads(sub, prog.blocks)
        writes = [n for n in _block_writes(sub)
                  if parent._find_var_recursive(n) is not None]
        parent.append_op(
            "while",
            inputs={"X": reads, "Condition": [self.cond_var]},
            outputs={"Out": writes, "StepScopes": []},
            attrs={"sub_block": sub.idx, "is_test": self.is_test})


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional (JAX :197): both branches return matching
    Variables (or None); each branch's return values are assigned to the
    shared outputs, and writes of outer variables inside a branch leave
    the op as outputs too (the other branch passes the old value on)."""
    helper = LayerHelper("cond", name=name)
    prog = helper.main_program

    def build(fn):
        with BlockGuard(prog) as blk:
            ret = fn() if fn is not None else None
        if ret is None:
            rets = []
        elif isinstance(ret, (list, tuple)):
            rets = list(ret)
        else:
            rets = [ret]
        return blk, rets

    true_blk, true_rets = build(true_fn)
    false_blk, false_rets = build(false_fn)
    if len(true_rets) != len(false_rets):
        raise ValueError("cond branches must return the same arity: %d vs %d"
                         % (len(true_rets), len(false_rets)))

    outs = [helper.create_variable_for_type_inference(v.dtype)
            for v in true_rets]
    for blk, rets in ((true_blk, true_rets), (false_blk, false_rets)):
        for out, ret in zip(outs, rets):
            blk.append_op("assign", inputs={"X": [ret]},
                          outputs={"Out": [out]})

    reads = []
    for blk in (true_blk, false_blk):
        for n in _external_reads(blk, prog.blocks):
            if n not in reads and n != pred.name:
                reads.append(n)

    parent = prog.current_block()
    out_names = [o.name for o in outs]
    for blk in (true_blk, false_blk):
        for n in _block_writes(blk):
            if n not in out_names and n not in blk.vars \
                    and parent._find_var_recursive(n) is not None:
                out_names.append(n)

    parent.append_op(
        "cond",
        inputs={"Cond": [pred], "Input": reads},
        outputs={"Out": out_names},
        attrs={"true_block": true_blk.idx, "false_block": false_blk.idx})
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """First-match-wins case chain (reference Switch; JAX :284), the
    learning-rate warmup's builder::

        with Switch() as switch:
            with switch.case(cond): ...
            with switch.default(): ...
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._pre_not_conds = []

    @contextlib.contextmanager
    def case(self, condition):
        helper = self.helper
        cb = ConditionalBlock(list(self._pre_not_conds) + [condition])
        not_cond = helper.create_variable_for_type_inference("bool")
        not_cond.stop_gradient = True
        helper.append_op("logical_not", inputs={"X": [condition]},
                         outputs={"Out": [not_cond]})
        self._pre_not_conds.append(not_cond)
        with cb.block():
            yield

    @contextlib.contextmanager
    def default(self):
        cb = ConditionalBlock(list(self._pre_not_conds))
        with cb.block():
            yield

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


class IfElse:
    """Reference IfElse (JAX :324): ``true_block``/``false_block`` each
    give outputs, and ``ie()`` merges them row by row with a ``where``
    on the condition (the reference splits and merges the rows with
    split_lod_tensor/merge_lod_tensor: the same result)."""

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_outs = []
        self._false_outs = []
        self._in_true = False

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        yield
        self._in_true = False

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        yield

    def input(self, x):
        return x

    def output(self, *outs):
        target = self._true_outs if self._in_true else self._false_outs
        target.extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("IfElse branches produced different arity")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            helper = LayerHelper("ifelse_merge")
            out = helper.create_variable_for_type_inference(t.dtype)
            helper.append_op("where", inputs={"Condition": [self.cond],
                                              "X": [t], "Y": [f]},
                             outputs={"Out": [out]})
            merged.append(out)
        return merged if len(merged) > 1 else merged[0]


class StaticRNNMemoryLink:
    def __init__(self, pre_mem, mem=None):
        self.pre_mem = pre_mem
        self.mem = mem


class StaticRNN:
    """Step-program RNN over a fixed number of time steps
    (reference control_flow.py StaticRNN over recurrent_op.cc).

    Inputs are time-major ``[T, batch, ...]``; the step sub-block sees one
    time slice; memories carry state across steps; outputs are re-stacked
    time-major.  One ``recurrent`` op runs the step block once per time
    step (ops/control_flow_ops.py); fully differentiable.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._sub = None
        self._parent = None
        self._step_inputs = []   # (outer Variable, inner Variable)
        self._memories = []      # StaticRNNMemoryLink (+ init outer var)
        self._mem_inits = []     # outer init Variables, parallel to _memories
        self._outputs = []       # inner Variables
        self._out_vars = []      # outer stacked output Variables
        self._status = "init"

    @contextlib.contextmanager
    def step(self):
        prog = self.helper.main_program
        self._parent = prog.current_block()
        guard = BlockGuard(prog)
        self._sub = guard.__enter__()
        self._status = "in_step"
        try:
            yield
        finally:
            guard.__exit__(None, None, None)
            self._status = "done"
            self._complete()

    def step_input(self, x):
        assert self._status == "in_step"
        inner = self._sub.create_var(
            name=self.helper.name + ".step_in.%d" % len(self._step_inputs),
            dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None)
        self._step_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               init_value=0.0, dtype="float32"):
        assert self._status == "in_step"
        if init is None:
            if shape is None:
                raise ValueError("StaticRNN.memory needs init or shape")
            # build init in the PARENT block (constant start state)
            prog = self.helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = self._parent.idx
            try:
                if batch_ref is not None:
                    # an inner step-input var maps back to its outer
                    # time-major array, whose batch axis is dim 1
                    dim_idx = 0
                    for outer, inner in self._step_inputs:
                        if inner.name == batch_ref.name:
                            batch_ref, dim_idx = outer, 1
                            break
                    init = tensor_layers.fill_constant_batch_size_like(
                        input=batch_ref, shape=[-1] + list(shape),
                        dtype=dtype, value=float(init_value or value),
                        input_dim_idx=dim_idx)
                else:
                    init = tensor_layers.fill_constant(
                        shape=list(shape), dtype=dtype,
                        value=float(init_value or value))
            finally:
                prog.current_block_idx = cur
        pre = self._sub.create_var(
            name=self.helper.name + ".mem.%d" % len(self._memories),
            dtype=init.dtype,
            shape=tuple(init.shape) if init.shape else None)
        self._memories.append(StaticRNNMemoryLink(pre_mem=pre))
        self._mem_inits.append(init)
        return pre

    def update_memory(self, mem, var):
        for link in self._memories:
            if link.pre_mem.name == mem.name:
                link.mem = var
                return
        raise ValueError("update_memory: unknown memory %r" % mem.name)

    def step_output(self, o):
        assert self._status == "in_step"
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        prog = self.helper.main_program
        for link in self._memories:
            if link.mem is None:
                raise ValueError("memory %r never updated" % link.pre_mem.name)
        # closure reads: everything the sub-block reads that is not a step
        # input/memory inner var — typically the weights
        inner_names = ({iv.name for _, iv in self._step_inputs}
                       | {l.pre_mem.name for l in self._memories})
        params = [n for n in _external_reads(self._sub, prog.blocks)
                  if n not in inner_names]

        n_steps = None
        if self._step_inputs and self._step_inputs[0][0].shape:
            n_steps = self._step_inputs[0][0].shape[0]
        outs = []
        for o in self._outputs:
            ov = self._parent.create_var(
                name=self.helper.name + ".out." + o.name, dtype=o.dtype,
                shape=((n_steps,) + tuple(o.shape)
                       if o.shape is not None and n_steps is not None
                       else None))
            outs.append(ov)
        finals = []
        for link in self._memories:
            fv = self._parent.create_var(
                name=self.helper.name + ".final." + link.mem.name,
                dtype=link.mem.dtype,
                shape=tuple(link.mem.shape) if link.mem.shape else None)
            finals.append(fv)

        self._parent.append_op(
            "recurrent",
            inputs={"Inputs": [x.name for x, _ in self._step_inputs],
                    "Initials": [v.name for v in self._mem_inits],
                    "Params": params},
            outputs={"Outputs": [v.name for v in outs],
                     "FinalStates": [v.name for v in finals]},
            attrs={"sub_block": self._sub.idx,
                   "step_input_vars": [iv.name for _, iv in self._step_inputs],
                   "pre_state_vars": [l.pre_mem.name for l in self._memories],
                   "state_vars": [l.mem.name for l in self._memories],
                   "step_output_vars": [o.name for o in self._outputs]})
        self._out_vars = outs
        self._final_vars = finals

    def __call__(self, *args, **kwargs):
        if not self._out_vars:
            raise ValueError("StaticRNN produced no outputs")
        return (self._out_vars[0] if len(self._out_vars) == 1
                else self._out_vars)


# ---------------------------------------------------------------------------
# DynamicRNN — padded batch + lengths mask (the LoD replacement)
# ---------------------------------------------------------------------------

class DynamicRNN:
    """Variable-length RNN over padded ``[batch, time, ...]`` inputs.

    The reference DynamicRNN reorders examples by length via LoDRankTable and
    shrinks the batch as sequences end; static shapes replace that with a
    mask: state updates freeze once ``t >= length``.  API mirrors the
    reference (step_input / memory / update_memory / output); ``step_input``
    takes the padded tensor plus a ``lengths`` int Variable of shape
    ``[batch]`` on first call.
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._rnn = StaticRNN(name=(name or "dyn") + "_inner")
        self._lengths = None
        self._t = None          # inner step-counter var
        self._guard_active = False
        self._mask = None

    @contextlib.contextmanager
    def block(self):
        with self._rnn.step():
            self._guard_active = True
            try:
                yield
            finally:
                self._guard_active = False

    def step_input(self, x, lengths=None):
        """x: [batch, time, ...] padded.  Returns the [batch, ...] slice."""
        # transpose to time-major for the recurrent op
        prog = self.helper.main_program
        cur = prog.current_block_idx
        prog.current_block_idx = self._rnn._parent.idx
        try:
            from . import nn as nn_layers
            perm = list(range(len(x.shape)))
            perm[0], perm[1] = 1, 0
            x_tm = nn_layers.transpose(x, perm)
            if self._t is None:
                # a [T] arange carried as a step input = the step counter
                t_vec = tensor_layers.range(
                    0, x.shape[1] if x.shape[1] != -1 else 0, 1, "int64") \
                    if x.shape[1] and x.shape[1] > 0 else None
                if t_vec is None:
                    raise ValueError(
                        "DynamicRNN needs a static time dimension")
                if lengths is None:
                    raise ValueError(
                        "DynamicRNN.step_input needs lengths on first call")
                self._lengths = lengths
                self._t_outer = t_vec
        finally:
            prog.current_block_idx = cur
        inner = self._rnn.step_input(x_tm)
        if self._t is None:
            self._t = self._rnn.step_input(self._t_outer)
        return inner

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               batch_ref=None):
        return self._rnn.memory(init=init, shape=shape, value=value,
                                dtype=dtype, batch_ref=batch_ref)

    def update_memory(self, mem, var):
        """Masked update: state advances only while t < length."""
        helper = LayerHelper("dynrnn_mask")
        mask = self._step_mask(len(var.shape) if var.shape else 2)
        sel = helper.create_variable_for_type_inference(var.dtype)
        helper.append_op("where",
                         inputs={"Condition": [mask], "X": [var],
                                 "Y": [mem]},
                         outputs={"Out": [sel]})
        self._rnn.update_memory(mem, sel)

    def _step_mask(self, ndim):
        from . import nn as nn_layers
        helper = LayerHelper("dynrnn_mask")
        mask = helper.create_variable_for_type_inference("bool")
        mask.stop_gradient = True
        helper.append_op("less_than",
                         inputs={"X": [self._t], "Y": [self._lengths]},
                         outputs={"Out": [mask]})
        for _ in range(ndim - 1):
            mask = nn_layers.unsqueeze(mask, [-1])
        return mask

    def output(self, *outputs):
        """Step outputs are zero-masked past each sequence's length — the
        static-shape image of LoD 'absent' positions."""
        masked = []
        for o in outputs:
            helper = LayerHelper("dynrnn_out")
            mask = self._step_mask(len(o.shape) if o.shape else 2)
            zeros = tensor_layers.zeros_like(o)
            sel = helper.create_variable_for_type_inference(o.dtype)
            helper.append_op("where",
                             inputs={"Condition": [mask], "X": [o],
                                     "Y": [zeros]},
                             outputs={"Out": [sel]})
            masked.append(sel)
        self._rnn.output(*masked)

    def __call__(self):
        out = self._rnn()
        # back to batch-major
        from . import nn as nn_layers
        prog = self.helper.main_program

        def to_bm(o):
            nd = len(o.shape) if o.shape else 3
            perm = [1, 0] + list(range(2, nd))
            return nn_layers.transpose(o, perm)
        if isinstance(out, (list, tuple)):
            return [to_bm(o) for o in out]
        return to_bm(out)


def reorder_lod_tensor_by_rank(x, rank_table):
    """Reorder x's rows by the LoD rank table (JAX :652)."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def is_empty(x, cond=None):
    """``[1]`` bool, whether x has no element (JAX :663)."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op("is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond
