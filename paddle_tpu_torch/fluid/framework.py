"""Program IR: Program / Block / Operator / Variable / Parameter.

The same user-facing contract as ``paddle_tpu/fluid/framework.py`` (and the
reference ``python/paddle/fluid/framework.py``): Python appends OpDescs
into nested blocks and an executor consumes the finished program.  The
in-memory IR is plain Python; the port's executor runs each op's lowering
rule on torch tensors (``lowering.py``).

Static shapes are the rule: the batch dimension may be -1 at build time
and is bound at first run; there is no LoD.
"""

import collections
import contextlib
import hashlib

import numpy as np

from . import unique_name
from .data_types import canonical_dtype


class OpRole:
    """Mirror of the reference op-role attribute (framework.py OpRole)."""

    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 0x100
    Collective = 0x200


OP_ROLE_KEY = "op_role"
OP_ROLE_VAR_KEY = "op_role_var"


class VariableType:
    LOD_TENSOR = "tensor"


class Variable:
    """A named tensor slot in a block (reference framework.py:376).

    ``shape`` is build-time metadata (may contain -1 for the batch dim);
    the executor binds concrete shapes at run time.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 type=VariableType.LOD_TENSOR, persistable=False,
                 stop_gradient=False, is_data=False, initializer=None,
                 lod_level=0):
        self.block = block
        self.name = name if name is not None else unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        self.lod_level = lod_level

    @property
    def is_parameter(self):
        # settable: startup programs mirror parameters as plain Variables
        # (layer_helper.create_parameter marks them)
        return getattr(self, "_param_backed", False) \
            or isinstance(self, Parameter)

    @is_parameter.setter
    def is_parameter(self, val):
        if not val and isinstance(self, Parameter):
            raise ValueError(
                "cannot clear is_parameter on Parameter %r: Parameter "
                "instances are inherently parameters" % self.name)
        self._param_backed = bool(val)

    def _sig(self):
        return (self.name, self.shape, self.dtype, self.type, self.persistable)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    # operator sugar (reference layers/math_op_patch.py; JAX
    # framework.py:116-146): `+`, `-`, `*`, `/` and unary `-`.  A float
    # scalar on a float Variable's right is a `scale` op; a scalar on the
    # left (or beside an integer Variable) is filled into a tensor first
    # (`fill_constant_batch_size_like`), as in the JAX package
    def _binary(self, other, op_type):
        from .layers import math_op_patch
        return math_op_patch.binary(self, other, op_type)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        from .layers import math_op_patch
        return math_op_patch.binary(other, self, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        from .layers import math_op_patch
        return math_op_patch.binary(other, self, "elementwise_div")

    def __neg__(self):
        from .layers import math_op_patch
        return math_op_patch.scale(self, -1.0)


class Parameter(Variable):
    """Trainable persistable variable (reference framework.py:3588)."""

    def __init__(self, block, shape, dtype, trainable=True, regularizer=None,
                 gradient_clip_attr=None, do_model_average=False, **kwargs):
        if shape is None or any(s is None or s < 0 for s in shape):
            raise ValueError("Parameter shape must be fully static, got %s" % (shape,))
        super().__init__(block, shape=shape, dtype=dtype, persistable=True,
                         **kwargs)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip_attr = gradient_clip_attr
        self.do_model_average = do_model_average
        self.optimize_attr = {"learning_rate": 1.0}


class Operator:
    """One op invocation: type + named input/output slots + attrs
    (OpDesc, framework.proto:43).  Slot values are lists of var names."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}   # slot -> [var name]
        self.outputs = {}
        self.attrs = dict(attrs) if attrs else {}

        def _names(value):
            if value is None:
                return []
            if isinstance(value, (list, tuple)):
                return [v.name if isinstance(v, Variable) else v for v in value]
            return [value.name if isinstance(value, Variable) else value]

        for slot, value in (inputs or {}).items():
            self.inputs[slot] = _names(value)
        for slot, value in (outputs or {}).items():
            self.outputs[slot] = _names(value)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def _sig(self):
        def _attr_sig(v):
            if isinstance(v, np.ndarray):
                return (v.dtype.str, v.shape, hashlib.md5(v.tobytes()).hexdigest())
            if isinstance(v, (list, tuple)):
                return tuple(_attr_sig(x) for x in v)
            return v
        return (self.type,
                tuple(sorted((k, tuple(v)) for k, v in self.inputs.items())),
                tuple(sorted((k, tuple(v)) for k, v in self.outputs.items())),
                tuple(sorted((k, _attr_sig(v)) for k, v in self.attrs.items())))

    def __repr__(self):
        ins = ", ".join("%s=%s" % (k, v) for k, v in self.inputs.items())
        outs = ", ".join("%s=%s" % (k, v) for k, v in self.outputs.items())
        return "{%s} = %s(%s)" % (outs, self.type, ins)


class Block:
    """An ordered op list plus a var scope (reference framework.py:1436)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx == -1:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        if var.name in self.vars:
            return self.vars[var.name]
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, shape, dtype, name=None, **kwargs):
        param = Parameter(self, shape, dtype, name=name, **kwargs)
        # Parameters live in the outermost (global) block, as in the reference.
        gb = self.program.global_block()
        gb.vars[param.name] = param
        param.block = gb
        self.program._bump_version()
        return param

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = block.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs)

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        attrs = dict(attrs) if attrs else {}
        if OP_ROLE_KEY not in attrs:
            attrs[OP_ROLE_KEY] = self.program._current_role
        stage = getattr(self.program, "_current_pipeline_stage", None)
        if stage is not None and "pipeline_stage" not in attrs:
            attrs["pipeline_stage"] = stage   # set by fluid.device_guard
        scope_path = current_name_scope()
        if scope_path and "op_namescope" not in attrs:
            attrs["op_namescope"] = scope_path
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _sig(self):
        return (self.idx, self.parent_idx,
                tuple(v._sig() for v in self.vars.values()),
                tuple(op._sig() for op in self.ops))


# Program-level model-parallel annotations the transpilers set
# (tensor_parallel / sequence_parallel / expert_parallel; JAX
# framework.py:339): what clone() carries over and what the fingerprint
# folds in, so a plan built before a transpile is never reused after it.
PROGRAM_ANNOTATIONS = (
    ("_mp_degree", 0), ("_mp_shardings", {}),
    ("_sp_degree", 0), ("_sp_mode", None), ("_sp_feed_dims", {}),
    ("_ep_degree", 0),
)


def annotation_key(program):
    """The program's model-parallel annotations as a hashable tuple."""
    out = []
    for name, default in PROGRAM_ANNOTATIONS:
        val = getattr(program, name, default)
        if isinstance(val, dict):
            val = tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple))
                                else v) for k, v in val.items()))
        out.append(val)
    return tuple(out)


class Program:
    """A whole program: list of nested blocks (framework.py:2775).
    ``_version``/``fingerprint`` key the executor's dispatch-plan cache."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._fingerprint_cache = (None, None)
        self._current_role = OpRole.Forward
        self._is_test = False
        self._seed_counter = 0
        # AMP tags set by contrib.mixed_precision.decorate: the compute
        # dtype of conv/matmul, and whether their outputs stay in it
        self._amp_dtype = None
        self._amp_keep = False
        # optimizer state -> its parameter (optimizer._add_accumulator)
        self._opt_state_of = {}
        # weight-update sharding (transpiler/collective.py): state vars
        # each rank holds 1/N of, N, and {padded flat buffer: logical
        # bucket numel} (the elastic restore's layout identity)
        self._dp_sharded_state = set()
        self._wus_degree = None
        self._wus_padded_numel = {}

    # -- structure ---------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    def _create_block(self, parent_idx=None):
        """Open a sub-block under ``parent_idx`` (default: the current
        block) and make it current (JAX framework.py:406): the step block
        of a ``recurrent`` op, which control-flow layers fill and then
        close with :meth:`_rollback`."""
        parent_idx = self.current_block_idx if parent_idx is None \
            else parent_idx
        block = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(block)
        self.current_block_idx = block.idx
        self._bump_version()
        return block

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @property
    def fingerprint(self):
        ver, fp = self._fingerprint_cache
        if ver == self._version:
            return fp
        h = hashlib.sha1()
        h.update(repr(tuple(b._sig() for b in self.blocks)).encode())
        h.update(repr((self.random_seed, self._is_test, self._amp_dtype,
                       self._amp_keep)).encode())
        h.update(repr(annotation_key(self)).encode())
        fp = h.hexdigest()
        self._fingerprint_cache = (self._version, fp)
        return fp

    def next_op_seed(self):
        """Deterministic per-op seed for random ops with seed attr 0."""
        self._seed_counter += 1
        return self._seed_counter

    # -- roles (used by backward and the optimizer) ------------------------
    @contextlib.contextmanager
    def _role_guard(self, role):
        """Ops appended inside get ``role`` (OpRole.Backward for grad ops,
        OpRole.Optimize for optimizer ops) as their ``op_role`` attr."""
        prev_role, self._current_role = self._current_role, role
        try:
            yield
        finally:
            self._current_role = prev_role

    def _lr_schedule_guard(self):
        """Ops appended inside carry ``OpRole.LRSched`` (reference
        framework.py:463): the learning-rate schedule's ops."""
        return self._role_guard(OpRole.LRSched)

    # -- cloning -----------------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy the program (reference Program.clone).

        ``for_test=True`` marks the clone as inference: ops with an
        ``is_test`` attr get it set, and the dropout / fused_attention
        lowerings read it."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, shape=v.shape, dtype=v.dtype,
                                   name=v.name, trainable=v.trainable,
                                   regularizer=v.regularizer,
                                   stop_gradient=v.stop_gradient,
                                   initializer=v.initializer)
                    nv.optimize_attr = dict(v.optimize_attr)
                else:
                    nv = Variable(nb, name=v.name, shape=v.shape,
                                  dtype=v.dtype, type=v.type,
                                  persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  is_data=v.is_data,
                                  initializer=v.initializer)
                    if getattr(v, "_param_backed", False):
                        nv.is_parameter = True
                nb.vars[name] = nv
            for op in b.ops:
                attrs = dict(op.attrs)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, attrs=attrs)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nb.ops.append(nop)
        p._is_test = for_test
        p._amp_dtype = self._amp_dtype
        p._amp_keep = self._amp_keep
        p._opt_state_of = dict(self._opt_state_of)
        p._dp_sharded_state = set(self._dp_sharded_state)
        p._wus_degree = self._wus_degree
        p._wus_padded_numel = dict(self._wus_padded_numel)
        for name, default in PROGRAM_ANNOTATIONS:
            if hasattr(self, name):
                val = getattr(self, name)
                setattr(p, name, dict(val) if isinstance(val, dict)
                        else val)
        p.current_block_idx = 0
        p._bump_version()
        return p

    def list_vars(self):
        for block in self.blocks:
            yield from block.vars.values()

    @staticmethod
    def parse_from_string(binary_str):
        """Deserialize a reference ``ProgramDesc`` protobuf string
        (reference framework.py:3323 contract; wire codec in
        proto_compat.py)."""
        from . import proto_compat
        return proto_compat.parse_program(binary_str)

    def serialize_to_string(self):
        """Serialize to reference ``ProgramDesc`` wire bytes (the
        ``program.desc.serialize_to_string()`` idiom)."""
        from . import proto_compat
        return proto_compat.serialize_program(self)

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append("-- block %d (parent %d) --" % (b.idx, b.parent_idx))
            for v in b.vars.values():
                lines.append("  " + repr(v))
            for op in b.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = to_string


# ---------------------------------------------------------------------------
# Default program registry + guards (reference framework.py bottom section).
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


# Attrs by which a control-flow op names its sub-block, and attrs naming
# the inner variables the op binds itself each step (a recurrent op's
# step inputs and carried state): the block traversals (the executor's
# read analysis, ``ops/control_flow_ops.block_reads``) share them (JAX
# framework.py:607-623).
SUB_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")
BOUND_VAR_ATTRS = ("step_input_vars", "pre_state_vars")


def op_sub_block_indices(op):
    return [op.attr(a) for a in SUB_BLOCK_ATTRS if op.attr(a) is not None]


def op_bound_var_names(op):
    bound = set()
    for a in BOUND_VAR_ATTRS:
        bound |= set(op.attr(a, []) or [])
    return bound


def grad_var_name(name):
    return name + "@GRAD"


# ---------------------------------------------------------------------------
# name_scope / place helpers (reference framework.py name_scope:62,
# cpu_places/cuda_places/cuda_pinned_places, is_compiled_with_cuda)
# ---------------------------------------------------------------------------

_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Debug op-name prefix context (reference framework.py:62): while
    active, Block.append_op stamps ops with the `op_namescope` attr."""
    _name_scope_stack.append(prefix or "")
    try:
        yield
    finally:
        _name_scope_stack.pop()


def current_name_scope():
    return "/".join(p for p in _name_scope_stack if p)


def is_compiled_with_cuda():
    """True when PyTorch sees a CUDA device, so the reference idiom
    ``CUDAPlace(0) if is_compiled_with_cuda() else CPUPlace()`` picks
    the card whenever there is one."""
    import torch
    return torch.cuda.is_available()


def cpu_places(device_count=None):
    from .executor import CPUPlace
    import os as _os
    if device_count is None:
        device_count = int(_os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(device_count)]


def cuda_places(device_ids=None):
    """One CUDAPlace per visible CUDA device (or per given id)."""
    import torch
    from .executor import CUDAPlace
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in device_ids]


def cuda_pinned_places(device_count=None):
    """Host places for pinned staging buffers: CPU places, as in the JAX
    package (framework.py:690)."""
    return cpu_places(device_count)
