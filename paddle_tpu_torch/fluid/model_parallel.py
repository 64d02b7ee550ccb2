"""The model-parallel layer: how a rank executes a program transpiled
for tensor, sequence or expert parallelism.

The JAX package annotates the program (``_mp_shardings``, ``sp_axis`` on
attention ops, ``_sp_feed_dims``, ``ep_axis`` on MoE ops), compiles it
over a ``(dp, mp|sp|ep)`` mesh and lets GSPMD partition the rest.  The
port has no GSPMD: each rank is a process (``fluid/distributed.py``), so
the executor places the collectives itself, from the same annotations:

- :func:`context` — the rank's :class:`mesh_utils.Coords` for each axis
  above 1 of the program's layout: ``("dp", mp, sp, ep)`` row-major over
  the world with the model axes trailing, as the JAX package builds its
  mesh (compiler.py:148-160, executor.py:2065-2067), or, for a
  pipelined program, ``("dp", "pp", "mp"[, "sp"][, "ep"])``
  (``fluid/pipeline.py``).  Each axis has its own process groups.  A
  world the degrees do not divide is refused; a process with no world
  runs the program unsharded (the JAX package's ops run unsharded off
  the mesh too).  With more than one dp replica, the program's runs
  resolve ring 0 to the dp group (``lowering.ExecState.ring_group``),
  so a ``GradAllReduce`` transpile (fleet's, ``with_data_parallel``'s)
  averages gradients over the replicas only; every other program keeps
  the world as ring 0.
- :func:`plan` — per forward op of the main block, what it reads and
  writes: which variables are this rank's shard, and on which dim of
  which axis.  Sequence feeds are sliced on their sequence dim over sp;
  a weight of ``_mp_shardings`` is held as the rank's slice.  Then, op
  by op and axis by axis (mp, then sp, each rule seeing the op as the
  previous axis left it), over that axis's group:

  * an op that can run on the shard of its sharded input (see
    ``_RULES``: elementwise ops and activations, softmax and layer norm
    over other dims, ``mul``/``matmul`` contracting another dim, the
    embedding lookup, ``reshape2`` keeping the leading dims up to the
    sharded one (its global length in the shape attr becomes ``0``),
    ``transpose2``, ``fused_attention`` on sequence shards) runs there;
    each replicated float input it reads gets ``copy_to`` (its gradient
    summed over the group), and a replicated input that must line up
    with the shard is cut to it (``scatter_to``);
  * a Megatron pair runs as the pair: the column matmul's input
    ``copy_to``, the row matmul's output ``reduce_from``;
  * every other op (reductions, ``slice``, ``gather``, a ``reshape`` that
    merges the sharded dim, ``switch_moe``, ...) sees each sharded input
    all-gathered first (``gather_from``) and computes the unsharded
    result, the same on every rank of the group.

  So a variable can be sharded on two axes at once: the sequence dim
  over sp and the feature dim over mp, between a column and a row
  matmul of a sequence-parallel program.  Under these rules every rank
  holds the exact gradient of what it holds, so no parameter gradient
  needs a further collective, and the loss, which only a reduction can
  produce, is replicated.  A fetch of a sharded variable is
  all-gathered.  Ops that run on shards fold the rank's coordinates on
  dp and on those axes into their generator seed (a rank-local dropout
  mask); replicated ops fold only the dp rank, so every rank of a group
  draws the same mask.
- :func:`shard_state` — a value written to the scope with the global
  size of a sharded weight (the startup's initial value, or the same
  weight's optimizer state) keeps the rank's slice.  The parity tests
  load the JAX package's global parameters the same way
  (``convert.load_numpy_params(..., program=main)``).

Expert parallelism needs no plan: ``switch_moe`` (``ops/moe_ops.py``)
runs its dispatch over the ep group itself, and the rest of the program
is replicated over it.
"""

import torch

from . import distributed, mesh_utils
from .framework import OpRole, Operator
from ..parallel.tensor_parallel import (copy_to, gather_from, reduce_from,
                                        scatter_to, split)

_DEGREES = (("mp", "_mp_degree"), ("sp", "_sp_degree"),
            ("ep", "_ep_degree"))


def degrees(program):
    """{axis: degree} of the program's model-parallel degrees above 1."""
    return {axis: int(getattr(program, attr, 0) or 0)
            for axis, attr in _DEGREES
            if int(getattr(program, attr, 0) or 0) > 1}


def _pipeline_stages(program):
    if not getattr(program, "_pipeline_config", None):
        return 1
    from .pipeline import num_stages
    return num_stages(program)


def layout(program, world):
    """The program's rank layout over a world of ``world`` ranks:
    (name, size) pairs, ``dp`` first, then ``pp`` for a pipelined
    program, then its degrees above 1 in ``mesh_utils.AXES`` order (mp
    always with a pipeline).  Raises when the degrees do not divide the
    world, or when a pipeline's world is smaller than its stages times
    its degrees (the JAX package's RuntimeError)."""
    want = degrees(program)
    stages = _pipeline_stages(program)
    model = 1
    for d in want.values():
        model *= d
    if stages > 1:
        mp, sp, ep = (want.get(a, 1) for a in mesh_utils.AXES)
        total = stages * model
        if world < total:
            raise RuntimeError(
                "pipeline needs %d stages x mp=%d x sp=%d x ep=%d = %d "
                "devices, have %d" % (stages, mp, sp, ep, total, world))
        dp = world // total if world % total == 0 else 1
        return [("dp", dp), ("pp", stages), ("mp", mp)] + \
            [(a, want[a]) for a in ("sp", "ep") if a in want]
    if world % model:
        raise ValueError(
            "%s does not divide the world of %d rank(s)"
            % (" x ".join("%s_degree=%d" % (a, want[a])
                          for a in mesh_utils.AXES if a in want), world))
    return [("dp", world // model)] + \
        [(a, want[a]) for a in mesh_utils.AXES if a in want]


def context(program):
    """{axis: Coords} of the program's :func:`layout` in this process's
    world, for every axis above 1 ({} with neither a degree above 1 nor
    pipeline stages, or with degrees but no world)."""
    if _pipeline_stages(program) < 2 and (
            not degrees(program) or distributed._dist() is None):
        return {}
    return mesh_utils.layout_coords(layout(program,
                                           distributed.process_count()))


def local_shapes(program, par):
    """{weight: the shape this rank holds} for each weight of
    ``program._mp_shardings`` whose axis is in ``par``."""
    out = {}
    block = program.global_block()
    for name, (axis, dim) in (getattr(program, "_mp_shardings", None)
                              or {}).items():
        c = par.get(axis)
        var = block._find_var_recursive(name)
        if c is None or var is None or not var.shape:
            continue
        shape = list(var.shape)
        shape[dim] //= c.degree
        out[name] = tuple(shape)
    return out


def carry_degrees(src, dst):
    """Stamp ``src``'s model-parallel degrees on ``dst`` (a startup
    built beside it), so that ``dst``'s runs resolve ring 0 as ``src``'s
    do."""
    for _axis, attr in _DEGREES:
        setattr(dst, attr, getattr(src, attr, 0))


def dp_rank(par):
    """The rank the random ops of replicated computation fold in."""
    for c in par.values():
        return c.dp_rank
    return distributed.process_index()


# ---------------------------------------------------------------------------
# The state: a rank's slice of each sharded weight
# ---------------------------------------------------------------------------

def _annotation(program, name):
    ann = getattr(program, "_mp_shardings", None) or {}
    if name in ann:
        return name, ann[name]
    base = program._opt_state_of.get(name)
    if base is not None and base in ann:
        return base, ann[base]
    return None, None


def shard_state(program, name, value, par):
    """``value`` as this rank holds it: the rank's slice of a weight in
    ``program._mp_shardings`` (or of its same-shaped optimizer state)
    when ``value`` has the global size; anything else unchanged."""
    if not par or not isinstance(value, torch.Tensor):
        return value
    base, entry = _annotation(program, name)
    if entry is None:
        return value
    axis, dim = entry
    c = par.get(axis)
    if c is None or c.degree <= 1:
        return value
    var = program.global_block()._find_var_recursive(base)
    shape = tuple(var.shape or ()) if var is not None else ()
    if tuple(value.shape) != shape or value.dim() <= dim or \
            value.shape[dim] % c.degree:
        return value
    size = value.shape[dim] // c.degree
    return value.narrow(dim, c.rank * size, size).clone()


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

class OpPlan:
    """How one op runs: ``op`` (an attr-overridden copy where a shape
    attr was rewritten), ``xin``/``xout`` ({name: fn} applied to inputs
    before and outputs after the rule, inside the op's autograd graph)
    and ``rank`` (the number its random draws fold in when it runs on
    shards: the rank's row-major index over dp and the axes it runs on
    shards of; None for replicated computation)."""

    __slots__ = ("op", "xin", "xout", "rank")

    def __init__(self, op, xin, xout, rank):
        self.op, self.xin, self.xout, self.rank = op, xin, xout, rank


class ShardPlan:
    """The plan of one block: ``ops`` {op index: OpPlan}, ``feeds`` and
    ``fetch`` {name: [(axis, dim)]} to slice on feeding and gather on
    fetching, ``coords`` {axis: Coords} of the sharded axes."""

    def __init__(self, coords):
        self.coords = coords
        self.ops = {}
        self.feeds = {}
        self.fetch = {}

    def slice_feed(self, name, value):
        for axis, d in self.feeds.get(name, ()):
            value = split(value, self.coords[axis].group, d)
        return value

    def gather_fetch(self, name, value):
        dims = self.fetch.get(name)
        if not dims:
            return value
        with torch.no_grad():
            for axis, d in dims:
                value = gather_from(value, self.coords[axis].group, d, axis)
        return value


class _Ctx:
    """What a rule sees: the op, the static shapes, the sharded dims of
    its inputs, and the transforms it may apply."""

    def __init__(self, op, block, sh, program, coords):
        self.op, self.block, self.sh = op, block, sh
        self.program = program
        self.g, self.axis, self.P = coords.group, coords.axis, coords.degree

    def shape(self, name):
        v = self.block._find_var_recursive(name)
        return list(v.shape) if v is not None and v.shape is not None \
            else None

    def one(self, slot):
        names = self.op.input(slot)
        return names[0] if names else None

    def copy(self):
        g, axis = self.g, self.axis
        return lambda t: copy_to(t, g, axis) if t.is_floating_point() \
            else t

    def scatter(self, d):
        g, axis = self.g, self.axis
        return lambda t: scatter_to(t, g, d, axis)

    def gather(self, d):
        g, axis = self.g, self.axis
        return lambda t: gather_from(t, g, d, axis)

    def reduce(self):
        g, axis = self.g, self.axis
        return lambda t: reduce_from(t, g, axis)

    def weight_dim(self, name):
        """The sharded dim of ``name`` when it is a weight of
        ``_mp_shardings`` on this axis, else None."""
        ann = getattr(self.program, "_mp_shardings", None) or {}
        entry = ann.get(name)
        if entry is None or entry[0] != self.axis:
            return None
        return entry[1]


def _replicated_inputs(c, skip=()):
    """``copy_to`` on every input the op reads replicated."""
    xin = {}
    for slot, names in c.op.inputs.items():
        if slot in skip:
            continue
        for n in names:
            if n and n not in c.sh:
                xin[n] = c.copy()
    return xin


def _all_outputs(c, d):
    return {n: d for names in c.op.outputs.values() for n in names if n}


_UNARY = frozenset([
    "relu", "gelu", "tanh", "sigmoid", "leaky_relu", "elu", "swish", "silu",
    "dropout", "scale", "cast", "exp", "sqrt", "rsqrt", "square", "abs",
    "log", "softplus", "softsign", "relu6", "hard_swish", "hard_sigmoid",
    "assign", "sign", "floor", "ceil", "round", "reciprocal", "sin", "cos",
    "logsigmoid", "tanh_shrink", "brelu", "soft_relu", "thresholded_relu",
    "stanh", "pow", "clip",
])


def _unary(c):
    x = c.one("X")
    if x not in c.sh or set(c.sh).intersection(
            n for s, ns in c.op.inputs.items() if s != "X" for n in ns):
        return None
    return {}, {}, _all_outputs(c, c.sh[x])


def _softmax(c):
    x = c.one("X")
    shape = c.shape(x)
    axis = int(c.op.attr("axis", -1))
    if shape is None or axis % len(shape) == c.sh[x]:
        return None
    return {}, {}, {c.op.output("Out")[0]: c.sh[x]}


def _layer_norm(c):
    x = c.one("X")
    if x not in c.sh or c.sh[x] >= int(c.op.attr("begin_norm_axis", 1)):
        return None
    if any(c.one(s) in c.sh for s in ("Scale", "Bias")):
        return None
    # Mean and Variance are flattened over the leading dims: only the
    # grad op reads them
    return _replicated_inputs(c, ("X",)), {}, {c.op.output("Y")[0]:
                                               c.sh[x]}


def _elementwise(c):
    x, y = c.one("X"), c.one("Y")
    xs, ys = c.shape(x), c.shape(y)
    if xs is None or ys is None:
        return None
    axis = c.op.attr("axis", -1)
    if axis is None or axis == -1:
        axis = len(xs) - len(ys)
    dims = set()
    if x in c.sh:
        dims.add(c.sh[x])
    if y in c.sh:
        dims.add(axis + c.sh[y])
    if len(dims) != 1:
        return None
    D = dims.pop()
    xin = {}
    if x not in c.sh:
        xin[x] = c.copy() if xs[D] == 1 else c.scatter(D)
    if y not in c.sh and y != x:
        covers = axis <= D < axis + len(ys)
        xin[y] = c.scatter(D - axis) if covers and ys[D - axis] != 1 \
            else c.copy()
    return xin, {}, {c.op.output("Out")[0]: D}


def _mul(c):
    x, y = c.one("X"), c.one("Y")
    xs = c.shape(x)
    if xs is None:
        return None
    xnc = int(c.op.attr("x_num_col_dims", 1))
    out = c.op.output("Out")[0]
    wd = c.weight_dim(y)
    if wd is not None:
        if int(c.op.attr("y_num_col_dims", 1)) != 1 or \
                len(c.shape(y) or ()) != 2:
            return None
        return _megatron(c, x, xs, wd, out, xnc)
    if x in c.sh and y not in c.sh and c.sh[x] < xnc:
        return {y: c.copy()}, {}, {out: c.sh[x]}
    return None


def _matmul(c):
    x, y = c.one("X"), c.one("Y")
    xs, ys = c.shape(x), c.shape(y)
    if xs is None or ys is None or c.op.attr("transpose_X", False):
        return None
    out = c.op.output("Out")[0]
    wd = c.weight_dim(y)
    if wd is not None:
        if len(ys) != 2:
            return None
        if c.op.attr("transpose_Y", False):
            wd = 1 - wd
        return _megatron(c, x, xs, wd, out, len(xs) - 1)
    if x in c.sh and y not in c.sh and len(ys) == 2 and \
            c.sh[x] <= len(xs) - 2:
        return {y: c.copy()}, {}, {out: c.sh[x]}
    return None


def _megatron(c, x, xs, wd, out, xnc):
    """A matmul whose weight is mp-sharded: ``wd`` 1 (the output
    features) is the column half of a pair, ``wd`` 0 (the contracted
    features) the row half."""
    last = len(xs) - 1
    if wd == 1:
        if x in c.sh:
            return None
        return {x: c.copy()}, {}, {out: xnc}
    if xnc != last:
        return None
    if x in c.sh and c.sh[x] != last:
        return None
    xin = {} if x in c.sh else {x: c.scatter(last)}
    return xin, {out: c.reduce()}, {}


def _lookup(c):
    ids, w = c.one("Ids"), c.one("W")
    if ids not in c.sh or w in c.sh:
        return None
    ishape = c.shape(ids)
    d = c.sh[ids]
    if c.op.type == "lookup_table" and ishape and d >= len(ishape) - 1:
        return None
    return {w: c.copy()}, {}, {c.op.output("Out")[0]: d}


def _reshape(c):
    x = c.one("X")
    if c.op.input("Shape") or c.op.input("ShapeTensor"):
        return None
    d = c.sh[x]
    shape = list(c.op.attr("shape") or ())
    xs = c.shape(x)
    if xs is None or d >= len(shape):
        return None
    for i in range(d + 1):
        t = shape[i]
        same = xs[i] is not None and xs[i] > 0 and t == xs[i]
        if not (t == 0 or same or (t == -1 and i < d)):
            return None
    shape[d] = 0                  # the rank's length, copied from X
    outs = {c.op.output("Out")[0]: d}
    return {}, {}, outs, {"shape": shape}


def _transpose(c):
    x = c.one("X")
    perm = list(c.op.attr("axis"))
    return {}, {}, {c.op.output("Out")[0]: perm.index(c.sh[x])}


def _attention(c):
    if c.axis != "sp":
        return None
    q = c.one("Q")
    if c.sh.get(q) != 2:
        return None
    flags = {}
    for slot in ("Q", "K", "V", "BiasQK"):
        n = c.one(slot)
        if n is None:
            continue
        if n in c.sh and c.sh[n] != 2:
            return None
        flags[slot] = n in c.sh
    return {}, {}, {c.op.output("Out")[0]: 2}, {"__sp__": flags}


_RULES = {
    "softmax": _softmax,
    "layer_norm": _layer_norm,
    "mul": _mul,
    "matmul": _matmul,
    "lookup_table": _lookup,
    "lookup_table_v2": _lookup,
    "reshape2": _reshape,
    "reshape": _reshape,
    "transpose2": _transpose,
    "transpose": _transpose,
    "fused_attention": _attention,
}
for _t in _UNARY:
    _RULES[_t] = _unary
for _t in ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow"):
    _RULES[_t] = _elementwise


def _override(op, attrs):
    nop = Operator(op.block, op.type, attrs=dict(op.attrs, **attrs))
    nop.inputs = op.inputs
    nop.outputs = op.outputs
    return nop


def _compose(maps):
    """{name: fn} of several axes' transforms, each name's applied in the
    axes' order."""
    out = {}
    for m in maps:
        for n, fn in m.items():
            prev = out.get(n)
            out[n] = fn if prev is None else \
                (lambda t, f=prev, g=fn: g(f(t)))
    return out


def plan(program, block, feed_names, fetch_names, par):
    """The :class:`ShardPlan` of ``block`` for the world's ``par``
    ({axis: Coords}), or None when no tensor or sequence degree is
    active (expert parallelism needs none)."""
    axes = [a for a in ("mp", "sp") if a in par]
    if not axes:
        return None
    out = ShardPlan({a: par[a] for a in axes})
    sh = {a: {} for a in axes}
    if "sp" in sh:
        P = par["sp"].degree
        dims = getattr(program, "_sp_feed_dims", None) or {}
        for n in feed_names:
            d = dims.get(n)
            v = block._find_var_recursive(n)
            shape = list(v.shape or ()) if v is not None else []
            if d is not None and len(shape) > d and shape[d] and \
                    shape[d] > 0 and shape[d] % P == 0:
                sh["sp"][n] = d
                out.feeds[n] = [("sp", d)]
    if "mp" in sh:
        for n, (ax, d) in (getattr(program, "_mp_shardings", None)
                           or {}).items():
            if ax == "mp":
                sh["mp"][n] = d
    for i, op in enumerate(block.ops):
        if int(op.attr("op_role", 0) or 0) & (OpRole.Backward |
                                              OpRole.Optimize):
            continue
        cur, xins, xouts, on_shards, touched = op, [], [], [], False
        for a in axes:
            s = sh[a]
            if not any(n in s for n in cur.input_arg_names()):
                for n in cur.output_arg_names():
                    s.pop(n, None)
                continue
            touched = True
            c = _Ctx(cur, block, s, program, par[a])
            rule = _RULES.get(cur.type)
            got = rule(c) if rule is not None else None
            if got is None:
                # every other op: the unsharded result on this axis, the
                # same on every rank of its group
                xins.append({n: c.gather(s[n])
                             for n in cur.input_arg_names() if n in s})
                for n in cur.output_arg_names():
                    s.pop(n, None)
                continue
            xin, xout, outs = got[:3]
            attrs = got[3] if len(got) > 3 else None
            for n in cur.output_arg_names():
                s.pop(n, None)
            s.update(outs)
            xins.append(xin)
            xouts.append(xout)
            on_shards.append(a)
            if attrs:
                cur = _override(cur, attrs)
        if touched:
            fold = par[axes[0]].fold(on_shards) if on_shards else None
            out.ops[i] = OpPlan(cur, _compose(xins), _compose(xouts), fold)
    for n in fetch_names:
        dims = [(a, sh[a][n]) for a in axes if n in sh[a]]
        if dims:
            out.fetch[n] = dims
    return out
