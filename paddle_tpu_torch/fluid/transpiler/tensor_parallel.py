"""Tensor (model) parallel transpiler: Megatron weight sharding as a
program annotation pass (counterpart
``paddle_tpu/fluid/transpiler/tensor_parallel.py``, the same pass op for
op).

The pass records on the program which weights are sharded over the
``mp`` axis and on which dim (``program._mp_shardings``): the first
matmul of a Megatron pair column-sharded ``[K, N/mp]`` with its bias,
the second row-sharded ``[K/mp, N]`` (Shoeybi et al., arXiv:1909.08053).
It inserts no op.  Where the JAX package then compiles over a ``(dp,
mp)`` mesh and GSPMD inserts the all-reduce of each pair, the port's
executor places the rules itself (``fluid/model_parallel.py``): the
column matmul's input gets ``copy_to`` (its gradient summed over the mp
group), the row matmul's output ``reduce_from`` (one all-reduce), the
chain ops between them run on the rank's feature shard, and a rank's
startup keeps its slice of each sharded weight and of the weight's
optimizer state.  A weight sharded by :meth:`shard_weight` outside a
detected pair is gathered before any op that cannot run on its shard
(a ``reshape2`` splitting heads, for example), so the result stays the
unsharded one.

Usage::

    t = TensorParallelTranspiler(mp_degree=2)
    t.transpile(main_program, startup_program)   # auto-annotates pairs
    # or explicit control:
    t.shard_weight(main_program, "fc_0.w_0", dim=1)   # column
    t.shard_weight(main_program, "fc_1.w_0", dim=0)   # row

then run every rank of a world the degree divides
(``fluid.distributed.init``), or through fleet's
``DistributedStrategy(mp_degree=N)``.
"""

# ops through which a "pair" of matmuls may be chained while keeping the
# intermediate feature dim intact (elementwise / activation / dropout)
_CHAIN_OPS = frozenset([
    "relu", "gelu", "tanh", "sigmoid", "leaky_relu", "elu", "swish",
    "dropout", "scale", "cast", "elementwise_add", "elementwise_mul",
])

_MATMUL_OPS = frozenset(["mul", "matmul"])


class TensorParallelTranspiler:
    """Annotate a program's weights for Megatron tensor parallelism over
    ``mp_degree`` mesh partitions."""

    def __init__(self, mp_degree, mesh_axis="mp"):
        if mp_degree < 1:
            raise ValueError("mp_degree must be >= 1")
        self.mp_degree = mp_degree
        self.mesh_axis = mesh_axis

    # -- manual annotation -------------------------------------------------
    def shard_weight(self, program, param_name, dim):
        """Mark ``param_name`` as sharded on ``dim`` over the mp axis.
        dim=1 → column-parallel, dim=0 → row-parallel (for 2-D weights)."""
        var = program.global_block()._find_var_recursive(param_name)
        if var is None:
            raise ValueError("no variable %r in program" % param_name)
        shape = var.shape or ()
        if len(shape) <= dim:
            raise ValueError("cannot shard %r (shape %s) on dim %d"
                             % (param_name, shape, dim))
        if shape[dim] is not None and shape[dim] > 0 and \
                shape[dim] % self.mp_degree:
            raise ValueError(
                "dim %d of %r (%s) is not divisible by mp_degree=%d"
                % (dim, param_name, shape, self.mp_degree))
        shardings = getattr(program, "_mp_shardings", None)
        if shardings is None:
            shardings = program._mp_shardings = {}
        shardings[param_name] = (self.mesh_axis, dim)
        program._mp_degree = self.mp_degree
        program._bump_version()

    # -- auto annotation ---------------------------------------------------
    def transpile(self, main_program, startup_program=None):
        """Find Megatron pairs and annotate them.  Returns the list of
        (col_weight, row_weight) pairs annotated."""
        from ..framework import op_sub_block_indices

        program = main_program
        annotated = set(getattr(program, "_mp_shardings", {}))
        pairs = []
        # recompute sub-blocks merge into their PARENT's scan (the pair
        # may span the wrapper boundary in either direction), so skip
        # them in this outer walk
        recompute_subs = set()
        for blk in program.blocks:
            for op in blk.ops:
                if op.type == "recompute":
                    recompute_subs.update(op_sub_block_indices(op))
        for blk in program.blocks:
            if blk.idx in recompute_subs:
                continue
            pairs += self._annotate_block(program, blk, annotated)
        if not getattr(program, "_mp_shardings", None):
            # stamping _mp_degree with zero annotations would force a
            # (dp, mp) mesh (and its divisibility constraint) on a program
            # that has no tensor parallelism at all — refuse instead
            raise ValueError(
                "TensorParallelTranspiler found no Megatron matmul pair "
                "to shard (and no manual shard_weight annotations); the "
                "model has no mp_degree=%d-shardable structure"
                % self.mp_degree)
        program._mp_degree = self.mp_degree
        program._bump_version()
        if startup_program is not None:
            startup_program._mp_degree = self.mp_degree
            startup_program._mp_shardings = dict(
                getattr(program, "_mp_shardings", {}))
        return pairs

    def _annotate_block(self, program, block, annotated):
        from ..framework import op_sub_block_indices

        # producer map: var name -> op producing it (single-assignment in
        # practice for forward graphs; last writer wins like the executor).
        # recompute sub-blocks reuse the packed span's var names, so their
        # ops merge into the parent's scan IN PLACE of the wrapper op —
        # a Megatron pair that spans the boundary (in either direction)
        # chains seamlessly, and the pair loop below iterates the merged
        # list so inner matmuls are visited too.
        producer = {}
        consumers = {}
        scan_ops = []

        def index_ops(ops):
            for op in ops:
                if op.type == "recompute":
                    for sub_idx in op_sub_block_indices(op):
                        index_ops(program.blocks[sub_idx].ops)
                    continue
                scan_ops.append(op)
                for names in op.outputs.values():
                    for n in names:
                        producer[n] = op
                for names in op.inputs.values():
                    for n in names:
                        consumers.setdefault(n, []).append(op)

        index_ops(block.ops)

        def weight_of(op):
            """The Parameter operand of a matmul-like op, or None."""
            names = op.inputs.get("Y") or []
            if not names:
                return None
            v = block._find_var_recursive(names[0])
            if v is not None and getattr(v, "persistable", False) and \
                    v.shape and len(v.shape) == 2:
                return v
            return None

        def chain_back(op, depth=6):
            """Walk X-input producers through elementwise ops to the
            nearest matmul; None if the chain breaks."""
            for _ in range(depth):
                xs = op.inputs.get("X") or []
                if not xs:
                    return None
                prod = producer.get(xs[0])
                if prod is None:
                    return None
                if prod.type in _MATMUL_OPS:
                    return prod
                if prod.type not in _CHAIN_OPS:
                    return None
                op = prod
            return None

        pairs = []
        mp = self.mp_degree
        for op in scan_ops:
            if op.type not in _MATMUL_OPS:
                continue
            w2 = weight_of(op)
            if w2 is None or w2.name in annotated:
                continue
            first = chain_back(op)
            if first is None or first.type not in _MATMUL_OPS:
                continue
            w1 = weight_of(first)
            if w1 is None or w1.name in annotated:
                continue
            # divisibility: w1 col-sharded on dim 1, w2 row-sharded on dim 0
            if (w1.shape[1] or 0) % mp or (w2.shape[0] or 0) % mp:
                continue
            # the contracted dims must correspond (w1's output feeds w2)
            if w1.shape[1] != w2.shape[0]:
                continue
            self.shard_weight(program, w1.name, dim=1)
            self.shard_weight(program, w2.name, dim=0)
            annotated.update((w1.name, w2.name))
            pairs.append((w1.name, w2.name))
            # bias of the column-parallel fc is feature-sharded too
            out1 = (first.outputs.get("Out") or [None])[0]
            for c in consumers.get(out1, ()):
                if c.type == "elementwise_add":
                    for n in c.inputs.get("Y", []):
                        bv = block._find_var_recursive(n)
                        if bv is not None and \
                                getattr(bv, "persistable", False) and \
                                bv.shape and len(bv.shape) == 1 and \
                                bv.shape[0] == w1.shape[1]:
                            self.shard_weight(program, n, dim=0)
                            annotated.add(n)
        return pairs
