"""Collective transpiler: rewrite a one-rank program for synchronous data
parallel with explicit collective ops (counterpart
``paddle_tpu/fluid/transpiler/collective.py``; reference
``python/paddle/fluid/transpiler/collective.py``).

- ``Collective`` (reference :36) appends the bootstrap to the startup
  program — ``c_gen_nccl_id`` + ``c_comm_init`` per ring — broadcasts
  every parameter from rank 0, and marks both programs
  (``_use_collective``, ``_collective_nranks``, ``_collective_rings``).
- ``GradAllReduce`` (:175) scales each gradient by 1/nranks and sums it
  over the ranks with ``c_allreduce_sum`` after the backward op that
  produced it.  By default consecutive same-dtype gradients are
  coalesced into buckets of up to ``fuse_grad_size_mb`` (reshape →
  concat → scale → one all-reduce → split → reshape); a gradient larger
  than a bucket gets a bucket of its own.  ``fuse_grad_size_mb=0`` is the
  reference's one collective per gradient.
- ``LocalSGD`` (:263) trains locally and averages the parameters every
  ``k_steps`` steps (one ``local_sgd_sync`` op per parameter).

The ops run on ``torch.distributed`` process groups, one process per
rank (ops/collective_ops.py).  The rewritten programs are the JAX
package's op for op.

**Gradient scale.** 1/nranks times the sum over ranks is the mean of the
ranks' gradients.  With a loss that is a mean over the batch (all five
models) and equal local batches, that is the gradient of the global
batch, which the JAX package computes over its mapped batch.  With a
loss SUMMED over the batch it is 1/nranks of the global batch's
gradient, in both packages alike; neither adds a mode for it.  The
scale op carries ``__dp_mean__``, and its rule (ops/math_ops.py) divides
by the world the program runs in, as the JAX rule divides by its mapped
axis's size: a program transpiled with no endpoints (``nranks=0``)
averages over whatever world runs it.

**Wire precision.** ``allreduce_precision`` is ``fp32`` (exact),
``bf16`` (the payload cast) or ``int8`` (the block-scaled two-phase
exchange of ``quantized_collectives``).  On the int8 wire with
``error_feedback=True`` each exchange gets a persistable fp32 residual
``<name>@EF_RESIDUAL``, zero-filled by the startup program: scope state
that windows carry and checkpoints save like an optimizer moment.

**Hierarchical allreduce** (``hierarchical_allreduce_nnodes`` > 1):
both programs carry ``_collective_hierarchical``, and the executor runs
every ring as two levels (ops/collective_ops.py).

**Weight-update sharding** (``weight_update_sharding=True``, ZeRO-1;
JAX :311-700): per bucket, a ``c_reducescatter`` of the coalesced
gradient (padded to ``Bp``, a multiple of N, or of N x the block on the
int8 wire) at the bucket's last producer; the bucket's per-parameter
optimizer ops become ONE op on this rank's 1/N shard of the coalesced
parameters and of moments created sharded (declared at ``(Bp,)``,
filled by the startup program at ``(Bp / N,)``, listed in
``_dp_sharded_state``); then a ``c_allgather`` of the updated shard
(fp32: bit-equal to the replicated update) or of the quantized
parameter delta (bf16, int8 with a sharded residual).  ``_wus_degree``
is N and ``_wus_padded_numel`` maps every padded buffer to its logical
bucket size B (the elastic restore's layout identity).  Only an
elementwise optimizer fed the raw backward gradient can update a shard
(optimizer.elementwise_state_slots); anything else, and a hierarchical
ring, is refused as in the JAX package.
"""

import numpy as np

from ..framework import OpRole, OP_ROLE_KEY, OP_ROLE_VAR_KEY
from .. import distributed
from ..quantized_collectives import DEFAULT_BLOCK_SIZE, resolve_precision


class Collective:
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.nranks = None
        self.rank = None

    def transpile(self, startup_program, main_program, rank=0,
                  endpoints=None, current_endpoint=None, wait_port=True,
                  nranks=None, hierarchical_allreduce_nnodes=None):
        self.startup_program = startup_program
        self.main_program = main_program
        self.rank = rank
        if nranks is None:
            nranks = len(endpoints) if endpoints else 0
        # 0: whatever world the process runs in
        self.nranks = nranks
        self.hierarchical = hierarchical_allreduce_nnodes
        self._init_communicators()
        self._broadcast_params()
        self._transpile_main()
        for program in (main_program, startup_program):
            program._use_collective = True
            program._collective_nranks = nranks or None
            program._collective_rings = {r: "dp" for r in range(self.nrings)}
            # reference nccl_helper.h:246: two levels, "dcn" across
            # nodes and "ici" within one (ops/collective_ops.py)
            program._collective_hierarchical = hierarchical_allreduce_nnodes
            program._bump_version()

    # -- startup rewrites --------------------------------------------------
    def _init_communicators(self):
        block = self.startup_program.global_block()
        for ring_id in range(self.nrings):
            nccl_id = block.create_var(name="nccl_id_%d" % ring_id,
                                       persistable=True, dtype="int32",
                                       shape=(1,))
            block.append_op("c_gen_nccl_id", outputs={"Out": [nccl_id]},
                            attrs={"rank": self.rank, "ring_id": ring_id,
                                   OP_ROLE_KEY: OpRole.Collective})
            block.append_op("c_comm_init", inputs={"X": [nccl_id]},
                            attrs={"nranks": self.nranks,
                                   "rank": self.rank, "ring_id": ring_id,
                                   OP_ROLE_KEY: OpRole.Collective})

    def _broadcast_params(self):
        block = self.startup_program.global_block()
        ring_id = 0
        # parameters live in the MAIN program; the startup block holds
        # same-named persistable vars to initialize then broadcast
        for param in self.main_program.global_block().all_parameters():
            block.append_op("c_broadcast", inputs={"X": [param.name]},
                            outputs={"Out": [param.name]},
                            attrs={"ring_id": ring_id, "root": 0,
                                   OP_ROLE_KEY: OpRole.Collective})
        block.append_op("c_sync_comm_stream",
                        inputs={"X": []}, outputs={"Out": []},
                        attrs={"ring_id": ring_id,
                               OP_ROLE_KEY: OpRole.Collective})

    def _transpile_main(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """transpiler/collective.py:175 — scale(1/nranks) + c_allreduce_sum per
    gradient.

    By default gradients are *coalesced*: consecutive grads (same dtype) are
    flattened and concatenated into buckets of up to ``fuse_grad_size_mb``
    and all-reduced as one tensor, so a ResNet-50 emits O(buckets) rather
    than O(params) collectives (the reference's
    ``ir/alloc_continuous_space_for_grad_pass.cc`` +
    ``fuse_all_reduce_op_pass.cc`` graph rewrites).  A gradient larger than
    a bucket gets a bucket of its own.  Pass ``fuse_grad_size_mb=0`` for
    the reference's one-collective-per-grad layout.

    ``allreduce_precision`` selects the wire payload (EQuARX, PAPERS.md):

    - ``'fp32'`` (default) — exact, bit-identical to the pre-knob path;
    - ``'bf16'`` — payload cast, half the bytes (the deprecated-but-kept
      ``use_bf16_allreduce=True`` maps here);
    - ``'int8'`` — block-scaled two-phase quantized exchange
      (``quant_block_size`` elements per max-abs scale), ~1/4 the bytes.
      With ``error_feedback=True`` (default) each gradient gets a
      persistable fp32 residual variable (``<grad>@EF_RESIDUAL``,
      zero-initialized by the startup program) that carries the local
      quantization error into the next step — scope state, so it rides
      K-step windows and checkpoints like optimizer moments.

    ``sync_batch_norm=True`` first turns every batch_norm into
    sync_batch_norm (ir.py).
    """

    def __init__(self, nrings=1, fuse_grad_size_mb=32,
                 sync_batch_norm=False, use_bf16_allreduce=False,
                 allreduce_precision=None, quant_block_size=None,
                 error_feedback=True, weight_update_sharding=False):
        super().__init__(nrings)
        self.fuse_grad_size_mb = fuse_grad_size_mb
        self.sync_batch_norm = sync_batch_norm
        self.allreduce_precision = resolve_precision(allreduce_precision,
                                                     use_bf16_allreduce)
        # deprecated alias, kept as a readable mirror of the knob
        self.use_bf16_allreduce = (self.allreduce_precision == "bf16")
        self.quant_block_size = int(quant_block_size or DEFAULT_BLOCK_SIZE)
        self.error_feedback = bool(error_feedback)
        # ZeRO-style weight-update sharding ("Scale MLPerf-0.6 models on
        # Google TPU-v3 Pods", PAPERS.md): reduce-scatter each bucket's
        # gradient, update only the local 1/N shard of params +
        # optimizer moments (the moments are CREATED sharded — optimizer
        # state memory drops ~1/N per rank), then all-gather the
        # updated parameters back.  Same wire bytes as the allreduce it
        # replaces (RS + AG = the allreduce's own two phases) and the
        # int8 wire format composes: the RS is the quantized phase-1
        # exchange with error feedback, the AG carries the quantized
        # parameter DELTA with its own (sharded) residual.
        self.weight_update_sharding = bool(weight_update_sharding)
        # sharded state var -> (replaced accumulators, Bp, S)
        self.wus_state_sources = {}

    def _allreduce_attrs(self, ring):
        # __grad_bucket__ marks the collective as a coalesced gradient
        # exchange for the comm_buckets/overlap telemetry (lowering.
        # ExecState.record_comm) — other allreduces (sync-BN stats,
        # LocalSGD averaging) must not count as overlappable buckets
        return {"ring_id": ring, OP_ROLE_KEY: OpRole.Backward,
                "precision": self.allreduce_precision,
                "use_bf16": self.use_bf16_allreduce,
                "quant_block_size": self.quant_block_size,
                "__grad_bucket__": True}

    def _ef_residual(self, block, base_name, shape):
        """Create the error-feedback residual for one gradient (or one
        coalesced bucket): a persistable fp32 var in the MAIN block plus
        a same-named startup var zero-filled by the startup program —
        the scope then carries/checkpoints it like an optimizer moment.
        Returns the var name, or None when error feedback is off or the
        precision needs none."""
        if self.allreduce_precision != "int8" or not self.error_feedback:
            return None
        name = base_name + "@EF_RESIDUAL"
        shape = tuple(int(s) for s in shape)
        block.create_var(name=name, persistable=True, dtype="float32",
                         shape=shape)
        sblock = self.startup_program.global_block()
        svar = sblock.create_var(name=name, persistable=True,
                                 dtype="float32", shape=shape)
        sblock.append_op("fill_constant", outputs={"Out": [svar]},
                         attrs={"shape": list(shape), "dtype": "float32",
                                "value": 0.0,
                                OP_ROLE_KEY: OpRole.Forward})
        return name

    def _collect_grads(self, block):
        """[(producing op idx, param name, grad name)] in program order.
        A DGC parameter is left out: its ``dgc_momentum`` op exchanges
        its own masked gradient (JAX collective.py:170)."""
        dgc = getattr(block.program, "_dgc_param_names", set())
        out = []
        for idx, op in enumerate(block.ops):
            if not (op.attr(OP_ROLE_KEY, 0) & OpRole.Backward):
                continue
            role_vars = op.attr(OP_ROLE_VAR_KEY)
            if not role_vars:
                continue
            for i in range(0, len(role_vars), 2):
                if role_vars[i] in dgc:
                    continue
                out.append((idx, role_vars[i], role_vars[i + 1]))
        return out

    def _transpile_main(self):
        if self.sync_batch_norm:
            from ..ir import get_pass
            get_pass("sync_batch_norm_pass")(self.main_program)
        block = self.main_program.global_block()
        # under GSPMD the JAX package's switch_moe routes the global
        # batch's tokens (one capacity, one load-balance loss): each
        # replica's op routes its ring's tokens together (ops/moe_ops.py)
        for op in block.ops:
            if op.type == "switch_moe":
                op.attrs["__dp_tokens__"] = True
        inserts = self._collect_grads(block)
        if self.weight_update_sharding:
            self._transpile_wus(block, inserts)
        elif self.fuse_grad_size_mb and self.fuse_grad_size_mb > 0:
            self._transpile_fused(block, inserts)
        else:
            self._transpile_per_grad(block, inserts)

    def _transpile_per_grad(self, block, inserts):
        ring = 0
        for idx, param, grad_name in reversed(inserts):
            ar_inputs = {"X": [grad_name]}
            ar_outputs = {"Out": [grad_name]}
            # residual shape must match the GRADIENT the collective moves
            # — a shapeless/recursive-scope param used to fall back to
            # (1,) and create a mis-shaped residual
            gvar = block._find_var_recursive(grad_name)
            pvar = block._find_var_recursive(param)
            shape = (tuple(gvar.shape) if gvar is not None and gvar.shape
                     else tuple(pvar.shape) if pvar is not None
                     and pvar.shape else (1,))
            res = self._ef_residual(block, grad_name, shape)
            if res is not None:
                ar_inputs["Residual"] = [res]
                ar_outputs["ResidualOut"] = [res]
            block._insert_op(
                idx + 1, "c_allreduce_sum",
                inputs=ar_inputs, outputs=ar_outputs,
                attrs=self._allreduce_attrs(ring))
            block._insert_op(
                idx + 1, "scale",
                inputs={"X": [grad_name]}, outputs={"Out": [grad_name]},
                attrs={"scale": 1.0 / max(self.nranks, 1)
                       if self.nranks else 1.0,
                       "__dp_mean__": True,
                       OP_ROLE_KEY: OpRole.Backward})
            ring = (ring + 1) % self.nrings

    def _iter_buckets(self, block, inserts, limit_bytes):
        """Coalescing bucketizer shared by the fused and weight-update-
        sharded paths: yields buckets of consecutive same-dtype grads up
        to ``limit_bytes`` (0 → one bucket per grad, the reference
        per-grad layout) as they CLOSE, in producer order — the consumer
        emits each bucket's collective immediately at its last-producer
        position, so earlier buckets' exchanges are already in flight
        while later grads are still being produced."""
        import numpy as np
        from .. import model_parallel
        # a model-parallel program's sharded weight has a gradient of the
        # shape the rank holds
        prog = block.program
        local = model_parallel.local_shapes(prog,
                                            model_parallel.context(prog))
        cur, cur_bytes, cur_dtype = [], 0, None
        for idx, pname, gname in inserts:
            p = block._find_var_recursive(pname)
            shape = tuple(int(s) for s in local.get(pname, p.shape))
            numel = int(np.prod(shape)) if shape else 1
            nbytes = numel * 4
            if cur and (not limit_bytes or cur_dtype != p.dtype or
                        cur_bytes + nbytes > limit_bytes):
                yield cur
                cur, cur_bytes = [], 0
            cur.append((idx, pname, gname, numel, shape))
            cur_bytes += nbytes
            cur_dtype = p.dtype
        if cur:
            yield cur

    def _transpile_fused(self, block, inserts):
        limit = int(self.fuse_grad_size_mb * (1 << 20))
        mean = (1.0 / max(self.nranks, 1)) if self.nranks else 1.0
        ring = 0
        offset = 0   # ops inserted so far shift later producer indices
        # each bucket's exchange goes in as the bucket closes, at its
        # last producer's position
        for bi, bucket in enumerate(
                self._iter_buckets(block, inserts, limit)):
            pos = max(e[0] for e in bucket) + 1 + offset
            dtype = block._find_var_recursive(bucket[0][1]).dtype
            fused = block.create_var(
                name="coalesced_grad_%d" % bi, dtype=dtype,
                shape=(sum(e[3] for e in bucket),))
            flats = []
            ops = []
            for _, pname, gname, numel, _shape in bucket:
                flat = block.create_var(name=gname + "@FLAT", dtype=dtype,
                                        shape=(numel,))
                flats.append(flat.name)
                ops.append(("reshape", {"X": [gname]}, {"Out": [flat.name]},
                            {"shape": [numel]}))
            ops.append(("concat", {"X": flats}, {"Out": [fused.name]},
                        {"axis": 0}))
            ops.append(("scale", {"X": [fused.name]}, {"Out": [fused.name]},
                        {"scale": mean, "__dp_mean__": True}))
            ar_inputs = {"X": [fused.name]}
            ar_outputs = {"Out": [fused.name]}
            res = self._ef_residual(block, fused.name,
                                    (sum(e[3] for e in bucket),))
            if res is not None:
                ar_inputs["Residual"] = [res]
                ar_outputs["ResidualOut"] = [res]
            ops.append(("c_allreduce_sum", ar_inputs, ar_outputs,
                        self._allreduce_attrs(ring)))
            ops.append(("split", {"X": [fused.name]}, {"Out": flats},
                        {"axis": 0, "sections": [e[3] for e in bucket]}))
            for (_, pname, gname, numel, shape), flat in zip(bucket, flats):
                ops.append(("reshape", {"X": [flat]}, {"Out": [gname]},
                            {"shape": list(shape)}))
            for off, (tp, ins, outs, attrs) in enumerate(ops):
                attrs[OP_ROLE_KEY] = OpRole.Backward
                block._insert_op(pos + off, tp, inputs=ins, outputs=outs,
                                 attrs=attrs)
            offset += len(ops)
            ring = (ring + 1) % self.nrings

    # -- weight-update sharding (ZeRO-style) -------------------------------

    def _transpile_wus(self, block, inserts):
        """Rewrite gradient exchange + optimizer update for weight-update
        sharding: per bucket, ``c_reducescatter`` the coalesced gradient
        at its last-producer position (eager, overlap-schedulable), then
        replace the bucket's per-param optimizer ops with ONE op updating
        the local 1/N shard of the coalesced parameters against sharded
        moments, and ``c_allgather`` the result back.  Optimizer-state
        memory drops ~1/N per rank at the allreduce's own wire bytes
        (RS + AG are its two phases)."""
        from ..optimizer import elementwise_state_slots

        if self.hierarchical and self.hierarchical > 1:
            raise ValueError(
                "weight_update_sharding does not compose with "
                "hierarchical allreduce: the sharded exchange is "
                "single-level, as in the JAX package")
        main, startup = self.main_program, self.startup_program
        N = int(self.nranks) if self.nranks else 0
        if not N:
            # no endpoints: the ranks ring 0 spans in this world — the
            # dp replicas of a model-parallel program, else the world
            from .. import model_parallel
            par = model_parallel.context(main)
            N = next(iter(par.values())).dp_size if par \
                else distributed.process_count()
        main._wus_degree = startup._wus_degree = N
        for prog in (main, startup):
            if not hasattr(prog, "_dp_sharded_state"):
                prog._dp_sharded_state = set()
            if not hasattr(prog, "_wus_padded_numel"):
                prog._wus_padded_numel = {}
        int8 = self.allreduce_precision == "int8"
        # pad unit: shards must line up with quantization blocks so the
        # int8 RS/AG phases split evenly (fp32/bf16 only need / N)
        unit = N * (self.quant_block_size if int8 else 1)
        limit = int(self.fuse_grad_size_mb * (1 << 20)) \
            if self.fuse_grad_size_mb and self.fuse_grad_size_mb > 0 else 0
        ring = 0
        offset = 0
        metas = []
        for bi, bucket in enumerate(self._iter_buckets(block, inserts,
                                                       limit)):
            self._wus_check_grad_consumers(block, bucket)
            B = sum(e[3] for e in bucket)
            Bp = -(-B // unit) * unit
            meta = {"bi": bi, "bucket": bucket, "B": B, "Bp": Bp,
                    "S": Bp // N, "ring": ring,
                    "dtype": block._find_var_recursive(bucket[0][1]).dtype}
            offset += self._wus_emit_reduce_scatter(block, meta, offset)
            metas.append(meta)
            ring = (ring + 1) % self.nrings
        for meta in metas:
            self._wus_rewrite_update(block, meta, N,
                                     elementwise_state_slots)
        main._bump_version()
        startup._bump_version()

    def _wus_check_grad_consumers(self, block, bucket):
        """Weight-update sharding consumes each gradient straight out of
        backward into the reduce-scatter; any other Optimize-role reader
        (gradient clip, regularization, a non-shardable optimizer) would
        silently see the UNREDUCED local gradient — refuse loudly."""
        from ..optimizer import elementwise_state_slots
        for idx, pname, gname in ((e[0], e[1], e[2]) for e in bucket):
            for op in block.ops[idx + 1:]:
                if not (op.attr(OP_ROLE_KEY, 0) & OpRole.Optimize):
                    continue
                reads = any(gname in names for names in op.inputs.values())
                if not reads:
                    continue
                if op.input("Param") == [pname] and \
                        elementwise_state_slots(op.type) is not None:
                    continue   # the optimizer op we are about to replace
                raise NotImplementedError(
                    "weight_update_sharding: gradient %r is consumed by "
                    "%r beyond its elementwise optimizer op (gradient "
                    "clip / regularization / %s do not compose with the "
                    "sharded update yet)" % (gname, op.type, op.type))

    def _wus_coalesce_ops(self, block, sources, flat_names, numels,
                          dtype, B, Bp, pad_name, out_name):
        """reshape each source to its flat + optional zero pad + concat
        into ONE (Bp,) coalesced buffer — the single bucket-layout
        definition shared by the gradient (reduce-scatter input) and
        parameter (shard source) sides, which must agree
        element-for-element for the sharded update to be the same slice
        of both."""
        ops = []
        for src, flat, numel in zip(sources, flat_names, numels):
            block.create_var(name=flat, dtype=dtype, shape=(numel,))
            ops.append(("reshape", {"X": [src]}, {"Out": [flat]},
                        {"shape": [numel]}))
        cat = list(flat_names)
        if Bp > B:
            block.create_var(name=pad_name, dtype=dtype, shape=(Bp - B,))
            ops.append(("fill_constant", {}, {"Out": [pad_name]},
                        {"shape": [Bp - B], "dtype": dtype,
                         "value": 0.0}))
            cat.append(pad_name)
        ops.append(("concat", {"X": cat}, {"Out": [out_name]},
                    {"axis": 0}))
        return ops

    def _wus_emit_reduce_scatter(self, block, meta, offset):
        """Emit flatten→concat→scale→pad→c_reducescatter at the bucket's
        last-producer position; returns the number of ops inserted."""
        bi, bucket = meta["bi"], meta["bucket"]
        dtype, B, Bp, S = meta["dtype"], meta["B"], meta["Bp"], meta["S"]
        pos = max(e[0] for e in bucket) + 1 + offset
        mean = 1.0 / max(self.nranks, 1) if self.nranks else 1.0
        fused = block.create_var(name="wus_grad_%d" % bi, dtype=dtype,
                                 shape=(Bp,))
        gshard = block.create_var(name="wus_grad_shard_%d" % bi,
                                  dtype=dtype, shape=(S,))
        meta["gshard"] = gshard.name
        ops = self._wus_coalesce_ops(
            block, [e[2] for e in bucket],
            [e[2] + "@FLAT" for e in bucket], [e[3] for e in bucket],
            dtype, B, Bp, "wus_grad_pad_%d" % bi, fused.name)
        ops.append(("scale", {"X": [fused.name]}, {"Out": [fused.name]},
                    {"scale": mean, "__dp_mean__": True}))
        rs_inputs = {"X": [fused.name]}
        rs_outputs = {"Out": [gshard.name]}
        res = self._ef_residual(block, fused.name, (Bp,))
        if res is not None:
            rs_inputs["Residual"] = [res]
            rs_outputs["ResidualOut"] = [res]
            # replicated, but its (Bp,) shape is still a function of the
            # degree — elastic restore re-pads it like the sharded state
            self._wus_record_padded(res, B)
        ops.append(("c_reducescatter", rs_inputs, rs_outputs,
                    self._allreduce_attrs(meta["ring"])))
        for off, (tp, ins, outs, attrs) in enumerate(ops):
            attrs[OP_ROLE_KEY] = OpRole.Backward
            block._insert_op(pos + off, tp, inputs=ins, outputs=outs,
                             attrs=attrs)
        return len(ops)

    def _wus_record_padded(self, name, logical_numel):
        """Register a persistable var whose global ``(Bp,)`` shape pads
        the degree-independent logical bucket size ``B`` up to a
        multiple of the shard unit: the padded length changes with the
        world size, so elastic restore (checkpoint.py ``reshard=True``)
        re-slices exactly these vars, cross-checking ``B`` as the
        bucket-layout identity."""
        for prog in (self.main_program, self.startup_program):
            prog._wus_padded_numel[name] = int(logical_numel)

    def _wus_sharded_state_var(self, name, global_shape, local_shape,
                               fill, dtype, link_param, logical_numel):
        """Create one SHARDED persistable state var (an optimizer-moment
        shard or the AG-phase error-feedback residual): declared at its
        GLOBAL shape, zero/fill-initialized by the startup program at the
        LOCAL per-rank shape — each rank's scope holds only its 1/N slice
        (``program._dp_sharded_state``)."""
        self._wus_record_padded(name, logical_numel)
        for prog in (self.main_program, self.startup_program):
            prog.global_block().create_var(
                name=name, persistable=True, dtype=dtype,
                shape=tuple(global_shape))
            prog._dp_sharded_state.add(name)
            if link_param is not None:
                links = dict(getattr(prog, "_opt_state_of", None) or {})
                links[name] = link_param
                prog._opt_state_of = links
        self.startup_program.global_block().append_op(
            "fill_constant", outputs={"Out": [name]},
            attrs={"shape": list(local_shape), "dtype": dtype,
                   "value": float(fill), OP_ROLE_KEY: OpRole.Forward})
        return name

    def _wus_startup_fill_value(self, acc_name):
        """Fill value of an accumulator's startup initializer (adagrad's
        initial_accumulator_value etc.); 0.0 when none is found."""
        sblock = self.startup_program.global_block()
        for op in sblock.ops:
            if op.type == "fill_constant" and op.output("Out") == [acc_name]:
                return float(op.attr("value", 0.0))
        return 0.0

    def _wus_drop_var(self, name):
        """Remove a replaced per-param accumulator: its var (both
        programs), its startup fill op, and its optimizer-state link."""
        for prog in (self.main_program, self.startup_program):
            blk = prog.global_block()
            blk.vars.pop(name, None)
            links = getattr(prog, "_opt_state_of", None)
            if links and name in links:
                links = dict(links)
                del links[name]
                prog._opt_state_of = links
        sblock = self.startup_program.global_block()
        for i in range(len(sblock.ops) - 1, -1, -1):
            op = sblock.ops[i]
            if op.type == "fill_constant" and op.output("Out") == [name]:
                sblock._remove_op(i)

    def _wus_rewrite_update(self, block, meta, N, state_slots_of):
        """Replace the bucket's per-param optimizer ops with one sharded
        update: slice this rank's 1/N of the coalesced params, run the
        SAME optimizer op on (param shard, grad shard, sharded moments),
        all-gather the result (fp32: the updated shard verbatim —
        bit-exact vs the replicated update; bf16/int8: the quantized
        parameter DELTA, whose dynamic range matches gradients, int8 with
        a sharded error-feedback residual), and scatter it back into the
        parameter variables."""
        bi, bucket = meta["bi"], meta["bucket"]
        dtype, B, Bp, S = meta["dtype"], meta["B"], meta["Bp"], meta["S"]
        int8 = self.allreduce_precision == "int8"
        exact = self.allreduce_precision == "fp32"

        # locate + validate the bucket's original optimizer ops
        grad_of = {e[1]: e[2] for e in bucket}
        found = {}
        for i, op in enumerate(block.ops):
            if (op.attr(OP_ROLE_KEY, 0) & OpRole.Optimize) and \
                    op.input("Param") and \
                    op.input("Param")[0] in grad_of and \
                    state_slots_of(op.type) is not None:
                pname = op.input("Param")[0]
                # the op must consume the bucket's gradient VERBATIM —
                # an optimizer whose Grad was rewired to a processed
                # variable (AMP's unscale + non-finite gating chain,
                # emitted under Backward role so the consumer check
                # cannot see it) would silently lose that processing if
                # we swapped in the reduce-scattered raw gradient
                if op.input("Grad") != [grad_of[pname]]:
                    raise NotImplementedError(
                        "weight_update_sharding: optimizer op %r for "
                        "param %r consumes %r, not the backward "
                        "gradient %r — gradient post-processing (e.g. "
                        "AMP loss-scale unscaling, "
                        "mixed_precision.decorate) does not compose "
                        "with the sharded update yet"
                        % (op.type, pname, op.input("Grad"),
                           grad_of[pname]))
                found[pname] = (i, op)
        missing = [e[1] for e in bucket if e[1] not in found]
        if missing:
            have = sorted({op.type for _i, op in found.values()})
            raise NotImplementedError(
                "weight_update_sharding: no elementwise optimizer op "
                "found for params %s (optimizers present: %s) — only "
                "elementwise update rules (optimizer."
                "ELEMENTWISE_OPTIMIZER_STATE) can update a 1/N shard; "
                "lamb/lars/dgc need the whole parameter" % (missing,
                                                            sorted(have)))
        ops_meta = [found[e[1]] for e in bucket]
        first_op = ops_meta[0][1]
        op_type = first_op.type
        slots = state_slots_of(op_type)

        def update_attrs(op):
            return {k: v for k, v in op.attrs.items()
                    if k not in (OP_ROLE_KEY, OP_ROLE_VAR_KEY)}

        ref_attrs = update_attrs(first_op)
        for _, op in ops_meta[1:]:
            if op.type != op_type or update_attrs(op) != ref_attrs:
                raise NotImplementedError(
                    "weight_update_sharding: params of one coalesced "
                    "bucket are updated by different optimizer "
                    "configurations (%s vs %s) — lower fuse_grad_size_mb "
                    "or use one optimizer per program"
                    % ((op_type, ref_attrs), (op.type, update_attrs(op))))
        lr_names = {tuple(op.input("LearningRate")) for _, op in ops_meta}
        if len(lr_names) > 1:
            raise NotImplementedError(
                "weight_update_sharding: params of one bucket carry "
                "different learning rates (per-param learning_rate "
                "attrs): %s" % sorted(lr_names))

        # sharded moments replace the per-param accumulators (THE memory
        # win: each rank now stores 1/N of the optimizer state)
        first_param = bucket[0][1]
        shard_inputs, shard_outputs = {}, {}
        for in_slot, out_slot in slots.items():
            fill = self._wus_startup_fill_value(
                first_op.input(in_slot)[0])
            sname = self._wus_sharded_state_var(
                "wus_%s_%d" % (in_slot.lower(), bi), (Bp,), (S,),
                fill, dtype, first_param, B)
            shard_inputs[in_slot] = [sname]
            shard_outputs[out_slot] = [sname]
            # the per-parameter accumulators the shard replaces, in
            # bucket order (CompiledProgram carries a scope's values
            # over into the shard)
            self.wus_state_sources[sname] = (
                [op.input(in_slot)[0] for _, op in ops_meta], Bp, S)
            for _, op in ops_meta:
                self._wus_drop_var(op.input(in_slot)[0])
        # scalar companions (LearningRate, beta-pow accumulators):
        # identical across the bucket's params by construction — the
        # first param's serve the bucket (the others keep advancing
        # through _finish_update, negligibly small state)
        for slot in first_op.inputs:
            if slot in ("Param", "Grad") or slot in slots:
                continue
            shard_inputs[slot] = list(first_op.input(slot))

        pshard = block.create_var(name="wus_param_shard_%d" % bi,
                                  dtype=dtype, shape=(S,))
        pfused = block.create_var(name="wus_param_%d" % bi, dtype=dtype,
                                  shape=(Bp,))
        pfull = block.create_var(name="wus_param_full_%d" % bi,
                                 dtype=dtype, shape=(Bp,))
        coll_attrs = self._allreduce_attrs(meta["ring"])
        coll_attrs[OP_ROLE_KEY] = OpRole.Optimize
        # the AG is the parameter-return phase, not a gradient bucket:
        # comm_buckets counts RS-phase exchanges only (overlap bound
        # 1 - 1/buckets), so the marker must not ride the gather
        del coll_attrs["__grad_bucket__"]

        ops = self._wus_coalesce_ops(
            block, [e[1] for e in bucket],
            ["wus_pflat_%d_%d" % (bi, j) for j in range(len(bucket))],
            [e[3] for e in bucket], dtype, B, Bp,
            "wus_param_pad_%d" % bi, pfused.name)
        ops.append(("c_shard_slice", {"X": [pfused.name]},
                    {"Out": [pshard.name]},
                    {"ring_id": meta["ring"], OP_ROLE_KEY: OpRole.Optimize}))
        if not exact:
            pold = block.create_var(name="wus_param_old_%d" % bi,
                                    dtype=dtype, shape=(S,))
            ops.append(("assign", {"X": [pshard.name]},
                        {"Out": [pold.name]}, {}))
        upd_inputs = dict(shard_inputs)
        upd_inputs["Param"] = [pshard.name]
        upd_inputs["Grad"] = [meta["gshard"]]
        upd_outputs = dict(shard_outputs)
        upd_outputs["ParamOut"] = [pshard.name]
        ops.append((op_type, upd_inputs, upd_outputs, dict(ref_attrs)))
        if exact:
            ops.append(("c_allgather", {"X": [pshard.name]},
                        {"Out": [pfull.name]}, coll_attrs))
        else:
            delta = block.create_var(name="wus_delta_%d" % bi,
                                     dtype=dtype, shape=(S,))
            dfull = block.create_var(name="wus_delta_full_%d" % bi,
                                     dtype=dtype, shape=(Bp,))
            ops.append(("elementwise_sub",
                        {"X": [pshard.name], "Y": [pold.name]},
                        {"Out": [delta.name]}, {"axis": -1}))
            ag_inputs = {"X": [delta.name]}
            ag_outputs = {"Out": [dfull.name]}
            if int8 and self.error_feedback:
                res = self._wus_sharded_state_var(
                    "wus_param_%d@EF_RESIDUAL" % bi, (Bp,), (S,), 0.0,
                    "float32", None, B)
                ag_inputs["Residual"] = [res]
                ag_outputs["ResidualOut"] = [res]
            ops.append(("c_allgather", ag_inputs, ag_outputs,
                        dict(coll_attrs)))
            ops.append(("elementwise_add",
                        {"X": [pfused.name], "Y": [dfull.name]},
                        {"Out": [pfull.name]}, {"axis": -1}))
        sections = [e[3] for e in bucket]
        outs = ["wus_pout_%d_%d" % (bi, j) for j in range(len(bucket))]
        for name, numel in zip(outs, sections):
            block.create_var(name=name, dtype=dtype, shape=(numel,))
        if Bp > B:
            sections = sections + [Bp - B]
            drop = block.create_var(name="wus_pad_out_%d" % bi,
                                    dtype=dtype, shape=(Bp - B,))
            outs = outs + [drop.name]
        ops.append(("split", {"X": [pfull.name]}, {"Out": outs},
                    {"axis": 0, "sections": sections}))
        for (_, pname, _g, numel, shape), oname in zip(bucket, outs):
            ops.append(("reshape", {"X": [oname]}, {"Out": [pname]},
                        {"shape": list(shape)}))

        # splice: remove the originals, insert the sharded chain where
        # the first of them stood (after any LR-schedule ops)
        indices = sorted(i for i, _ in ops_meta)
        for i in reversed(indices):
            block._remove_op(i)
        pos = indices[0]
        for off, (tp, ins, outs_, attrs) in enumerate(ops):
            attrs.setdefault(OP_ROLE_KEY, OpRole.Optimize)
            block._insert_op(pos + off, tp, inputs=ins, outputs=outs_,
                             attrs=attrs)


class LocalSGD(Collective):
    """transpiler/collective.py:263 — train locally, average the
    parameters over the ranks every ``k_steps`` steps (one
    ``local_sgd_sync`` op per parameter, gated on the step)."""

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_main(self):
        block = self.main_program.global_block()
        for param in block.program.global_block().all_parameters():
            block.append_op("local_sgd_sync",
                            inputs={"X": [param]},
                            outputs={"Out": [param]},
                            attrs={"k_steps": self.k_steps, "ring_id": 0,
                                   OP_ROLE_KEY: OpRole.Optimize})
