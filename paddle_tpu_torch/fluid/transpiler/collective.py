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

Not ported yet, each raising ``NotImplementedError`` naming ROADMAP
queue 1 item 10b: ``weight_update_sharding=True``,
``allreduce_precision="int8"`` with its error-feedback residuals, and
``hierarchical_allreduce_nnodes``.
"""

import numpy as np

from ..framework import OpRole, OP_ROLE_KEY, OP_ROLE_VAR_KEY
from ..ops.collective_ops import resolve_precision


def _item_10b(what):
    return NotImplementedError(
        "%s is not ported yet (ROADMAP queue 1 item 10b)" % what)


class Collective:
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.nranks = None
        self.rank = None

    def transpile(self, startup_program, main_program, rank=0,
                  endpoints=None, current_endpoint=None, wait_port=True,
                  nranks=None, hierarchical_allreduce_nnodes=None):
        if hierarchical_allreduce_nnodes and hierarchical_allreduce_nnodes > 1:
            raise _item_10b("hierarchical allreduce "
                            "(hierarchical_allreduce_nnodes=%d)"
                            % hierarchical_allreduce_nnodes)
        self.startup_program = startup_program
        self.main_program = main_program
        self.rank = rank
        if nranks is None:
            nranks = len(endpoints) if endpoints else 0
        # 0: whatever world the process runs in
        self.nranks = nranks
        self._init_communicators()
        self._broadcast_params()
        self._transpile_main()
        for program in (main_program, startup_program):
            program._use_collective = True
            program._collective_nranks = nranks or None
            program._collective_rings = {r: "dp" for r in range(self.nrings)}
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
    gradient, coalesced into ``fuse_grad_size_mb`` buckets by default
    (``fuse_grad_size_mb=0``: one collective per gradient).
    ``allreduce_precision`` is ``'fp32'`` (exact, the default) or
    ``'bf16'`` (the payload cast; ``use_bf16_allreduce=True`` is the
    older spelling).  ``sync_batch_norm=True`` first turns every
    batch_norm into sync_batch_norm (ir.py)."""

    def __init__(self, nrings=1, fuse_grad_size_mb=32,
                 sync_batch_norm=False, use_bf16_allreduce=False,
                 allreduce_precision=None, quant_block_size=None,
                 error_feedback=True, weight_update_sharding=False):
        super().__init__(nrings)
        self.fuse_grad_size_mb = fuse_grad_size_mb
        self.sync_batch_norm = sync_batch_norm
        self.allreduce_precision = resolve_precision(allreduce_precision,
                                                     use_bf16_allreduce)
        if self.allreduce_precision == "int8":
            raise _item_10b("allreduce_precision='int8' (with its "
                            "error-feedback residuals)")
        if weight_update_sharding:
            raise _item_10b("weight_update_sharding=True")
        self.use_bf16_allreduce = (self.allreduce_precision == "bf16")
        # the JAX package's int8 knobs; inert on the fp32 and bf16 wires
        self.quant_block_size = int(quant_block_size or 256)
        self.error_feedback = bool(error_feedback)
        self.weight_update_sharding = False

    def _allreduce_attrs(self, ring):
        # __grad_bucket__ marks a transpiled gradient exchange for the
        # step event's comm_buckets (sync-BN statistics and LocalSGD
        # averages are not buckets)
        return {"ring_id": ring, OP_ROLE_KEY: OpRole.Backward,
                "precision": self.allreduce_precision,
                "use_bf16": self.use_bf16_allreduce,
                "quant_block_size": self.quant_block_size,
                "__grad_bucket__": True}

    def _collect_grads(self, block):
        """[(producing op idx, param name, grad name)] in program order."""
        out = []
        for idx, op in enumerate(block.ops):
            if not (op.attr(OP_ROLE_KEY, 0) & OpRole.Backward):
                continue
            role_vars = op.attr(OP_ROLE_VAR_KEY)
            if not role_vars:
                continue
            for i in range(0, len(role_vars), 2):
                out.append((idx, role_vars[i], role_vars[i + 1]))
        return out

    def _transpile_main(self):
        if self.sync_batch_norm:
            from ..ir import get_pass
            get_pass("sync_batch_norm_pass")(self.main_program)
        block = self.main_program.global_block()
        inserts = self._collect_grads(block)
        if self.fuse_grad_size_mb and self.fuse_grad_size_mb > 0:
            self._transpile_fused(block, inserts)
        else:
            self._transpile_per_grad(block, inserts)

    def _mean(self):
        return 1.0 / max(self.nranks, 1) if self.nranks else 1.0

    def _transpile_per_grad(self, block, inserts):
        ring = 0
        for idx, _param, grad_name in reversed(inserts):
            block._insert_op(
                idx + 1, "c_allreduce_sum",
                inputs={"X": [grad_name]}, outputs={"Out": [grad_name]},
                attrs=self._allreduce_attrs(ring))
            block._insert_op(
                idx + 1, "scale",
                inputs={"X": [grad_name]}, outputs={"Out": [grad_name]},
                attrs={"scale": self._mean(), "__dp_mean__": True,
                       OP_ROLE_KEY: OpRole.Backward})
            ring = (ring + 1) % self.nrings

    def _iter_buckets(self, block, inserts, limit_bytes):
        """Buckets of consecutive same-dtype gradients of up to
        ``limit_bytes`` (counted at 4 bytes an element, as the JAX
        package counts them), yielded as they close, in producer order.
        A bucket closes before the gradient that would overflow it, so a
        gradient larger than the limit (BERT-base's 94 MB word-embedding
        gradient against 32 MB) gets a bucket of its own."""
        cur, cur_bytes, cur_dtype = [], 0, None
        for idx, pname, gname in inserts:
            p = block._find_var_recursive(pname)
            shape = tuple(int(s) for s in p.shape)
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
            for _, _pname, gname, numel, _shape in bucket:
                flat = block.create_var(name=gname + "@FLAT", dtype=dtype,
                                        shape=(numel,))
                flats.append(flat.name)
                ops.append(("reshape", {"X": [gname]}, {"Out": [flat.name]},
                            {"shape": [numel]}))
            ops.append(("concat", {"X": flats}, {"Out": [fused.name]},
                        {"axis": 0}))
            ops.append(("scale", {"X": [fused.name]}, {"Out": [fused.name]},
                        {"scale": self._mean(), "__dp_mean__": True}))
            ops.append(("c_allreduce_sum", {"X": [fused.name]},
                        {"Out": [fused.name]}, self._allreduce_attrs(ring)))
            ops.append(("split", {"X": [fused.name]}, {"Out": flats},
                        {"axis": 0, "sections": [e[3] for e in bucket]}))
            for (_, _pname, gname, _numel, shape), flat in zip(bucket, flats):
                ops.append(("reshape", {"X": [flat]}, {"Out": [gname]},
                            {"shape": list(shape)}))
            for off, (tp, ins, outs, attrs) in enumerate(ops):
                attrs[OP_ROLE_KEY] = OpRole.Backward
                block._insert_op(pos + off, tp, inputs=ins, outputs=outs,
                                 attrs=attrs)
            offset += len(ops)
            ring = (ring + 1) % self.nrings


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
