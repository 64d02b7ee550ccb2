"""The int8 wire (``paddle_tpu_torch/fluid/quantized_collectives.py`` and
the int8 paths of ``ops/collective_ops.py``) and hierarchical allreduce,
against paddle_tpu.

In this process: the block quantizer, its inverse and the wire-byte
helpers against the JAX package's on seeded inputs, bit for bit (array
equality), all-zero blocks, padding and ``pad_to`` included.

A 2-process gloo pack (this file is its worker): ``c_allreduce_sum``,
``c_reducescatter`` and ``c_allgather`` on the int8 wire, with and without
an error-feedback ``Residual``, as one-op programs; rank r feeds its rows
of a global input, and JAX runs the program marked for 2 ranks on two
devices of the virtual CPU mesh, fed the global input.  The ranks'
outputs concatenated, and their ``ResidualOut``s, equal JAX's fetches
within 8 fp32 roundings (2^-24 relative each) of the largest value: the
blocks and scales are JAX's bit for bit, but XLA may contract a product
and the sum after it into one fused multiply-add (the port rounds each
on its own, as the JAX source writes them), and one rounding of a
partial sum moves a block's scale by an ulp.
Int8 requests that the JAX package turns into the bf16 cast (a 2-D
gather, a reduce-scatter whose numel does not divide by N x the block, a
hierarchical ring) match its bf16 result within one bf16 rounding
(2^-8 relative).  Each op's wire bytes are JAX's byte helpers' number.

Hierarchical allreduce (``hierarchical_allreduce_nnodes=2``): the fc
program of tests/test_collective.py::test_hierarchical_allreduce_matches
_flat trained 4 SGD steps on a 4-process pack (2 nodes of 2 ranks: a
reduce within the node, an all-reduce across nodes, a broadcast) and on
the 2-process pack (2 nodes of 1): losses bit-equal to the flat
GradAllReduce of the same pack and within ``rtol 1e-6`` of JAX's
two-level run, parameters within ``atol 1e-6``; the wire bytes split per
level under JAX's names (``dcn``, ``ici``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import quantized_collectives as qc

from test_torch_collective_ops import pack_logs, run_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

NPROC = 2
BF16_RTOL = 2.0 ** -8
# int8 ops against JAX: this many fp32 roundings of the largest value
INT8_ROUNDINGS = 8

# (case id, op type, attrs, per-rank input shape, residual?, input kind)
CASES = [
    ("allreduce", "c_allreduce_sum", {}, (2, 600), False, "randn"),
    ("allreduce_ef", "c_allreduce_sum", {}, (2, 600), True, "randn"),
    ("allreduce_zero_block", "c_allreduce_sum", {}, (2, 600), True,
     "zero_block"),
    ("allreduce_bs64_ef", "c_allreduce_sum", {"quant_block_size": 64},
     (3, 50), True, "randn"),
    ("reducescatter", "c_reducescatter", {"quant_block_size": 64},
     (256,), False, "randn"),
    ("reducescatter_ef", "c_reducescatter", {"quant_block_size": 64},
     (256,), True, "randn"),
    ("allgather", "c_allgather", {"quant_block_size": 64}, (128,), False,
     "randn"),
    ("allgather_ef", "c_allgather", {"quant_block_size": 64}, (128,), True,
     "randn"),
    # the bf16 cast, as the JAX ops degrade these int8 requests
    ("allgather_2d_is_bf16", "c_allgather", {}, (2, 6), False, "randn"),
    ("reducescatter_ragged_is_bf16", "c_reducescatter",
     {"quant_block_size": 64}, (100,), False, "randn"),
]
BF16_CASES = {"allgather_2d_is_bf16", "reducescatter_ragged_is_bf16"}
HIER_STEPS, HIER_ROWS = 4, 8


def global_input(kind, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(NPROC * shape[0], *shape[1:]).astype(np.float32) * 3
    if kind == "zero_block":
        x.reshape(-1)[:300] = 0.0
    return x


def residual_input(shape, seed):
    return (np.random.RandomState(100 + seed).randn(*shape) * 0.01) \
        .astype(np.float32)


def one_op_program(pkg, op_type, attrs, shape, residual):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if len(shape) == 1:
            x = pkg.layers.data(name="x", shape=list(shape),
                                dtype="float32", append_batch_size=False)
        else:
            x = pkg.layers.data(name="x", shape=list(shape[1:]),
                                dtype="float32")
        block = main.global_block()
        out = block.create_var(name="out", dtype="float32")
        ins, outs = {"X": [x]}, {"Out": [out]}
        if residual:
            block.create_var(name="res", dtype="float32", shape=shape,
                             persistable=True)
            ins["Residual"] = outs["ResidualOut"] = ["res"]
        block.append_op(op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs, precision="int8", ring_id=0))
    return main


def fc_program(pkg, nnodes, nranks):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(
            x, size=1,
            param_attr=pkg.ParamAttr(
                initializer=pkg.initializer.ConstantInitializer(0.5)),
            bias_attr=pkg.ParamAttr(
                initializer=pkg.initializer.ConstantInitializer(0.0)))
        d = pred - y
        loss = pkg.layers.mean(d * d)
        pkg.optimizer.SGDOptimizer(0.05).minimize(loss)
    pkg.transpiler.GradAllReduce().transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * nranks, nranks=nranks,
        hierarchical_allreduce_nnodes=nnodes)
    return main, startup, loss


def fc_feed(nranks, rank=None):
    rng = np.random.RandomState(9)
    xs = rng.normal(size=(nranks * HIER_ROWS, 6)).astype(np.float32)
    ys = rng.normal(size=(nranks * HIER_ROWS, 1)).astype(np.float32)
    if rank is None:
        return {"x": xs, "y": ys}
    rows = slice(rank * HIER_ROWS, (rank + 1) * HIER_ROWS)
    return {"x": xs[rows], "y": ys[rows]}


# ---------------------------------------------------------------------------
# The packs' worker
# ---------------------------------------------------------------------------

def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist, telemetry
    rank, n = dist.init(place=fluid.CPUPlace())
    exe = fluid.Executor(fluid.CPUPlace())
    res = {"rank": rank, "world": n, "outputs": {}, "residuals": {},
           "comm": {}}

    def comm_of_last():
        ev = telemetry.step_events()[-1]
        return dict(ev["comm_by"] or {}), dict(ev["comm_by_axis"] or {})

    if n == NPROC:
        for i, (cid, op_type, attrs, shape, with_res, kind) in \
                enumerate(CASES):
            x = global_input(kind, shape, i)[rank * shape[0]:
                                             (rank + 1) * shape[0]]
            scope = fluid.Scope()
            if with_res:
                scope.set_var("res", torch.from_numpy(
                    residual_input(shape, i)))
            fetch = ["out", "res"] if with_res else ["out"]
            got = exe.run(one_op_program(fluid, op_type, attrs, shape,
                                         with_res),
                          feed={"x": x}, fetch_list=fetch, scope=scope)
            res["outputs"][cid] = got[0].tolist()
            if with_res:
                res["residuals"][cid] = got[1].tolist()
            res["comm"][cid] = comm_of_last()[0]
        # an int8 request on a hierarchical ring is the bf16 cast
        main = one_op_program(fluid, "c_allreduce_sum", {}, (2, 600), False)
        main._collective_hierarchical = 2
        x = global_input("randn", (2, 600), 0)[rank * 2:(rank + 1) * 2]
        res["outputs"]["allreduce_hier_is_bf16"] = exe.run(
            main, feed={"x": x}, fetch_list=["out"],
            scope=fluid.Scope())[0].tolist()
        res["comm"]["allreduce_hier_is_bf16"] = comm_of_last()
    # fc + SGD, hierarchical (n // 2 ranks a node) and flat
    for tag, nnodes in (("hier", 2), ("flat", None)):
        main, startup, loss = fc_program(fluid, nnodes, n)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        res[tag] = [float(exe.run(main, feed=fc_feed(n, rank),
                                  fetch_list=[loss],
                                  scope=scope)[0].reshape(-1)[0])
                    for _ in range(HIER_STEPS)]
        res[tag + "_comm"] = comm_of_last()
        res[tag + "_params"] = {p: scope.find_var(p).numpy().tolist()
                                for p in ("fc_0.w_0", "fc_0.b_0")}
    with open(Path(out_dir) / ("rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def _pack(tmp_path_factory, nproc):
    out_dir = tmp_path_factory.mktemp("qc_pack%d" % nproc)
    proc = run_pack(Path(__file__), out_dir, nproc=nproc)
    assert proc.returncode == 0, \
        proc.stderr[-3000:] + pack_logs(out_dir, nproc)
    return [json.loads((out_dir / ("rank%d.json" % r)).read_text())
            for r in range(nproc)]


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    return _pack(tmp_path_factory, NPROC)


@pytest.fixture(scope="module")
def pack4(tmp_path_factory):
    return _pack(tmp_path_factory, 4)


def jax_fetch(op_type, attrs, shape, with_res, x, res=None, hier=None):
    """The JAX package's fetch of the one-op program over 2 devices of the
    virtual mesh: the replicas' outputs concatenated, and the residual as
    its replicated state keeps it (device 0's)."""
    import paddle_tpu.fluid as jfluid
    main = one_op_program(jfluid, op_type, attrs, shape, with_res)
    main._use_collective = True
    main._collective_nranks = NPROC
    main._collective_rings = {0: "dp"}
    main._collective_hierarchical = hier
    scope = jfluid.Scope()
    if with_res:
        scope.set_var("res", res)
    got = jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=["out", "res"] if with_res
        else ["out"], scope=scope)
    return [np.asarray(g, np.float32) for g in got]


# ---------------------------------------------------------------------------
# The quantizer and the byte helpers, in this process
# ---------------------------------------------------------------------------

def _quant_input(kind, numel, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(numel) * rng.uniform(0.01, 100)).astype(np.float32)
    if kind == "zero_block":
        x[:256] = 0.0
    elif kind == "ties":
        # exact .5 multiples of the block's step: round half to even
        x = (np.arange(numel) % 9 - 4).astype(np.float32) * 0.5
        x[0] = 127.0
    return x


@pytest.mark.parametrize("kind,numel,bs,pad_to", [
    ("randn", 1000, 256, 1), ("randn", 1000, 256, 2),
    ("randn", 1000, 256, 3), ("randn", 7, 256, 8),
    ("zero_block", 768, 256, 2), ("randn", 4096, 64, 4),
    ("ties", 512, 128, 1), ("randn", 1, 4, 1)])
def test_block_quantizer_matches_paddle_tpu_bit_for_bit(kind, numel, bs,
                                                       pad_to):
    import jax.numpy as jnp
    import torch
    from paddle_tpu.fluid import quantized_collectives as jqc
    x = _quant_input(kind, numel, numel + bs)
    q, s, n = qc.quantize_block_scaled(torch.from_numpy(x), bs, pad_to)
    jq, js, jn = jqc.quantize_block_scaled(jnp.asarray(x), bs, pad_to)
    assert n == jn == numel
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.shape[0] % pad_to == 0
    if kind == "zero_block":
        assert float(s[0]) == 1.0 and not q[0].any()
    back = qc.dequantize_block_scaled(q, s, n, (numel,), torch.float32)
    jback = jqc.dequantize_block_scaled(jq, js, jn, (numel,), jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    # the rows form: _block_quantize / _block_dequantize
    rows = x[:numel - numel % bs].reshape(-1, bs) if numel >= bs else \
        x.reshape(1, -1)
    rq, rs = qc._block_quantize(torch.from_numpy(rows))
    jrq, jrs = jqc._block_quantize(jnp.asarray(rows))
    np.testing.assert_array_equal(rq.numpy(), np.asarray(jrq))
    np.testing.assert_array_equal(
        qc._block_dequantize(rq, rs).numpy(),
        np.asarray(jqc._block_dequantize(jrq, jrs)))


@pytest.mark.parametrize("numel,precision,bs,itemsize,world", [
    (1000, "int8", 256, 4, 1), (1000, "int8", 256, 4, 8),
    (7, "int8", 256, 4, 2), (4096, "int8", 64, 4, 4),
    (1000, "bf16", 256, 4, 2), (1000, "fp32", 256, 4, 2),
    (1000, "fp32", 256, 8, 1)])
def test_wire_byte_helpers_match_paddle_tpu(numel, precision, bs, itemsize,
                                            world):
    from paddle_tpu.fluid import quantized_collectives as jqc
    assert qc.block_count(numel, bs, world) == \
        jqc.block_count(numel, bs, world)
    for fn in ("phase_wire_bytes", "allreduce_wire_bytes"):
        assert getattr(qc, fn)(numel, precision, bs, itemsize, world) == \
            getattr(jqc, fn)(numel, precision, bs, itemsize, world)


@pytest.mark.parametrize("precision,use_bf16", [
    (None, False), (None, True), ("", True), ("int8", True),
    ("bf16", False), ("fp32", True)])
def test_resolve_precision_matches_paddle_tpu(precision, use_bf16):
    from paddle_tpu.fluid import quantized_collectives as jqc
    assert qc.resolve_precision(precision, use_bf16) == \
        jqc.resolve_precision(precision, use_bf16)


def test_resolve_precision_refuses_an_unknown_wire():
    with pytest.raises(ValueError, match="allreduce_precision"):
        qc.resolve_precision("fp8")


# ---------------------------------------------------------------------------
# Pack tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_int8_op_matches_paddle_tpu_over_two_ranks(pack, case):
    i = CASES.index(case)
    cid, op_type, attrs, shape, with_res, kind = case
    got = np.concatenate([np.asarray(r["outputs"][cid], np.float32)
                          for r in pack])
    res0 = residual_input(shape, i) if with_res else None
    want = jax_fetch(op_type, attrs, shape, with_res,
                     global_input(kind, shape, i), res0)
    assert got.shape == want[0].shape
    if cid in BF16_CASES:
        np.testing.assert_allclose(got, want[0], rtol=BF16_RTOL, atol=1e-6)
        return
    # the blocks and scales are JAX's bit for bit; what follows may
    # differ by XLA's fused multiply-adds (one fp32 rounding of a partial
    # sum moves a block's scale by an ulp): INT8_ROUNDINGS roundings of
    # the largest value
    bound = INT8_ROUNDINGS * 2.0 ** -24 * np.abs(want[0]).max()
    np.testing.assert_allclose(got, want[0], rtol=0, atol=bound)
    if with_res:
        # JAX fetches the replicas' residuals concatenated too
        got_res = np.concatenate([np.asarray(r["residuals"][cid],
                                             np.float32) for r in pack])
        x = global_input(kind, shape, i)
        np.testing.assert_allclose(
            got_res, want[1], rtol=0,
            atol=INT8_ROUNDINGS * 2.0 ** -24 * np.abs(x).max())
        # error feedback is live: the residual moved
        assert not np.array_equal(got_res[:len(res0)], res0)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_int8_op_counts_the_wire_bytes_of_paddle_tpu(pack, cid):
    from paddle_tpu.fluid import quantized_collectives as jqc
    _c, op_type, attrs, shape, _r, _k = CASES[[c[0] for c in CASES]
                                              .index(cid)]
    bs = attrs.get("quant_block_size", 256)
    numel = int(np.prod(shape))
    species = {"c_allreduce_sum": "allreduce", "c_reducescatter":
               "reducescatter", "c_allgather": "allgather"}[op_type]
    if cid in BF16_CASES:
        nbytes = 2 * numel * (NPROC if species == "allgather" else 1)
        want = {species + "_bf16": nbytes}
    elif species == "allreduce":
        want = {"allreduce_int8": jqc.allreduce_wire_bytes(
            numel, "int8", bs, world_size=NPROC)}
    elif species == "allgather":
        want = {"allgather_int8": jqc.phase_wire_bytes(
            numel * NPROC, "int8", bs)}
    else:
        want = {"reducescatter_int8": jqc.phase_wire_bytes(
            numel, "int8", bs)}
    for r in pack:
        assert r["comm"][cid] == want


def test_int8_wire_is_about_a_quarter_of_fp32(pack):
    numel = 2 * 600
    int8 = pack[0]["comm"]["allreduce"]["allreduce_int8"]
    fp32 = qc.allreduce_wire_bytes(numel, "fp32")
    assert 0.25 <= int8 / fp32 < 0.34


def test_int8_on_a_hierarchical_ring_is_the_bf16_cast(pack):
    got = np.concatenate([np.asarray(r["outputs"]["allreduce_hier_is_bf16"],
                                     np.float32) for r in pack])
    x = global_input("randn", (2, 600), 0)
    want, = jax_fetch("c_allreduce_sum", {}, (2, 600), False, x, hier=2)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    by, by_axis = pack[0]["comm"]["allreduce_hier_is_bf16"]
    assert by == {"allreduce_bf16": 2 * 2 * 2 * 600}
    # two nodes of one rank: the whole exchange is across nodes
    assert by_axis == {"dcn": 2 * 2 * 2 * 600}


def _jax_hier(nranks, nnodes):
    import paddle_tpu.fluid as jfluid
    main, startup, loss = fc_program(jfluid, nnodes, nranks)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [np.asarray(exe.run(main, feed=fc_feed(nranks),
                                 fetch_list=[loss], scope=scope)[0],
                         np.float32).reshape(-1)
              for _ in range(HIER_STEPS)]
    params = {p: np.asarray(scope.find_var(p))
              for p in ("fc_0.w_0", "fc_0.b_0")}
    return np.stack(losses), params


@pytest.mark.parametrize("nproc", [2, 4])
def test_hierarchical_allreduce_matches_flat_and_paddle_tpu(
        pack, pack4, nproc):
    ranks = pack if nproc == 2 else pack4
    hier = np.array([r["hier"] for r in ranks], np.float32).T
    flat = np.array([r["flat"] for r in ranks], np.float32).T
    np.testing.assert_array_equal(hier, flat)
    want, params = _jax_hier(nproc, 2)
    np.testing.assert_allclose(hier, want, rtol=1e-6, atol=1e-7)
    for r in ranks:
        for p, v in params.items():
            np.testing.assert_allclose(np.asarray(r["hier_params"][p],
                                                  np.float32), v, atol=1e-6)


@pytest.mark.parametrize("nproc", [2, 4])
def test_hierarchical_wire_bytes_split_per_level(pack, pack4, nproc):
    ranks = pack if nproc == 2 else pack4
    by, by_axis = ranks[0]["hier_comm"]
    flat_by, flat_axis = ranks[0]["flat_comm"]
    # the same bytes as the flat ring, attributed per level: the inner
    # level moves the whole payload, the outer the 1/per_node shard
    assert by == flat_by
    total = sum(flat_axis.values())
    assert flat_axis == {"dp": total}
    if nproc == 2:
        assert by_axis == {"dcn": total}
    else:
        assert set(by_axis) == {"dcn", "ici"}
        assert sum(by_axis.values()) == total
        assert by_axis["ici"] == round(total * 1.0 / 1.5)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
