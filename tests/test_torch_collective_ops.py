"""The port's c_* collective ops (``paddle_tpu_torch/fluid/ops/
collective_ops.py``) in a world of two ranks against paddle_tpu's.

The port runs one process per rank: a module-scoped fixture launches ONE
2-process pack (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2``, gloo on the CPU; this file is its worker script)
and every test reads the pack's per-rank results.  Each case is a
one-op program; rank r is fed rows [2r, 2r + 2) of a global [4, 6]
input.  The JAX package runs the same program marked for 2 ranks on two
devices of the virtual CPU mesh, fed the whole [4, 6], and fetches the
replicas' outputs concatenated — which the ranks' outputs, concatenated,
must equal: exactly on the fp32 wire (the prod within 1e-6: the port
multiplies, JAX takes exp(sum(log))), within one bf16 rounding (2^-8
relative) on the bf16 wire.

The pack also checks what only a world of ranks has: a second ring
built by ``c_comm_init``, the calls and wire bytes each op counts, the
executor's refusal of a program transpiled for another rank count, and
``fluid.distributed``'s consensus helpers.  In this process (a world of
one, no process group) every op is the identity, the int8 wire and an
error-feedback residual included (the residual passes through), and the
item-11 ops raise.  The int8 wire over two ranks is
tests/test_torch_quantized_collectives.py.  The pytest process never
creates a process group: all world > 1 work runs in the pack's
processes.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NPROC, ROWS, COLS = 2, 2, 6
BF16_RTOL = 2.0 ** -8

# (case id, op type, attrs, input kind)
CASES = [
    ("allreduce_sum", "c_allreduce_sum", {}, "randn"),
    ("allreduce_sum_bf16", "c_allreduce_sum", {"precision": "bf16"},
     "randn"),
    ("allreduce_sum_use_bf16", "c_allreduce_sum", {"use_bf16": True},
     "randn"),
    ("allreduce_max", "c_allreduce_max", {}, "randn"),
    ("allreduce_max_bf16", "c_allreduce_max", {"precision": "bf16"},
     "randn"),
    ("allreduce_min", "c_allreduce_min", {}, "randn"),
    ("allreduce_prod", "c_allreduce_prod", {}, "positive"),
    ("allreduce_prod_bf16", "c_allreduce_prod", {"precision": "bf16"},
     "positive"),
    ("broadcast_root1", "c_broadcast", {"root": 1}, "randn"),
    ("broadcast_root1_bf16", "c_broadcast",
     {"root": 1, "precision": "bf16"}, "randn"),
    ("allgather", "c_allgather", {}, "randn"),
    ("allgather_bf16", "c_allgather", {"precision": "bf16"}, "randn"),
    ("reducescatter", "c_reducescatter", {}, "randn"),
    ("reducescatter_bf16", "c_reducescatter", {"precision": "bf16"},
     "randn"),
    ("shard_slice", "c_shard_slice", {}, "randn"),
    ("local_sgd_sync", "local_sgd_sync", {"k_steps": 1}, "randn"),
    ("legacy_allreduce", "allreduce", {}, "randn"),
    ("legacy_broadcast", "broadcast", {"root": 1}, "randn"),
    ("sync_calc_stream", "c_sync_calc_stream", {}, "randn"),
    ("sync_comm_stream", "c_sync_comm_stream", {}, "randn"),
    ("wait_compute", "c_wait_compute", {}, "randn"),
    ("alltoall", "c_alltoall", {}, "randn"),
    ("alltoall_bf16", "c_alltoall", {"precision": "bf16"}, "randn"),
    ("alltoall_int8", "c_alltoall", {"precision": "int8"}, "randn"),
]
BF16_CASES = {c[0] for c in CASES if c[0].endswith("bf16")} - {
    "allreduce_max_bf16", "broadcast_root1_bf16"}   # these stay exact


def global_input(kind, seed):
    rng = np.random.RandomState(seed)
    shape = (NPROC * ROWS, COLS)
    if kind == "positive":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def one_op_program(pkg, op_type, attrs, ring_id=0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[COLS], dtype="float32")
        block = main.global_block()
        out = block.create_var(name="out", dtype="float32")
        block.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                        attrs=dict(attrs, ring_id=ring_id))
    return main


# ---------------------------------------------------------------------------
# The pack: launcher and worker
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_pack(script, out_dir, nproc=NPROC, args=(), launcher_args=()):
    """Start ``script worker <out_dir> args...`` as ``nproc`` ranks under
    the port's launcher (gloo rendezvous on a free port) and return the
    launcher's Popen without waiting.  Each rank's output is in
    ``out_dir/logs/workerlog.<rank>``."""
    out_dir = Path(out_dir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # one intra-op thread a rank: the programs are tiny, and the pack
    # shares the host's cores with the other test workers
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc),
           "--coordinator", "127.0.0.1:%d" % free_port(),
           "--log_dir", str(out_dir / "logs"), "--grace_period", "5",
           *launcher_args, str(script), "worker", str(out_dir), *args]
    return subprocess.Popen(cmd, env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait_pack(proc, timeout=240):
    """The CompletedProcess of a :func:`start_pack` launcher; on a
    timeout the launcher is killed and TimeoutExpired raised."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_pack(script, out_dir, nproc=NPROC, args=(), launcher_args=(),
             timeout=240):
    """Run ``script worker <out_dir> args...`` as ``nproc`` ranks under
    the port's launcher and wait for it (:func:`start_pack`)."""
    return wait_pack(start_pack(script, out_dir, nproc, args,
                                launcher_args), timeout)


def pack_logs(out_dir, nproc=NPROC):
    logs = []
    for r in range(nproc):
        p = Path(out_dir) / "logs" / ("workerlog.%d" % r)
        logs.append(p.read_text()[-3000:] if p.exists() else "")
    return "\n".join(logs)


def worker(out_dir):
    from paddle_tpu_torch.fluid import distributed as dist, telemetry
    from paddle_tpu_torch.fluid.ops import collective_ops
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    rank, n = dist.init(place=fluid.CPUPlace())
    exe = fluid.Executor(fluid.CPUPlace())
    res = {"rank": rank, "world": n, "backend": dist.backend(),
           "outputs": {}, "calls": {}, "comm": {}}
    for i, (cid, op_type, attrs, kind) in enumerate(CASES):
        x = global_input(kind, i)[rank * ROWS:(rank + 1) * ROWS]
        collective_ops.reset_calls()
        n0 = telemetry.step_events_recorded()
        out, = exe.run(one_op_program(fluid, op_type, attrs), feed={"x": x},
                       fetch_list=["out"], scope=fluid.Scope())
        res["outputs"][cid] = out.tolist()
        res["calls"][cid] = dict(collective_ops.calls)
        ev = [e for e in telemetry.step_events()[-1:]
              if telemetry.step_events_recorded() > n0]
        res["comm"][cid] = dict(ev[0]["comm_by"] or {}) if ev else None
    # a second ring, built by the startup's c_comm_init
    startup = fluid.Program()
    startup.global_block().append_op(
        "c_comm_init", attrs={"nranks": n, "rank": rank, "ring_id": 1})
    exe.run(startup, scope=fluid.Scope())
    x = global_input("randn", 0)[rank * ROWS:(rank + 1) * ROWS]
    out, = exe.run(one_op_program(fluid, "c_allreduce_sum", {}, ring_id=1),
                   feed={"x": x}, fetch_list=["out"], scope=fluid.Scope())
    res["ring1_allreduce"] = out.tolist()
    try:
        exe.run(one_op_program(fluid, "c_allreduce_sum", {}, ring_id=2),
                feed={"x": x}, fetch_list=["out"], scope=fluid.Scope())
        res["unknown_ring"] = None
    except RuntimeError as e:
        res["unknown_ring"] = str(e)
    # a program transpiled for another rank count is refused
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start), fluid.unique_name.guard():
        xv = fluid.layers.data(name="x", shape=[COLS], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(xv, size=1))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    GradAllReduce().transpile(start, main, rank=rank, endpoints=["a"] * 3)
    try:
        exe.run(start, scope=fluid.Scope())
        res["wrong_world"] = None
    except RuntimeError as e:
        res["wrong_world"] = str(e)
    res["consensus"] = list(dist.consensus_flags(rank == 1, False))
    res["any"] = dist.any_process(rank == 0)
    res["equal_ok"] = dist.all_processes_equal(7, "seven")
    try:
        dist.all_processes_equal(rank, "rank")
        res["equal_differs"] = None
    except RuntimeError as e:
        res["equal_differs"] = str(e)
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f, default=str)
    dist.shutdown()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("collective_pack")
    proc = run_pack(Path(__file__), out_dir)
    assert proc.returncode == 0, proc.stderr[-3000:] + pack_logs(out_dir)
    return [json.loads((out_dir / ("rank%d.json" % r)).read_text())
            for r in range(NPROC)]


def jax_fetch(op_type, attrs, x):
    """The JAX package's fetch of the one-op program over 2 devices of
    the virtual mesh (replicas' outputs concatenated)."""
    import paddle_tpu.fluid as jfluid
    main = one_op_program(jfluid, op_type, attrs)
    main._use_collective = True
    main._collective_nranks = NPROC
    main._collective_rings = {0: "dp"}
    out, = jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=["out"], scope=jfluid.Scope())
    return np.asarray(out, dtype=np.float32)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_paddle_tpu_over_two_ranks(pack, case):
    i = CASES.index(case)
    cid, op_type, attrs, kind = case
    got = np.concatenate([np.asarray(r["outputs"][cid], np.float32)
                          for r in pack])
    want = jax_fetch(op_type, attrs, global_input(kind, i))
    assert got.shape == want.shape
    if cid in BF16_CASES:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    elif op_type == "c_allreduce_prod" or cid.endswith("int8"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_bf16_wire_really_rounds(pack):
    """The bf16 sum is not the exact sum of its inputs (the cast is
    real); the max and broadcast cases above hold exactly with the knob
    set."""
    i = [c[0] for c in CASES].index("allreduce_sum_bf16")
    x = global_input("randn", i)
    exact = x[:ROWS] + x[ROWS:]
    got = np.asarray(pack[0]["outputs"]["allreduce_sum_bf16"], np.float32)
    assert not np.array_equal(got, exact)
    np.testing.assert_allclose(got, exact, rtol=2 * BF16_RTOL, atol=1e-2)


def test_pack_ran_two_gloo_ranks(pack):
    assert [r["rank"] for r in pack] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in pack)


@pytest.mark.parametrize("cid,species,nbytes", [
    ("allreduce_sum", "allreduce_fp32", 2 * 4 * ROWS * COLS),
    ("allreduce_sum_bf16", "allreduce_bf16", 2 * 2 * ROWS * COLS),
    ("broadcast_root1", "broadcast_fp32", 2 * 4 * ROWS * COLS),
    ("allgather", "allgather_fp32", NPROC * 4 * ROWS * COLS),
    ("reducescatter_bf16", "reducescatter_bf16", 2 * ROWS * COLS),
    ("alltoall", "a2a_fp32", 4 * ROWS * COLS),
    ("alltoall_int8", "a2a_int8", ROWS * COLS + 4 * ROWS),
])
def test_each_collective_counts_one_call_and_its_wire_bytes(
        pack, cid, species, nbytes):
    op_type = dict((c[0], c[1]) for c in CASES)[cid]
    for r in pack:
        assert r["calls"][cid] == {op_type: 1}
        assert r["comm"][cid] == {species: nbytes}


def test_pass_through_ops_issue_nothing(pack):
    for cid in ("sync_calc_stream", "sync_comm_stream", "wait_compute",
                "shard_slice"):
        assert pack[0]["calls"][cid] == {}
        assert pack[0]["comm"][cid] == {}


def test_second_ring_from_c_comm_init(pack):
    want = global_input("randn", 0)
    want = np.tile(want[:ROWS] + want[ROWS:], (1, 1))
    for r in pack:
        np.testing.assert_array_equal(
            np.asarray(r["ring1_allreduce"], np.float32), want)
        assert "ring_id 2 has no process group" in r["unknown_ring"]


def test_program_for_another_rank_count_is_refused(pack):
    for r in pack:
        assert "transpiled for nranks=3" in r["wrong_world"]
        assert "world of 2" in r["wrong_world"]


def test_consensus_helpers(pack):
    for r in pack:
        assert r["consensus"] == [True, False]
        assert r["any"] is True
        assert r["equal_ok"] == 7
        assert "rank differs across processes" in r["equal_differs"]


def test_world_of_one_ops_are_identity():
    x = global_input("randn", 3)[:ROWS]
    exe = fluid.Executor(fluid.CPUPlace())
    for _cid, op_type, attrs, _k in CASES:
        out, = exe.run(one_op_program(fluid, op_type, attrs), feed={"x": x},
                       fetch_list=["out"], scope=fluid.Scope())
        np.testing.assert_array_equal(out, x)
    assert "torch.distributed" not in sys.modules or \
        not sys.modules["torch.distributed"].is_initialized()


@pytest.mark.parametrize("op_type,attrs,item", [
    ("c_alltoall", {}, "item 11"),
    ("ring_attention", {}, "item 11"),
])
def test_unported_collectives_raise_naming_their_item(op_type, attrs, item):
    """The two ops of ROADMAP ``item`` that used to raise run now: with no
    process group ``c_alltoall`` is the identity and ``ring_attention``
    is local attention, as the JAX ops are outside a mapped axis (their
    two-rank runs: the ``alltoall`` cases above and
    tests/test_torch_sequence_parallel.py)."""
    exe = fluid.Executor(fluid.CPUPlace())
    if op_type == "c_alltoall":
        x = global_input("randn", 5)[:ROWS]
        out, = exe.run(one_op_program(fluid, op_type, attrs),
                       feed={"x": x}, fetch_list=["out"],
                       scope=fluid.Scope())
        np.testing.assert_array_equal(out, x)
        return
    import paddle_tpu.fluid as jfluid
    rng = np.random.RandomState(3)
    feed = {n: rng.randn(2, 8, 2, 4).astype(np.float32) for n in "qkv"}
    got = []
    for pkg in (jfluid, fluid):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            vs = [pkg.layers.data(name=n, shape=[2, 8, 2, 4],
                                  dtype="float32", append_batch_size=False)
                  for n in "qkv"]
            out = main.current_block().create_var(name="attn_out",
                                                  dtype="float32")
            main.current_block().append_op(
                op_type, inputs={"Q": [vs[0]], "K": [vs[1]], "V": [vs[2]]},
                outputs={"Out": [out]}, attrs=dict(attrs, causal=True))
        got.append(np.asarray(pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=[out], scope=pkg.Scope())[0]))
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op_type", ["c_allreduce_sum", "c_allgather",
                                     "c_reducescatter"])
def test_world_of_one_int8_with_residual_is_identity(op_type):
    """With no process group the int8 wire is the identity and the
    error-feedback residual passes through unchanged, as the JAX ops do
    outside a mapped context."""
    main = one_op_program(fluid, op_type, {"precision": "int8"})
    block = main.global_block()
    block.create_var(name="res", dtype="float32", persistable=True)
    block.ops[-1].inputs["Residual"] = ["res"]
    block.ops[-1].outputs["ResidualOut"] = ["res"]
    scope = fluid.Scope()
    res = torch.from_numpy(global_input("randn", 9)[:ROWS])
    scope.set_var("res", res.clone())
    x = global_input("randn", 8)[:ROWS]
    out, got_res = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=["out", "res"], scope=scope)
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(got_res, res.numpy())


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
