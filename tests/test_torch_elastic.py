"""Elastic training in the port (``fluid/elastic.py``, ``restore(reshard=
True)``, the launcher's ``--max_restarts``/``--elastic_min_nproc``),
mirroring tests/test_elastic.py.

In this process (worlds of one, no process group), with paddle_tpu's
``nranks=2`` weight-update-sharding checkpoint of the Momentum MLP as the
degree-2 side: the reshard gate (refused without ``reshard=True``,
naming it and ``checkpoint_metadata``), the 2 → 1 → 2 round trip (the
port reshards the JAX checkpoint to degree 1 and pivot-saves it at once;
JAX reshards that back to degree 2 and goes on BIT-equal to its
uninterrupted run), a different bucket layout refused, mixed-degree
selection and retention, the pivot save killed at each write boundary,
and ``run_elastic`` handing ``next_world``'s spec to the next
``init``.

Three packs over gloo (this file is their worker), each rank training
the MLP through ``run_elastic`` and ``train_from_dataset(
checkpoint_manager=)`` with weight-update sharding and async pod saves:

- **shrink by relaunch**: ``launch --max_restarts 1 --elastic_min_nproc
  1``; rank 1 SIGKILLs itself after a save commits, the launcher
  relaunches a world of one, which reshard-restores 2 → 1 (parameters and
  moments bit-equal to the checkpoint's global values) and trains to the
  end — its final parameters BIT-equal to a world of one in this process
  that restores the same checkpoint and takes the same batches; no torn
  prefix is ever the latest; a ``resize`` record carries ``recovery_s``.
- **shrink in-process**: a stop on both ranks, then ``next_world`` gives
  rank 0 a world of one at a fresh rendezvous (``shutdown`` + ``init``);
  it reshard-restores the drain's final save and finishes, ``cycles`` 2
  and ``resizes`` 1.
- **expand**: two ranks reshard-restore the world of one's last save
  (1 → 2): each rank's half of the moments bit-equal to the checkpoint,
  and two more steps within ``rtol 1e-5`` of a world of one taking them.
"""

import json
import os
import signal
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import elastic, preemption, telemetry
from paddle_tpu_torch.fluid.checkpoint import (CheckpointManager,
                                               _load_manifest_entry,
                                               checkpoint_metadata,
                                               latest_checkpoint,
                                               read_manifest)
from paddle_tpu_torch.fluid.storage import (MARKER_NAME,
                                            ObjectStoreStorage)

from test_torch_checkpoint import SimulatedCrash, crash_at, truncate_file
from test_torch_collective_ops import pack_logs, run_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_weight_update_sharding import PARAMS, mlp

CPU = fluid.CPUPlace()
TOTAL, EXTRA, PERIOD, KILL_AT, STOP_AT, ROWS = 12, 2, 2, 6, 3, 8


def program(pkg, nranks, fuse=32):
    main, startup, loss = mlp(pkg, pkg.optimizer.MomentumOptimizer(0.05, 0.9))
    pkg.transpiler.GradAllReduce(
        weight_update_sharding=True, fuse_grad_size_mb=fuse).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * nranks, nranks=nranks)
    return main, startup, loss


def batch(i, rank=0, world=1):
    """Rank ``rank``'s rows of global batch ``i`` in a world of ``world``."""
    rng = np.random.RandomState(1000 + i)
    xs = rng.randn(ROWS, 16).astype(np.float32)
    ys = (xs @ np.random.RandomState(7).randn(16, 1)).astype(np.float32)
    k = ROWS // world
    return {"x": xs[rank * k:(rank + 1) * k], "y": ys[rank * k:(rank + 1) * k]}


class Batches:
    """The minimal dataset ``train_from_dataset`` reads: batches ``start``
    .. ``stop - 1``, ``on_batch(i)`` called before each is handed out."""

    def __init__(self, start, stop, rank, world, on_batch=None):
        self.start, self.stop = start, stop
        self.rank, self.world = rank, world
        self.on_batch = on_batch

    def set_thread(self, n):
        pass

    def _prepare_to_run(self):
        pass

    def _finish_to_run(self):
        pass

    def __iter__(self):
        for i in range(self.start, self.stop):
            if self.on_batch is not None:
                self.on_batch(i)
            yield batch(i, self.rank, self.world)


def _state(main, scope):
    return {v.name: scope.find_var(v.name).numpy().copy()
            for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


# ---------------------------------------------------------------------------
# The packs' worker
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(out_dir, mode):
    from paddle_tpu_torch.fluid import distributed as dist
    out_dir = Path(out_dir)
    attempt, prev = elastic.world_env()
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if world > 1:
        dist.init(backend="gloo")
    init = dict(np.load(out_dir / "init.npz"))
    exe = fluid.Executor(CPU)
    ckdir = out_dir / ("ck_expand" if mode == "expand" else "ck")
    stop = TOTAL + EXTRA if mode == "expand" else TOTAL
    log = {"attempt": attempt, "prev": prev, "cycles": []}

    def build(ctx):
        main, startup, loss = program(fluid, ctx.process_count)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.load_numpy_params(scope, init, CPU)
        mgr = CheckpointManager(str(ckdir), main_program=main, place=CPU,
                                storage=ObjectStoreStorage())
        build.loss = loss
        rec = {"world": ctx.process_count, "rank": ctx.process_index}
        latest = mgr.latest_checkpoint()
        if latest is not None:
            rec["latest"] = os.path.basename(latest)
            rec["dirs"] = {e: os.path.isfile(os.path.join(ckdir, e,
                                                          MARKER_NAME))
                           for e in sorted(os.listdir(ckdir))
                           if e.startswith("step-")}
        log["cycles"].append(rec)
        return mgr, scope, main

    def train(ctx):
        rec = log["cycles"][-1]
        start = 0
        if ctx.restored is not None:
            start = ctx.scope.step_counter - 1
            rec["restored"] = dict(step=ctx.restored["step"],
                                   path=ctx.restored["path"],
                                   resized=ctx.restored["resized"])
            np.savez(out_dir / ("restored_a%d_c%d_r%d.npz" % (
                attempt, ctx.cycle, ctx.process_index)),
                **_state(ctx.program, ctx.scope))

        def on_batch(i):
            if mode == "launch" and attempt == 0 and \
                    ctx.process_index == 1 and i == KILL_AT:
                # die once a save has committed: the launcher relaunches
                # a world of one
                ctx.manager.wait()
                if ctx.manager.last_step is not None:
                    os.kill(os.getpid(), signal.SIGKILL)
            if mode == "inproc" and ctx.cycle == 0 and i == STOP_AT:
                preemption.request_stop("capacity-lost")

        ds = Batches(start, stop, ctx.process_index, ctx.process_count,
                     on_batch)
        status = exe.train_from_dataset(
            ctx.program, ds, scope=ctx.scope, fetch_list=[build.loss],
            print_period=10 ** 9, checkpoint_manager=ctx.manager,
            checkpoint_period=PERIOD)
        ctx.manager.wait()
        if not status["preempted"] and \
                ctx.manager.last_step != ctx.scope.step_counter:
            # the end state, for the next pack and the checks
            ctx.manager.save(scope=ctx.scope, main_program=ctx.program,
                             sync=True)
        rec["status"] = status
        return status

    def next_world(ctx):
        if ctx.process_index != 0:
            return None
        return {"coordinator_address": "127.0.0.1:%d" % _free_port(),
                "num_processes": 1, "process_id": 0, "backend": "gloo"}

    status = elastic.run_elastic(
        build, train, next_world=next_world if mode == "inproc" else None)
    rank = dist.process_index()
    resizes = [e for e in telemetry.step_events() if e.get("kind") ==
               "resize"]
    log.update(status={k: v for k, v in status.items() if k != "last"},
               last=status["last"], resize=resizes[-1] if resizes else None)
    with open(out_dir / ("%s_a%d_r%d.json" % (mode, attempt, rank)),
              "w") as f:
        json.dump(log, f, default=str)
    dist.shutdown()


# ---------------------------------------------------------------------------
# The packs
# ---------------------------------------------------------------------------

def _init(d):
    import paddle_tpu.fluid as jfluid
    main, startup, _l = mlp(jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    np.savez(Path(d) / "init.npz",
             **{p: np.asarray(scope.find_var(p)) for p in PARAMS})


def _run(d, mode, nproc=2, launcher_args=()):
    proc = run_pack(Path(__file__), d, nproc=nproc, args=(mode,),
                    launcher_args=launcher_args)
    assert proc.returncode == 0, proc.stderr[-3000:] + pack_logs(d, nproc)
    return proc


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic_pack")
    _init(d)
    launch = _run(d, "launch", launcher_args=(
        "--max_restarts", "1", "--elastic_min_nproc", "1"))
    # the expand pack starts from the world of one's last checkpoint
    import shutil
    shutil.copytree(d / "ck", d / "ck_expand")
    _run(d, "expand")
    di = tmp_path_factory.mktemp("elastic_inproc")
    _init(di)
    _run(di, "inproc")

    def read(dd, name):
        return json.loads((dd / name).read_text())
    return dict(dir=d, inproc_dir=di, launch_stderr=launch.stderr,
                a1=read(d, "launch_a1_r0.json"),
                expand=[read(d, "expand_a0_r%d.json" % r) for r in range(2)],
                inproc=read(di, "inproc_a0_r0.json"),
                inproc1=read(di, "inproc_a0_r1.json"))


def _global_state(path):
    body = read_manifest(path)
    return {n: _load_manifest_entry(path, n, e)
            for n, e in body["tensors"].items()}


def _continue(path, start, stop, nranks=1):
    """A world of one restoring ``path`` (resharded) and taking batches
    ``start`` .. ``stop - 1``: (state, losses)."""
    main, startup, loss = program(fluid, nranks)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    exe.run(startup, scope=scope)
    CheckpointManager(os.path.dirname(path), place=CPU).restore(
        path, scope=scope, main_program=main, reshard=True)
    losses = [float(exe.run(main, feed=batch(i), fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for i in range(start, stop)]
    return _state(main, scope), losses


def test_launcher_relaunches_a_world_of_one(packs):
    assert "world 2 -> 1" in packs["launch_stderr"]
    a1 = packs["a1"]
    assert (a1["attempt"], a1["prev"]) == (1, 2)
    cyc, = a1["cycles"]
    assert cyc["world"] == 1 and cyc["restored"]["resized"]
    assert a1["status"]["resizes"] == 1 and not a1["status"]["preempted"]
    res = a1["resize"]
    assert (res["old_world"], res["new_world"], res["old_degree"],
            res["new_degree"]) == (2, 1, 2, 1)
    assert res["recovery_s"] > 0


def test_no_torn_checkpoint_is_ever_selected(packs):
    cyc = packs["a1"]["cycles"][0]
    committed = sorted((int(e.split("-")[1]), e)
                       for e, marked in cyc["dirs"].items() if marked)
    assert cyc["latest"] == committed[-1][1]
    assert cyc["restored"]["step"] == committed[-1][0]


def test_reshard_restore_is_the_checkpoint_bit_for_bit(packs):
    d = packs["dir"]
    path = packs["a1"]["cycles"][0]["restored"]["path"]
    want = _global_state(path)
    got = dict(np.load(d / "restored_a1_c0_r0.npz"))
    main, _s, _l = program(fluid, 1)
    for n, v in got.items():
        if n in main._wus_padded_numel:
            B = main._wus_padded_numel[n]
            np.testing.assert_array_equal(v[:B], want[n][:B], err_msg=n)
        else:
            np.testing.assert_array_equal(v, want[n], err_msg=n)


def test_shrunk_world_ends_where_a_world_of_one_does(packs):
    a1 = packs["a1"]
    path = a1["cycles"][0]["restored"]["path"]
    step = a1["cycles"][0]["restored"]["step"]
    state, _l = _continue(path, step - 1, TOTAL)
    final = _global_state(latest_checkpoint(str(packs["dir"] / "ck"),
                                            storage=ObjectStoreStorage()))
    assert a1["last"]["steps"] == TOTAL - (step - 1)
    for p in PARAMS:
        np.testing.assert_array_equal(final[p], state[p], err_msg=p)


def test_expand_reshards_one_to_two(packs):
    d = packs["dir"]
    e0, e1 = packs["expand"]
    for e in (e0, e1):
        cyc, = e["cycles"]
        assert cyc["world"] == 2 and cyc["restored"]["resized"]
    path = e0["cycles"][0]["restored"]["path"]
    want = _global_state(path)
    halves = [dict(np.load(d / ("restored_a0_c0_r%d.npz" % r)))
              for r in range(2)]
    main, _s, _l = program(fluid, 2)
    for n in main._dp_sharded_state:
        B = main._wus_padded_numel[n]
        got = np.concatenate([h[n] for h in halves])
        np.testing.assert_array_equal(got[:B], want[n][:B], err_msg=n)
    step = e0["cycles"][0]["restored"]["step"]
    state, _losses = _continue(path, step - 1, TOTAL + EXTRA)
    assert e0["last"]["steps"] == EXTRA
    final = _global_state(latest_checkpoint(
        str(d / "ck_expand"), storage=ObjectStoreStorage()))
    for p in PARAMS:
        np.testing.assert_allclose(final[p], state[p], rtol=1e-5,
                                   atol=1e-6, err_msg=p)


def test_run_elastic_resizes_in_process(packs):
    r0, r1 = packs["inproc"], packs["inproc1"]
    assert r1["status"]["cycles"] == 1 and r1["status"]["preempted"]
    assert r0["status"]["cycles"] == 2 and r0["status"]["resizes"] == 1
    assert [c["world"] for c in r0["cycles"]] == [2, 1]
    assert r0["cycles"][0]["status"]["preempted"]
    assert r0["last"] == {"steps": TOTAL - (r0["status"]["restored_step"]
                                            - 1),
                          "preempted": False, "rollbacks": 0}
    assert r0["resize"]["old_world"] == 2 and r0["resize"]["new_world"] == 1


# ---------------------------------------------------------------------------
# In-process: the JAX package's degree-2 checkpoints in worlds of one
# ---------------------------------------------------------------------------

def _jax(tmp, steps=3, save=True):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.checkpoint import CheckpointManager as JMgr
    main, startup, loss = program(jfluid, 2)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = dict(np.load(tmp / "init.npz")) if (tmp / "init.npz").exists() \
        else None
    if init:
        for k, v in init.items():
            scope.set_var(k, v)
    for i in range(steps):
        exe.run(main, feed=batch(i), fetch_list=[loss], scope=scope)
    path = JMgr(str(tmp / "a"), scope=scope, main_program=main,
                async_save=False).save() if save else None
    return dict(main=main, scope=scope, exe=exe, loss=loss, path=path)


def _jax_steps(j, scope, start, n):
    return [[float(x) for x in np.ravel(np.asarray(
        j["exe"].run(j["main"], feed=batch(i), fetch_list=[j["loss"]],
                     scope=scope)[0]))] for i in range(start, start + n)]


def test_reshard_gate_and_the_round_trip_through_the_port(tmp_path):
    from paddle_tpu.fluid.checkpoint import CheckpointManager as JMgr
    _init(tmp_path)
    j = _jax(tmp_path)
    control = _jax_steps(j, j["scope"], 3, 3)
    main, startup, _l = program(fluid, 1)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    mgr = CheckpointManager(str(tmp_path / "a"), place=CPU)
    for match in ("world size", "reshard=True", "checkpoint_metadata"):
        with pytest.raises(RuntimeError, match=match):
            mgr.resume(scope=scope, main_program=main)
    info = checkpoint_metadata(j["path"])
    assert info["shard_degree"] == 2 and not info["multihost"]
    assert "wus_velocity_0" in info["sharded_vars"]
    meta = mgr.resume(scope=scope, main_program=main, reshard=True)
    assert meta["resharded"] and meta["shard_degree"] == 2
    # the pivot: saved at degree 1 at once, restored by JAX at degree 2
    pivot = CheckpointManager(str(tmp_path / "b"), place=CPU,
                              async_save=False).save(scope=scope,
                                                     main_program=main)
    assert checkpoint_metadata(pivot)["shard_degree"] == 1
    j2 = _jax(tmp_path, steps=0, save=False)
    meta = JMgr(str(tmp_path / "b"), main_program=j2["main"]).resume(
        scope=j2["scope"], reshard=True)
    assert meta["resharded"]
    assert _jax_steps(j2, j2["scope"], 3, 3) == control


def test_reshard_refuses_a_different_bucket_layout(tmp_path):
    _init(tmp_path)
    _jax(tmp_path, steps=1)
    main, startup, _l = program(fluid, 1, fuse=0)
    with pytest.raises(RuntimeError, match="bucket layouts differ"):
        CheckpointManager(str(tmp_path / "a"), place=CPU).resume(
            scope=fluid.Scope(), main_program=main, reshard=True)


def test_mixed_degree_selection_and_gc(tmp_path):
    import shutil
    _init(tmp_path)
    d = str(tmp_path / "a")
    p_old = _jax(tmp_path, steps=1)["path"]
    main, startup, _l = program(fluid, 1)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    mgr = CheckpointManager(d, place=CPU, async_save=False, max_to_keep=2)
    mgr.resume(scope=scope, main_program=main, reshard=True)
    scope.step_counter += 5
    p_new = mgr.save(scope=scope, main_program=main)
    p_torn = os.path.join(d, "step-%d" % (scope.step_counter + 5))
    shutil.copytree(p_old, p_torn)
    truncate_file(os.path.join(p_torn, "MANIFEST.json"))
    assert latest_checkpoint(d) == p_new
    assert checkpoint_metadata(p_old)["shard_degree"] == 2
    assert checkpoint_metadata(p_new)["shard_degree"] == 1
    mgr.gc()
    assert os.path.isdir(p_old) and os.path.isdir(p_new)
    CheckpointManager(d, place=CPU, max_to_keep=1).gc()
    assert not os.path.isdir(p_old) and os.path.isdir(p_new)
    assert latest_checkpoint(d) == p_new


@pytest.mark.parametrize("point", ["tensor:", "manifest_mid", "marker:"])
def test_pivot_save_kill_matrix_keeps_fallback(tmp_path, point):
    _init(tmp_path)
    _jax(tmp_path, steps=2)
    store = ObjectStoreStorage()
    main, startup, _l = program(fluid, 1)
    scope = fluid.Scope()
    fluid.Executor(CPU).run(startup, scope=scope)
    CheckpointManager(str(tmp_path / "a"), place=CPU).resume(
        scope=scope, main_program=main, reshard=True)
    mgr_b = CheckpointManager(str(tmp_path / "b"), place=CPU,
                              async_save=False, storage=store)
    with crash_at(point):
        with pytest.raises(SimulatedCrash):
            mgr_b.save(scope=scope, main_program=main)
    assert latest_checkpoint(str(tmp_path / "b"), storage=store) is None
    meta = CheckpointManager(str(tmp_path / "a"), place=CPU).resume(
        scope=fluid.Scope(), main_program=main, reshard=True)
    assert meta["resharded"]
    mgr_b.save(scope=scope, main_program=main)
    p = latest_checkpoint(str(tmp_path / "b"), storage=store)
    assert checkpoint_metadata(p)["shard_degree"] == 1


def test_distributed_shutdown_world_of_one_and_reinit():
    from paddle_tpu_torch.fluid import distributed as dist
    assert dist.init() == (0, 1)
    dist.shutdown()
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert telemetry.process_label() is None
    assert dist.init() == (0, 1)


def test_run_elastic_carries_next_world_spec_to_reinit(tmp_path,
                                                       monkeypatch):
    from paddle_tpu_torch.fluid import distributed as dist
    calls = []
    real_init = dist.init

    def recording_init(**kw):
        calls.append(dict(kw))
        return real_init(**kw)

    monkeypatch.setattr(dist, "init", recording_init)

    def build(ctx):
        prog = fluid.Program()
        return CheckpointManager(str(tmp_path / "ck"), place=CPU), \
            fluid.Scope(), prog

    def train(ctx):
        return {"steps": 0, "preempted": ctx.cycle == 0, "rollbacks": 0}

    spec = {"num_processes": 1, "process_id": 0}
    status = elastic.run_elastic(
        build, train,
        next_world=lambda ctx: dict(spec) if ctx.cycle == 0 else None)
    assert status["cycles"] == 2 and status["resizes"] == 0
    assert calls == [{}, spec]


def test_world_env_reads_the_launchers_variables(monkeypatch):
    monkeypatch.delenv("PADDLE_ELASTIC_ATTEMPT", raising=False)
    monkeypatch.delenv("PADDLE_ELASTIC_PREV_NPROC", raising=False)
    assert elastic.world_env() == (0, None)
    monkeypatch.setenv("PADDLE_ELASTIC_ATTEMPT", "2")
    monkeypatch.setenv("PADDLE_ELASTIC_PREV_NPROC", "4")
    assert elastic.world_env() == (2, 4)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2], sys.argv[3])
