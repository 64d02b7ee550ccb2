"""Pod checkpoints in the port (``fluid/checkpoint.py`` in a world of
several ranks, ``fluid/storage.py``'s lease, reaper age and mixed
reader), mirroring the checkpoint tests of tests/test_multihost.py
(:444-980), and checkpoints crossing between the packages.

Ranks are simulated in this process: one ``CheckpointManager`` per rank
with a pinned ``process_index``/``process_count``, run on threads with a
``threading.Barrier`` as the protocol's fence (the barriered save), or
with every collective hook raising (the async save, which must agree
through storage alone).  The fault hooks of tests/test_torch_checkpoint
.py kill, fail or park a save at each write boundary.

- The barriered save round-trips; the chief refuses to commit while a
  rank's manifest is missing; a kill at every new write boundary (a
  rank's tensor, either rank's manifest, the merged manifest, the marker)
  never leaves a selectable torn step; doctored files (a flipped marker,
  a lost rank manifest) are refused; one rank's failed upload aborts the
  save on every rank; a ``LocalStorage`` manager switching to the marker
  protocol keeps its rename-committed checkpoints; ``save(sync=True)``
  runs the barriered protocol to its end.
- The async save commits with no collective and restores bit for bit;
  while a rank's upload is parked the prefix is invisible and later scope
  changes do not leak into it; a dead rank, a dead chief and a wedged
  rank each cost one abandoned prefix, never a hang; the reaper spares a
  young markerless prefix and reaps it once old.
- Sharded state (weight-update sharding over 2 ranks): each rank writes
  its slice with its index range, and a restore keeps each rank's slice.
- Across the packages, bit for bit: a paddle_tpu checkpoint of an
  ``nranks=2`` weight-update-sharding job restores into the port at
  degree 2 (each rank's half) and, with ``reshard=True``, at degree 1,
  where training goes on (losses within ``rtol 1e-5`` of JAX going on at
  degree 2); a pod checkpoint the port's two ranks wrote restores into
  paddle_tpu, whose ``checkpoint_metadata`` reads it as a world of two.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import flags, telemetry
from paddle_tpu_torch.fluid.checkpoint import (CheckpointManager,
                                               checkpoint_metadata,
                                               latest_checkpoint,
                                               read_manifest,
                                               snapshot_addressable,
                                               validate_checkpoint)
from paddle_tpu_torch.fluid.storage import (MARKER_NAME,
                                            ObjectStoreStorage)

from test_torch_checkpoint import (SimulatedCrash, _scope_with,
                                   _state_program, block_at, crash_at,
                                   flip_byte, raise_at)
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_weight_update_sharding import (PARAMS, feeds, mlp,
                                               transpile)

CPU = fluid.CPUPlace()


def _tiny_state(step=3):
    return _state_program(), _scope_with(1, step)


def _values(scope):
    return {n: scope.find_var(n).numpy().copy() for n in scope.var_names()}


def _world(dirname, scope, program, count=2, async_save=False,
           barrier=None, consensus=None, scopes=None):
    return [CheckpointManager(dirname, storage=ObjectStoreStorage(),
                              scope=scopes[i] if scopes else scope,
                              main_program=program, process_index=i,
                              process_count=count, async_save=async_save,
                              barrier=barrier, consensus=consensus,
                              place=CPU)
            for i in range(count)]


def _on_threads(mgrs, fn):
    errs = {}

    def run(i, m):
        try:
            fn(m)
        except BaseException as e:       # noqa: BLE001 — surfaced below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i, m))
               for i, m in enumerate(mgrs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return errs


def _threaded_world_save(dirname, scope, program, count=2, scopes=None):
    """A barriered pod save with every rank live: one thread per rank."""
    bar = threading.Barrier(count)
    mgrs = _world(dirname, scope, program, count,
                  barrier=lambda name: bar.wait(60), scopes=scopes)
    errs = _on_threads(mgrs, lambda m: m.save())
    assert not errs, errs
    return mgrs


def _phase_save(dirname, scope, program):
    """The pod save's phases in protocol order, one after another, for a
    simulated world of two: the fault hooks see the write boundaries a
    real pack fires."""
    m0, m1 = _world(dirname, scope, program)
    store = m0._shared_prefix_storage()
    final = os.path.join(dirname, "step-%d" % scope.step_counter)
    meta = {"step": int(scope.step_counter),
            "step_counter": int(scope.step_counter),
            "timestamp": time.time()}
    names = m0._persistable_names(program)
    store.begin(final)                                          # chief
    full, shards = snapshot_addressable(scope, names, program, 1,
                                        want_full=False)
    m1._mh_write_local(store, final, 1, full, shards, meta)     # rank 1
    full, shards = snapshot_addressable(scope, names, program, 0)
    m0._mh_write_local(store, final, 0, full, shards, meta)     # chief
    m0._mh_commit(store, final, 2, meta)                        # chief
    return final


def _latest(d):
    return latest_checkpoint(d, storage=ObjectStoreStorage())


# ---------------------------------------------------------------------------
# The barriered save
# ---------------------------------------------------------------------------

def test_simulated_world_save_restore_round_trip(tmp_path):
    program, scope = _tiny_state()
    mgrs = _threaded_world_save(str(tmp_path), scope, program)
    path = mgrs[0].latest_checkpoint()
    assert path is not None
    body = read_manifest(path)
    assert body["multihost"] == {"process_count": 2, "manifests": [
        "MANIFEST.p0.json", "MANIFEST.p1.json"]}
    assert all(m.last_step == 3 for m in mgrs)
    fresh = fluid.Scope()
    meta = mgrs[1].restore(path, scope=fresh, main_program=program)
    assert (meta["step"], meta["process_count"]) == (3, 2)
    for n, v in _values(scope).items():
        np.testing.assert_array_equal(fresh.find_var(n).numpy(), v)


def test_chief_commit_aborts_when_worker_manifest_missing(tmp_path):
    program, scope = _tiny_state()
    m0, m1 = _world(str(tmp_path), scope, program)
    store = m0._shared_prefix_storage()
    final = os.path.join(str(tmp_path), "step-3")
    meta = {"step": 3, "step_counter": 3, "timestamp": time.time()}
    store.begin(final)
    names = m0._persistable_names(program)
    full, shards = snapshot_addressable(scope, names, program, 0)
    m0._mh_write_local(store, final, 0, full, shards, meta)
    with pytest.raises((RuntimeError, ValueError), match="manifest"):
        m0._mh_commit(store, final, 2, meta)
    assert not os.path.exists(os.path.join(final, MARKER_NAME))
    assert _latest(str(tmp_path)) is None
    m1._mh_write_local(store, final, 1, {}, shards, meta)
    m0._mh_commit(store, final, 2, meta)
    assert validate_checkpoint(final, storage=ObjectStoreStorage())


@pytest.mark.parametrize("point", ["tensor:", "pmanifest:p1",
                                   "pmanifest:p0", "manifest_mid",
                                   "marker:"])
def test_simulated_world_kill_matrix_never_selects_torn(tmp_path, point):
    program, scope = _tiny_state()
    good = _threaded_world_save(str(tmp_path), scope,
                                program)[0].latest_checkpoint()
    assert good is not None
    scope.step_counter += 1
    with crash_at(point):
        with pytest.raises(SimulatedCrash):
            _phase_save(str(tmp_path), scope, program)
    assert _latest(str(tmp_path)) == good


def test_committed_pod_ckpt_with_doctored_files_is_not_selected(tmp_path):
    program, scope = _tiny_state()
    path = _threaded_world_save(str(tmp_path), scope,
                                program)[0].latest_checkpoint()
    store = ObjectStoreStorage()
    flip_byte(os.path.join(path, MARKER_NAME))
    assert not validate_checkpoint(path, storage=store)
    assert _latest(str(tmp_path)) is None
    _threaded_world_save(str(tmp_path), scope, program)
    path = _latest(str(tmp_path))
    assert path is not None
    os.unlink(os.path.join(path, "MANIFEST.p1.json"))
    assert not validate_checkpoint(path, storage=store)
    assert _latest(str(tmp_path)) is None


class _ThreadConsensus:
    """The global OR of ``fluid.distributed.any_process`` across threads."""

    def __init__(self, n):
        self._lock = threading.Lock()
        self._vals = []
        self._deposit = threading.Barrier(n)
        self._read = threading.Barrier(n, action=self._vals.clear)

    def __call__(self, value):
        with self._lock:
            self._vals.append(bool(value))
        self._deposit.wait(60)
        result = any(self._vals)
        self._read.wait(60)
        return result


def test_pod_save_aborts_every_process_when_one_upload_fails(tmp_path):
    program, scope = _tiny_state()
    good = _threaded_world_save(str(tmp_path), scope,
                                program)[0].latest_checkpoint()
    scope.step_counter += 1
    bar = threading.Barrier(2)
    mgrs = _world(str(tmp_path), scope, program,
                  barrier=lambda name: bar.wait(60),
                  consensus=_ThreadConsensus(2))
    with raise_at("pmanifest:p1"):
        errs = _on_threads(mgrs, lambda m: m.save())
    assert set(errs) == {0, 1}
    assert isinstance(errs[1], OSError)
    assert "sibling process failed" in str(errs[0])
    torn = os.path.join(str(tmp_path), "step-%d" % scope.step_counter)
    assert not os.path.exists(os.path.join(torn, MARKER_NAME))
    assert _latest(str(tmp_path)) == good


def test_pod_upgrade_preserves_rename_committed_checkpoints(tmp_path):
    program, scope = _tiny_state()
    legacy = CheckpointManager(str(tmp_path), async_save=False, scope=scope,
                               main_program=program, place=CPU).save()
    assert not os.path.exists(os.path.join(legacy, MARKER_NAME))
    scope.step_counter += 1
    bar = threading.Barrier(2)
    mgrs = [CheckpointManager(str(tmp_path), scope=scope,
                              main_program=program, process_index=i,
                              process_count=2, async_save=False,
                              barrier=lambda name: bar.wait(60), place=CPU)
            for i in range(2)]

    def save(m):
        with pytest.warns(UserWarning, match="marker protocol"):
            m.save()
    errs = _on_threads(mgrs, save)
    assert not errs, errs
    assert os.path.isdir(legacy)
    store = mgrs[0]._reader_storage()
    newest = latest_checkpoint(str(tmp_path), storage=store)
    assert newest and newest.endswith("step-%d" % scope.step_counter)
    import shutil
    shutil.rmtree(newest)
    assert latest_checkpoint(str(tmp_path), storage=store) == legacy
    meta = mgrs[0].restore(legacy, scope=fluid.Scope(),
                           main_program=program)
    assert meta["step"] == 3


def test_forced_sync_pod_save_uses_barriered_protocol(tmp_path):
    program, scope = _tiny_state()
    bar = threading.Barrier(2)
    mgrs = _world(str(tmp_path), scope, program, async_save=True,
                  barrier=lambda name: bar.wait(60))
    errs = _on_threads(mgrs, lambda m: m.save(sync=True))
    assert not errs, errs
    for m in mgrs:
        assert m.last_step == scope.step_counter
        assert m._thread is None
    assert _latest(str(tmp_path)) is not None


# ---------------------------------------------------------------------------
# The async save: agreement through storage alone
# ---------------------------------------------------------------------------

def _no_collective(*_a, **_k):
    raise AssertionError("collective invoked inside the async pod save")


def _async_world(dirname, scope, program, count=2):
    return _world(dirname, scope, program, count, async_save=True,
                  barrier=_no_collective, consensus=_no_collective)


@pytest.fixture
def _short_commit_poll():
    old = flags.get_flag("checkpoint_commit_timeout_s")
    flags.set_flag("checkpoint_commit_timeout_s", 0.4)
    yield
    flags.set_flag("checkpoint_commit_timeout_s", old)


def test_async_pod_save_commits_without_collectives(tmp_path):
    program, scope = _tiny_state()
    mgrs = _async_world(str(tmp_path), scope, program)
    ref = _values(scope)
    paths = [m.save() for m in mgrs]
    assert paths[0] == paths[1]
    for m in mgrs:
        m.wait()
        assert m._thread is None and m.last_step == scope.step_counter
    path = _latest(str(tmp_path))
    assert path == paths[0]
    assert read_manifest(path)["multihost"]["process_count"] == 2
    fresh = fluid.Scope()
    mgrs[1].restore(path, scope=fresh, main_program=program)
    for n, want in ref.items():
        np.testing.assert_array_equal(fresh.find_var(n).numpy(), want)


def test_async_pod_save_inflight_invisible_and_snapshot_isolated(tmp_path):
    program, scope = _tiny_state()
    m0, m1 = _async_world(str(tmp_path), scope, program)
    ref = _values(scope)
    g = telemetry.registry().gauge("checkpoint_async_in_flight")
    with block_at("pmanifest:p1") as (reached, release):
        m0.save()
        m1.save()
        assert reached.wait(30)
        assert int(g.value()) == 1
        assert _latest(str(tmp_path)) is None
        # training goes on: every var changes during the upload
        for n in scope.var_names():
            scope.set_var(n, scope.find_var(n) + 100.0)
        release.set()
        for m in (m0, m1):
            m.wait()
    assert int(g.value()) == 0
    path = _latest(str(tmp_path))
    assert path is not None
    fresh = fluid.Scope()
    m0.restore(path, scope=fresh, main_program=program)
    for n, want in ref.items():
        np.testing.assert_array_equal(fresh.find_var(n).numpy(), want)


def test_async_pod_worker_death_chief_abandons(tmp_path, _short_commit_poll):
    program, scope = _tiny_state()
    good = _threaded_world_save(str(tmp_path), scope,
                                program)[0].latest_checkpoint()
    scope.step_counter += 1
    aband = telemetry.counter("checkpoint_commit_abandoned_total")
    a0 = int(aband.value() or 0)
    m0, m1 = _async_world(str(tmp_path), scope, program)
    with crash_at("pmanifest:p1"):
        m0.save()
        m1.save()
        m0.wait()                      # the chief abandons, no error
        with pytest.raises(SimulatedCrash):
            m1.wait()                  # the rank's own death re-raised
    assert int(aband.value() or 0) - a0 == 1
    assert m0.last_step != scope.step_counter
    assert _latest(str(tmp_path)) == good


def test_async_pod_chief_death_worker_abandons_then_recovers(
        tmp_path, _short_commit_poll):
    program, scope = _tiny_state()
    good = _threaded_world_save(str(tmp_path), scope,
                                program)[0].latest_checkpoint()
    scope.step_counter += 1
    aband = telemetry.counter("checkpoint_commit_abandoned_total")
    a0 = int(aband.value() or 0)
    m0, m1 = _async_world(str(tmp_path), scope, program)
    with crash_at("marker:"):
        m0.save()
        m1.save()
        m1.wait()
        with pytest.raises(SimulatedCrash):
            m0.wait()
    assert int(aband.value() or 0) - a0 == 1
    assert _latest(str(tmp_path)) == good
    scope.step_counter += 1
    mgrs = _async_world(str(tmp_path), scope, program)
    for m in mgrs:
        m.save()
    for m in mgrs:
        m.wait()
        assert m.last_step == scope.step_counter
    assert _latest(str(tmp_path)).endswith("step-%d" % scope.step_counter)


def test_async_pod_wedged_worker_chief_abandons_without_hanging(
        tmp_path, _short_commit_poll):
    program, scope = _tiny_state()
    m0, m1 = _async_world(str(tmp_path), scope, program)
    with block_at("pmanifest:p1") as (reached, release):
        t0 = time.monotonic()
        m0.save()
        m1.save()
        assert reached.wait(30)
        m0.wait()
        assert time.monotonic() - t0 < 20
        release.set()
        m1.wait()
    for m in (m0, m1):
        assert m.last_step != scope.step_counter
    assert _latest(str(tmp_path)) is None


def test_gc_spares_young_markerless_prefix_reaps_aged(tmp_path):
    program, scope = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), storage=ObjectStoreStorage(),
                            scope=scope, main_program=program,
                            async_save=False, process_index=0,
                            process_count=2, barrier=lambda name: None,
                            place=CPU)
    committed = _threaded_world_save(str(tmp_path), scope,
                                     program)[0].latest_checkpoint()
    debris = os.path.join(str(tmp_path), "step-9999")
    store = mgr._shared_prefix_storage()
    store.begin(debris)
    store.put(debris, "t.npy", b"x" * 8, "tensor:t")
    mgr.gc()
    assert os.path.isdir(debris)
    assert _latest(str(tmp_path)) == committed
    old = flags.get_flag("checkpoint_reap_min_age_s")
    flags.set_flag("checkpoint_reap_min_age_s", 0.0)
    try:
        mgr.gc()
    finally:
        flags.set_flag("checkpoint_reap_min_age_s", old)
    assert not os.path.exists(debris)
    assert _latest(str(tmp_path)) == committed


# ---------------------------------------------------------------------------
# Sharded state, and checkpoints crossing the packages
# ---------------------------------------------------------------------------

def _sharded_program(B=5, Bp=6):
    """A state program with one weight-update-sharded buffer of B logical
    elements padded to Bp, over 2 ranks."""
    prog = _state_program()
    prog.global_block().create_var(name="m", shape=(Bp,), dtype="float32",
                                   persistable=True)
    prog._wus_degree = 2
    prog._dp_sharded_state = {"m"}
    prog._wus_padded_numel = {"m": B}
    return prog


def test_sharded_state_saves_each_ranks_slice_and_restores_it(tmp_path):
    prog = _sharded_program()
    m = np.arange(6, dtype=np.float32) + 0.5
    scopes = []
    for r in range(2):
        sc = _scope_with(1, 4)
        sc.set_var("m", torch.from_numpy(m[3 * r:3 * r + 3].copy()))
        scopes.append(sc)
    mgrs = _threaded_world_save(str(tmp_path), None, prog, scopes=scopes)
    path = mgrs[0].latest_checkpoint()
    entry = read_manifest(path)["tensors"]["m"]
    assert entry["shape"] == [6]
    assert [(s["process"], s["index"]) for s in entry["shards"]] == \
        [(0, [[0, 3]]), (1, [[3, 6]])]
    info = checkpoint_metadata(path)
    assert (info["shard_degree"], info["sharded_vars"], info["multihost"],
            info["process_count"]) == (2, ["m"], True, 2)
    for r, mgr in enumerate(mgrs):
        fresh = fluid.Scope()
        mgr.restore(path, scope=fresh, main_program=prog)
        np.testing.assert_array_equal(fresh.find_var("m").numpy(),
                                      m[3 * r:3 * r + 3])
    # a world of one holding the degree-2 layout: refused without
    # reshard, the logical bucket kept and the pad re-zeroed with it
    one = _state_program()
    one.global_block().create_var(name="m", shape=(5,), dtype="float32",
                                  persistable=True)
    one._wus_degree = 1
    one._dp_sharded_state = {"m"}
    one._wus_padded_numel = {"m": 5}
    mgr1 = CheckpointManager(str(tmp_path), place=CPU)
    with pytest.raises(RuntimeError, match="reshard=True"):
        mgr1.restore(path, scope=fluid.Scope(), main_program=one)
    fresh = fluid.Scope()
    meta = mgr1.restore(path, scope=fresh, main_program=one, reshard=True)
    assert meta["resharded"]
    np.testing.assert_array_equal(fresh.find_var("m").numpy(), m[:5])
    # a different logical bucket is a different layout
    one._wus_padded_numel = {"m": 4}
    one.global_block().var("m").shape = (4,)
    with pytest.raises(RuntimeError, match="bucket layouts differ"):
        mgr1.restore(path, scope=fluid.Scope(), main_program=one,
                     reshard=True)


def _jax_wus_job(tmp_path, steps=2):
    """paddle_tpu's nranks=2 weight-update-sharding MLP after ``steps``
    steps, saved by its own CheckpointManager; returns (dir, scope,
    program, loss)."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.checkpoint import CheckpointManager as JMgr
    main, startup, loss = mlp(jfluid)
    transpile(jfluid, main, startup, weight_update_sharding=True)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed=feeds(), fetch_list=[loss], scope=scope)
    d = str(tmp_path / "jax")
    JMgr(d, scope=scope, main_program=main, async_save=False).save()
    return d, scope, main, loss


def _port_wus(nranks):
    main, startup, loss = mlp(fluid)
    fluid.transpiler.GradAllReduce(weight_update_sharding=True).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * nranks, nranks=nranks)
    return main, startup, loss


def test_paddle_tpu_sharded_checkpoint_restores_into_the_port(tmp_path):
    import paddle_tpu.fluid as jfluid
    d, jscope, jmain, jloss = _jax_wus_job(tmp_path)
    sharded = sorted(jmain._dp_sharded_state)
    want = {n: np.asarray(jscope.find_var(n))
            for n in sharded + list(PARAMS)}
    # degree 2: each rank keeps its half
    main, _s, _l = _port_wus(2)
    halves = {}
    for r in range(2):
        scope = fluid.Scope()
        meta = CheckpointManager(d, process_index=r, process_count=2,
                                 place=CPU).resume(scope=scope,
                                                   main_program=main)
        assert meta["shard_degree"] == 2 and not meta["resharded"]
        for n in sharded:
            halves.setdefault(n, []).append(scope.find_var(n).numpy())
        for p in PARAMS:
            np.testing.assert_array_equal(scope.find_var(p).numpy(),
                                          want[p])
    for n in sharded:
        np.testing.assert_array_equal(np.concatenate(halves[n]), want[n])
    # degree 1, resharded: the logical buckets whole; training goes on
    main1, startup1, loss1 = _port_wus(1)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup1, scope=scope)
    meta = CheckpointManager(d, place=CPU).resume(
        scope=scope, main_program=main1, reshard=True)
    assert meta["resharded"] and meta["shard_degree"] == 2
    for n in sharded:
        B = main1._wus_padded_numel[n]
        np.testing.assert_array_equal(scope.find_var(n).numpy()[:B],
                                      want[n][:B])
    got = [float(exe.run(main1, feed=feeds(), fetch_list=[loss1],
                         scope=scope)[0].reshape(-1)[0]) for _ in range(2)]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jwant = [float(np.asarray(jexe.run(jmain, feed=feeds(),
                                       fetch_list=[jloss],
                                       scope=jscope)[0]).mean())
             for _ in range(2)]
    np.testing.assert_allclose(got, jwant, rtol=1e-5)


def test_port_pod_checkpoint_restores_into_paddle_tpu(tmp_path):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.checkpoint import (
        CheckpointManager as JMgr, checkpoint_metadata as jmeta)
    d, jscope, jmain, _l = _jax_wus_job(tmp_path)
    persist = [v.name for v in jmain.list_vars() if v.persistable and
               jscope.find_var(v.name) is not None]
    want = {n: np.asarray(jscope.find_var(n)) for n in persist}
    # the port's two ranks, each holding its half of the sharded state
    main, _s, _l = _port_wus(2)
    scopes = []
    for r in range(2):
        sc = fluid.Scope()
        for n in persist:
            v = want[n]
            if n in main._dp_sharded_state:
                v = v[r * len(v) // 2:(r + 1) * len(v) // 2]
            sc.set_var(n, torch.from_numpy(v.copy()))
        sc.step_counter = 7
        scopes.append(sc)
    pd = str(tmp_path / "port")
    path = _threaded_world_save(pd, None, main, scopes=scopes)[0] \
        .latest_checkpoint()
    info = jmeta(path)
    assert (info["multihost"], info["process_count"], info["shard_degree"],
            info["step"]) == (True, 2, 2, 7)
    jfresh = jfluid.Scope()
    JMgr(pd).restore(path, scope=jfresh, main_program=jmain)
    assert jfresh.step_counter == 7
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(jfresh.find_var(n)), v,
                                      err_msg=n)
