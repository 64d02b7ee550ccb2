"""The port's fault-tolerant checkpointing (paddle_tpu_torch.fluid.
checkpoint.CheckpointManager, storage.py, io.py's savers) on the CPU.

The first tests mirror paddle_tpu's ``tests/test_checkpoint_manager.py``
(its 15 checkpoint tests) and the first two of
``tests/test_checkpoint_resume.py`` against the port: atomic
manifest-committed saves, a kill at EVERY write boundary leaving
``latest_checkpoint()`` loadable with exact parity, torn and corrupt
checkpoints never selected, retention, async saves, strict two-phase
restore, the crash-safe legacy savers, and resume parity (rtol 1e-5,
atol 1e-7, as there).  The fault hooks live here (``paddle_tpu``'s
``tests/faultinject.py`` drives the JAX package's hook, not the port's).

Then the two packages' checkpoints against each other, bit for bit:
- a checkpoint written by paddle_tpu's ``CheckpointManager`` (tiny BERT
  pretraining, dropout off, 2 Adam steps) restores into the port with
  every persistable and ``step_counter`` equal; two more steps then
  stay within 1e-5 (losses rtol, parameters atol) of JAX continuing;
- the port's checkpoint of that state restores into paddle_tpu with
  every persistable and ``step_counter`` equal;
- a bfloat16 persistable round-trips bit-exact in the port, its file
  byte-identical to the JAX package's for the same bits, and a JAX bf16
  checkpoint restores into the port bit-exact; an int32 entry (how
  paddle_tpu holds a declared int64 variable) restores widened.
"""

import contextlib
import glob
import json
import os
import tempfile
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import checkpoint as jcheckpoint
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import checkpoint, storage
from paddle_tpu_torch.fluid.checkpoint import CheckpointManager
from paddle_tpu_torch.models import bert
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

CPU = fluid.CPUPlace()


# ---------------------------------------------------------------------------
# Fault hooks on the port's write boundaries
# ---------------------------------------------------------------------------

class SimulatedCrash(BaseException):
    """Emulates SIGKILL at a write boundary: no ``except Exception``
    cleanup path can swallow it."""


@contextlib.contextmanager
def _hook(fn):
    prev = checkpoint.set_fault_hook(fn)
    try:
        yield
    finally:
        checkpoint.set_fault_hook(prev)


@contextlib.contextmanager
def crash_at(point_substr, nth=1):
    """Raise SimulatedCrash the ``nth`` time a matching point fires."""
    seen = [0]

    def hook(name):
        if point_substr in name:
            seen[0] += 1
            if seen[0] == nth:
                raise SimulatedCrash(name)
    with _hook(hook):
        yield


@contextlib.contextmanager
def raise_at(point_substr):
    def hook(name):
        if point_substr in name:
            raise OSError("injected I/O failure at %s" % name)
    with _hook(hook):
        yield


@contextlib.contextmanager
def fail_n_times(point_substr, n):
    seen = [0]

    def hook(name):
        if point_substr in name and seen[0] < n:
            seen[0] += 1
            raise storage.TransientStorageError("injected %d/%d at %s"
                                                % (seen[0], n, name))
    with _hook(hook):
        yield seen


@contextlib.contextmanager
def block_at(point_substr):
    """Yields (reached, release): the saver blocks at the first matching
    point until ``release`` is set."""
    reached, release, fired = threading.Event(), threading.Event(), [False]

    def hook(name):
        if point_substr in name and not fired[0]:
            fired[0] = True
            reached.set()
            release.wait(timeout=30)
    try:
        with _hook(hook):
            yield reached, release
    finally:
        release.set()


@contextlib.contextmanager
def record_points():
    into = []
    with _hook(into.append):
        yield into


def truncate_file(path):
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)


def flip_byte(path, offset=None):
    size = os.path.getsize(path)
    off = size // 2 if offset is None else offset % size
    with open(path, "rb+") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# A var-only "state program" and scopes of CPU tensors: the fault matrix is
# pure host I/O, so killing a save at ~20 boundaries stays fast
# ---------------------------------------------------------------------------

_SHAPES = (("fc_0.w_0", (4, 3)), ("fc_0.b_0", (3,)),
           ("moment/acc_0", (4, 3)))


def _state_program(shapes=_SHAPES, dtype="float32"):
    prog = fluid.Program()
    for name, shape in shapes:
        prog.global_block().create_var(name=name, shape=shape, dtype=dtype,
                                       persistable=True)
    return prog


def _scope_with(seed, step):
    rng = np.random.RandomState(seed)
    sc = fluid.Scope()
    for name, shape in _SHAPES:
        sc.set_var(name, torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)))
    sc.step_counter = step
    return sc


def _values(sc):
    return {n: sc.find_var_numpy(n).copy() for n, _ in _SHAPES}


def _mgr(d, **kw):
    kw.setdefault("async_save", False)
    return CheckpointManager(d, place=CPU, **kw)


def _assert_restored(d, prog, expect_scope, expect_step):
    fresh = fluid.Scope()
    meta = _mgr(d).restore(scope=fresh, main_program=prog)
    assert meta["step"] == expect_step
    assert fresh.step_counter == expect_step
    for n, v in _values(expect_scope).items():
        np.testing.assert_array_equal(fresh.find_var_numpy(n), v)
    return meta


def test_save_restore_roundtrip_and_manifest(tmp_path):
    prog = _state_program()
    sc = _scope_with(0, step=7)
    mgr = _mgr(str(tmp_path))
    path = mgr.save(scope=sc, main_program=prog)
    assert os.path.basename(path) == "step-7"
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    body = checkpoint.read_manifest(path)
    assert body["step"] == 7 and body["step_counter"] == 7
    assert set(body["tensors"]) == {n for n, _ in _SHAPES}
    for n, shape in _SHAPES:
        ent = body["tensors"][n]
        assert tuple(ent["shape"]) == shape and ent["dtype"] == "float32"
    _assert_restored(str(tmp_path), prog, sc, 7)
    assert mgr.saves == mgr.snapshots == 1 and mgr.last_step == 7
    assert mgr.last_bytes == sum(e["bytes"] for e in body["tensors"].values())
    assert mgr.last_save_s >= 0.0 and mgr.last_snapshot_ms >= 0.0
    meta = checkpoint.checkpoint_metadata(path)
    assert meta["step"] == 7 and meta["tensor_count"] == 3


def test_resume_returns_none_on_empty_dir(tmp_path):
    mgr = _mgr(str(tmp_path))
    assert mgr.resume(scope=fluid.Scope(),
                      main_program=_state_program()) is None
    with pytest.raises(RuntimeError, match="no complete checkpoint"):
        mgr.restore(scope=fluid.Scope(), main_program=_state_program())


def test_crash_at_every_write_boundary_keeps_a_loadable_checkpoint(
        tmp_path):
    prog = _state_program()
    sc_a, sc_b = _scope_with(1, step=1), _scope_with(2, step=2)
    probe = str(tmp_path / "probe")
    with record_points() as points:
        _mgr(probe).save(step=2, scope=sc_b, main_program=prog)
    assert any(p.startswith("tensor:") for p in points)
    assert any(p.startswith("manifest") for p in points)
    assert any(p.startswith("before_commit:") for p in points)
    for i, point in enumerate(points):
        d = str(tmp_path / ("kill%d" % i))
        mgr = _mgr(d)
        mgr.save(step=1, scope=sc_a, main_program=prog)   # baseline
        with crash_at(point):
            with pytest.raises(SimulatedCrash):
                mgr.save(step=2, scope=sc_b, main_program=prog)
        committed = point.startswith(("after_commit:", "after_gc:"))
        latest = checkpoint.latest_checkpoint(d)
        assert latest is not None, "no loadable checkpoint after " + point
        if committed:
            assert latest.endswith("step-2"), point
            _assert_restored(d, prog, sc_b, 2)
        else:
            assert latest.endswith("step-1"), point
            _assert_restored(d, prog, sc_a, 1)
        # the next save recovers cleanly, reaping the debris
        _mgr(d).save(step=3, scope=sc_b, main_program=prog)
        assert checkpoint.latest_checkpoint(d).endswith("step-3")
        assert not glob.glob(os.path.join(d, "*.tmp-*"))


def test_torn_and_corrupt_committed_checkpoints_are_skipped(tmp_path):
    prog = _state_program()
    sc_a, sc_b = _scope_with(3, 1), _scope_with(4, 2)
    d = str(tmp_path)
    mgr = _mgr(d, max_to_keep=None)
    p1 = mgr.save(step=1, scope=sc_a, main_program=prog)
    p2 = mgr.save(step=2, scope=sc_b, main_program=prog)
    truncate_file(os.path.join(p2, "fc_0.w_0.npy"))
    assert checkpoint.latest_checkpoint(d) == p1
    p3 = mgr.save(step=3, scope=sc_b, main_program=prog)
    flip_byte(os.path.join(p3, checkpoint.MANIFEST_NAME))
    assert checkpoint.latest_checkpoint(d) == p1
    p4 = mgr.save(step=4, scope=sc_b, main_program=prog)
    f = os.path.join(p4, "fc_0.b_0.npy")
    flip_byte(f, offset=os.path.getsize(f) - 2)
    assert checkpoint.latest_checkpoint(d) == p1
    _assert_restored(d, prog, sc_a, 1)


def test_stale_tmp_dirs_are_gcd_and_ignored(tmp_path):
    d = str(tmp_path)
    stale = os.path.join(d, "step-9.tmp-deadbeef")
    os.makedirs(stale)
    with open(os.path.join(stale, "junk.npy"), "wb") as f:
        f.write(b"\x00" * 16)
    assert checkpoint.latest_checkpoint(d) is None
    _mgr(d).save(step=1, scope=_scope_with(5, 1),
                 main_program=_state_program())
    assert not os.path.exists(stale)


def test_retention_keeps_last_n(tmp_path):
    prog = _state_program()
    d = str(tmp_path)
    mgr = _mgr(d, max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step=step, scope=_scope_with(step, step),
                 main_program=prog)
    kept = sorted(e for e in os.listdir(d) if e.startswith("step-"))
    assert kept == ["step-3", "step-4"]


def test_retention_never_deletes_the_only_complete_checkpoint(tmp_path):
    prog = _state_program()
    d = str(tmp_path)
    p1 = _mgr(d, max_to_keep=1).save(step=1, scope=_scope_with(6, 1),
                                     main_program=prog)
    bogus = os.path.join(d, "step-2")
    os.makedirs(bogus)
    with open(os.path.join(bogus, checkpoint.MANIFEST_NAME), "w") as f:
        f.write("{not json")
    _mgr(d, max_to_keep=1).gc()
    assert os.path.isdir(p1)
    assert checkpoint.latest_checkpoint(d) == p1
    assert os.path.isdir(bogus)
    with pytest.raises(ValueError):
        checkpoint.read_manifest(bogus)
    _mgr(d, max_to_keep=1).save(step=3, scope=_scope_with(7, 3),
                                main_program=prog)
    assert not os.path.isdir(p1)
    assert checkpoint.latest_checkpoint(d).endswith("step-3")
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(d, max_to_keep=0)


def test_async_save_returns_before_bytes_hit_disk(tmp_path):
    prog = _state_program()
    sc = _scope_with(8, 1)
    want = _values(sc)
    d = str(tmp_path)
    mgr = _mgr(d, async_save=True)
    with block_at("manifest_begin") as (reached, release):
        path = mgr.save(step=1, scope=sc, main_program=prog)
        assert reached.wait(10)
        assert not os.path.exists(path)
        assert glob.glob(os.path.join(d, "*.tmp-*"))
        # training may change the scope at once, in place too: the
        # snapshot owns its memory
        for n, _ in _SHAPES:
            sc.find_var(n).zero_()
        release.set()
        mgr.wait()
    assert checkpoint.latest_checkpoint(d) == path
    fresh = fluid.Scope()
    mgr.restore(path, scope=fresh, main_program=prog)
    for n, v in want.items():
        np.testing.assert_array_equal(fresh.find_var_numpy(n), v)


def test_async_save_error_surfaces_on_wait_and_next_save(tmp_path):
    prog = _state_program()
    sc = _scope_with(9, 1)
    mgr = _mgr(str(tmp_path), async_save=True)
    with raise_at("tensor:"):
        mgr.save(step=1, scope=sc, main_program=prog)
        with pytest.raises(OSError, match="injected"):
            mgr.wait()
    with raise_at("manifest"):
        mgr.save(step=2, scope=sc, main_program=prog)
        mgr._thread.join()
    with pytest.raises(OSError, match="injected"):
        mgr.save(step=3, scope=sc, main_program=prog)
    mgr.save(step=4, scope=sc, main_program=prog)
    mgr.wait()
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("step-4")


def _build(pkg):
    x = pkg.layers.data(name="x", shape=[8], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    h = pkg.layers.fc(x, size=16, act="tanh")
    pred = pkg.layers.fc(h, size=1)
    loss = pkg.layers.mean(pkg.layers.square(pred - y))
    pkg.optimizer.Adam(0.01).minimize(loss)   # moments must survive too
    return loss


def _net():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = _build(fluid)
    rng = np.random.RandomState(0)
    feed = {"x": rng.normal(size=(32, 8)).astype(np.float32),
            "y": rng.normal(size=(32, 1)).astype(np.float32)}
    return main, startup, loss, feed


def test_async_save_does_not_block_the_hot_path(tmp_path):
    """Steps between save() and commit run while the write is held, and
    the save took exactly one snapshot (one device synchronisation on
    the card)."""
    main, startup, loss, feed = _net()
    sc = fluid.Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=sc)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
    mgr = _mgr(str(tmp_path), async_save=True, main_program=main)
    with block_at("manifest_begin") as (reached, release):
        mgr.save(scope=sc)
        assert reached.wait(10)
        live = [exe.run(main, feed=feed, fetch_list=[loss], scope=sc,
                        return_numpy=False)[0] for _ in range(3)]
        assert mgr.snapshots == 1 and mgr.saves == 0
        assert mgr._thread.is_alive()
        release.set()
        mgr.wait()
    assert torch.isfinite(live[-1]).all()
    path = checkpoint.latest_checkpoint(str(tmp_path))
    assert path is not None and checkpoint.validate_checkpoint(path)


def test_restore_strict_names_missing_and_mismatched_tensors(tmp_path):
    prog = _state_program()
    sc = _scope_with(10, 1)
    d = str(tmp_path)
    _mgr(d).save(step=1, scope=sc, main_program=prog)
    bigger = _state_program(_SHAPES + (("extra_w", (2, 2)),))
    mgr = _mgr(d)
    half = fluid.Scope()
    with pytest.raises(RuntimeError, match="extra_w"):
        mgr.restore(scope=half, main_program=bigger)
    # a strict failure leaves the scope COMPLETELY untouched
    assert half.var_names() == [] and half.step_counter == 0
    fresh = fluid.Scope()
    mgr.restore(scope=fresh, main_program=bigger, strict=False)
    assert fresh.find_var("extra_w") is None
    np.testing.assert_array_equal(fresh.find_var_numpy("fc_0.b_0"),
                                  _values(sc)["fc_0.b_0"])
    reshaped = _state_program((("fc_0.w_0", (5, 5)),))
    with pytest.raises(RuntimeError, match="fc_0.w_0"):
        mgr.restore(scope=fluid.Scope(), main_program=reshaped)
    retyped = _state_program((("fc_0.w_0", (4, 3)),), dtype="bfloat16")
    with pytest.raises(RuntimeError, match="dtype"):
        mgr.restore(scope=fluid.Scope(), main_program=retyped)


def test_load_vars_strict_raises_on_missing_file(tmp_path):
    prog = _state_program()
    sc = _scope_with(11, 0)
    exe = fluid.Executor(CPU)
    d = str(tmp_path / "vars")
    with fluid.scope_guard(sc):
        fluid.io.save_persistables(exe, d, main_program=prog)
        os.remove(os.path.join(d, "fc_0.b_0.npy"))
        with pytest.raises(RuntimeError) as ei:
            fluid.io.load_persistables(exe, d, main_program=prog)
        assert "fc_0.b_0" in str(ei.value) and d in str(ei.value)
        sentinel = torch.full((3,), 7.0)
        sc.set_var("fc_0.b_0", sentinel)
        fluid.io.load_persistables(exe, d, main_program=prog, strict=False)
        assert torch.equal(sc.find_var("fc_0.b_0"), sentinel)


def test_load_vars_strict_raises_on_missing_npz_entry(tmp_path):
    prog = _state_program()
    blk = prog.global_block()
    sc = fluid.Scope()
    sc.set_var("fc_0.w_0", torch.ones(4, 3))
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(sc):
        fluid.io.save_vars(exe, str(tmp_path), vars=[blk.var("fc_0.w_0")],
                           filename="all")
        with pytest.raises(RuntimeError, match="fc_0.b_0"):
            fluid.io.load_vars(exe, str(tmp_path),
                               vars=[blk.var("fc_0.w_0"),
                                     blk.var("fc_0.b_0")], filename="all")
        fluid.io.load_vars(exe, str(tmp_path),
                           vars=[blk.var("fc_0.w_0"), blk.var("fc_0.b_0")],
                           filename="all", strict=False)


def test_legacy_save_persistables_is_crash_safe(tmp_path):
    prog = _state_program()
    sc = _scope_with(12, 0)
    vals = _values(sc)
    exe = fluid.Executor(CPU)
    d = str(tmp_path / "model")
    with fluid.scope_guard(sc):
        with crash_at("tensor:", nth=2):
            with pytest.raises(SimulatedCrash):
                fluid.io.save_persistables(exe, d, main_program=prog)
        assert not os.path.exists(d)
        assert glob.glob(d + ".tmp-*")
        fluid.io.save_persistables(exe, d, main_program=prog)
        assert os.path.isdir(d)
        sc.set_var("fc_0.w_0", torch.zeros(4, 3))
        with crash_at("tensor:", nth=1):
            with pytest.raises(SimulatedCrash):
                fluid.io.save_persistables(exe, d, main_program=prog)
    np.testing.assert_array_equal(
        np.load(os.path.join(d, "fc_0.w_0.npy")), vals["fc_0.w_0"])
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(exe, d, main_program=prog)
    for name in vals:
        np.testing.assert_array_equal(fresh.find_var_numpy(name),
                                      vals[name])


def test_save_inference_model_is_crash_safe(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(main.global_block().var("x"), size=2)
    exe = fluid.Executor(CPU)
    sc = fluid.Scope()
    d = str(tmp_path / "infer")
    with fluid.scope_guard(sc):
        exe.run(startup)
        with crash_at("model:"):
            with pytest.raises(SimulatedCrash):
                fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                              main_program=main)
        assert not os.path.exists(d)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
        prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
    assert feeds == ["x"] and len(fetches) == 1
    out = exe.run(prog, feed={"x": np.ones((3, 4), np.float32)},
                  fetch_list=fetches, scope=sc)
    assert out[0].shape == (3, 2)


# ---------------------------------------------------------------------------
# Resume parity (mirrors test_checkpoint_resume.py's first two tests)
# ---------------------------------------------------------------------------

def test_resume_from_checkpoint_matches_uninterrupted():
    main, startup, loss, feed = _net()

    def step(exe):
        return exe.run(main, feed=feed, fetch_list=[loss])[0].item()

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        ref = [step(exe) for _ in range(10)]
    with tempfile.TemporaryDirectory() as ckpt:
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            exe.run(startup)
            first5 = [step(exe) for _ in range(5)]
            fluid.io.save_persistables(exe, ckpt, main_program=main)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            exe.run(startup)                   # re-init, then overwrite
            fluid.io.load_persistables(exe, ckpt, main_program=main)
            rest = [step(exe) for _ in range(5)]
    np.testing.assert_allclose(first5 + rest, ref, rtol=1e-5, atol=1e-7)


def test_resume_via_manager_after_torn_save_matches_uninterrupted():
    """Checkpoint at step 5, train on, get KILLED mid-save at step 7 (a
    torn tmp dir), restart, auto-resume: the torn save is invisible and
    steps 6..10 match an uninterrupted run."""
    main, startup, loss, feed = _net()

    def step(exe):
        return exe.run(main, feed=feed, fetch_list=[loss])[0].item()

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        ref = [step(exe) for _ in range(10)]
    with tempfile.TemporaryDirectory() as ckpt:
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            exe.run(startup)
            mgr = _mgr(ckpt, main_program=main)
            first5 = [step(exe) for _ in range(5)]
            mgr.save()
            saved_step = fluid.global_scope().step_counter
            for _ in range(2):
                step(exe)
            with crash_at("manifest_mid"):
                with pytest.raises(SimulatedCrash):
                    mgr.save()
            assert glob.glob(os.path.join(ckpt, "*.tmp-*"))
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(CPU)
            mgr = _mgr(ckpt, main_program=main)
            meta = mgr.resume()      # no startup run: restore is whole
            assert meta is not None and meta["step"] == saved_step
            assert fluid.global_scope().step_counter == saved_step
            rest = [step(exe) for _ in range(5)]
    np.testing.assert_allclose(first5 + rest, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rows", [2, 50])
def test_lookup_gradient_is_torch_embeddings_and_leaves_the_setting(rows):
    """The lookup_table rule's table gradient (``LookupFunction``, taken
    under deterministic algorithms so that resumed training on the card
    retraces the unbroken run) is ``F.embedding``'s gradient bit for bit,
    repeated ids included, and the caller's deterministic-algorithms
    setting is what it was after the backward."""
    from paddle_tpu_torch.fluid.ops.tensor_ops import LookupFunction
    rng = np.random.RandomState(rows)
    ids = torch.from_numpy(rng.randint(0, rows, 300))
    w = torch.from_numpy(rng.randn(rows, 16).astype(np.float32))
    g = torch.from_numpy(rng.randn(300, 16).astype(np.float32))
    grads = []
    for fn in (torch.nn.functional.embedding, LookupFunction.apply):
        wt = w.clone().requires_grad_()
        out = fn(ids, wt)
        assert torch.equal(out, w[ids])
        grads.append(torch.autograd.grad(out, wt, g)[0])
    assert torch.equal(grads[0], grads[1])
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("warn_only", [False, True])
def test_lookup_gradient_keeps_a_callers_deterministic_setting(warn_only):
    """Inside the table gradient a caller's own deterministic setting
    holds as given (strict stays strict), and it is the same after."""
    from paddle_tpu_torch.fluid.ops import tensor_ops
    seen = []
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        with tensor_ops._deterministic():
            seen.append((torch.are_deterministic_algorithms_enabled(),
                         torch.is_deterministic_algorithms_warn_only_enabled()))
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled()))
    finally:
        torch.use_deterministic_algorithms(False)
    assert seen == [(True, warn_only)] * 2


def test_object_store_backend_commits_by_marker_and_retries(tmp_path):
    prog = _state_program()
    sc = _scope_with(13, 4)
    d = str(tmp_path)
    store = storage.ObjectStoreStorage(retries=3, backoff_s=0.001)
    mgr = _mgr(d, storage=store)
    with fail_n_times("tensor:fc_0.w_0", 2) as seen:
        path = mgr.save(scope=sc, main_program=prog)
    assert seen[0] == 2
    assert os.path.isfile(os.path.join(path, storage.MARKER_NAME))
    assert checkpoint.read_manifest(path)["commit"] == "marker"
    assert checkpoint.latest_checkpoint(d, storage=store) == path
    # a kill between the uploads and the marker: never selected
    with crash_at("marker:"):
        with pytest.raises(SimulatedCrash):
            mgr.save(step=9, scope=sc, main_program=prog)
    assert os.path.isdir(os.path.join(d, "step-9"))
    assert checkpoint.latest_checkpoint(d, storage=store) == path
    # ... even by a reader that does not enforce markers
    assert not checkpoint.validate_checkpoint(os.path.join(d, "step-9"))
    fresh = fluid.Scope()
    _mgr(d, storage=store).resume(scope=fresh, main_program=prog)
    assert fresh.step_counter == 4


def test_object_store_gc_reaps_markerless_prefixes_only(tmp_path):
    prog = _state_program()
    d = str(tmp_path)
    store = storage.ObjectStoreStorage(backoff_s=0.001)
    mgr = _mgr(d, storage=store, max_to_keep=None)
    kept = mgr.save(scope=_scope_with(1, 2), main_program=prog)
    with crash_at("manifest_begin"):
        with pytest.raises(SimulatedCrash):
            mgr.save(scope=_scope_with(2, 5), main_program=prog)
    torn = os.path.join(d, "step-5")
    assert os.path.isdir(torn)
    # a committed prefix whose marker no longer validates is evidence,
    # not debris: GC keeps it
    rotten = mgr.save(scope=_scope_with(3, 3), main_program=prog)
    flip_byte(os.path.join(rotten, storage.MARKER_NAME), 5)
    # the next save's GC runs after its commit and reaps the torn
    # upload at once, however young
    newest = mgr.save(scope=_scope_with(4, 8), main_program=prog)
    assert not os.path.exists(torn)
    assert all(os.path.isdir(p) for p in (kept, rotten, newest))
    assert checkpoint.latest_checkpoint(d, storage=store) == newest


def test_unported_options_raise_naming_their_item(tmp_path):
    # steps_per_run windows are ported (test_torch_multi_step.py)
    assert CheckpointManager(str(tmp_path), steps_per_run=4) \
        .steps_per_run == 4
    with pytest.raises(NotImplementedError, match="item 10b"):
        CheckpointManager(str(tmp_path), process_count=2, process_index=0)
    with pytest.raises(NotImplementedError, match="item 10b"):
        _mgr(str(tmp_path)).restore(scope=fluid.Scope(),
                                    main_program=_state_program(),
                                    reshard=True)


# ---------------------------------------------------------------------------
# bf16 and the dtype rules
# ---------------------------------------------------------------------------

def test_bf16_persistable_round_trips_bit_exact(tmp_path):
    prog = _state_program((("emb", (6, 5)), ("w", (3,))), dtype="bfloat16")
    rng = np.random.RandomState(14)
    sc = fluid.Scope()
    vals = {n: torch.from_numpy(rng.randn(*s).astype(np.float32) * 30)
            .to(torch.bfloat16) for n, s in (("emb", (6, 5)), ("w", (3,)))}
    for n, t in vals.items():
        sc.set_var(n, t)
    path = _mgr(str(tmp_path)).save(step=3, scope=sc, main_program=prog)
    body = checkpoint.read_manifest(path)
    assert body["tensors"]["emb"]["dtype"] == "bfloat16"
    data = open(os.path.join(path, "emb.npy"), "rb").read()
    # the JAX package's bytes for the same bits
    bits = vals["emb"].view(torch.int16).numpy()
    import io as _io
    jbuf = _io.BytesIO()
    np.save(jbuf, bits.view(ml_dtypes.bfloat16))
    assert data == jbuf.getvalue()
    fresh = fluid.Scope()
    _mgr(str(tmp_path)).restore(scope=fresh, main_program=prog)
    for n, t in vals.items():
        got = fresh.find_var(n)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16))


def test_jax_bf16_and_narrowed_int64_checkpoint_restores_in_the_port(
        tmp_path):
    """paddle_tpu writes bf16 as '<V2' .npy files named bfloat16 in the
    manifest, and holds a declared int64 variable as int32: the port
    restores the first bit for bit and widens the second."""
    rng = np.random.RandomState(15)
    emb = (rng.randn(4, 3) * 10).astype(ml_dtypes.bfloat16)
    cnt = np.array([12345], np.int32)
    jprog = jfluid.Program()
    jprog.global_block().create_var(name="emb", shape=(4, 3),
                                    dtype="bfloat16", persistable=True)
    jprog.global_block().create_var(name="cnt", shape=(1,), dtype="int64",
                                    persistable=True)
    jsc = jfluid.Scope()
    jsc.set_var("emb", emb)
    jsc.set_var("cnt", cnt)
    jsc.step_counter = 5
    jcheckpoint.CheckpointManager(str(tmp_path), async_save=False).save(
        scope=jsc, main_program=jprog)
    prog = fluid.Program()
    prog.global_block().create_var(name="emb", shape=(4, 3),
                                   dtype="bfloat16", persistable=True)
    prog.global_block().create_var(name="cnt", shape=(1,), dtype="int64",
                                   persistable=True)
    fresh = fluid.Scope()
    meta = _mgr(str(tmp_path)).resume(scope=fresh, main_program=prog)
    assert meta["step"] == 5 and fresh.step_counter == 5
    got = fresh.find_var("emb")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  emb.view(np.int16))
    c = fresh.find_var("cnt")
    assert c.dtype == torch.int64 and c.tolist() == [12345]


# ---------------------------------------------------------------------------
# Across the packages: tiny BERT pretraining, dropout off
# ---------------------------------------------------------------------------

B, P, LR = 4, 4, 1e-3


def _bert(pkg, mod):
    cfg = mod.tiny_config(hidden_dropout=0.0, attn_dropout=0.0)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_pretrain(cfg, lr=LR, max_pred_per_seq=P)
    return main, startup, out


def _bert_feed(cfg, seed):
    rng = np.random.RandomState(seed)
    S = cfg.max_seq_len
    lengths = rng.randint(S // 2, S + 1, B)
    pos = np.stack([rng.choice(n, P, replace=False) + i * S
                    for i, n in enumerate(lengths)])
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (B, S, 1)),
        "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (B, 1, 1)),
        "sent_ids": rng.randint(0, 2, (B, S, 1)),
        "input_mask": (np.arange(S)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
        "mask_pos": pos.reshape(-1, 1).astype(np.int32),
        "mask_label": rng.randint(0, cfg.vocab_size, (B * P, 1)),
        "nsp_label": rng.randint(0, 2, (B, 1)),
    }


@pytest.fixture(scope="module")
def across(tmp_path_factory):
    root = tmp_path_factory.mktemp("across")
    jmain, jstartup, jout = _bert(jfluid, jbert)
    cfg = jout["config"]
    feeds = [_bert_feed(cfg, s) for s in range(4)]
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    jsc = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jsc)
    for f in feeds[:2]:
        jexe.run(jmain, feed=f, fetch_list=[jout["loss"]], scope=jsc)
    jdir = str(root / "jax")
    jcheckpoint.CheckpointManager(jdir, async_save=False).save(
        scope=jsc, main_program=jmain)
    saved = {n: np.array(jsc.find_var(n)) for n in names}
    saved_step = jsc.step_counter
    jlosses = [float(np.asarray(jexe.run(
        jmain, feed=f, fetch_list=[jout["loss"]], scope=jsc)[0])[0])
        for f in feeds[2:]]
    jafter = {n: np.array(jsc.find_var(n)) for n in names}

    pmain, _, pout = _bert(fluid, bert)
    psc = fluid.Scope()
    meta = _mgr(jdir, main_program=pmain).resume(scope=psc)
    restored = {n: psc.find_var_numpy(n) for n in names}
    restored_step = psc.step_counter
    pdir = str(root / "port")
    _mgr(pdir, main_program=pmain).save(scope=psc)
    pexe = fluid.Executor(CPU)
    plosses = [float(pexe.run(pmain, feed=f, fetch_list=[pout["loss"]],
                              scope=psc)[0][0]) for f in feeds[2:]]
    pafter = {n: psc.find_var_numpy(n) for n in names}
    return dict(names=names, saved=saved, saved_step=saved_step,
                meta=meta, restored=restored, restored_step=restored_step,
                jlosses=jlosses, plosses=plosses, jafter=jafter,
                pafter=pafter, pdir=pdir, jmain=jmain)


def test_jax_checkpoint_restores_into_the_port_bit_exact(across):
    assert across["meta"]["step"] == across["saved_step"]
    assert across["restored_step"] == across["saved_step"]
    assert len(across["names"]) > 50
    for n in across["names"]:
        want, got = across["saved"][n], across["restored"][n]
        assert got.dtype == want.dtype, n
        np.testing.assert_array_equal(got, want, err_msg=n)


def test_port_continues_a_jax_checkpoint_like_jax(across):
    np.testing.assert_allclose(across["plosses"], across["jlosses"],
                               rtol=1e-5)
    for n in across["names"]:
        np.testing.assert_allclose(across["pafter"][n], across["jafter"][n],
                                   rtol=0, atol=1e-5, err_msg=n)


def test_port_checkpoint_restores_into_jax_bit_exact(across):
    body = checkpoint.read_manifest(checkpoint.latest_checkpoint(
        across["pdir"]))
    assert set(body["tensors"]) == set(across["names"])
    jsc = jfluid.Scope()
    meta = jcheckpoint.CheckpointManager(
        across["pdir"], async_save=False).resume(
            scope=jsc, main_program=across["jmain"])
    assert meta["step"] == across["saved_step"]
    assert jsc.step_counter == across["saved_step"]
    for n in across["names"]:
        np.testing.assert_array_equal(np.asarray(jsc.find_var(n)),
                                      across["saved"][n], err_msg=n)
    # and the two packages' manifests describe the same tensors
    jbody = checkpoint.read_manifest(checkpoint.latest_checkpoint(
        os.path.join(os.path.dirname(across["pdir"]), "jax")))
    for n, ent in body["tensors"].items():
        j = jbody["tensors"][n]
        assert (ent["shape"], ent["dtype"], ent["crc32"]) == \
            (j["shape"], j["dtype"], j["crc32"]), n
    assert json.dumps(sorted(body["tensors"])) == \
        json.dumps(sorted(jbody["tensors"]))
