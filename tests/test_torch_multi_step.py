"""``Executor.run_window`` in the port (paddle_tpu_torch) — K steps in
one call — against K port ``run`` calls and against paddle_tpu's
``run_window`` on the CPU, on tiny BERT pretraining (``tiny_config``: 2
layers, width 64, 4 heads, S=32; ``max_pred_per_seq=4``, batch 4, Adam
at lr 1e-3) with numpy feeds made from a seed.

- The port's K=4 window is bit-equal to four port ``run`` calls, dropout
  included (hidden dropout 0.1: inner step i draws at step ``step0 + i``),
  and a per-step ``run`` after a window continues the same stream.
- With dropout off, JAX's startup persistables carried into the port
  (``load_numpy_params``), two K=4 windows: losses ``rtol 1e-4``, every
  persistable after the second window ``atol 1e-5``.  JAX runs its flash
  attention in Pallas interpret mode, the port the plain versions of its
  kernels.
- The stacked-dimension error, one plan per (program, feeds, fetches,
  K) and ``compile_count``.
- ``FLAGS_check_nan_inf=skip``: a poisoned inner step keeps its state,
  the verdicts equal JAX's; ``raise`` names the same op as JAX.
- ``CheckpointManager(steps_per_run=4)``: a save lands on the window
  boundary and a save off it raises the JAX error, a restore under
  another K warns, and a windowed checkpoint written by the port
  restores into paddle_tpu bit-exact (float32).
"""

import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags
from paddle_tpu.fluid import profiler as jprofiler
from paddle_tpu.fluid.checkpoint import CheckpointManager as JCheckpointManager
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import flags, profiler
from paddle_tpu_torch.models import bert

from test_torch_bert_training import make_feed
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

K, LR = 4, 1e-3


def build(pkg, bert_mod, seed=7, **kw):
    kw.setdefault("hidden_dropout", 0.0)
    kw.setdefault("attn_dropout", 0.0)
    cfg = bert_mod.tiny_config(**kw)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = bert_mod.build_pretrain(cfg, lr=LR, max_pred_per_seq=4)
    return main, startup, out


def stack(feeds):
    return {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def port_state(main, scope):
    return {n: scope.find_var_numpy(n) for n in persistables(main)}


def port_started(main, startup):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, scope


@pytest.fixture(scope="module")
def feeds():
    cfg = bert.tiny_config()
    return [make_feed(cfg, seed=i) for i in range(2 * K + 1)]


def test_window_is_bit_equal_to_k_runs_dropout_included(feeds):
    main, startup, out = build(fluid, bert, hidden_dropout=0.1)
    exe, sc1 = port_started(main, startup)
    runs = [exe.run(main, feed=f, fetch_list=[out["loss"]], scope=sc1)[0]
            for f in feeds[:K]]
    exe, sc2 = port_started(main, startup)
    c0 = exe.compile_count()
    win = exe.run_window(main, feed=stack(feeds[:K]),
                         fetch_list=[out["loss"]], scope=sc2,
                         steps_per_run=K)
    assert exe.compile_count() == c0 + 1
    assert tuple(win[0].shape)[0] == K
    np.testing.assert_array_equal(
        np.concatenate([np.ravel(x) for x in runs]),
        win[0].numpy().ravel())
    assert sc1.step_counter == sc2.step_counter
    assert sc2._window_end == sc2.step_counter
    s1, s2 = port_state(main, sc1), port_state(main, sc2)
    for n in s1:
        np.testing.assert_array_equal(s1[n], s2[n], err_msg=n)


def test_run_after_window_continues_the_same_stream(feeds):
    """window(4) then one run() == five run() calls, bit for bit."""
    main, startup, out = build(fluid, bert, hidden_dropout=0.1)
    exe, sc1 = port_started(main, startup)
    runs = [exe.run(main, feed=f, fetch_list=[out["loss"]], scope=sc1)[0]
            for f in feeds[:K + 1]]
    exe, sc2 = port_started(main, startup)
    exe.run_window(main, feed=stack(feeds[:K]), fetch_list=[out["loss"]],
                   scope=sc2, steps_per_run=K)
    last = exe.run(main, feed=feeds[K], fetch_list=[out["loss"]],
                   scope=sc2)[0]
    np.testing.assert_array_equal(runs[-1], last)
    s1, s2 = port_state(main, sc1), port_state(main, sc2)
    for n in s1:
        np.testing.assert_array_equal(s1[n], s2[n], err_msg=n)


def test_window_matches_jax_run_window(feeds):
    jmain, jstartup, jout = build(jfluid, jbert)
    pmain, _, pout = build(fluid, bert)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = persistables(jmain)
    assert names == persistables(pmain)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    pscope.step_counter = jscope.step_counter
    pexe = fluid.Executor(fluid.CPUPlace())
    jl, pl = [], []
    for w in range(2):
        st = stack(feeds[w * K:(w + 1) * K])
        jl.append(np.asarray(jexe.run_window(
            jmain, feed=st, fetch_list=[jout["loss"].name], scope=jscope,
            steps_per_run=K)[0]).ravel())
        pl.append(pexe.run_window(
            pmain, feed=st, fetch_list=[pout["loss"]], scope=pscope,
            steps_per_run=K)[0].numpy().ravel())
    np.testing.assert_allclose(np.concatenate(pl), np.concatenate(jl),
                               rtol=1e-4)
    assert pscope.step_counter == jscope.step_counter
    for n in names:
        np.testing.assert_allclose(pscope.find_var_numpy(n),
                                   np.array(jscope.find_var(n)),
                                   atol=1e-5, err_msg=n)


def test_wrong_leading_dim_raises_and_plans_are_cached(feeds):
    main, startup, out = build(fluid, bert)
    exe, scope = port_started(main, startup)
    with pytest.raises(ValueError, match="leading dim 4"):
        exe.run_window(main, feed=stack(feeds[:3]),
                       fetch_list=[out["loss"]], scope=scope,
                       steps_per_run=K)
    c0 = exe.compile_count()
    for w in range(2):
        exe.run_window(main, feed=stack(feeds[w * K:(w + 1) * K]),
                       fetch_list=[out["loss"]], scope=scope,
                       steps_per_run=K)
    assert exe.compile_count() == c0 + 1     # one plan, reused
    exe.run_window(main, feed=stack(feeds[:2]), fetch_list=[out["loss"]],
                   scope=scope, steps_per_run=2)
    assert exe.compile_count() == c0 + 2     # another K, another plan
    with pytest.raises(RuntimeError, match="return_numpy=False"):
        exe.run_window(main, feed=stack(feeds[:K]),
                       fetch_list=[out["loss"]], scope=scope,
                       steps_per_run=K, return_numpy=True)
    with pytest.raises(ValueError, match="FLAGS_steps_per_run"):
        exe.run_window(main, feed=stack(feeds[:K]), scope=scope,
                       steps_per_run=0)


def _log_program(pkg):
    """x -> fc -> log(x) + mean(fc) -> mean, SGD; a batch of -1s makes
    the loss NaN (the JAX package's skip-policy program)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 2
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        pred = pkg.layers.fc(x, size=2)
        out = pkg.layers.log(x) + pkg.layers.mean(pred)
        loss = pkg.layers.mean(out)
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _poisoned_window(pkg, flags_mod, prof, policy):
    main, startup, loss = _log_program(pkg)
    good = np.ones((8, 4), np.float32)
    bad = -np.ones((8, 4), np.float32)
    seq = np.stack([good, bad, good, good])
    flags_mod.set_flag("check_nan_inf", policy)
    prof.reset_bad_step_count()
    try:
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        names = [p.name for p in main.global_block().all_parameters()]
        before = {n: np.array(scope.find_var(n)) for n in names}
        exe.run_window(main, feed={"x": seq}, fetch_list=[loss],
                       scope=scope, steps_per_run=K)
        # the window's verdicts (the startup run may have left its own)
        verdicts = np.array(prof._bad_steps["pending"][-1]).ravel().tolist()
        after = {n: np.array(scope.find_var(n)) for n in names}
        return before, after, verdicts, prof.bad_step_count()
    finally:
        flags_mod.set_flag("check_nan_inf", "off")
        prof.reset_bad_step_count()


def test_skip_policy_keeps_state_of_a_poisoned_inner_step():
    pbefore, pafter, pv, pbad = _poisoned_window(fluid, flags, profiler,
                                                 "skip")
    jbefore, jafter, jv, jbad = _poisoned_window(jfluid, jflags, jprofiler,
                                                 "skip")
    assert pv == jv == [True, False, True, True]
    assert pbad == jbad == 1
    # the poisoned step kept its state: the same parameters as the three
    # good steps alone
    main, startup, loss = _log_program(fluid)
    exe, scope = port_started(main, startup)
    good = np.ones((8, 4), np.float32)
    for _ in range(3):
        exe.run(main, feed={"x": good}, fetch_list=[loss], scope=scope)
    for n, v in pafter.items():
        np.testing.assert_array_equal(v, scope.find_var_numpy(n))
        # the packages draw different startup weights; this program's
        # gradient does not depend on them, so the updates agree
        np.testing.assert_allclose(v - pbefore[n], jafter[n] - jbefore[n],
                                   atol=1e-6)


def test_raise_policy_names_the_op_jax_names():
    msgs = []
    for pkg, flags_mod, prof in ((fluid, flags, profiler),
                                 (jfluid, jflags, jprofiler)):
        with pytest.raises(Exception, match="contains Inf or Nan") as e:
            _poisoned_window(pkg, flags_mod, prof, "raise")
        msgs.append(str(e.value).split("contains")[0].split()[-3:])
    assert msgs[0] == msgs[1]


def _windowed_run(main, startup, out, feeds, offset=1):
    """Startup, ``offset`` per-step runs, then one K-window."""
    exe, scope = port_started(main, startup)
    for f in feeds[:offset]:
        exe.run(main, feed=f, fetch_list=[out["loss"]], scope=scope)
    exe.run_window(main, feed=stack(feeds[offset:offset + K]),
                   fetch_list=[out["loss"]], scope=scope, steps_per_run=K)
    return exe, scope


def test_checkpoint_lands_on_the_window_boundary(feeds, tmp_path):
    main, startup, out = build(fluid, bert)
    exe, scope = _windowed_run(main, startup, out, feeds)
    mgr = fluid.CheckpointManager(str(tmp_path), async_save=False,
                                  main_program=main, steps_per_run=K)
    path = mgr.save(scope=scope)
    # startup + 1 run + a window of 4: the marker, not a multiple of K
    assert scope._window_end == scope.step_counter == 6
    meta = fluid.checkpoint.checkpoint_metadata(path)
    assert meta["steps_per_run"] == K and meta["step"] == 6
    exe.run(main, feed=feeds[0], fetch_list=[out["loss"]], scope=scope)
    with pytest.raises(ValueError, match="not a window boundary"):
        mgr.save(scope=scope)
    fresh = fluid.Scope()
    other = fluid.CheckpointManager(str(tmp_path), main_program=main,
                                    steps_per_run=8, place=fluid.CPUPlace())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = other.resume(scope=fresh)
    assert got["steps_per_run"] == K
    assert any("steps_per_run=4" in str(x.message) for x in w)
    assert fresh._window_end == fresh.step_counter == 6


def test_windowed_port_checkpoint_restores_into_jax_bit_exact(
        feeds, tmp_path):
    pmain, pstartup, pout = build(fluid, bert)
    _, scope = _windowed_run(pmain, pstartup, pout, feeds)
    fluid.CheckpointManager(str(tmp_path), async_save=False,
                            main_program=pmain, steps_per_run=K).save(
        scope=scope)
    jmain, jstartup, _ = build(jfluid, jbert)
    jscope = jfluid.Scope()
    meta = JCheckpointManager(str(tmp_path), async_save=False,
                              main_program=jmain,
                              steps_per_run=K).resume(scope=jscope)
    assert meta["steps_per_run"] == K and jscope.step_counter == 6
    for n in persistables(pmain):
        np.testing.assert_array_equal(np.array(jscope.find_var(n)),
                                      scope.find_var_numpy(n), err_msg=n)
