"""AMP loss scaling in the port (``contrib.mixed_precision.decorate`` with
``init_loss_scaling != 1`` or dynamic scaling), against paddle_tpu on
the CPU, each program from JAX's startup state:

- static scaling (128, SGD): the same ops as JAX's; per-step losses
  ``rtol 1e-5, atol 1e-6`` against the unscaled program and against
  JAX's, every persistable ``rtol 1e-5, atol 1e-6``;
- dynamic scaling (SGD and Adam; init 64, incr every 2, decr every 1)
  with an inf fed on step 2: the same ops as JAX's; the gated gradients
  of the bad step exactly 0; SGD's parameters bit-unchanged by it while
  Adam's move by its moments, as in JAX; ``loss_scaling``,
  ``amp_good_steps`` and ``amp_bad_steps`` after every step equal to
  JAX's and to the closed form (64, 51.2, 51.2, 102.4, ...); every
  persistable after every step ``rtol 1e-5, atol 1e-6``;
- pure bf16 with dynamic scaling and Adam: the scale sequence exactly,
  losses ``rtol 2e-2`` (bf16 products in both packages);
- GradientMerge over AMP with dynamic scaling (the JAX package's
  composability case, in one process): losses and persistables as
  above, the accumulators of loss-scaled (x128) gradients at ``atol``
  128e-6.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.contrib import mixed_precision as jamp

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision as amp
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

AMP = {jfluid: jamp, fluid: amp}


def _data(n=32, d=8, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    return xs, xs.sum(1, keepdims=True).astype(np.float32)


def _mlp(pkg):
    L = pkg.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, 16, act="relu")
    pred = L.fc(h, 1)
    return L.mean(L.square_error_cost(pred, y))


def _ops(prog):
    return [[(op.type, op.inputs, op.outputs, op.attrs) for op in b.ops]
            for b in prog.blocks]


def _get(pkg, scope, name):
    if pkg is fluid:
        return scope.find_var_numpy(name)
    return np.asarray(scope.find_var(name))


def run_both(make_opt, feeds, fetch=lambda main, opt: []):
    """The program in both packages, the port from JAX's startup state;
    per step the loss, the extra fetches and every persistable."""
    out, init = {}, None
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss = _mlp(pkg)
            opt = make_opt(pkg)
            opt.minimize(loss)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: np.array(scope.find_var(n)) for n in names}
        else:
            fluid.load_numpy_params(scope, init, fluid.CPUPlace())
        extra = fetch(main, opt)
        losses, fetched, states = [], [], []
        for feed in feeds:
            got = exe.run(main, feed=feed, fetch_list=[loss] + extra,
                          scope=scope)
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            fetched.append([np.asarray(g) for g in got[1:]])
            states.append({n: _get(pkg, scope, n) for n in names})
        out[pkg] = dict(main=main, opt=opt, losses=losses, fetched=fetched,
                        states=states, init=init)
    return out[jfluid], out[fluid]


def _check_states(j, p, rtol=1e-5, atol=1e-6, scaled=1.0):
    """Every persistable after every step; gradient-merge accumulators,
    which hold loss-scaled gradients, at ``atol`` times the scale."""
    for step, (sj, sp) in enumerate(zip(j["states"], p["states"])):
        for n in sj:
            tol = atol * scaled if "_gm_acc" in n else atol
            np.testing.assert_allclose(sp[n], sj[n], rtol=rtol, atol=tol,
                                       err_msg="%s step %d" % (n, step))


def test_static_loss_scaling_matches_unscaled_and_jax():
    xs, ys = _data()
    feeds = [{"x": xs, "y": ys}] * 5
    j, p = run_both(lambda pkg: AMP[pkg].decorate(
        pkg.optimizer.SGDOptimizer(0.1), init_loss_scaling=128.0,
        amp_dtype=None), feeds)
    _jp, plain = run_both(lambda pkg: pkg.optimizer.SGDOptimizer(0.1), feeds)
    assert _ops(p["main"]) == _ops(j["main"])
    kinds = [op.type for op in p["main"].global_block().ops]
    assert kinds.count("isfinite") == 1 and kinds.count("where") == 4
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p["losses"], plain["losses"], rtol=1e-5,
                               atol=1e-6)
    _check_states(j, p)


def _dynamic_closed_form(init, finite, incr_every, decr_every, incr=2.0,
                         decr=0.8):
    scale, good, bad, out = np.float32(init), 0, 0, []
    for ok in finite:
        good, bad = (good + 1, 0) if ok else (0, bad + 1)
        if good >= incr_every:
            scale, good = np.float32(scale * np.float32(incr)), 0
        if bad >= decr_every:
            scale, bad = np.float32(scale * np.float32(decr)), 0
        scale = max(scale, np.float32(1.0))
        out.append((float(scale), good, bad))
    return out


def _gated_grads(main, opt):
    """The ``where`` outputs: the gradients the optimizer ops read."""
    return [op.output("Out")[0] for op in main.global_block().ops
            if op.type == "where"]


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_dynamic_loss_scaling_skips_a_bad_step_as_jax_does(inner):
    xs, ys = _data()
    bad = xs.copy()
    bad[0, 0] = np.inf
    feeds = [{"x": xs, "y": ys}, {"x": bad, "y": ys}] + \
        [{"x": xs, "y": ys}] * 4

    def make(pkg):
        base = pkg.optimizer.SGDOptimizer(0.1) if inner == "sgd" else \
            pkg.optimizer.AdamOptimizer(0.01)
        return AMP[pkg].decorate(base, init_loss_scaling=64.0,
                                 use_dynamic_loss_scaling=True,
                                 decr_every_n_nan_or_inf=1,
                                 incr_every_n_steps=2, amp_dtype=None)
    j, p = run_both(make, feeds, _gated_grads)
    assert _ops(p["main"]) == _ops(j["main"])
    assert not np.isfinite(p["losses"][1])
    for g in p["fetched"][1]:
        np.testing.assert_array_equal(g, 0)
    want = _dynamic_closed_form(64.0, [True, False, True, True, True, True],
                                2, 1)
    scale = p["opt"].get_loss_scaling().name
    for step, s in enumerate(p["states"]):
        counters = sorted(n for n in s if n.startswith("amp_"))
        got = (float(s[scale][0]),) + tuple(int(s[n][0]) for n in
                                            reversed(counters))
        assert got == want[step], (step, got, want[step])
    params = [v.name for v in p["main"].global_block().all_parameters()]
    moved = [not np.array_equal(p["states"][1][n], p["states"][0][n])
             for n in params]
    # a skipped step leaves SGD's parameters alone; Adam's moments still
    # move them (the reference's semantics, kept by both packages)
    assert not any(moved) if inner == "sgd" else all(moved)
    finite = [l for i, l in enumerate(p["losses"]) if i != 1]
    np.testing.assert_allclose(finite, [l for i, l in enumerate(j["losses"])
                                        if i != 1], rtol=1e-5, atol=1e-6)
    _check_states(j, p)


def test_pure_bf16_dynamic_scaling_matches_jax():
    xs, ys = _data(seed=3)
    bad = xs.copy()
    bad[1, 2] = np.nan
    feeds = [{"x": xs, "y": ys}] * 2 + [{"x": bad, "y": ys}] + \
        [{"x": xs, "y": ys}] * 2
    j, p = run_both(lambda pkg: AMP[pkg].decorate(
        pkg.optimizer.AdamOptimizer(1e-2), init_loss_scaling=2.0 ** 15,
        use_dynamic_loss_scaling=True, incr_every_n_steps=2,
        decr_every_n_nan_or_inf=1, use_pure_bf16=True), feeds)
    assert p["main"]._amp_dtype == "bfloat16" and p["main"]._amp_keep
    scale = p["opt"].get_loss_scaling().name
    got = [float(s[scale][0]) for s in p["states"]]
    assert got == [float(s[scale][0]) for s in j["states"]]
    assert got == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16 * np.float32(0.8),
                   2.0 ** 16 * np.float32(0.8), 2.0 ** 17 * np.float32(0.8)]
    ok = [i for i in range(5) if i != 2]
    assert np.isfinite([p["losses"][i] for i in ok]).all()
    np.testing.assert_allclose([p["losses"][i] for i in ok],
                               [j["losses"][i] for i in ok], rtol=2e-2)


def test_gradient_merge_over_dynamic_scaling_matches_jax():
    rng = np.random.RandomState(9)
    xs = rng.normal(size=(32, 8)).astype(np.float32)
    ys = rng.normal(size=(32, 1)).astype(np.float32)
    feeds = [{"x": xs[(s % 2) * 16:(s % 2) * 16 + 16],
              "y": ys[(s % 2) * 16:(s % 2) * 16 + 16]} for s in range(6)]

    def make(pkg):
        opt = AMP[pkg].decorate(pkg.optimizer.SGDOptimizer(0.1),
                                init_loss_scaling=128.0,
                                use_dynamic_loss_scaling=True,
                                incr_every_n_steps=3, amp_dtype=None)
        return pkg.optimizer.GradientMergeOptimizer(opt, k_steps=2)
    j, p = run_both(make, feeds)
    assert _ops(p["main"]) == _ops(j["main"])
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5,
                               atol=1e-6)
    _check_states(j, p, scaled=128.0)
    assert p["losses"][-1] < p["losses"][0]
