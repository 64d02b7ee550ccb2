"""TSM, the temporal-shift ResNet-50 (``paddle_tpu_torch/models/tsm.py``,
the model zoo's video classifier), in the port against paddle_tpu on the
CPU.

At ``tsm.test_config()`` (one bottleneck a stage, widths / 8, clips of 4
frames of 32 x 32, 10 classes, 2 clips, dropout off) both packages build
the program from the same builders (the port's ``models/tsm.py``, loaded
a second time as a module of ``paddle_tpu.models``), and their op types
and persistable shapes must be equal, there and at ``base_config()``.
JAX's startup persistables are carried into the port's scope
(``fluid.load_numpy_params``) and both take three Momentum steps on the
first three synthetic batches, at the rates 0.01, 0.001 and 0.0001 (the
test config's boundaries are ``[1, 2]``).

The conditioning account behind the tolerances.  Each of the 13 batch
norms normalises by statistics over 8 frames of at most 16 x 16 (down to
1 x 1 after the last stage's stride: 8 values a channel there), which
amplifies a relative difference of its input by up to ~10x; relu's kink
sends a pre-activation that rounds to the other side of 0 in one package
from the whole slope to none; the softmax over 10 classes of a mean over
4 frames then feeds one cross entropy.  So the step-1 gradient moves
under rounding alone: JAX's own whole gradient moves by 3.6e-6 to
5.7e-6 in relative L2 (its worst parameter's by 1.0e-5 to 1.3e-5) when
the frames move by a relative 1e-7, about an ulp, and the port's by
4.3e-6.  Measured port against JAX (``python tests/test_torch_tsm.py``
prints it): the step-1 loss 8.7e-8 relative, the whole gradient 1.1e-5,
the worst parameter's 2.9e-5 (``bn2a_branch2b_scale``), 2-3x the nudge's
spread.  The tolerances: the step-1 loss at ``rtol 1e-5``; each
parameter's gradient within ``1e-4`` in relative L2 and the whole
within ``5e-5``.  Each step again from JAX's state holds the loss at
``rtol 1e-5``, each velocity (a running sum of gradients, so of their
conditioning) within ``1e-4`` in relative L2, and every other
persistable (weights, moving statistics, the step counter) entry by
entry at ``rtol 1e-4, atol 1e-6``.  The three chained losses, which
carry each step's gradient difference into the next step's weights, are
held at ``rtol 1e-4`` (measured 1.2e-5 at step 3).

The shift itself: a clip whose frames are the constants 1, 2, 3, 4 (and
11, 12, ... in the second clip) goes through the bottleneck's ``shift``
in both packages; channels ``[0, C/8)`` must read the frame before (0 at
the first), ``[C/8, C/4)`` the frame after (0 at the last), the rest
their own.
"""

import importlib.util

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (the parent of the second module)
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import tsm
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

STEPS = 3
SEED = 13
LOSS_RTOL = 1e-5              # step 1 and each step again
CHAIN_RTOL = 1e-4             # the three chained losses (measured 1.2e-5)
PARAM_GRAD_TOL = 1e-4         # relative L2, each parameter's step-1 gradient
#                               and each velocity after a step (2.9e-5)
GRAD_TOL = 5e-5               # relative L2, the whole step-1 gradient
#                               (measured 1.1e-5; JAX's own moves by up to
#                               5.7e-6 under a 1e-7 nudge of the frames)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)   # every other persistable


def _jax_tsm():
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu.models._tsm_of_the_port", tsm.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTSM = _jax_tsm()


def _build(pkg, cfg):
    mod = JTSM if pkg is jfluid else tsm
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build(cfg)
    return main, startup, out


def _scope(pkg, state):
    scope = pkg.Scope()
    if pkg is jfluid:
        import jax.numpy as jnp
        for n, v in state.items():
            scope.set_var(n, jnp.asarray(v))
    else:
        fluid.load_numpy_params(scope, state, fluid.CPUPlace())
    return scope


def _read(pkg, scope, n):
    return np.array(scope.find_var(n)) if pkg is jfluid else \
        scope.find_var_numpy(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _collect():
    cfg = tsm.test_config()
    jmain, jstartup, _ = _build(jfluid, cfg)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in jmain.global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    batches = [f for _, f in zip(range(STEPS), tsm.feeds(cfg, SEED))]
    out = dict(params=params, names=names)
    states = {}
    for pkg in (jfluid, fluid):
        main, _, built = _build(pkg, cfg)
        scope = _scope(pkg, init)
        exe = pkg.Executor(pkg.CPUPlace())
        steps, after = [], []
        # every step fetches the gradients, so JAX compiles the step once
        for f in batches:
            got = [np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=[built["loss"]] + grads,
                scope=scope)]
            steps.append((float(got[0].reshape(-1)[0]), got[1:]))
            after.append({n: _read(pkg, scope, n) for n in names})
        out[pkg] = steps
        states[pkg] = after
    # the port's step k again from JAX's state before it
    before = [init] + states[jfluid][:-1]
    main, _, built = _build(fluid, cfg)
    exe = fluid.Executor(fluid.CPUPlace())
    out["again"] = []
    for k, f in enumerate(batches):
        scope = _scope(fluid, before[k])
        loss = exe.run(main, feed=f, fetch_list=[built["loss"]],
                       scope=scope)[0]
        out["again"].append(dict(
            loss=float(np.asarray(loss).reshape(-1)[0]),
            after={n: _read(fluid, scope, n) for n in names},
            ref_after=states[jfluid][k]))
    return out


@pytest.fixture(scope="module")
def runs():
    return _collect()


@pytest.mark.parametrize("which", ["test", "base"])
def test_programs_are_the_same(which):
    """The same op types in order and the same persistables and shapes
    in both packages; one ``temporal_shift`` a bottleneck (4 at the test
    config, 16 at the zoo's), each ahead of its block's first 1x1 conv."""
    cfg = tsm.test_config() if which == "test" else tsm.base_config()
    j, _, _ = _build(jfluid, cfg)
    p, _, _ = _build(fluid, cfg)
    ops = [o.type for o in p.global_block().ops]
    assert ops == [o.type for o in j.global_block().ops]
    shapes = [{v.name: tuple(v.shape) for v in m.list_vars()
               if v.persistable} for m in (j, p)]
    assert shapes[0] == shapes[1]
    blocks = sum(cfg["depth"])
    assert ops.count("temporal_shift") == blocks
    assert all(ops[k + 1] == "conv2d" for k, t in enumerate(ops)
               if t == "temporal_shift")
    assert ops.count("conv2d") == 1 + 3 * blocks + len(cfg["depth"])
    assert ("dropout" in ops) == (which == "base")


def test_base_config_shape():
    """The model zoo's widths: a ResNet-50 (53 convs, 24.3 M parameters
    with the 400-way fc), 16 shifts of 1/8 over 8 frames, the input ``[16,
    8, 3, 224, 224]``, dropout 0.5."""
    cfg = tsm.base_config()
    main, _, out = _build(fluid, cfg)
    ops = main.global_block().ops
    shifts = [o for o in ops if o.type == "temporal_shift"]
    assert len(shifts) == 16
    assert all(o.attr("seg_num") == 8 and o.attr("shift_ratio") == 0.125
               for o in shifts)
    assert main.global_block().var("image").shape == (16, 8, 3, 224, 224)
    assert tuple(main.global_block().var("res5c_branch2c_weights").shape) \
        == (2048, 512, 1, 1)
    params = main.global_block().all_parameters()
    assert sum(int(np.prod(p.shape)) for p in params) == 24327632
    assert [o.attr("dropout_prob") for o in ops if o.type == "dropout"] == \
        [0.5]
    assert tsm.images_per_step(cfg) == 128
    assert tuple(out["out"].shape)[-1] == 400


def test_step1_loss_and_gradients(runs):
    """Step 1 from JAX's startup weights: the loss and every parameter's
    gradient."""
    (jl, jg), (pl, pg) = runs[jfluid][0], runs[fluid][0]
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for name, a, b in zip(runs["params"], pg, jg):
        assert _rel(a, b) <= PARAM_GRAD_TOL, (name, _rel(a, b))
    whole = _rel(np.concatenate([g.ravel() for g in pg]),
                 np.concatenate([g.ravel() for g in jg]))
    assert whole <= GRAD_TOL, whole


def test_each_step_again_from_the_reference_state(runs):
    """Each step from JAX's state before it: the loss, each velocity in
    relative L2 and every other persistable after it entry by entry."""
    for k, again in enumerate(runs["again"]):
        np.testing.assert_allclose(again["loss"], runs[jfluid][k][0],
                                   rtol=LOSS_RTOL)
        for n in runs["names"]:
            got, want = again["after"][n], again["ref_after"][n]
            if n.endswith("_velocity_0"):
                assert _rel(got, want) <= PARAM_GRAD_TOL, (k, n)
            else:
                np.testing.assert_allclose(got, want, err_msg="step %d %s" %
                                           (k, n), **STATE_TOL)


def test_three_chained_steps(runs):
    """Three steps in each package from the same start: finite losses
    within CHAIN_RTOL of JAX's."""
    jl = [s[0] for s in runs[jfluid]]
    pl = [s[0] for s in runs[fluid]]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=CHAIN_RTOL)


def _shift_run(pkg, x, cfg):
    main, startup = pkg.Program(), pkg.Program()
    mod = JTSM if pkg is jfluid else tsm
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        v = pkg.layers.data("x", list(x.shape), dtype="float32",
                            append_batch_size=False)
        out = mod.shift(v, cfg)
    return np.asarray(pkg.Executor(pkg.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[out])[0])


@pytest.mark.parametrize("channels", [16, 12])
def test_shift_reads_the_neighbouring_frames(channels):
    """Frames of distinct constants: channels ``[0, int(C/8))`` read the
    frame before, ``[int(C/8), int(C/4))`` the frame after, zero past the
    clip, the rest their own; at C = 12 the split points are truncated
    (1 and 3)."""
    cfg = tsm.test_config()
    T = cfg["seg_num"]
    frame = np.array([[10 * n + t + 1 for t in range(T)] for n in range(2)],
                     np.float32)
    x = np.broadcast_to(frame.reshape(2 * T, 1, 1, 1),
                        (2 * T, channels, 2, 2)).copy()
    c1, c2 = int(channels / 8), int(channels / 4)
    prev = np.concatenate([np.zeros((2, 1)), frame[:, :-1]], 1).reshape(-1)
    nxt = np.concatenate([frame[:, 1:], np.zeros((2, 1))], 1).reshape(-1)
    for pkg in (jfluid, fluid):
        got = _shift_run(pkg, x, cfg)[:, :, 0, 0]
        np.testing.assert_array_equal(got[:, :c1], np.repeat(
            prev[:, None], c1, 1))
        np.testing.assert_array_equal(got[:, c1:c2], np.repeat(
            nxt[:, None], c2 - c1, 1))
        np.testing.assert_array_equal(got[:, c2:], x[:, c2:, 0, 0])


if __name__ == "__main__":
    # the readings the tolerances rest on
    r = _collect()
    (jl, jg), (pl, pg) = r[jfluid][0], r[fluid][0]
    print("step-1 loss", jl, pl, abs(pl - jl) / abs(jl))
    rels = sorted(((_rel(a, b), n) for n, a, b in
                   zip(r["params"], pg, jg)), reverse=True)
    print("worst gradients", rels[:5])
    print("whole gradient", _rel(np.concatenate([g.ravel() for g in pg]),
                                 np.concatenate([g.ravel() for g in jg])))
    print("chained losses", [s[0] for s in r[jfluid]],
          [s[0] for s in r[fluid]])
    print("each step again, worst velocity", max(
        (_rel(a["after"][n], a["ref_after"][n]), n, k)
        for k, a in enumerate(r["again"]) for n in r["names"]
        if n.endswith("_velocity_0")))
