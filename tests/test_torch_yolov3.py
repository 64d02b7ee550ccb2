"""YOLOv3 on DarkNet-53 (``paddle_tpu_torch/models/yolov3.py``, the model
zoo's detector) in the port against paddle_tpu on the CPU.

At ``yolov3.test_config()`` (one block a stage, widths / 8, 64 x 64
images, maps of 2², 4² and 8², 4 classes, batch 2, 6 ground-truth slots)
both packages build the program from the same builders (the port's
``models/yolov3.py``, loaded a second time as a module of
``paddle_tpu.models``), and their op types and persistable shapes must
be equal.  JAX's startup persistables are carried into the port's scope
(``fluid.load_numpy_params``) and both take three Momentum steps on the
first three synthetic batches.  The test config's warm-up is 2 steps, so
the steps run at the rates 0, 5e-4 and 1e-3 (the ramp, then the
piecewise schedule): the first updates only the velocities and the
batch-norm statistics, the other two move the weights (by up to 0.03
and 0.085 here).

The conditioning account behind the tolerances.  ``leaky_relu`` has no
dead zone, so a pre-activation that rounds to the other side of 0 in
one package changes its entry's gradient by 0.9 of it, not all of it,
and only where the pre-activation is within a rounding of 0.  The 36
batch norms each divide by a batch statistic; on the 2 x 2 map at batch
2 a statistic averages 8 values, which amplifies a relative difference
by up to ~10x a layer, and the 1x1 route and transition convs chain
them without a residual.  ``yolov3_loss`` matches each ground truth to
the anchor of the best IoU, from the ground truth and the anchors alone
(equal across packages), and ignores a cell whose predicted box has an
IoU above ``ignore_thresh`` with some ground truth: a predicted box
within a rounding of the threshold would flip that cell's objectness
term, a jump no tolerance covers (none occurs in these batches).
Measured (``python tests/test_torch_yolov3.py``
prints it): the step-1 loss is bit-equal, the worst parameter's gradient
3.9e-6 in relative L2, the whole gradient 1.3e-7.  The tolerances leave
a factor of 25 or more over those: each parameter's step-1 gradient
within ``1e-4`` in relative L2, the whole within ``1e-5``.  Each step
again from JAX's state holds the loss at ``rtol 1e-5`` and every
persistable (weights, velocities and moving statistics) at ``rtol 1e-4,
atol 1e-6`` (measured: every entry within ``1e-4 |ref| + 9e-8``); the
three chained losses at ``rtol 1e-5`` (measured 7.7e-8).

The evaluation program (``yolo_box`` on the three maps, ``transpose``,
``concat``, ``multiclass_nms`` over the 4 classes, no background) runs
in both packages on JAX's trained state: the ``[2, 100, 6]`` slab's
labels exactly, its scores and boxes within ``atol 1e-5``.
"""

import importlib.util

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (the parent of the second module)
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import yolov3
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

STEPS = 3
SEED = 11
LOSS_RTOL = 1e-5              # step 1, each step again, the chained losses
PARAM_GRAD_TOL = 1e-4         # relative L2, each parameter's step-1 gradient
GRAD_TOL = 1e-5               # relative L2, the whole step-1 gradient
STATE_TOL = dict(rtol=1e-4, atol=1e-6)   # every persistable after a step
SLAB_ATOL = 1e-5


def _jax_yolov3():
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu.models._yolov3_of_the_port", yolov3.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JYOLO = _jax_yolov3()


def _build(pkg, cfg, evaluate=False):
    mod = JYOLO if pkg is jfluid else yolov3
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_eval(cfg) if evaluate else mod.build(cfg)
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


class _Run:
    """One package's training program on a scope."""

    def __init__(self, pkg, cfg, state):
        self.pkg = pkg
        self.main, _, out = _build(pkg, cfg)
        self.loss = out["loss"]
        self.scope = _scope(pkg, state)
        self.exe = pkg.Executor(pkg.CPUPlace())

    def step(self, feed, extra=()):
        got = [np.asarray(v) for v in self.exe.run(
            self.main, feed=feed, fetch_list=[self.loss] + list(extra),
            scope=self.scope)]
        return float(got[0].reshape(-1)[0]), got[1:]

    def state(self, names):
        return {n: _read(self.pkg, self.scope, n) for n in names}


def _collect():
    cfg = yolov3.test_config()
    jmain, jstartup, _ = _build(jfluid, cfg)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in jmain.global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    batches = [f for _, f in zip(range(STEPS), yolov3.feeds(cfg, SEED))]
    out = dict(cfg=cfg, init=init, params=params, names=names)
    states = {}
    for pkg in (jfluid, fluid):
        run = _Run(pkg, cfg, init)
        steps, after = [], []
        # every step fetches the gradients, so JAX compiles the step once
        for f in batches:
            steps.append(run.step(f, grads))
            after.append(run.state(names))
        out[pkg] = dict(steps=steps)
        states[pkg] = after
    # the port's step k again from JAX's state before it
    before = [init] + states[jfluid][:-1]
    out["again"] = []
    for k, f in enumerate(batches):
        run = _Run(fluid, cfg, before[k])
        loss, _ = run.step(f)
        out["again"].append(dict(loss=loss, after=run.state(names),
                                 ref_after=states[jfluid][k]))
    # evaluation of JAX's trained state in both packages
    for pkg in (jfluid, fluid):
        emain, _, eout = _build(pkg, cfg, evaluate=True)
        scope = _scope(pkg, states[jfluid][-1])
        exe = pkg.Executor(pkg.CPUPlace())
        out[pkg]["eval"] = [np.asarray(exe.run(
            emain, feed=yolov3.eval_feed(cfg, f), fetch_list=eout["outs"],
            scope=scope)[0]) for f in batches[:2]]
    return out


@pytest.fixture(scope="module")
def runs():
    return _collect()


@pytest.mark.parametrize("evaluate", [False, True], ids=["train", "eval"])
def test_programs_are_the_same(evaluate):
    """The same op types in order and the same persistables and shapes
    in both packages; 39 convolutions, 36 of them followed by
    ``leaky_relu``, at the test widths."""
    cfg = yolov3.test_config()
    j, _, _ = _build(jfluid, cfg, evaluate)
    p, _, _ = _build(fluid, cfg, evaluate)
    ops = [o.type for o in p.global_block().ops]
    assert ops == [o.type for o in j.global_block().ops]
    shapes = [{v.name: tuple(v.shape) for v in m.list_vars()
               if v.persistable} for m in (j, p)]
    assert shapes[0] == shapes[1]
    assert ops.count("conv2d") == 39 and ops.count("leaky_relu") == 36
    for t in (("multiclass_nms", "yolo_box", "transpose2", "concat")
              if evaluate else ("yolov3_loss", "momentum",
                                "nearest_interp")):
        assert t in ops, t


def test_base_config_shape():
    """The model zoo's widths: 75 convolutions, 72 followed by
    ``leaky_relu`` at 0.1, outputs of 255 channels on maps of 19, 38 and
    76, the last stage 1024 wide; 608 x 608 images, batch 8."""
    cfg = yolov3.base_config()
    main, _, out = _build(fluid, cfg)
    ops = main.global_block().ops
    types = [o.type for o in ops]
    assert types.count("conv2d") == 75 and types.count("leaky_relu") == 72
    assert all(o.attr("alpha") == 0.1 for o in ops
               if o.type == "leaky_relu")
    assert yolov3.map_sides(cfg) == [19, 38, 76]
    assert [tuple(o.shape) for o in out["outputs"]] == \
        [(8, 255, s, s) for s in (19, 38, 76)]
    w = main.global_block().var("stage.4.3.1.conv.weights")
    assert tuple(w.shape) == (1024, 512, 3, 3)


def test_step1_loss_and_gradients(runs):
    """Step 1 from JAX's startup weights: the loss and every parameter's
    gradient."""
    (jl, jg), (pl, pg) = (runs[k]["steps"][0] for k in (jfluid, fluid))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for name, a, b in zip(runs["params"], pg, jg):
        assert _rel(a, b) <= PARAM_GRAD_TOL, (name, _rel(a, b))
    whole = _rel(np.concatenate([g.ravel() for g in pg]),
                 np.concatenate([g.ravel() for g in jg]))
    assert whole <= GRAD_TOL, whole


def test_each_step_again_from_the_reference_state(runs):
    """Each step from JAX's state before it: the loss, and every
    persistable after it (parameters, velocities, moving statistics,
    the step counter)."""
    for k, again in enumerate(runs["again"]):
        jl = runs[jfluid]["steps"][k][0]
        np.testing.assert_allclose(again["loss"], jl, rtol=LOSS_RTOL)
        for n in runs["names"]:
            np.testing.assert_allclose(again["after"][n],
                                       again["ref_after"][n],
                                       err_msg="step %d %s" % (k, n),
                                       **STATE_TOL)


def test_three_chained_steps(runs):
    """Three steps in each package from the same start: finite losses
    within LOSS_RTOL of JAX's."""
    jl = [s[0] for s in runs[jfluid]["steps"]]
    pl = [s[0] for s in runs[fluid]["steps"]]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_eval_slab_on_the_same_scope(runs):
    """``[2, 100, 6]`` slabs: labels exactly, scores and boxes within
    SLAB_ATOL; kept rows carry a class in ``[0, 4)``, padding rows -1."""
    for js, ps in zip(runs[jfluid]["eval"], runs[fluid]["eval"]):
        assert ps.shape == js.shape == (2, 100, 6)
        np.testing.assert_array_equal(ps[..., 0], js[..., 0])
        np.testing.assert_allclose(ps[..., 1:], js[..., 1:], rtol=0,
                                   atol=SLAB_ATOL)
        labels = ps[..., 0]
        assert (labels >= 0).any()
        assert ((labels == -1) | ((labels >= 0) & (labels < 4))).all()


if __name__ == "__main__":
    # the readings the tolerances rest on
    r = _collect()
    (jl, jg), (pl, pg) = (r[k]["steps"][0] for k in (jfluid, fluid))
    print("step-1 loss", jl, pl, abs(pl - jl) / abs(jl))
    rels = sorted(((_rel(a, b), n) for n, a, b in
                   zip(r["params"], pg, jg)), reverse=True)
    print("worst gradients", rels[:5])
    print("whole gradient", _rel(np.concatenate([g.ravel() for g in pg]),
                                 np.concatenate([g.ravel() for g in jg])))
