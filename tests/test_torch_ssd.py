"""MobileNet-SSD (``paddle_tpu_torch/models/ssd.py``, the model zoo's
detector) and the JAX package's two detection layer pipelines, in the
port against paddle_tpu on the CPU.

MobileNet-SSD at ``ssd.test_config()`` (scale 0.25, 96 x 96 images, 204
priors, 6 classes, batch 4): both packages build the program from the
same builders (the port's ``models/ssd.py``, loaded a second time as a
module of ``paddle_tpu.models``), and their op types and persistable
shapes must be equal.  JAX's startup persistables are carried into the
port's scope and both take three RMSProp steps on the first three
synthetic batches.

This network is ill-conditioned in float32 at random weights, and the
tolerances say how far.  Its 35 batch norms each amplify a relative
difference (1e-5 after the first block, 1e-4 at module11, 1e-2 on the
1 x 1 maps, where a batch norm averages 4 values); one pre-activation
that rounds to the other side of a relu moves the whole step-1 gradient
by ~2%; RMSProp's first step is ~lr·sqrt(20)·sign(g), so a gradient
entry near 0 flips its step; and XLA's IoUs are not an IEEE-rounded
composition (its vectorised loop contracts ``ax + ay`` into an FMA, the
loop's scalar tail does not), so an exact IoU tie between two priors can
match a different prior in each package.  The checks:

- step 1 from the same weights: the loss within ``rtol 1e-5``; each
  head parameter's gradient (after the backbone's last relu) within
  ``1e-3`` in relative L2, the whole gradient within ``5e-2``;
- each step again from JAX's state before it: the match indices equal,
  or differing only between priors whose IoUs with the same ground
  truth tie within ``1e-6``; where they are equal, the loss within
  ``rtol 1e-4`` and every persistable's move together within ``1e-1``
  of JAX's move in relative L2;
- the three chained steps: the losses within ``5e-2`` relative.  Past a
  tie the two runs are two trajectories (their parameter moves differ
  by ~100% from step 3 on, as JAX's own two conv routes' do), so each
  parameter's move is held only to the size of JAX's, within a factor
  of ``2``.

The evaluation program (``detection_output`` + ``detection_map``) runs in
both packages on the same scope, JAX's trained state: the slab's labels
exactly, its scores and boxes within ``atol 1e-5``, the mAP equal.

The pipelines are ``tests/test_detection_layers.py``'s SSD (multi_box_head,
ssd_loss, detection_output; 8 SGD steps) and RPN (anchor_generator,
generate_proposals, rpn_target_assign; 5 SGD steps), built in both
packages from JAX's startup weights: losses within ``rtol 1e-4`` and the
final slabs (NMS rows, proposals) within ``atol 1e-4``, labels exactly.
"""

import importlib.util

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (the parent of the second module)
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import ssd
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

STEPS = 3
SEED = 11
LOSS_RTOL = 1e-5              # step 1 from the same weights
STEP_LOSS_RTOL = 1e-4         # each step again from JAX's state
HEAD_GRAD_TOL = 1e-3          # relative L2, each head parameter
GRAD_TOL = 5e-2               # relative L2, the whole step-1 gradient
STEP_MOVE_TOL = 1e-1          # relative L2, all moves of one step
CHAIN_LOSS_RTOL = 5e-2        # three chained steps
CHAIN_MOVE_FACTOR = 2.0
TIE_TOL = 1e-6                # IoUs this close are one tie
SLAB_ATOL = 1e-5
PIPE_RTOL = 1e-4


def _jax_ssd():
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu.models._ssd_of_the_port", ssd.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSSD = _jax_ssd()


def _build(pkg, cfg, evaluate=False):
    mod = JSSD if pkg is jfluid else ssd
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


def _moves(state, before, after_ref):
    """Every persistable's move from ``before``, concatenated, and the
    reference's: (mine, reference)."""
    mine, ref = [], []
    for n in sorted(before):
        mine.append((state[n].astype(np.float64) - before[n]).ravel())
        ref.append((after_ref[n].astype(np.float64) - before[n]).ravel())
    return np.concatenate(mine), np.concatenate(ref)


def _op_out(main, op_type, slot):
    return [o.output(slot)[0] for o in main.global_block().ops
            if o.type == op_type][0]


class _Run:
    """One package's training program on a scope, fetching the loss, the
    match indices and the IoUs (and, when asked, gradients)."""

    def __init__(self, pkg, cfg, state):
        self.pkg = pkg
        self.main, _, out = _build(pkg, cfg)
        self.scope = _scope(pkg, state)
        self.exe = pkg.Executor(pkg.CPUPlace())
        self.fetch = [out["loss"], _op_out(self.main, "bipartite_match",
                                           "ColToRowMatchIndices"),
                      _op_out(self.main, "iou_similarity", "Out")]

    def step(self, feed, extra=()):
        got = [np.asarray(v) for v in self.exe.run(
            self.main, feed=feed, fetch_list=self.fetch + list(extra),
            scope=self.scope)]
        return float(got[0].reshape(-1)[0]), got[1], got[2], got[3:]

    def state(self, names):
        return {n: _read(self.pkg, self.scope, n) for n in names}


@pytest.fixture(scope="module")
def runs():
    cfg = ssd.test_config()
    jmain, jstartup, _ = _build(jfluid, cfg)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in jmain.global_block().all_parameters()]
    grads = [p + "@GRAD" for p in params]
    batches = [f for _, f in zip(range(STEPS), ssd.feeds(cfg, SEED))]
    out = dict(cfg=cfg, init=init, params=params)
    chains = {}
    for pkg in (jfluid, fluid):
        run = _Run(pkg, cfg, init)
        steps = [run.step(f, grads if k == 0 else ())
                 for k, f in enumerate(batches)]
        chains[pkg] = dict(run=run, steps=steps, final=run.state(names))
    out["jax"], out["port"] = chains[jfluid], chains[fluid]
    # JAX's state before each step, then the port's step from it
    states, run = [init], _Run(jfluid, cfg, init)
    for f in batches[:-1]:
        run.step(f)
        states.append(run.state(names))
    states.append(out["jax"]["final"])
    out["again"] = []
    for k, f in enumerate(batches):
        run = _Run(fluid, cfg, states[k])
        loss, match, _, _ = run.step(f)
        out["again"].append(dict(loss=loss, match=match, before=states[k],
                                 after=run.state(names),
                                 ref_after=states[k + 1]))
    # evaluation of JAX's trained state in both packages
    for pkg, key in ((jfluid, "jax_eval"), (fluid, "port_eval")):
        emain, _, eout = _build(pkg, cfg, evaluate=True)
        scope = _scope(pkg, states[-1])
        exe = pkg.Executor(pkg.CPUPlace())
        out[key] = [[np.asarray(v) for v in exe.run(
            emain, feed=f, fetch_list=eout["outs"], scope=scope)]
            for f in batches]
    return out


def test_programs_are_the_same():
    """The same op types in order and the same persistables and shapes,
    for training and evaluation; the head's shapes."""
    cfg = ssd.test_config()
    for evaluate in (False, True):
        j, _, _ = _build(jfluid, cfg, evaluate)
        p, _, _ = _build(fluid, cfg, evaluate)
        assert [o.type for o in p.global_block().ops] == \
            [o.type for o in j.global_block().ops]
        shapes = {k: {v.name: tuple(v.shape) for v in m.list_vars()
                      if v.persistable} for k, m in ((0, j), (1, p))}
        assert shapes[0] == shapes[1]
    P = ssd.num_priors(cfg)
    assert P == 204
    _, _, po = _build(fluid, cfg)
    assert tuple(po["locs"].shape)[1:] == (P, 4)
    assert tuple(po["confs"].shape)[1:] == (P, cfg["classes"])
    ops = [o.type for o in p.global_block().ops]
    for t in ("depthwise_conv2d", "prior_box", "multiclass_nms",
              "detection_map"):
        assert t in ops, t


def test_base_config_priors():
    """The model zoo's head maps 19, 10, 5, 3, 2, 1: 1917 priors."""
    cfg = ssd.base_config()
    assert ssd.map_sides(cfg) == [19, 10, 5, 3, 2, 1]
    assert ssd.num_priors(cfg) == 1917


def test_step1_loss_and_gradients(runs):
    """Step 1 from JAX's startup weights: the loss, the head's
    gradients each and the whole gradient."""
    (jl, jm, _, jg), (pl, pm, _, pg) = (runs[k]["steps"][0]
                                        for k in ("jax", "port"))
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    head = 0
    for name, a, b in zip(runs["params"], pg, jg):
        if name.startswith("conv2d_") and \
                int(name.split("_")[1].split(".")[0]) >= 35:
            head += 1
            assert _rel(a, b) <= HEAD_GRAD_TOL, (name, _rel(a, b))
    assert head == 24
    whole = _rel(np.concatenate([g.ravel() for g in pg]),
                 np.concatenate([g.ravel() for g in jg]))
    assert whole <= GRAD_TOL, whole


def _tied(match_a, match_b, iou):
    """Every column where the two match slabs differ is one of two
    columns whose IoUs with the row either matched tie within TIE_TOL."""
    for b, c in zip(*np.nonzero(match_a != match_b)):
        rows = {int(r) for r in (match_a[b, c], match_b[b, c]) if r >= 0}
        others = [c2 for c2 in np.nonzero(match_a[b] != match_b[b])[0]
                  if c2 != c]
        if not any(abs(float(iou[b, r, c]) - float(iou[b, r, c2])) <=
                   TIE_TOL for r in rows for c2 in others):
            return False
    return True


def test_each_step_again_from_the_reference_state(runs):
    """Each step from JAX's state before it: matches equal or differing
    at IoU ties; where equal, the loss and the step's moves."""
    compared = 0
    for k, again in enumerate(runs["again"]):
        jl, jm, jiou, _ = runs["jax"]["steps"][k]
        assert _tied(again["match"], jm, jiou), k
        if not np.array_equal(again["match"], jm):
            continue
        compared += 1
        np.testing.assert_allclose(again["loss"], jl, rtol=STEP_LOSS_RTOL)
        mine, ref = _moves(again["after"], again["before"],
                           again["ref_after"])
        assert _rel(mine, ref) <= STEP_MOVE_TOL, (k, _rel(mine, ref))
    assert compared >= 2


def test_three_chained_steps(runs):
    """Three steps in each package from the same start: finite losses
    within CHAIN_LOSS_RTOL; each parameter's move within a factor
    CHAIN_MOVE_FACTOR of JAX's in L2."""
    jl = [s[0] for s in runs["jax"]["steps"]]
    pl = [s[0] for s in runs["port"]["steps"]]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=CHAIN_LOSS_RTOL)
    init, j, p = runs["init"], runs["jax"]["final"], runs["port"]["final"]
    for n in runs["params"]:
        dj = np.linalg.norm(j[n].astype(np.float64) - init[n])
        dp = np.linalg.norm(p[n].astype(np.float64) - init[n])
        if dj == 0:                 # a zero bias no loss term reaches
            assert dp == 0, n
            continue
        assert 1 / CHAIN_MOVE_FACTOR <= dp / dj <= CHAIN_MOVE_FACTOR, \
            (n, dp, dj)


def test_eval_slab_on_the_same_scope(runs):
    """``[4, 200, 6]`` slabs: labels exactly, scores and boxes within
    SLAB_ATOL, and the same mAP."""
    for jo, po in zip(runs["jax_eval"], runs["port_eval"]):
        js, ps = jo[0], po[0]
        assert ps.shape == js.shape == (4, 200, 6)
        np.testing.assert_array_equal(ps[..., 0], js[..., 0])
        np.testing.assert_allclose(ps[..., 1:], js[..., 1:], rtol=0,
                                   atol=SLAB_ATOL)
        np.testing.assert_array_equal(po[1], jo[1])
        kept = ps[..., 0] >= 0
        assert kept.any() and (ps[..., 0][kept] >= 1).all()
        assert 0.0 <= float(po[1][0]) <= 1.0


# -- the JAX package's layer pipelines (tests/test_detection_layers.py) -----

def _ssd_pipeline(pkg):
    L = pkg.layers
    img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[4, 4], dtype="float32")
    gt_label = L.data(name="gt_label", shape=[4, 1], dtype="int64")
    c1 = L.conv2d(img, 8, 3, stride=2, padding=1, act="relu")
    c2 = L.conv2d(c1, 8, 3, stride=2, padding=1, act="relu")
    locs, confs, boxes, vars_ = L.multi_box_head(
        inputs=[c1, c2], image=img, base_size=32, num_classes=3,
        aspect_ratios=[[1.0], [1.0]], min_sizes=[8.0, 16.0],
        max_sizes=[16.0, 24.0], flip=False)
    loss = L.reduce_mean(L.ssd_loss(locs, confs, gt_box, gt_label, boxes,
                                    vars_))
    pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    nmsed = L.detection_output(locs, confs, boxes, vars_,
                               nms_threshold=0.45, nms_top_k=40,
                               keep_top_k=10, score_threshold=0.01)
    return loss, nmsed


SSD_FEED = {
    "img": np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32),
    "gt_box": np.array(
        [[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
          [0, 0, 0, 0], [0, 0, 0, 0]],
         [[0.2, 0.3, 0.6, 0.7], [0, 0, 0, 0],
          [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32),
    "gt_label": np.array([[[1], [2], [0], [0]],
                          [[1], [0], [0], [0]]], np.int64)}


def _rpn_pipeline(pkg):
    L = pkg.layers
    img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
    gt = L.data(name="gt", shape=[3, 4], dtype="float32")
    im_info = L.data(name="im_info", shape=[3], dtype="float32")
    feat = L.conv2d(img, 16, 3, stride=4, padding=1, act="relu")
    anchor, var = L.anchor_generator(feat, anchor_sizes=[8.0, 16.0],
                                     aspect_ratios=[1.0], stride=[4.0, 4.0])
    scores = L.conv2d(feat, 2, 1)
    deltas = L.conv2d(feat, 8, 1)
    rois, _ = L.generate_proposals(L.sigmoid(scores), deltas, im_info,
                                   anchor, var, pre_nms_top_n=50,
                                   post_nms_top_n=8, nms_thresh=0.7,
                                   min_size=0.0)
    sc, loc, tl, tb, iw = L.rpn_target_assign(
        deltas, scores, L.reshape(anchor, [-1, 4]), var,
        L.reshape(gt, [-1, 4]), rpn_batch_size_per_im=16,
        rpn_fg_fraction=0.25, use_random=False)
    total = L.reduce_mean(L.sigmoid_cross_entropy_with_logits(
        sc, L.cast(tl, "float32"))) + L.reduce_mean(L.abs(loc - tb) * iw)
    pkg.optimizer.SGDOptimizer(0.01).minimize(total)
    return total, rois


RPN_FEED = {"img": np.random.RandomState(0).rand(1, 3, 32, 32)
            .astype(np.float32),
            "gt": np.array([[[2, 2, 12, 12], [18, 18, 30, 30],
                             [0, 0, 0, 0]]], np.float32),
            "im_info": np.array([[32, 32, 1.0]], np.float32)}


def _pipeline(build, feed, steps):
    """Both packages from JAX's startup: per-step losses and the last
    step's second fetch."""
    res = {}
    init = None
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            loss, other = build(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = pkg.Scope()
            exe.run(startup, scope=scope)
            init = {v.name: np.array(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable}
        else:
            scope = _scope(pkg, init)
        vals = [[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=[loss, other], scope=scope)]
            for _ in range(steps)]
        res[pkg] = ([float(v[0].reshape(-1)[0]) for v in vals], vals[-1][1])
    return res[jfluid], res[fluid]


@pytest.mark.parametrize("name", ["ssd", "rpn"])
def test_layer_pipeline(name):
    """The SSD pipeline (8 steps; its NMS slab) and the RPN pipeline (5
    steps; its proposals), port against JAX; the losses fall."""
    build, feed, steps = {"ssd": (_ssd_pipeline, SSD_FEED, 8),
                          "rpn": (_rpn_pipeline, RPN_FEED, 5)}[name]
    (jl, jo), (pl, po) = _pipeline(build, feed, steps)
    np.testing.assert_allclose(pl, jl, rtol=PIPE_RTOL)
    assert pl[-1] <= pl[0]
    assert po.shape == jo.shape
    if name == "ssd":
        assert po.shape[-1] == 6
        np.testing.assert_array_equal(po[..., 0], jo[..., 0])
        np.testing.assert_allclose(po[..., 1:], jo[..., 1:], atol=1e-4)
    else:
        assert po.shape == (1, 8, 4)
        np.testing.assert_allclose(po, jo, atol=1e-4)

