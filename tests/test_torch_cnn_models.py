"""VGG, MobileNet and SE-ResNeXt (``paddle_tpu_torch.models.vgg``,
``.mobilenet``, ``.se_resnext``), ``fluid.nets`` and ``fluid.metrics``
in the port against paddle_tpu on the CPU.

Each model is built in both packages at a small size and takes one
training step from JAX's carried startup state on one seeded batch:
VGG-11 (``build_train``, Momentum with L2Decay) at 64 x 64, batch 4, its
two dropouts set to 0; MobileNet-v1's ``tiny`` (scale 0.25, depthwise
convs) at 32 x 32, batch 8, under Momentum; SE-ResNeXt-50 (``build_train``,
cardinality 32, dropout 0) at 32 x 32, batch 4, cloned for test so that
batch norm normalizes by its running statistics (in training mode the
model is chaotic at this size: JAX's own two conv routes give gradients
up to 50% apart).  The programs' op types and variable shapes must be
equal.

Tolerances, float32: the step-1 loss ``rtol 1e-5``, and each step-1
parameter gradient within ``max(floor, 2·(spread_jax + spread_port))``
of that tensor in relative L2 norm (``floor`` 1e-4, and 2e-2 for VGG),
where a package's spread is how far its
gradient moves (relative L2) when it runs its other convolution route
(``FLAGS_conv_im2col=all``).  The floor is for max pooling: where two
entries of a pooling window lie within the two packages' forward
rounding (1e-5), the packages route that window's gradient to different
entries, which VGG-11's five 2 x 2 max pools do in a few of ~10^5
windows and which moves its conv gradients by up to 0.9% in L2 (each
package's own route change flips other windows, or none).  MobileNet
pools by averages only, and SE-ResNeXt's one max pool flips no window
on this batch.  The spread
covers the gradients that are rounding alone, a conv bias before batch
norm, whose exact gradient is 0.

``nets``: simple_img_conv_pool, glu and scaled_dot_product_attention (2
heads), forward and gradients ``rtol 1e-5, atol 1e-6``.  ``metrics``
(numpy in both packages): the same updates give equal ``eval()``.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import metrics as jmetrics
from paddle_tpu.models import mobilenet as jmobilenet
from paddle_tpu.models import se_resnext as jse_resnext
from paddle_tpu.models import vgg as jvgg

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import metrics as pmetrics
from paddle_tpu_torch.models import mobilenet, se_resnext, vgg
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

GRAD_L2 = {"vgg11": 2e-2, "mobilenet_tiny": 1e-4, "se_resnext50": 1e-4}


def _mobilenet_train(mod, pkg):
    img = pkg.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss = pkg.layers.mean(pkg.layers.cross_entropy(mod.tiny(img), label))
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return {"loss": loss}


MODELS = {
    "vgg11": (vgg, jvgg, 4, 64, lambda mod, pkg: mod.build_train(
        class_dim=10, depth=11, image_size=64)),
    "mobilenet_tiny": (mobilenet, jmobilenet, 8, 32, _mobilenet_train),
    "se_resnext50": (se_resnext, jse_resnext, 4, 32,
                     lambda mod, pkg: mod.build_train(
                         class_dim=10, image_size=32, dropout=0.0)),
}
# batch norm from its running statistics (the startup's 0 and 1): in
# training mode SE-ResNeXt-50 at a CPU test's size is chaotic, its last
# stage normalizing 1 x 1 maps over a few images, so that JAX's own two
# conv routes give gradients up to 50% apart
TEST_MODE = {"se_resnext50"}


def _build(pkg, mod, make):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = make(mod, pkg)
    for op in main.global_block().ops:
        if op.type in ("dropout", "dropout_grad"):
            # the grad op carries a copy of the forward's attrs, and the
            # JAX package's replays the forward from them
            op._set_attr("dropout_prob", 0.0)
    return main, startup, out


def _step(pkg, main, loss, init, feed, grads, im2col):
    scope = pkg.Scope()
    if pkg is jfluid:
        import jax.numpy as jnp
        for n, v in init.items():
            scope.set_var(n, jnp.asarray(v))
    else:
        fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    pkg.flags.set_flag("conv_im2col", im2col)
    try:
        got = pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    finally:
        pkg.flags.set_flag("conv_im2col", "off")
    return [np.asarray(g) for g in got]


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    pmod, jmod, batch, size, make = MODELS[request.param]
    jmain, jstartup, jout = _build(jfluid, jmod, make)
    pmain, pstartup, pout = _build(fluid, pmod, make)
    params = [p.name for p in pmain.global_block().all_parameters()]
    grads = [pmain._grad_name_map[p] for p in params]
    if request.param in TEST_MODE:
        jmain, pmain = jmain.clone(for_test=True), pmain.clone(for_test=True)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jmain.list_vars() if v.persistable}
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    out = dict(name=request.param, jprogs=(jmain, jstartup),
               pprogs=(pmain, pstartup), grads=grads)
    for key, pkg, main, loss, route in (
            ("j", jfluid, jmain, jout["loss"], "off"),
            ("p", fluid, pmain, pout["loss"], "off"),
            ("js", jfluid, jmain, jout["loss"], "all"),
            ("ps", fluid, pmain, pout["loss"], "all")):
        out[key] = _step(pkg, main, loss, init, feed, grads, route)
    return out


def test_programs_have_the_reference_ops_and_var_shapes(model):
    for jprog, pprog in zip(model["jprogs"], model["pprogs"]):
        assert [op.type for op in pprog.global_block().ops] == \
            [op.type for op in jprog.global_block().ops]
        assert {n: (v.shape, v.dtype) for n, v in
                pprog.global_block().vars.items()} == \
            {n: (v.shape, v.dtype) for n, v in
             jprog.global_block().vars.items()}
    types = {op.type for op in model["pprogs"][0].global_block().ops}
    if model["name"] == "mobilenet_tiny":
        assert "depthwise_conv2d" in types


def _l2(a, b, ref):
    return np.linalg.norm(a - b) / (np.linalg.norm(ref) + 1e-30)


def test_step1_loss_and_gradients_match(model):
    j, p, js, ps = (model[k] for k in ("j", "p", "js", "ps"))
    np.testing.assert_allclose(p[0], j[0], rtol=1e-5)
    over = {}
    for i, name in enumerate(model["grads"], 1):
        spread = _l2(js[i], j[i], j[i]) + _l2(ps[i], p[i], j[i])
        err = _l2(p[i], j[i], j[i])
        if err > max(GRAD_L2[model["name"]], 2 * spread):
            over[name] = (err, spread)
    assert not over, over


# -- nets --------------------------------------------------------------------

def _data(pkg, name, arr):
    v = pkg.layers.data(name, list(arr.shape), dtype=str(arr.dtype),
                        append_batch_size=False)
    v.stop_gradient = False
    return v


NETS = ["simple_img_conv_pool", "glu", "scaled_dot_product_attention"]


@pytest.mark.parametrize("net", NETS)
def test_nets(net):
    rng = np.random.RandomState(NETS.index(net))
    x = rng.randn(*{"simple_img_conv_pool": (2, 3, 8, 8),
                    "glu": (4, 6),
                    "scaled_dot_product_attention": (2, 5, 8)}[net]
                  ).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x)
        if net == "simple_img_conv_pool":
            out = pkg.nets.simple_img_conv_pool(
                xv, num_filters=4, filter_size=3, pool_size=2,
                pool_stride=2, act="relu")
        elif net == "glu":
            out = pkg.nets.glu(xv, dim=-1)
        else:
            out = pkg.nets.scaled_dot_product_attention(xv, xv, xv,
                                                        num_heads=2)
        loss = pkg.layers.mean(pkg.layers.square(out))
        params = pkg.default_main_program().global_block().all_parameters()
        return [out] + pkg.gradients(loss, [xv] + params)

    outs = []
    init = None
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if init is None:
            init = {v.name: np.array(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable}
        else:
            fluid.load_numpy_params(scope, init, fluid.CPUPlace())
        outs.append([np.asarray(o) for o in exe.run(
            main, feed={"x": x}, fetch_list=fetch, scope=scope)])
    for j, p in zip(*outs):
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6)


# -- metrics -------------------------------------------------------------------

def test_metrics_give_the_reference_values():
    rng = np.random.RandomState(3)
    preds = rng.rand(50, 2)
    labels = rng.randint(0, 2, 50)
    distances = rng.randint(0, 3, (5, 4)).astype(np.float64)
    results = []
    for m in (jmetrics, pmetrics):
        acc, auc = m.Accuracy(), m.Auc(num_thresholds=200)
        prec, rec = m.Precision(), m.Recall()
        comp = m.CompositeMetric()
        comp.add_metric(m.Precision())
        comp.add_metric(m.Recall())
        ed, chunk = m.EditDistance(), m.ChunkEvaluator()
        dmap = m.DetectionMAP(ap_version="11point")
        for i in range(5):
            rows = slice(10 * i, 10 * i + 10)
            acc.update(value=float((preds[rows, 1] > 0.5).mean()), weight=10)
            auc.update(preds[rows], labels[rows])
            prec.update(preds[rows, 1], labels[rows])
            rec.update(preds[rows, 1], labels[rows])
            comp.update(preds[rows, 1], labels[rows])
            ed.update(distances[i], 4)
            chunk.update(7 + i, 6 + i, 4 + i)
            dmap.update([(c, s, t) for c, s, t in zip(
                labels[rows], preds[rows, 1], preds[rows, 0] > 0.4)],
                {0: 3, 1: 4})
        results.append([acc.eval(), auc.eval(), prec.eval(), rec.eval(),
                        comp.eval(), ed.eval(), chunk.eval(), dmap.eval()])
    assert results[1] == results[0]
