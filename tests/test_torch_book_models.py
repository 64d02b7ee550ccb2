"""The reference's book models in the port (paddle_tpu_torch) against
paddle_tpu on the CPU, at the JAX book tests' sizes
(``paddle_tpu_torch.models.book.test_config``): fit_a_line, image
classification (resnet_cifar10 and vgg16_bn_drop), word2vec (softmax
and nce), understand_sentiment (conv and stacked LSTM),
recommender_system, label_semantic_roles, rnn_encoder_decoder and
machine_translation with its beam decode.

Both packages build each program from the same builders (the port's
``models/book.py``, loaded a second time against ``paddle_tpu``'s fluid,
dataset and models); the programs' op types and variable shapes must be
equal.  JAX's startup persistables are carried into the port's scope
(``load_numpy_params``), and both take three optimizer steps on the
first three batches of the port's dataset.

Tolerances, float32.  A second run of each package takes its other
convolution route (``FLAGS_conv_im2col=all``: patches times one matrix,
the products summed in another order); how far it lies from the first
is that package's spread, the size of its rounding after the network's
conditioning amplified it (batch norm over a single pass of
``E[x²] − E[x]²``, and Adam, which turns the rounding of a gradient
that is 0 in exact arithmetic, a conv bias before batch norm, into a
full step of either sign).  Programs without a conv have a spread of 0.
Per-step losses hold within ``max(1e-5·|loss|, 2·(spread_jax +
spread_port))`` and every persistable after step 3 within
``max(2e-5·max|p| + 1e-3·lr + 1e-12, 2·(spread_jax + spread_port))`` of
that tensor, the spreads taken tensor by tensor: Adam divides each
gradient entry by its own running size, so an entry with a small
gradient takes a step near ``lr`` whatever its size, and that entry's
rounding moves the step by a fraction of ``lr`` (up to 1.2e-5 at ``lr``
1e-2 here: a thousandth of one step).
word2vec with nce draws its noise classes from each framework's own
RNG, so its losses and parameters cannot follow JAX's: it is held by its
program, finite falling losses, parameters that all moved and stayed
finite, and its step-1 loss equal (``rtol 1e-5``) to the JAX rule's
formula in numpy on the port's own samples and hidden layer
(tests/test_torch_book_ops.py holds the op itself).

The beam decode runs from the same weights in both: SentenceIds equal,
SentenceScores ``rtol 1e-5``.  The ported datasets yield the same
samples as ``paddle_tpu.dataset``.
"""

import importlib.util

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (the parent of the second book module)
import paddle_tpu.dataset as jdataset
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.dataset as pdataset
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import book
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

STEPS = 3
LOSS_RTOL = 1e-5
PARAM_RTOL, STEP_SHARE, PARAM_ATOL = 2e-5, 1e-3, 1e-12


def _jax_book():
    """``models/book.py`` loaded as a module of ``paddle_tpu.models``: its
    relative imports then name paddle_tpu's fluid and dataset."""
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu.models._book_of_the_port", book.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JBOOK = _jax_book()


def build(pkg, mod, name, cfg, decode=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_decode(cfg) if decode else mod.build(name, cfg)
    return main, startup, out


def _train(pkg, main, out, init, feeds, im2col="off"):
    """Losses of one step per feed from the state ``init``, and every
    persistable after them, with ``FLAGS_conv_im2col`` set to ``im2col``
    in ``pkg`` for the run."""
    scope = pkg.Scope()
    if pkg is jfluid:
        import jax.numpy as jnp
        for n, v in init.items():
            scope.set_var(n, jnp.asarray(v))
    else:
        fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    exe = pkg.Executor(pkg.CPUPlace())
    pkg.flags.set_flag("conv_im2col", im2col)
    try:
        losses = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[out["loss"]], scope=scope)[0]
        ).reshape(-1)[0]) for f in feeds]
    finally:
        pkg.flags.set_flag("conv_im2col", "off")
    read = (lambda n: np.array(scope.find_var(n))) if pkg is jfluid else \
        scope.find_var_numpy
    return losses, {n: read(n) for n in init}


@pytest.fixture(scope="module", params=book.NAMES)
def run(request):
    name = request.param
    cfg = book.test_config(name)
    jmain, jstartup, jout = build(jfluid, JBOOK, name, cfg)
    pmain, pstartup, pout = build(fluid, book, name, cfg)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    feeds = [f for _, f in zip(range(STEPS), book.feeds(name, cfg))]
    runs = dict(name=name, names=names, jprogs=(jmain, jstartup),
                pprogs=(pmain, pstartup), init=init, lr=cfg["lr"],
                params=[p.name for p in
                        pmain.global_block().all_parameters()])
    has_conv = any(op.type == "conv2d" for op in jmain.global_block().ops)
    for key, pkg, main, out, route in (
            ("j", jfluid, jmain, jout, "off"),
            ("p", fluid, pmain, pout, "off"),
            ("js", jfluid, jmain, jout, "all"),
            ("ps", fluid, pmain, pout, "all")):
        if route == "all" and not has_conv:
            runs[key] = runs[key[0]]
            continue
        runs[key] = _train(pkg, main, out, init, feeds, route)
    return runs


def _shapes(prog):
    return [{n: (v.shape, v.dtype, v.persistable)
             for n, v in b.vars.items()} for b in prog.blocks]


def test_programs_have_the_reference_ops_and_var_shapes(run):
    for jprog, pprog in zip(run["jprogs"], run["pprogs"]):
        assert len(pprog.blocks) == len(jprog.blocks)
        for jb, pb in zip(jprog.blocks, pprog.blocks):
            assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
            assert pb.parent_idx == jb.parent_idx
        assert _shapes(pprog) == _shapes(jprog)


def test_per_step_losses_match(run):
    (j, _), (p, _), (js, _), (ps, _) = (run[k] for k in ("j", "p", "js",
                                                           "ps"))
    j, p, js, ps = (np.array(v) for v in (j, p, js, ps))
    assert np.isfinite(p).all()
    if run["name"] == "word2vec_nce":
        assert p[-1] < p[0]
        return
    bound = np.maximum(LOSS_RTOL * np.abs(j),
                       2 * (np.abs(js - j) + np.abs(ps - p)))
    assert (np.abs(p - j) <= bound).all(), (p, j, js, ps)


def test_parameters_after_three_steps_match(run):
    jafter, pafter, jsafter, psafter = (run[k][1] for k in ("j", "p", "js",
                                                            "ps"))
    over = {}
    for n in run["names"]:
        j, p = jafter[n], pafter[n]
        assert p.shape == j.shape, n
        if j.dtype.kind != "f":
            np.testing.assert_array_equal(p, j, err_msg=n)
            continue
        if run["name"] == "word2vec_nce":
            assert np.isfinite(p).all(), n
            if n in run["params"]:
                assert (p != run["init"][n]).any(), n
            continue
        spread = np.abs(jsafter[n] - j).max() + \
            np.abs(psafter[n] - p).max()
        bound = max(PARAM_RTOL * np.abs(j).max() + STEP_SHARE * run["lr"] +
                    PARAM_ATOL, 2 * spread)
        err = np.abs(p.astype(np.float64) - j).max()
        if err > bound:
            over[n] = (err, bound)
    assert not over, over


def test_the_spread_is_small(run):
    """Each package's second route stays within 1e-4 of its first on
    every loss: the spread bounds rounding, not another trajectory."""
    for a, b in (("j", "js"), ("p", "ps")):
        x, y = np.array(run[a][0]), np.array(run[b][0])
        assert (np.abs(x - y) <= 1e-4 * np.abs(x)).all(), (a, x, y)


def test_word2vec_nce_step1_loss_is_the_formula():
    cfg = book.test_config("word2vec_nce")
    main, startup, out = build(fluid, book, "word2vec_nce", cfg)
    op = [o for o in main.global_block().ops if o.type == "nce"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = scope.find_var_numpy(op.input("Weight")[0]).astype(np.float64)
    b = scope.find_var_numpy(op.input("Bias")[0])[:, 0].astype(np.float64)
    feed = next(book.feeds("word2vec_nce", cfg))
    loss, hidden, samples = (np.asarray(v) for v in exe.run(
        main, feed=feed, scope=scope, fetch_list=[
            out["loss"], op.input("Input")[0],
            op.output("SampleLabels")[0]]))
    C, k = w.shape[0], cfg["neg"]
    x = hidden.astype(np.float64)
    lab = feed["w%d" % (cfg["n"] - 1)][:, 0]
    lt = (w[lab] * x).sum(-1) + b[lab]
    ln = (w[samples] * x[:, None, :]).sum(-1) + b[samples]
    cost = np.logaddexp(0, -(lt - np.log(k / C))) + \
        np.logaddexp(0, ln - np.log(k / C)).sum(-1)
    np.testing.assert_allclose(loss.reshape(-1)[0], cost.mean(), rtol=1e-5)


def test_machine_translation_beam_decode_matches():
    """build_decode from one set of weights (JAX's startup of the
    training program) on the first batch's sources: SentenceIds equal,
    SentenceScores rtol 1e-5, scores sorted best first."""
    cfg = book.test_config("machine_translation")
    jtrain = build(jfluid, JBOOK, "machine_translation", cfg)
    jdec = build(jfluid, JBOOK, None, cfg, decode=True)
    pdec = build(fluid, book, None, cfg, decode=True)
    assert [op.type for op in pdec[0].global_block().ops] == \
        [op.type for op in jdec[0].global_block().ops]
    jscope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jtrain[1], scope=jscope)
    feed = next(book.feeds("machine_translation", cfg))
    feed = {k: feed[k] for k in ("src", "src_len")}
    jids, jsc = (np.asarray(v) for v in exe.run(
        jdec[0], feed=feed, fetch_list=jdec[2]["outs"], scope=jscope))
    names = sorted(v.name for v in jdec[0].list_vars() if v.persistable)
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, {n: np.array(jscope.find_var(n))
                                     for n in names}, fluid.CPUPlace())
    pids, psc = (np.asarray(v) for v in fluid.Executor(fluid.CPUPlace()).run(
        pdec[0], feed=feed, fetch_list=pdec[2]["outs"], scope=pscope))
    assert pids.shape == (cfg["batch"], cfg["beam"], cfg["t_trg"])
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(psc, jsc, rtol=1e-5)
    assert (np.diff(psc, axis=1) <= 1e-5).all()


DATASETS = [("uci_housing", lambda d: d.uci_housing.train()),
            ("cifar", lambda d: d.cifar.train10()),
            ("imikolov", lambda d: d.imikolov.train(
                d.imikolov.build_dict(), 5)),
            ("imdb", lambda d: d.imdb.train()),
            ("movielens", lambda d: d.movielens.train()),
            ("conll05", lambda d: d.conll05.train()),
            ("wmt16", lambda d: d.wmt16.train(30, 30)),
            ("wmt14", lambda d: d.wmt14.train(30)),
            ("mnist", lambda d: d.mnist.train())]


@pytest.mark.parametrize("name,make", DATASETS, ids=[d[0] for d in DATASETS])
def test_ported_dataset_yields_the_same_samples(name, make):
    """The first 64 samples of each reader (two passes for imdb, whose
    stream continues across passes), field by field."""
    def take(reader, n=64):
        return [s for _, s in zip(range(n), reader())]
    jr, pr = make(jdataset), make(pdataset)
    for _ in range(2 if name == "imdb" else 1):
        for js, ps in zip(take(jr), take(pr)):
            assert len(js) == len(ps)
            for a, b in zip(js, ps):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
