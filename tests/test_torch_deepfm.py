"""DeepFM CTR training in the port (paddle_tpu_torch) against paddle_tpu on
the CPU: ``deepfm.build_train(tiny_config(), lr=1e-3)`` (8 fields over a
1,000-row table, embeddings of 8, a 68 → 32 → 32 → 1 tower, the FM
second-order term, ``sigmoid_cross_entropy_with_logits`` on the int64
label cast to float32; Adam) built in both packages, JAX's startup
persistables carried into the port's scope with ``load_numpy_params``,
then three Adam steps on one numpy batch of 16 whose ids repeat.

Tolerances, float32 throughout, as tests/test_torch_lenet.py:
- per-step losses ``rtol 1e-4``;
- step-1 parameter gradients ``|Δ| <= 1e-3·max|g| + 1e-9``;
- parameters after step 3 ``atol 1e-5``;
- the main and startup programs' op types, attributes, slots and
  variable shapes equal to the reference's (94 main ops at
  ``base_config()``, 82 at ``tiny_config()``).
The two ``lookup_table`` gradients alone, on ids that repeat and on an
id past the table (its row reads NaN in both packages and takes no
gradient): ``rtol 1e-6, atol 1e-7``.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import deepfm
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

BATCH, STEPS, LR = 16, 3, 1e-3


def build(pkg, mod, cfg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_train(cfg, lr=LR)
    return main, startup, out


def make_feed(cfg, batch=BATCH, seed=0):
    """bench_deepfm's draw at a small size; the first two examples share
    all their ids, so rows of both tables get several contributions."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.sparse_feature_dim,
                      (batch, cfg.num_fields, 1)).astype(np.int64)
    ids[1] = ids[0]
    ids[2, :2] = ids[0, 0]
    return {"sparse_ids": ids,
            "dense_value": rng.rand(batch, cfg.dense_dim).astype(np.float32),
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def train(exe, main, scope, feed, out, grads):
    """Losses of STEPS runs and the step-1 gradients."""
    losses, step1 = [], None
    for i in range(STEPS):
        got = exe.run(main, feed=feed, fetch_list=[out["loss"].name] +
                      (grads if i == 0 else []), scope=scope)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        if i == 0:
            step1 = [np.asarray(g) for g in got[1:]]
    return losses, step1


@pytest.fixture(scope="module")
def runs():
    cfg = deepfm.tiny_config()
    jmain, jstartup, jout = build(jfluid, jdeepfm, jdeepfm.tiny_config())
    pmain, pstartup, pout = build(fluid, deepfm, cfg)
    feed = make_feed(cfg)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = persistables(jmain)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in pmain.global_block().all_parameters()]
    grads = [pmain._grad_name_map[p] for p in params]
    jlosses, jgrads = train(jexe, jmain, jscope, feed, jout, grads)
    jafter = {n: np.array(jscope.find_var(n)) for n in names}
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    plosses, pgrads = train(fluid.Executor(fluid.CPUPlace()), pmain,
                            pscope, feed, pout, grads)
    pafter = {n: pscope.find_var_numpy(n) for n in names}
    return dict(jprogs=(jmain, jstartup), pprogs=(pmain, pstartup),
                names=names, params=params, grads=grads, jlosses=jlosses,
                plosses=plosses, jgrads=jgrads, pgrads=pgrads,
                jafter=jafter, pafter=pafter)


def op_list(prog):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in prog.global_block().ops]


def var_map(prog):
    return {n: (v.shape, v.dtype, v.persistable)
            for n, v in prog.global_block().vars.items()}


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_have_the_reference_ops_attrs_and_var_shapes(runs, which):
    jprog, pprog = runs["jprogs"][which], runs["pprogs"][which]
    assert op_list(pprog) == op_list(jprog)
    assert var_map(pprog) == var_map(jprog)


def test_base_config_builds_the_reference_program():
    """bench_deepfm's program: 94 main ops (2 lookup_table, 4 mul, 10
    adam, ...), the same ops, attributes and variables in both."""
    jmain, jstartup, _ = build(jfluid, jdeepfm, jdeepfm.base_config())
    pmain, pstartup, _ = build(fluid, deepfm, deepfm.base_config())
    types = [op.type for op in pmain.global_block().ops]
    assert len(types) == 94
    assert (types.count("lookup_table"), types.count("mul"),
            types.count("adam")) == (2, 4, 10)
    assert op_list(pmain) == op_list(jmain)
    assert op_list(pstartup) == op_list(jstartup)
    assert var_map(pmain) == var_map(jmain)
    assert pmain.global_block().var("fm_emb").shape == (1000001, 10)


def test_every_persistable_is_carried_across(runs):
    assert persistables(runs["pprogs"][0]) == runs["names"]
    # the two tables and three fcs (tiny_config's two hidden layers and
    # the output), w and b
    assert len(runs["params"]) == 8


def test_per_step_losses_match(runs):
    assert np.isfinite(runs["plosses"]).all()
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=1e-4)
    assert runs["plosses"][-1] < runs["plosses"][0]


def test_step1_parameter_gradients_match(runs):
    for name, j, p in zip(runs["grads"], runs["jgrads"], runs["pgrads"]):
        assert p.shape == j.shape, name
        bound = 1e-3 * np.abs(j).max() + 1e-9
        err = np.abs(p - j).max()
        assert err <= bound, (name, err, bound)


def test_parameters_after_three_steps_match(runs):
    for n in runs["names"]:
        np.testing.assert_allclose(runs["pafter"][n], runs["jafter"][n],
                                   atol=1e-5, rtol=0, err_msg=n)


def _lookup_grads(pkg, ids, w, c):
    """(out, dW) of ``mean(lookup_table(W, ids) * c)``: dW is c scattered
    to the rows ``ids`` name, divided by the count of out's entries."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        idv = pkg.layers.data("ids", list(ids.shape), dtype="int64",
                              append_batch_size=False)
        emb = pkg.layers.embedding(
            idv, size=list(w.shape), is_sparse=True,
            param_attr=pkg.ParamAttr(
                name="table", initializer=pkg.initializer.Constant(0.0)))
        cv = pkg.layers.data("c", list(c.shape), append_batch_size=False)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(emb, cv))
        gw, = pkg.gradients(loss, [main.global_block().var("table")])
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    if pkg is fluid:
        fluid.load_numpy_params(scope, {"table": w}, fluid.CPUPlace())
    else:
        scope.set_var("table", w)
    out, g = exe.run(main, feed={"ids": ids, "c": c},
                     fetch_list=[emb, gw], scope=scope)
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("case", ["repeated", "past_the_table"])
@pytest.mark.parametrize("width", [1, 8], ids=["fm_w1", "fm_emb"])
def test_lookup_table_gradient(case, width):
    """The two tables' gradients: rows hit several times sum their
    contributions; an id past the table reads a NaN row in both packages
    and adds to no row (the gradient stays finite)."""
    rows = 50
    rng = np.random.RandomState(width)
    ids = rng.randint(0, rows, (12, 1)).astype(np.int64)
    ids[3] = ids[7] = ids[0]
    if case == "past_the_table":
        ids[5] = rows + 3
    w = rng.randn(rows, width).astype(np.float32)
    c = rng.randn(12, width).astype(np.float32)
    jout, jg = _lookup_grads(jfluid, ids, w, c)
    pout, pg = _lookup_grads(fluid, ids, w, c)
    np.testing.assert_allclose(pout, jout, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=1e-7)
    assert np.isfinite(pg).all()
    assert np.abs(pg[ids[0, 0]]).max() > 0
    if case == "past_the_table":
        assert np.isnan(pout[5]).all()
        want = np.zeros_like(w)
        np.add.at(want, ids[ids[:, 0] < rows, 0],
                  np.delete(c, 5, axis=0) / c.size)
        np.testing.assert_allclose(pg, want, rtol=1e-6, atol=1e-7)
