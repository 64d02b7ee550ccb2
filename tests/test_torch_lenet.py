"""LeNet-5 training in the port (paddle_tpu_torch) against paddle_tpu on
the CPU: ``lenet.build_train(lr=1e-3)`` (two 5x5 conv + relu + 2x2 max
pool stages, fc 120, fc 84, fc 10, softmax cross-entropy, accuracy;
Adam) built in both packages, JAX's startup persistables carried into
the port's scope with ``load_numpy_params``, then three Adam steps on
one numpy batch of 16 images.

Tolerances, float32 throughout, as tests/test_torch_bert_training.py:
- per-step losses ``rtol 1e-4``; the fetched accuracy exactly;
- step-1 parameter gradients ``|Δ| <= 1e-3·max|g| + 1e-9``;
- parameters after step 3 ``atol 1e-5``;
- the main and startup programs' op-type sequences and variable shapes
  equal to the reference's.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import lenet as jlenet

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import lenet
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

BATCH, STEPS, LR = 16, 3, 1e-3


def build(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_train(lr=LR)
    return main, startup, out


def make_feed(batch=BATCH, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.normal(0, 1, (batch, 1, 28, 28)).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def train(exe, main, scope, feed, out, grads):
    """(losses, accuracies) of STEPS runs and the step-1 gradients."""
    losses, accs, step1 = [], [], None
    for i in range(STEPS):
        got = exe.run(main, feed=feed, fetch_list=[out["loss"].name,
                                                   out["acc"].name] +
                      (grads if i == 0 else []), scope=scope)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        accs.append(float(np.asarray(got[1]).reshape(-1)[0]))
        if i == 0:
            step1 = [np.asarray(g) for g in got[2:]]
    return losses, accs, step1


@pytest.fixture(scope="module")
def runs():
    jmain, jstartup, jout = build(jfluid, jlenet)
    pmain, pstartup, pout = build(fluid, lenet)
    feed = make_feed()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = persistables(jmain)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in pmain.global_block().all_parameters()]
    grads = [pmain._grad_name_map[p] for p in params]
    jlosses, jaccs, jgrads = train(jexe, jmain, jscope, feed, jout, grads)
    jafter = {n: np.array(jscope.find_var(n)) for n in names}
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    plosses, paccs, pgrads = train(fluid.Executor(fluid.CPUPlace()), pmain,
                                   pscope, feed, pout, grads)
    pafter = {n: pscope.find_var_numpy(n) for n in names}
    return dict(jprogs=(jmain, jstartup), pprogs=(pmain, pstartup),
                names=names, params=params, grads=grads, jlosses=jlosses,
                plosses=plosses, jaccs=jaccs, paccs=paccs, jgrads=jgrads,
                pgrads=pgrads, jafter=jafter, pafter=pafter)


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_have_the_reference_ops_and_var_shapes(runs, which):
    jprog, pprog = runs["jprogs"][which], runs["pprogs"][which]
    assert [op.type for op in pprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    assert {n: (v.shape, v.dtype, v.persistable)
            for n, v in pprog.global_block().vars.items()} == \
        {n: (v.shape, v.dtype, v.persistable)
         for n, v in jprog.global_block().vars.items()}


def test_every_persistable_is_carried_across(runs):
    assert persistables(runs["pprogs"][0]) == runs["names"]
    assert len(runs["params"]) == 10          # 2 convs + 3 fcs, w and b


def test_per_step_losses_and_accuracy_match(runs):
    assert np.isfinite(runs["plosses"]).all()
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=1e-4)
    assert runs["paccs"] == runs["jaccs"]
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
