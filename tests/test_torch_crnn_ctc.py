"""CRNN-CTC text recognition (``paddle_tpu_torch/models/crnn_ctc.py``,
the model zoo's OCR program) in the port against paddle_tpu on the CPU,
at ``crnn_ctc.test_config()``: images ``[4, 1, 16, 64]``, conv widths
4/8/8/16, GRUs of 16, 11 classes with the blank.

Both packages build the program from the same builders (the port's
``models/crnn_ctc.py``, loaded a second time as a module of
``paddle_tpu.models``, so its relative imports name paddle_tpu's fluid);
their op types and variable shapes must be equal.  JAX's startup
persistables are carried into the port's scope, and both take three
Momentum steps on the first three synthetic batches.  The per-step
losses hold within ``rtol 1e-4``, and every persistable after them
within ``rtol 1e-4`` of the JAX value plus ``1e-4`` of that tensor's
largest entry; a conv bias before batch norm, whose gradient is 0 in
exact arithmetic, is held at the level of the rounding in both
(``test_state_after_three_steps``).  The greedy decode
and the edit distances, each package on its own trained scope, are held
exactly.
"""

import importlib.util

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (the parent of the second module)
import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import crnn_ctc
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

STEPS = 3
RTOL = 1e-4
SEED = 7


def _jax_crnn():
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu.models._crnn_ctc_of_the_port", crnn_ctc.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCRNN = _jax_crnn()


def _build(pkg, mod, cfg, evaluate=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_eval(cfg) if evaluate else mod.build(cfg)
    return main, startup, out


def _scope(pkg, init):
    scope = pkg.Scope()
    if pkg is jfluid:
        import jax.numpy as jnp
        for n, v in init.items():
            scope.set_var(n, jnp.asarray(v))
    else:
        fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    return scope


def _read(pkg, scope, n):
    return np.array(scope.find_var(n)) if pkg is jfluid else \
        scope.find_var_numpy(n)


@pytest.fixture(scope="module")
def runs():
    cfg = crnn_ctc.test_config()
    progs = {pkg: _build(pkg, mod, cfg) for pkg, mod in
             ((jfluid, JCRNN), (fluid, crnn_ctc))}
    jmain, jstartup, _ = progs[jfluid]
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    batches = [f for _, f in zip(range(STEPS), crnn_ctc.feeds(cfg, SEED))]
    out = {"cfg": cfg, "progs": progs, "init": init, "batches": batches}
    for pkg in (jfluid, fluid):
        main, _, handles = progs[pkg]
        scope = _scope(pkg, init)
        exe = pkg.Executor(pkg.CPUPlace())
        losses = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[handles["loss"]], scope=scope)[0]
        ).reshape(-1)[0]) for f in batches]
        emain, _, eh = _build(pkg, JCRNN if pkg is jfluid else crnn_ctc,
                              cfg, evaluate=True)
        decoded = [np.asarray(v) for v in exe.run(
            emain, feed=batches[0], fetch_list=eh["outs"], scope=scope)]
        out[pkg] = dict(losses=losses, decoded=decoded, state={
            n: _read(pkg, scope, n) for n in names})
    return out


def test_programs_are_the_same():
    """The same op types in order, the same persistables and shapes."""
    cfg = crnn_ctc.test_config()
    for evaluate in (False, True):
        j, _, _ = _build(jfluid, JCRNN, cfg, evaluate)
        p, _, _ = _build(fluid, crnn_ctc, cfg, evaluate)
        assert [o.type for o in p.global_block().ops] == \
            [o.type for o in j.global_block().ops]
        shapes = {pkg: {v.name: tuple(v.shape) for v in m.list_vars()
                        if v.persistable} for pkg, m in ((0, j), (1, p))}
        assert shapes[0] == shapes[1]
    ops = [o.type for o in p.global_block().ops]
    for t in ("im2sequence", "ctc_align", "edit_distance", "top_k"):
        assert t in ops, t


def test_losses(runs):
    j, p = runs[jfluid]["losses"], runs[fluid]["losses"]
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, j, rtol=RTOL)


def _conv_bias(n):
    """The conv bias (or its velocity) a batch norm follows: 0 gradient
    in exact arithmetic, so its value is the rounding of each package."""
    return n.startswith("conv2d_") and ".b_0" in n


def test_state_after_three_steps(runs):
    """Every persistable: parameters, velocities, moving statistics, at
    ``rtol 1e-4`` plus ``1e-4`` of the tensor's largest entry.  A conv
    bias before batch norm instead stays at rounding level in both: its
    velocity within ``1e-4`` of the largest entry of its conv weight's
    velocity, its value within ``lr`` times that over the steps."""
    j, p = runs[jfluid]["state"], runs[fluid]["state"]
    lr = runs["cfg"]["lr"]
    moved = 0
    for n, want in j.items():
        got = p[n]
        assert got.shape == want.shape, n
        moved += not np.array_equal(want, runs["init"][n])
        if _conv_bias(n):
            conv = n.split(".")[0]
            bound = RTOL * float(np.abs(j[conv + ".w_0_velocity_0"]).max())
            if not n.endswith("_velocity_0"):
                bound *= lr * STEPS
            assert max(np.abs(got).max(), np.abs(want).max()) <= bound, n
            continue
        np.testing.assert_allclose(
            got, want, rtol=RTOL,
            atol=RTOL * float(np.abs(want).max()) + 1e-12, err_msg=n)
    assert moved > len(j) // 2


def test_greedy_decode_and_edit_distance(runs):
    """Decoded ids, their lengths, the distances and the count, exactly;
    a distance is at most the longer of the two lengths."""
    j, p = runs[jfluid]["decoded"], runs[fluid]["decoded"]
    cfg = runs["cfg"]
    for a, b in zip(p, j):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ids, ids_len, dist, n = p
    assert ids.shape == (cfg["batch"], crnn_ctc.steps(cfg))
    assert ((ids >= 0) & (ids < cfg["classes"])).all()
    label_len = runs["batches"][0]["label_len"]
    assert (dist[:, 0] <= np.maximum(ids_len, label_len)).all()
    assert int(n) == cfg["batch"]
