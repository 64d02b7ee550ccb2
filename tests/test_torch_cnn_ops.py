"""The op rules of ResNet training in the port (paddle_tpu_torch) against
paddle_tpu on the CPU, op by op, forward and gradients: the same
one-op program built in both packages through their layers, JAX's
startup persistables carried into the port's scope, the same numpy feed,
then the op's outputs and the gradients of ``loss = mean(fc(out, 1))``
(a random linear read-out, so every output entry gets its own gradient)
with respect to the op's inputs and parameters.

Tolerances (float32 unless stated):
- forward outputs and gradients ``atol 1e-5, rtol 1e-5`` (both packages
  compute the same float32 formulas, summed in other orders); conv2d
  ``atol 2e-5`` (a filter gradient sums N·Ho·Wo products);
- optimizer updates after two steps ``atol 1e-6``;
- AMP ``mul`` (bf16 operands): ``2e-2`` of the largest entry, and the
  output dtype exactly (float32 after the bf16 product, or bf16 in pure
  bf16).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import flags as jflags

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import flags as pflags
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _build(pkg, body, readout=True, optimizer=None, seed=1):
    """One program in ``pkg``: ``body(pkg)`` -> (outputs, wrt), where
    ``wrt`` are variables to fetch gradients of; a read-out loss and its
    backward (or ``optimizer(pkg).minimize``)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        outs, wrt = body(pkg)
        loss = None
        if readout:
            loss = pkg.layers.mean(pkg.layers.fc(outs[0], 1))
            if optimizer is None:
                pkg.append_backward(loss)
            else:
                optimizer(pkg).minimize(loss)
    return main, startup, outs, wrt, loss


def run_both(body, feed, readout=True, optimizer=None, steps=1,
             flag_values=None, override=None):
    """(jax fetches, port fetches, names) of ``steps`` runs: the op's
    outputs, then the gradients of ``wrt`` (on the first step), then
    every persistable after the last step."""
    flag_values = flag_values or {}
    for k, v in flag_values.items():
        jflags.set_flag(k, v)
        pflags.set_flag(k, v)
    try:
        jm, js, jouts, jwrt, jloss = _build(jfluid, body, readout, optimizer)
        pm, ps, pouts, pwrt, ploss = _build(fluid, body, readout, optimizer)
        jscope = jfluid.Scope()
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js, scope=jscope)
        names = sorted(v.name for v in jm.list_vars() if v.persistable)
        init = {n: np.array(jscope.find_var(n)) for n in names}
        if override:
            init.update(override)
            for n, a in override.items():
                jscope.set_var(n, a)
        pscope = fluid.Scope()
        fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
        pexe = fluid.Executor(fluid.CPUPlace())
        grads = [pm._grad_name_map[v.name] for v in pwrt] if readout else []
        fetch = [v.name for v in pouts] + grads
        res = []
        for exe, prog, scope in ((jexe, jm, jscope), (pexe, pm, pscope)):
            for i in range(steps):
                out = exe.run(prog, feed=feed, fetch_list=fetch if i == 0
                              else fetch[:1], scope=scope)
                if i == 0:
                    first = [np.asarray(o) for o in out]
            after = [np.asarray(scope.find_var(n)) if exe is jexe
                     else scope.find_var_numpy(n) for n in names]
            res.append((first, after))
    finally:
        for k in flag_values:
            jflags.set_flag(k, pflags._DEFS[k])
            pflags.set_flag(k, pflags._DEFS[k])
    return res[0], res[1], fetch, names


def _assert_all_close(j, p, names, **tol):
    assert len(j) == len(p) == len(names)
    for n, a, b in zip(names, j, p):
        assert a.shape == b.shape, (n, a.shape, b.shape)
        np.testing.assert_allclose(b.astype(np.float32),
                                   a.astype(np.float32), err_msg=n,
                                   **(tol or TOL))


def _feed(shape, seed=0, name="x"):
    return {name: np.random.RandomState(seed).randn(*shape)
            .astype(np.float32)}


def _x(pkg, shape, name="x"):
    v = pkg.layers.data(name=name, shape=list(shape), dtype="float32",
                        append_batch_size=False)
    v.stop_gradient = False
    return v


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (x shape, conv2d kwargs, flags)
    "3x3_pad1": ((2, 4, 9, 8), dict(num_filters=6, filter_size=3,
                                    padding=1), {}),
    "stride2_7x7": ((2, 3, 16, 15), dict(num_filters=8, filter_size=7,
                                         stride=2, padding=3), {}),
    "1x1_stride2": ((2, 8, 8, 8), dict(num_filters=16, filter_size=1,
                                       stride=2), {}),
    "dilated": ((1, 4, 11, 10), dict(num_filters=5, filter_size=3,
                                     padding=2, dilation=2), {}),
    "groups": ((2, 8, 7, 7), dict(num_filters=12, filter_size=3, padding=1,
                                  groups=4), {}),
    "depthwise": ((2, 6, 7, 7), dict(num_filters=6, filter_size=3,
                                     padding=1, groups=6), {}),
    "bias_relu": ((2, 4, 6, 6), dict(num_filters=4, filter_size=3,
                                     padding=1, bias_attr=None,
                                     act="relu"), {}),
    "nhwc": ((2, 4, 9, 8), dict(num_filters=6, filter_size=3, padding=1,
                                stride=2), {"conv_layout": "NHWC"}),
    "im2col_all": ((2, 4, 9, 8), dict(num_filters=6, filter_size=3,
                                      padding=1, stride=2),
                   {"conv_im2col": "all"}),
    "im2col_3x3": ((2, 4, 9, 8), dict(num_filters=6, filter_size=3,
                                      padding=1), {"conv_im2col": "3x3"}),
    "k1_route": ((2, 4, 9, 8), dict(num_filters=6, filter_size=3,
                                    padding=1), {"conv_pallas": True}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d(case):
    shape, kw, flag_values = CONV_CASES[case]
    kw = dict(kw)
    kw.setdefault("bias_attr", False)

    def body(pkg):
        x = _x(pkg, shape)
        out = pkg.layers.conv2d(x, **kw)
        filt = [p for p in pkg.default_main_program().global_block()
                .all_parameters() if p.name.startswith("conv2d")]
        return [out], [x] + filt
    (j, _), (p, _), names, _ = run_both(body, _feed(shape),
                                        flag_values=flag_values)
    _assert_all_close(j, p, names, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

POOL_CASES = {
    "max_3x3_s2_p1": dict(pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max"),
    "max_ceil": dict(pool_size=3, pool_stride=2, pool_type="max",
                     ceil_mode=True),
    "avg_exclusive_pad": dict(pool_size=3, pool_stride=2, pool_padding=1,
                              pool_type="avg"),
    "avg_inclusive_pad": dict(pool_size=3, pool_stride=2, pool_padding=1,
                              pool_type="avg", exclusive=False),
    "avg_ceil_exclusive": dict(pool_size=2, pool_stride=2, pool_type="avg",
                               ceil_mode=True),
    "avg_ceil_inclusive": dict(pool_size=3, pool_stride=2, pool_type="avg",
                               ceil_mode=True, exclusive=False),
    "avg_global": dict(pool_type="avg", global_pooling=True),
    "max_global": dict(pool_type="max", global_pooling=True),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d(case):
    shape = (2, 3, 9, 7)

    def body(pkg):
        x = _x(pkg, shape)
        return [pkg.layers.pool2d(x, **POOL_CASES[case])], [x]
    (j, _), (p, _), names, _ = run_both(body, _feed(shape, seed=2))
    _assert_all_close(j, p, names)


def test_avg_pool_of_bf16_divides_in_float32_as_jax():
    """A non-exclusive average pool divides by a float32 constant: JAX
    promotes a bf16 sum to float32 there, and so does the port."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.registry import get_op_def
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = _x(fluid, (2, 3, 4, 4))
        pooled = fluid.layers.pool2d(x, pool_type="avg",
                                     global_pooling=True)
    op = main.global_block().ops[-1]
    env = {x.name: torch.ones(2, 3, 4, 4, dtype=torch.bfloat16)}
    state = lowering.ExecState(main.blocks, 0, 0, torch.device("cpu"))
    get_op_def("pool2d").lower(lowering.LowerCtx(env, op, state,
                                                 main.global_block()), op)
    assert env[pooled.name].dtype == torch.float32


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------

BN_CASES = {"train": {}, "test": dict(is_test=True),
            "use_global_stats": dict(use_global_stats=True),
            "momentum_0.7": dict(momentum=0.7, epsilon=1e-3)}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm(case):
    """Y, SavedMean, SavedVariance (1/sqrt(var + eps)), the gradients of
    X, Scale and Bias, and the running mean and variance after the
    in-place update, from non-trivial running statistics."""
    shape = (4, 5, 6, 3)
    rng = np.random.RandomState(9)
    override = {"batch_norm_0.mean": rng.randn(5).astype(np.float32),
                "batch_norm_0.variance": (rng.rand(5) + 0.5)
                .astype(np.float32),
                "batch_norm_0.w_0": (rng.rand(5) + 0.5).astype(np.float32),
                "batch_norm_0.b_0": rng.randn(5).astype(np.float32)}

    def body(pkg):
        x = _x(pkg, shape)
        y = pkg.layers.batch_norm(x, **BN_CASES[case])
        block = pkg.default_main_program().global_block()
        op = block.ops[-1]
        saved = [block.var(op.output("SavedMean")[0]),
                 block.var(op.output("SavedVariance")[0])]
        params = [p for p in block.all_parameters()]
        return [y] + saved, [x] + params
    feed = {"x": (np.random.RandomState(3).randn(*shape) * 2 + 1)
            .astype(np.float32)}
    (j, ja), (p, pa), names, pnames = run_both(body, feed,
                                                override=override)
    _assert_all_close(j, p, names)
    _assert_all_close(ja, pa, pnames)
    stats = [pnames.index("batch_norm_0.mean"),
             pnames.index("batch_norm_0.variance")]
    moved = any(not np.array_equal(pa[i], override[pnames[i]])
                for i in stats)
    assert moved == (case in ("train", "momentum_0.7"))


# ---------------------------------------------------------------------------
# relu, top_k / accuracy
# ---------------------------------------------------------------------------

def test_relu():
    shape = (3, 7)

    def body(pkg):
        x = _x(pkg, shape)
        return [pkg.layers.relu(x)], [x]
    (j, _), (p, _), names, _ = run_both(body, _feed(shape, seed=4))
    _assert_all_close(j, p, names, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_and_accuracy(k):
    rng = np.random.RandomState(k)
    feed = {"x": rng.randn(16, 10).astype(np.float32),
            "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}

    def body(pkg):
        x = _x(pkg, (16, 10))
        label = pkg.layers.data(name="label", shape=[16, 1], dtype="int64",
                                append_batch_size=False)
        vals, idx = pkg.layers.topk(x, k)
        acc = pkg.layers.accuracy(x, label, k=k)
        return [vals, idx, acc], []
    (j, _), (p, _), names, _ = run_both(body, feed, readout=False)
    _assert_all_close(j, p, names, rtol=0, atol=0)
    assert 0.0 < float(p[2]) < 1.0


# ---------------------------------------------------------------------------
# optimizers and regularizers
# ---------------------------------------------------------------------------

OPT_CASES = {
    "sgd": lambda pkg: pkg.optimizer.SGDOptimizer(0.1),
    "momentum": lambda pkg: pkg.optimizer.MomentumOptimizer(0.1, 0.9),
    "momentum_nesterov": lambda pkg: pkg.optimizer.MomentumOptimizer(
        0.1, 0.9, use_nesterov=True),
    "momentum_l2decay": lambda pkg: pkg.optimizer.MomentumOptimizer(
        0.1, 0.9, regularization=pkg.regularizer.L2Decay(1e-2)),
    "sgd_l1decay": lambda pkg: pkg.optimizer.SGDOptimizer(
        0.1, regularization=pkg.regularizer.L1Decay(1e-2)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_two_steps(case):
    """Two steps of x -> fc(8, relu) -> read-out: every persistable
    (weights, velocities, learning rate) after the second step, and the
    program's ops (the regularizer's scale/sign/sum in OpRole.Optimize)."""
    shape = (6, 5)

    def body(pkg):
        x = _x(pkg, shape)
        return [pkg.layers.fc(x, 8, act="relu")], []
    (j, ja), (p, pa), names, pnames = run_both(
        body, _feed(shape, seed=6), optimizer=OPT_CASES[case], steps=2)
    _assert_all_close(ja, pa, pnames, rtol=0, atol=1e-6)
    assert any("velocity" in n for n in pnames) == ("momentum" in case)
    jm, _, _, _, _ = _build(jfluid, body, optimizer=OPT_CASES[case])
    pm, _, _, _, _ = _build(fluid, body, optimizer=OPT_CASES[case])
    jops = [(op.type, op.attr("op_role")) for op in jm.global_block().ops]
    pops = [(op.type, op.attr("op_role")) for op in pm.global_block().ops]
    assert pops == jops
    if "decay" in case:
        assert ("sum", 2) in pops and ("scale", 2) in pops
        assert (("sign", 2) in pops) == ("l1" in case)


# ---------------------------------------------------------------------------
# AMP: mul under contrib.mixed_precision.decorate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pure_bf16", [False, True],
                         ids=["fp32_outputs", "pure_bf16"])
def test_amp_mul(pure_bf16):
    """fc's mul with bf16 operands: float32 output (the bf16 product
    summed in float32) or, in pure bf16, a bf16 output; the parameter
    gradient stays float32 through the cast."""
    shape = (8, 16)

    def opt(pkg):
        return pkg.contrib.mixed_precision.decorate(
            pkg.optimizer.SGDOptimizer(0.0), use_pure_bf16=pure_bf16)

    def body(pkg):
        x = _x(pkg, shape)
        h = pkg.layers.fc(x, 12, bias_attr=False)
        block = pkg.default_main_program().global_block()
        return [h], [x] + list(block.all_parameters())

    feed = _feed(shape, seed=8)
    (j, _), (p, _), names, _ = run_both(body, feed, optimizer=opt)
    for n, a, b in zip(names, j, p):
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max(), n
    # the program is tagged the same way in both packages, and the mul's
    # output has the same dtype (the port's numpy fetch widens bf16, so
    # read the tensor itself)
    jm = _build(jfluid, body, optimizer=opt)[0]
    pm, ps, pouts, _, _ = _build(fluid, body, optimizer=opt)
    assert (pm._amp_dtype, pm._amp_keep) == (jm._amp_dtype, jm._amp_keep)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(ps, scope=scope)
    h, = exe.run(pm, feed=feed, fetch_list=pouts, scope=scope,
                 return_numpy=False)
    want_dtype = "bfloat16" if pure_bf16 else "float32"
    assert str(h.dtype) == "torch." + want_dtype
    assert str(j[0].dtype) == want_dtype


def test_amp_loss_scaling_is_not_ported_and_says_so():
    """Loss scaling raised until ROADMAP item 6 ported it; now the scaled,
    gated program is JAX's op for op and its outputs and updated
    persistables after two steps agree (optimizer ``atol 1e-6``; bf16
    products ``2e-2`` of the largest entry, as above).
    tests/test_torch_amp_scaling.py holds the rest."""
    def body(pkg):
        x = _x(pkg, (2, 3))
        return [pkg.layers.fc(x, 2)], []

    def opt(pkg):
        return pkg.contrib.mixed_precision.decorate(
            pkg.optimizer.SGDOptimizer(0.1), init_loss_scaling=128.0)
    jm = _build(jfluid, body, optimizer=opt)[0]
    pm = _build(fluid, body, optimizer=opt)[0]
    assert [(op.type, op.inputs, op.outputs, op.attrs)
            for op in pm.global_block().ops] == \
        [(op.type, op.inputs, op.outputs, op.attrs)
         for op in jm.global_block().ops]
    (j, ja), (p, pa), _names, _pnames = run_both(body, _feed((2, 3)),
                                                 optimizer=opt, steps=2)
    for a, b in zip(j + ja, p + pa):
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.abs(a - b).max() <= max(2e-2 * np.abs(a).max(), 1e-6)
