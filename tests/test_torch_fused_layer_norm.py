"""K6 in the port (``paddle_tpu_torch/fluid/ops/norm_ops.py``) against
paddle_tpu's Pallas row layer norm (``_pallas_layer_norm``, interpret mode
on the CPU) and its ``fused_layer_norm`` op, on shared numpy inputs.  On
CPU tensors the port's wrapper runs its plain version
(``layer_norm_reference``).

Tolerances: float32 ``rtol/atol 2e-5`` (the same float32 formula; the
mean and variance summed in other orders); bf16 inputs ``2e-2`` of the
largest output (one bf16 rounding of the output); gradients ``2e-4``, as
tests/test_pallas_attention.py holds JAX's own custom vjp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.ops.pallas_ops import (_pallas_layer_norm,
                                             fused_layer_norm as jax_fln)

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import norm_ops
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401


def _inputs(M, D, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, D) * 3 + 1).astype(np.float32)
    scale = (rng.rand(D) + 0.5).astype(np.float32)
    bias = rng.randn(D).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(64, 96), (1, 768), (100, 33), (6, 1)],
                         ids=lambda s: "%dx%d" % s)
def test_plain_k6_matches_pallas_fp32(shape):
    x, scale, bias = _inputs(*shape, seed=shape[0])
    want = np.asarray(_pallas_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), 1e-5))
    got = norm_ops.row_layer_norm(torch.from_numpy(x),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(bias), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_k6_matches_pallas_bf16():
    x, scale, bias = _inputs(48, 80, seed=3)
    want = _pallas_layer_norm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = norm_ops.row_layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(bias), 1e-5)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_fused_layer_norm_grads_match_jax_custom_vjp():
    x, scale, bias = _inputs(32, 48, seed=5)
    g = np.random.RandomState(6).randn(32, 48).astype(np.float32)
    out, vjp = jax.vjp(lambda a, s, b: jax_fln(a, s, b, 1e-5),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    before = norm_ops.row_layer_norm.launches
    got = norm_ops.fused_layer_norm(*ts, 1e-5)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    assert norm_ops.row_layer_norm.launches == before   # CPU: plain version
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def test_shape_errors():
    with pytest.raises(ValueError, match="x2d"):
        norm_ops.row_layer_norm(torch.zeros(2, 3, 4), torch.ones(4),
                                torch.zeros(4), 1e-5)
    with pytest.raises(ValueError, match="D=4"):
        norm_ops.row_layer_norm(torch.zeros(2, 4), torch.ones(5),
                                torch.zeros(4), 1e-5)


def _program(pkg, shape, bna, affine):
    """x -> fused_layer_norm (appended by hand: no layer emits it) ->
    mean(fc(y, 1)), with the backward; returns the program pair and the
    names to fetch."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=list(shape), dtype="float32",
                            append_batch_size=False)
        x.stop_gradient = False
        blk = main.global_block()
        inputs = {"X": [x]}
        params = []
        if affine:
            D = int(np.prod(shape[bna:]))
            for name, init in (("ln_scale", 1.0), ("ln_bias", 0.0)):
                params.append(pkg.layers.create_parameter(
                    [D], "float32", name=name,
                    default_initializer=pkg.initializer.Constant(init)))
            inputs.update(Scale=[params[0]], Bias=[params[1]])
        y = blk.create_var(name="ln_y", shape=shape, dtype="float32")
        mean = blk.create_var(name="ln_m", dtype="float32")
        var = blk.create_var(name="ln_v", dtype="float32")
        blk.append_op("fused_layer_norm", inputs=inputs,
                      outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                      attrs={"begin_norm_axis": bna, "epsilon": 1e-5})
        loss = pkg.layers.mean(pkg.layers.fc(y, 1, num_flatten_dims=bna))
        pkg.append_backward(loss)
    fetch = ["ln_y", "ln_m", "ln_v", main._grad_name_map["x"]] + \
        [main._grad_name_map[p.name] for p in params]
    return main, startup, fetch


@pytest.mark.parametrize("bna,affine", [(2, True), (1, True), (2, False)],
                         ids=["axis2_affine", "axis1_affine", "axis2_plain"])
def test_fused_layer_norm_op_in_a_program(bna, affine):
    """The op through each package's Executor, forward and backward: Y,
    float32 Mean and population Variance over the leading dims, and the
    gradients of X, Scale and Bias, against JAX's op (the Pallas kernel
    in interpret mode, backward the vjp of its reference)."""
    shape = (4, 8, 32)
    rng = np.random.RandomState(bna)
    feed = {"x": rng.randn(*shape).astype(np.float32)}
    jm, js, fetch = _program(jfluid, shape, bna, affine)
    pm, ps, pfetch = _program(fluid, shape, bna, affine)
    assert fetch == pfetch
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jm.list_vars() if v.persistable}
    want = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch,
                                            scope=jscope)]
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    got = fluid.Executor(fluid.CPUPlace()).run(pm, feed=feed,
                                               fetch_list=fetch,
                                               scope=pscope)
    for n, a, b in zip(fetch, want, got):
        assert a.shape == b.shape, n
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4, err_msg=n)
