"""K1 in the port (``paddle_tpu_torch/fluid/ops/conv_ops.py``) against
paddle_tpu's Pallas kernel (``conv_pallas.conv3x3_bn_relu``, interpret
mode on the CPU) on shared numpy inputs.

On CPU tensors the port's wrapper runs its plain version
(``conv3x3_bn_relu_reference``: float32 unfold x matmul + epilogue).

Tolerances:
- float32: ``atol 1e-5`` (both sum 9·C float32 products per output, in
  other orders);
- bfloat16 inputs: ``2e-2`` of the largest output (both accumulate in
  float32 and round the output to bf16 once; one bf16 step is 2^-8);
- ``Conv3x3Function`` against JAX's ``_pallas_conv3x3`` and its vjp
  (whose backward is XLA's conv): output and input gradient ``atol
  1e-5``, filter gradient ``atol 1e-4`` (a sum over N·H·W products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid.ops.conv_pallas import conv3x3_bn_relu as jax_conv
from paddle_tpu.fluid.ops.nn_ops import _pallas_conv3x3

from paddle_tpu_torch.fluid.ops import conv_ops

SHAPES = [
    (2, 8, 8, 8, 16),      # N, C, H, W, O: small square
    (1, 16, 14, 14, 32),   # ResNet stage-3 geometry
    (3, 4, 7, 7, 8),       # odd spatial (stage 4), several images
    (1, 8, 12, 6, 8),      # H != W
    (2, 20, 5, 9, 12),     # C, O not multiples of 16
]


def _inputs(shape, seed):
    N, C, H, W, O = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, O) * 0.1).astype(np.float32)
    sc = (rng.rand(O) + 0.5).astype(np.float32)
    sh = rng.randn(O).astype(np.float32)
    return x, w, sc, sh


@pytest.mark.parametrize("epilogue", ["bn_relu", "plain"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_k1_matches_pallas_fp32(shape, epilogue):
    x, w, sc, sh = _inputs(shape, seed=sum(shape))
    if epilogue == "plain":
        want = jax_conv(jnp.asarray(x), jnp.asarray(w), relu=False)
        got = conv_ops.conv3x3_bn_relu(torch.from_numpy(x),
                                       torch.from_numpy(w), relu=False)
    else:
        want = jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                        jnp.asarray(sh), relu=True)
        got = conv_ops.conv3x3_bn_relu(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sc),
            torch.from_numpy(sh), relu=True)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("epilogue", ["bn_relu", "plain"])
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_k1_matches_pallas_bf16(shape, epilogue):
    x, w, sc, sh = _inputs(shape, seed=7 + sum(shape))
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    if epilogue == "plain":
        want = jax_conv(xb, wb, relu=False)
        got = conv_ops.conv3x3_bn_relu(xt, wt, relu=False)
    else:
        want = jax_conv(xb, wb, jnp.asarray(sc), jnp.asarray(sh), relu=True)
        got = conv_ops.conv3x3_bn_relu(xt, wt, torch.from_numpy(sc),
                                       torch.from_numpy(sh), relu=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_conv3x3_function_grads_match_pallas_vjp():
    """NCHW x, OIHW w: the op route's autograd node against JAX's
    ``_pallas_conv3x3`` (forward K1, backward XLA's conv vjp)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 9, 7).astype(np.float32)
    w = (rng.randn(10, 6, 3, 3) * 0.2).astype(np.float32)
    g = rng.randn(2, 10, 9, 7).astype(np.float32)
    out, vjp = jax.vjp(_pallas_conv3x3, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = conv_ops.Conv3x3Function.apply(xt, wt)
    gx, gw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=0,
                               atol=1e-4)


def test_wrong_kernel_shape_raises_like_pallas():
    x = np.zeros((1, 8, 8, 4), np.float32)
    w = np.zeros((5, 5, 4, 8), np.float32)
    with pytest.raises(ValueError, match="3,3"):
        jax_conv(jnp.asarray(x), jnp.asarray(w))
    with pytest.raises(ValueError, match="3,3"):
        conv_ops.conv3x3_bn_relu(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(ValueError, match="scale"):
        conv_ops.conv3x3_bn_relu(torch.zeros(1, 4, 4, 2),
                                 torch.zeros(3, 3, 2, 8),
                                 scale=torch.ones(7))


def test_cpu_tensors_never_count_a_launch():
    before = conv_ops.conv3x3_bn_relu.launches
    conv_ops.conv3x3_bn_relu(torch.zeros(1, 4, 4, 2), torch.zeros(3, 3, 2, 4))
    assert conv_ops.conv3x3_bn_relu.launches == before


@pytest.mark.parametrize("case", ["stride2", "5x5", "groups", "dilated",
                                  "big_image", "k1"])
def test_k1_gate_is_the_jax_gate(case):
    """nn_ops.py:101-106: groups 1, 3x3, stride 1, pad 1, dilation 1, and
    a zero-padded image within 8 MiB."""
    args = dict(x_shape=(8, 64, 56, 56), itemsize=2, w_shape=(64, 64, 3, 3),
                strides=(1, 1), pads=(1, 1), dilations=(1, 1), groups=1)
    change = {"stride2": dict(strides=(2, 2)),
              "5x5": dict(w_shape=(64, 64, 5, 5)),
              "groups": dict(groups=2),
              "dilated": dict(dilations=(2, 2)),
              # (1023 + 2)^2 x 4 channels x 2 bytes: 16 kB over 8 MiB
              "big_image": dict(x_shape=(1, 4, 1023, 1023)),
              "k1": {}}[case]
    args.update(change)
    assert conv_ops.k1_applies(**args) == (case == "k1")
