"""K1's launch plan (``conv_ops.k1_plan``) on the CPU: the variant, tile,
BN, ring stages, shared memory and grid that the card runs for a call.

The kernel (``csrc/conv3x3_bn_relu.cu``) takes the plan as arguments and
refuses one whose grid or shared memory disagree with its own
arithmetic, so these checks hold what runs there:

- ResNet-50's four 3x3 stride-1 shapes take the ``wgmma`` variant;
- every plan fits the card: shared memory within 232,448 bytes, every
  TMA box dimension within 256, BN a multiple of 8 within 256;
- the grid covers every output pixel and channel exactly once, counted
  in numpy by decoding each block's slots as the kernel does, and a
  ``wgmma`` block's halo box holds every tap its pixels read;
- bfloat16 with C or O not a multiple of 8, or x off a 16-byte boundary,
  takes ``mma_sync``; float32 takes ``fp32``.

The shapes: ResNet-50's (batch 256), every K1 case of the card tests
(``tests/test_torch_cuda_kernels.py``), and shapes drawn by hypothesis.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from paddle_tpu_torch.fluid.ops import conv_ops
from test_torch_cuda_kernels import K1_CASES

SMEM_PER_BLOCK = 232448
# ResNet-50 v1.5's 3x3 stride-1 convs at bench_resnet's batch: N, H, W, C, O
RESNET = [(256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
          (256, 14, 14, 256, 256), (256, 7, 7, 512, 512)]
SLOTS = {"fp32": 256, "mma_sync": 128, "wgmma": 128}

CASES = ([(s, torch.bfloat16) for s in RESNET] +
         [(s, torch.float32) for s in RESNET] +
         [(c[:5], c[6]) for c in K1_CASES.values()])
IDS = (["resnet_%dx%d_bf16" % (s[1], s[3]) for s in RESNET] +
       ["resnet_%dx%d_fp32" % (s[1], s[3]) for s in RESNET] +
       list(K1_CASES))


def _check_limits(plan):
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["BN"] % 8 == 0 and 8 <= plan["BN"] <= 256
    assert plan["grid"][1] <= 65535
    if plan["variant"] == "wgmma":
        assert all(1 <= d <= 256 for d in plan["halo_box"] + plan["w_box"])
        assert plan["halo_box"][0] * 2 == 128     # one swizzle span a row
        assert plan["w_box"][2] == plan["BN"]
        assert plan["halo_stages"] >= 1 and plan["w_stages"] >= 2


def _block_pixels(plan, N, H, W):
    """[blocks, slots] output pixel index of every slot of every block
    (-1 where a slot computes no pixel), decoded as the kernel does, and
    [blocks, slots, 2] its row and column inside the block's halo box."""
    bx = np.arange(plan["grid"][0])[:, None]
    s = np.arange(SLOTS[plan["variant"]])[None, :]
    NB, RH, TW = plan["tile"]
    if plan["tiling"] == "flat":
        P = bx * 128 + s
        valid = P < N * H * W
        R, c = P // W, P % W
        box = np.stack(np.broadcast_arrays(R - R[:, :1], c), -1)
        return np.where(valid, P, -1), box
    n_cb, n_rb = -(-W // TW), -(-H // RH)
    cb, rb, nb = bx % n_cb, bx // n_cb % n_rb, bx // (n_cb * n_rb)
    img, r, c = s // (RH * TW), s // TW % RH, s % TW
    n, h, w = nb * NB + img, rb * RH + r, cb * TW + c
    valid = (img < NB) & (n < N) & (h < H) & (w < W)
    box = np.stack([np.broadcast_to(a, valid.shape)
                    for a in (img * (RH + 2) + r, c)], -1)
    return np.where(valid, (n * H + h) * W + w, -1), box


def _check_coverage(plan, N, H, W, O):
    pix, box = _block_pixels(plan, N, H, W)
    counts = np.bincount(pix[pix >= 0], minlength=N * H * W)
    assert counts.shape == (N * H * W,) and (counts == 1).all()
    BN = plan["BN"]
    o = (np.arange(plan["grid"][1])[:, None] * BN +
         np.arange(BN)[None, :]).ravel()
    assert (np.bincount(o[o < O], minlength=O) == 1).all()
    if plan["variant"] == "wgmma":
        # taps (dy, dx) read box row + dy and column + dx: inside the box
        pitch, rows = plan["halo_box"][1], plan["halo_box"][2]
        used = box[pix >= 0]
        assert used.min() >= 0
        assert (used[:, 0] + 2).max() < rows * plan["tile"][0]
        assert (used[:, 1] + 2).max() < pitch


@pytest.mark.parametrize("shape", RESNET,
                         ids=["%dx%dx%d" % s[1:4] for s in RESNET])
def test_resnet_shapes_take_the_wgmma_variant(shape):
    plan = conv_ops.k1_plan(*shape, torch.bfloat16)
    assert plan["variant"] == "wgmma"
    assert plan["threads"] == 288


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_plan_fits_the_card(shape, dtype):
    _check_limits(conv_ops.k1_plan(*shape, dtype))


@pytest.mark.parametrize("shape,dtype", CASES, ids=IDS)
def test_grid_covers_every_output_once(shape, dtype):
    N, H, W, C, O = shape
    _check_coverage(conv_ops.k1_plan(N, H, W, C, O, dtype), N, H, W, O)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_card_cases_name_the_planned_variant(case):
    N, H, W, C, O, _, dt, variant = K1_CASES[case]
    aligned = not case.startswith("misaligned")
    assert conv_ops.k1_plan(N, H, W, C, O, dt,
                            aligned=aligned)["variant"] == variant


@pytest.mark.parametrize("C,O", [(20, 24), (64, 12), (12, 64), (3, 8)])
def test_channels_not_a_multiple_of_8_take_mma_sync(C, O):
    plan = conv_ops.k1_plan(2, 9, 11, C, O, torch.bfloat16)
    assert plan["variant"] == "mma_sync"
    _check_coverage(plan, 2, 9, 11, O)


def test_unaligned_x_takes_mma_sync_and_float32_takes_fp32():
    assert conv_ops.k1_plan(2, 9, 11, 64, 64, torch.bfloat16,
                            aligned=False)["variant"] == "mma_sync"
    assert conv_ops.k1_plan(2, 9, 11, 64, 64,
                            torch.float32)["variant"] == "fp32"


@settings(max_examples=60, deadline=None)
@given(N=st.integers(1, 6), H=st.integers(1, 40), W=st.integers(1, 300),
       C=st.integers(1, 600), O=st.integers(1, 600),
       bf16=st.booleans())
def test_drawn_shapes_plan_within_limits_and_cover_once(N, H, W, C, O, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    plan = conv_ops.k1_plan(N, H, W, C, O, dtype)
    want = ("fp32" if not bf16 else
            "wgmma" if C % 8 == 0 and O % 8 == 0 else "mma_sync")
    assert plan["variant"] == want
    _check_limits(plan)
    _check_coverage(plan, N, H, W, O)
