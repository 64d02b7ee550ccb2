"""The numerics of the tensor-core attention kernels, emulated on the CPU.

K2 (flash-attention forward), K3 (dQ), K4 (dK/dV) and K5 (dBias)
compute their float32 products on the tensor cores in split TF32
(``csrc/attention_mma.cuh``):
each operand x is taken as big + small, big = x rounded to TF32 and
small = (x - big) rounded again (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero, onto 10 explicit mantissa bits), and a b is summed
as a_s b_b + a_b b_s + a_b b_b in float32.  This file rounds to TF32 by
integer operations on the float32 bits, runs the plain forward and the
plain dQ, dK/dV and dBias passes with every product done that way (ds k
included), and holds them against float64 at BERT-like shapes (a
[B, 1, S, S] padding mask, D = 64 and 128, causal) within the tolerances
that ``chip_smoke.py`` holds the kernels to: ``FP32_ATOL``
(``MASKED_ATOL`` on fully masked rows) for the forward, ``BWD_FP32_ATOL``
plus the ``MASKED_P_REL`` bound of fully masked rows for the backward.
One TF32 pass per product (11 mantissa bits) must fail those same
tolerances, so the check tells the two apart.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.fluid.ops import attention_ops as port_attn


def tf32(x):
    """x rounded to the nearest TF32 value, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b, passes):
    """a @ b in float32 as the kernels multiply: ``passes`` 3 is split
    TF32 (small terms first), 1 is one TF32 product."""
    a_big, b_big = tf32(a), tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def scores(q, k, bias, scale, causal, matmul):
    s = matmul(q, k.transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        allowed = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~allowed, -1e30)
    return s


def forward(q, k, v, bias, scale, causal, matmul):
    """(out, lse) of softmax(s) v with the products done by ``matmul``,
    in the dtype of the inputs."""
    s = scores(q, k, bias, scale, causal, matmul)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return matmul(p, v) / l, (m + torch.log(l)).squeeze(-1)


def dkv(q, k, v, bias, scale, dO, lse, delta, causal, matmul):
    """(dk, dv) of K4 (p recomputed from lse) with the products done by
    ``matmul``."""
    p, dp = p_dp(q, k, v, bias, scale, dO, lse, causal, matmul)
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    return matmul(ds.transpose(1, 2), q), matmul(p.transpose(1, 2), dO)


def p_dp(q, k, v, bias, scale, dO, lse, causal, matmul):
    """p recomputed from lse, and dp = dO v^T, as K3, K4 and K5 form them."""
    p = torch.exp(scores(q, k, bias, scale, causal, matmul) -
                  lse.unsqueeze(-1))
    return p, matmul(dO, v.transpose(1, 2))


def dq(q, k, v, bias, scale, dO, lse, delta, causal, matmul):
    """(dq,) of K3: (p (dp - delta) scale) k, ds k by ``matmul`` too."""
    p, dp = p_dp(q, k, v, bias, scale, dO, lse, causal, matmul)
    return (matmul(p * (dp - delta.unsqueeze(-1)) * scale, k),)


def dbias(q, k, v, bias, scale, dO, lse, delta, causal, matmul):
    """(dbias,) of K5: p (dp - delta), unscaled."""
    p, dp = p_dp(q, k, v, bias, scale, dO, lse, causal, matmul)
    return (p * (dp - delta.unsqueeze(-1)),)


def f64(a, b):
    return a @ b


# (D, causal): BERT-like, B = 2, H = 4, S = 128; a padding mask with
# lengths 128 and 57 unless causal
CASES = {"mask_d64": (64, False), "mask_d128": (128, False),
         "causal_d64": (64, True)}
B, H, S = 2, 4, 128


def _inputs(D, causal, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, dO = (torch.from_numpy(rng.randn(B * H, S, D).astype(np.float32))
                   for _ in range(4))
    bias = None
    masked = torch.zeros(B * H, S, dtype=torch.bool)
    if not causal:
        keep = (np.arange(S)[None, :] < np.array([S, 57])[:, None])
        keep = keep[:, :, None] & keep[:, None, :]               # [B, S, S]
        mask = np.where(keep, 0.0, -1e4).astype(np.float32)[:, None]
        bias = torch.from_numpy(mask).expand(B, H, S, S).reshape(B * H, S, S)
        masked = (bias.amax(-1) <= -1e3)
    return q, k, v, dO, bias, masked, 1.0 / math.sqrt(D)


def _forward_errors(passes, D, causal):
    q, k, v, _, bias, masked, scale = _inputs(D, causal)
    want, want_lse = forward(*(None if t is None else t.double()
                               for t in (q, k, v, bias)), scale, causal, f64)
    got, lse = forward(q, k, v, bias, scale, causal,
                       lambda a, b: mm(a, b, passes))
    row_err = (got.double() - want).abs().amax(-1)
    real = row_err[~masked].max().item()
    lse_err = (lse.double() - want_lse).abs()[~masked].max().item()
    masked_err = row_err[masked].max().item() if masked.any() else 0.0
    return real, lse_err, masked_err


# each backward pass emulated, with the names of its outputs in
# chip_smoke._masked_bounds
BWD_PASSES = {"dq": (dq, ("dq",)), "dkv": (dkv, ("dk", "dv")),
              "dbias": (dbias, ("dbias",))}


def _bwd_errors(which, passes, D, causal):
    """max over the outputs of backward pass ``which`` of |emulated -
    float64| beyond BWD_FP32_ATOL plus the masked-row bound (<= 0
    passes), and the largest raw error."""
    fn, names = BWD_PASSES[which]
    q, k, v, dO, bias, masked, scale = _inputs(D, causal, seed=1)
    d64 = [None if t is None else t.double() for t in (q, k, v, bias, dO)]
    out, lse = forward(*d64[:4], scale, causal, f64)
    delta = (out * d64[4]).sum(-1)
    want = fn(*d64[:4], scale, d64[4], lse, delta, causal, f64)
    lse32, delta32 = lse.float(), delta.float()
    got = fn(q, k, v, bias, scale, dO, lse32, delta32, causal,
             lambda a, b: mm(a, b, passes))
    args = (q, k, v, bias, scale, dO, lse32, delta32, causal)
    bounds = chip_smoke._masked_bounds(args, masked)
    excess, raw = [], []
    for g, w, name in zip(got, want, names):
        diff = (g.double() - w).abs()
        excess.append((diff - chip_smoke.BWD_FP32_ATOL -
                       bounds[name].double()).max().item())
        raw.append(diff.max().item())
    return max(excess), max(raw)


def test_tf32_rounding_matches_round_to_nearest_on_10_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -10, 3.0e-5, -7.25],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0 + 2 ** -10,
                         float(np.float32(3.0e-5)), -7.25])
    got = tf32(x)
    assert torch.equal(got[:5], want[:5].float()) and got[6] == -7.25
    # the low 13 bits are clear, and the error is at most half a TF32 ulp
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5].item() - 3.0e-5) <= 3.0e-5 * 2 ** -11
    # big + small keeps ~22 bits: the split's residual is below 2^-21
    y = torch.from_numpy(np.random.RandomState(2).randn(4096)
                         .astype(np.float32))
    big = tf32(y)
    rel = ((big + tf32(y - big)).double() - y.double()).abs() / \
        y.double().abs()
    assert rel.max().item() < 2 ** -21


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tf32_forward_within_kernel_tolerances(case):
    D, causal = CASES[case]
    real, lse_err, masked_err = _forward_errors(3, D, causal)
    assert real <= chip_smoke.FP32_ATOL, real
    assert lse_err <= chip_smoke.FP32_ATOL, lse_err
    assert masked_err <= chip_smoke.MASKED_ATOL, masked_err
    # one TF32 pass fails the same bound on real rows
    assert _forward_errors(1, D, causal)[0] > chip_smoke.FP32_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tf32_dkv_within_kernel_tolerances(case):
    D, causal = CASES[case]
    excess, raw = _bwd_errors("dkv", 3, D, causal)
    assert excess <= 0, (excess, raw)
    excess1, raw1 = _bwd_errors("dkv", 1, D, causal)
    assert excess1 > 0, (excess1, raw1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tf32_dq_within_kernel_tolerances(case):
    """K3: s, dp and ds k all in split TF32 stay within the kernel's
    tolerance; one TF32 pass each does not."""
    D, causal = CASES[case]
    excess, raw = _bwd_errors("dq", 3, D, causal)
    assert excess <= 0, (excess, raw)
    excess1, raw1 = _bwd_errors("dq", 1, D, causal)
    assert excess1 > 0, (excess1, raw1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tf32_dbias_within_kernel_tolerances(case):
    """K5: s and dp in split TF32 stay within the kernel's tolerance;
    one TF32 pass each does not."""
    D, causal = CASES[case]
    excess, raw = _bwd_errors("dbias", 3, D, causal)
    assert excess <= 0, (excess, raw)
    excess1, raw1 = _bwd_errors("dbias", 1, D, causal)
    assert excess1 > 0, (excess1, raw1)


def test_split_tf32_forward_agrees_with_port_plain_version():
    """The emulated kernel and the port's plain version (fp32) agree
    within FP32_ATOL on real rows, at D = 64 with the padding mask."""
    q, k, v, _, bias, masked, scale = _inputs(64, False)
    got, _ = forward(q, k, v, bias, scale, False, lambda a, b: mm(a, b, 3))
    want = port_attn.attention_reference(q, k, v, bias, scale)
    err = (got - want).abs().amax(-1)[~masked].max().item()
    assert err <= chip_smoke.FP32_ATOL, err
