"""K6: the row layer norm, and the ``fused_layer_norm`` op.

Counterpart of ``paddle_tpu/fluid/ops/pallas_ops.py:700-790``: the Pallas
kernel ``_layer_norm_kernel`` (:706, launched by ``_pallas_layer_norm``
:717), the ``fused_layer_norm`` custom vjp (:746) and its op (:767).

:func:`row_layer_norm` normalises each row of ``x2d [M, D]``: mean and
centred (population) variance in float32, then ``(x − mean)·rsqrt(var +
eps)·scale + bias``, output in x's dtype.  On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/layer_norm.cu`` (float32 or
bfloat16 x, any M and D) or raises; on a CPU tensor it runs
:func:`layer_norm_reference`, the plain version.  There is no fallback
from one to the other, and ``row_layer_norm.launches`` counts kernel
launches only.

:func:`fused_layer_norm` is the autograd node: forward K6, backward the
autograd of the plain composition, as JAX's ``_ln_bwd`` (:756) takes the
vjp of ``_reference_layer_norm``.
"""

import ctypes
import threading

import numpy as np
import torch

from .. import costmodel
from ..registry import register_op
from . import _kernels

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def layer_norm_reference(x2d, scale, bias, eps):
    """Plain PyTorch K6 (``_reference_layer_norm``, pallas_ops.py:741):
    float32 statistics over the last axis, affine in float32, cast to
    x's dtype."""
    xm = x2d.float()
    var, mean = torch.var_mean(xm, dim=-1, keepdim=True, correction=0)
    y = (xm - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x2d.dtype)


def _check(x2d, scale, bias):
    if x2d.dim() != 2:
        raise ValueError("row_layer_norm needs x2d [M, D], got %s"
                         % (tuple(x2d.shape),))
    D = x2d.shape[1]
    if tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError("scale %s and bias %s must be [D=%d]"
                         % (tuple(scale.shape), tuple(bias.shape), D))


def _kernel_device(x2d, scale, bias):
    """False when every tensor lies on the CPU; True when they all lie on
    one CUDA device with x in a kernel dtype; raises otherwise."""
    tensors = (x2d, scale, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if not (x2d.is_cuda and all(t.device == x2d.device for t in tensors)):
        raise ValueError("row_layer_norm: every input must lie on one CUDA "
                         "device (or all on the CPU), got %s"
                         % [str(t.device) for t in tensors])
    if x2d.dtype not in _KERNEL_DTYPES:
        raise TypeError("row_layer_norm kernel takes float32 or bfloat16 "
                        "x, got %s" % x2d.dtype)
    return True


def _k6_work(x2d, scale, bias, eps):
    return costmodel.kernel_work("K6", m=x2d.shape[0], d=x2d.shape[1],
                                 esz=x2d.element_size())


@costmodel.hand_kernel("K6", _k6_work)
def row_layer_norm(x2d, scale, bias, eps):
    """Layer norm of each row of ``x2d [M, D]`` with ``scale``/``bias``
    ``[D]``.  CPU tensors run :func:`layer_norm_reference`; CUDA tensors
    launch K6 (float32 or bfloat16 x; scale and bias are read as
    float32)."""
    _check(x2d, scale, bias)
    if not _kernel_device(x2d, scale, bias):
        return layer_norm_reference(x2d, scale, bias, eps)
    M, D = x2d.shape
    xc = x2d.contiguous()
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    y = torch.empty_like(xc)
    lib = _kernels.load("layer_norm")
    with torch.cuda.device(x2d.device):
        rc = lib.paddle_layer_norm(
            _KERNEL_DTYPES[x2d.dtype], xc.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), y.data_ptr(), M, D, ctypes.c_float(eps),
            torch.cuda.current_stream(x2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("row_layer_norm kernel launch failed: %s"
                           % _kernels.cuda_error_string(lib, rc))
    with _count_lock:
        row_layer_norm.launches += 1
    return y


row_layer_norm.launches = 0


class FusedLayerNormFunction(torch.autograd.Function):
    """Forward K6; backward the vjp of :func:`layer_norm_reference`,
    recomputed from the saved inputs (pallas_ops.py:756)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        ctx.save_for_backward(x2d, scale, bias)
        ctx.eps = eps
        return row_layer_norm(x2d, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_reference(*inputs, ctx.eps)
        grads = torch.autograd.grad(y, inputs, g)
        return grads[0], grads[1], grads[2], None


def fused_layer_norm(x2d, scale, bias, eps):
    """Differentiable layer norm of the rows of ``x2d``: K6 forward."""
    return FusedLayerNormFunction.apply(x2d, scale, bias, float(eps))


@register_op("fused_layer_norm")
def _fused_layer_norm_op(ctx, op):
    """pallas_ops.py:767: layer norm over the axes from
    ``begin_norm_axis`` on, through :func:`fused_layer_norm`; writes Y,
    and Mean and population Variance in float32 over the leading dims,
    the layer_norm op's contract."""
    x = ctx.i("X")
    scale = ctx.i_opt("Scale")
    bias = ctx.i_opt("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    bna = ctx.attr("begin_norm_axis", 1)
    lead = tuple(x.shape[:bna])
    D = int(np.prod(x.shape[bna:]))
    x2d = x.reshape(-1, D)
    if scale is None:
        scale = torch.ones(D, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(D, dtype=x.dtype, device=x.device)
    y = fused_layer_norm(x2d, scale.reshape(-1), bias.reshape(-1), eps)
    ctx.set("Y", y.reshape(x.shape))
    var, mean = torch.var_mean(x2d.float(), dim=-1, correction=0)
    ctx.set("Mean", mean.reshape(lead))
    ctx.set("Variance", var.reshape(lead))
