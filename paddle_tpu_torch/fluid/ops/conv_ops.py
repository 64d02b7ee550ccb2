"""K1: the 3x3 implicit-GEMM convolution, and its autograd node.

Counterpart of ``paddle_tpu/fluid/ops/conv_pallas.py`` (the Pallas kernel
``_conv3x3_kernel`` :33, entry point ``conv3x3_bn_relu`` :58) and of the
``_pallas_conv3x3`` custom vjp in ``paddle_tpu/fluid/ops/nn_ops.py:36-63``.

:func:`conv3x3_bn_relu` computes, over NHWC ``x [N, H, W, C]`` and HWIO
``w [3, 3, C, O]``, ``act(scale[o]·Σ_{dy,dx,c} x[n,h+dy-1,w+dx-1,c]·
w[dy,dx,c,o] + shift[o])``: stride 1, padding 1, float32 accumulation,
output in x's dtype; scale/shift None is the identity, ``relu`` the
optional activation.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/conv3x3_bn_relu.cu`` (float32 or bfloat16) or
raises; on a CPU tensor it runs :func:`conv3x3_bn_relu_reference`, the
plain version.  There is no fallback from one to the other, and
``conv3x3_bn_relu.launches`` counts kernel launches only.

:class:`Conv3x3Function` is the ``conv2d`` op's route behind
``FLAGS_conv_pallas`` (NCHW in and out, as the op holds its tensors):
forward through :func:`conv3x3_bn_relu` without epilogue, backward
through the library's convolution gradients
(``torch.ops.aten.convolution_backward``), as ``_pallas_conv3x3_bwd``
takes XLA's.  :func:`k1_applies` is the JAX gate (nn_ops.py:101-106), so
the same convs take K1 in both packages.
"""

import threading

import torch
import torch.nn.functional as F

from . import _kernels

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
# the JAX gate keeps one padded image resident in VMEM; kept as the same
# bound so that the two packages route the same convs
_PADDED_IMAGE_BYTES = 8 * 2 ** 20


def k1_applies(x_shape, itemsize, w_shape, strides, pads, dilations,
               groups):
    """True when ``conv2d`` takes K1 (JAX nn_ops.py:101-106): groups 1, a
    3x3 filter, stride 1, padding 1, dilation 1, and one zero-padded NCHW
    image ``(H+2)·(W+2)·C·itemsize`` within 8 MiB."""
    _, C, H, W = x_shape
    return (groups == 1 and
            (H + 2) * (W + 2) * C * itemsize <= _PADDED_IMAGE_BYTES and
            tuple(w_shape[2:]) == (3, 3) and tuple(strides) == (1, 1) and
            tuple(pads) == (1, 1) and tuple(dilations) == (1, 1))


def _check(x, w, scale, shift):
    if x.dim() != 4:
        raise ValueError("conv3x3_bn_relu needs NHWC x [N, H, W, C], got %s"
                         % (tuple(x.shape),))
    N, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError("conv3x3_bn_relu needs a [3,3,C,O] kernel with "
                         "C=%d, got %s" % (C, tuple(w.shape)))
    O = w.shape[3]
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and tuple(t.shape) != (O,):
            raise ValueError("%s must be [O=%d], got %s"
                             % (name, O, tuple(t.shape)))
    return N, H, W, C, O


def conv3x3_bn_relu_reference(x, w, scale=None, shift=None, relu=True):
    """Plain PyTorch K1: float32 ``unfold`` patches times the weights as a
    matrix, then the epilogue, cast to x's dtype.  ``F.unfold`` orders a
    patch (c, dy, dx) where the kernel orders it (dy, dx, c), as JAX's
    ``w.reshape(9C, O)`` does (conv_pallas.py:75): the same sums, taken
    in another order."""
    N, H, W, C, O = _check(x, w, scale, shift)
    cols = F.unfold(x.float().permute(0, 3, 1, 2), 3, padding=1)
    wm = w.float().permute(2, 0, 1, 3).reshape(C * 9, O)
    acc = torch.matmul(cols.transpose(1, 2), wm)          # [N, H*W, O]
    if scale is not None:
        acc = acc * scale.float()
    if shift is not None:
        acc = acc + shift.float()
    if relu:
        acc = acc.clamp_min(0.0)
    return acc.reshape(N, H, W, O).to(x.dtype)


def _kernel_device(x, w, scale, shift):
    """False when every tensor lies on the CPU; True when they all lie on
    one CUDA device with x and w in one kernel dtype; raises otherwise."""
    tensors = [t for t in (x, w, scale, shift) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return False
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("conv3x3_bn_relu: every input must lie on one "
                         "CUDA device (or all on the CPU), got %s"
                         % [str(t.device) for t in tensors])
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError("conv3x3_bn_relu kernel takes float32 or bfloat16 "
                        "x and w of one dtype, got %s and %s"
                        % (x.dtype, w.dtype))
    return True


def conv3x3_bn_relu(x, w, scale=None, shift=None, relu=True):
    """3x3/s1/p1 conv + per-channel affine + optional relu over NHWC
    ``x [N, H, W, C]`` and HWIO ``w [3, 3, C, O]``; scale/shift ``[O]`` or
    None.  Returns ``[N, H, W, O]`` in x's dtype (a contiguous NHWC
    tensor).  CPU tensors run :func:`conv3x3_bn_relu_reference`; CUDA
    tensors launch K1."""
    N, H, W, C, O = _check(x, w, scale, shift)
    if not _kernel_device(x, w, scale, shift):
        return conv3x3_bn_relu_reference(x, w, scale, shift, relu)
    # NHWC storage: free when x is a channels_last NCHW tensor's permuted
    # view, one copy otherwise
    xc = x.contiguous()
    wm = w.reshape(9 * C, O).contiguous()         # rows (dy, dx, c)
    sc = None if scale is None else scale.float().contiguous()
    sh = None if shift is None else shift.float().contiguous()
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    lib = _kernels.load("conv3x3_bn_relu")
    with torch.cuda.device(x.device):
        rc = lib.paddle_conv3x3_bn_relu(
            _KERNEL_DTYPES[x.dtype], xc.data_ptr(), wm.data_ptr(),
            None if sc is None else sc.data_ptr(),
            None if sh is None else sh.data_ptr(), out.data_ptr(),
            N, H, W, C, O, int(bool(relu)),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv3x3_bn_relu kernel launch failed: %s"
                           % _kernels.cuda_error_string(lib, rc))
    with _count_lock:
        conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0


class Conv3x3Function(torch.autograd.Function):
    """``conv2d`` with a 3x3 filter, stride 1, padding 1 over NCHW ``x``
    and OIHW ``w`` (one dtype): forward K1 (no epilogue), backward the
    library's convolution gradients.  The output is an NCHW view of K1's
    NHWC result, i.e. a channels_last tensor."""

    @staticmethod
    def forward(ctx, x, w):
        out = conv3x3_bn_relu(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                              relu=False)
        ctx.save_for_backward(x, w)
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need[0], need[1], False])
        return gx, gw
