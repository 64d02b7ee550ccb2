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
``conv3x3_bn_relu.launches`` counts kernel launches only
(``launches_by_variant`` by variant; ``input_copies`` the calls whose x
was not NHWC-contiguous and was copied first).

:func:`k1_plan` is the launch plan the kernel runs (variant, tile, BN,
ring stages, shared memory, grid), computed here so that the CPU tests
check exactly what the card runs; the C entry point refuses a plan that
disagrees with its own arithmetic.  The variant follows from the call
alone: ``wgmma`` (TMA + ``wgmma``) for bfloat16 with C and O multiples
of 8 and 16-byte-aligned x and w, ``mma_sync`` for the other bfloat16
calls, ``fp32`` for float32.

:class:`Conv3x3Function` is the ``conv2d`` op's route behind
``FLAGS_conv_pallas`` (NCHW in and out, as the op holds its tensors):
forward through :func:`conv3x3_bn_relu` without epilogue, backward
through the library's convolution gradients
(``torch.ops.aten.convolution_backward``), as ``_pallas_conv3x3_bwd``
takes XLA's.  :func:`k1_applies` is the JAX gate (nn_ops.py:101-106), so
the same convs take K1 in both packages.
"""

import functools
import threading

import torch
import torch.nn.functional as F

from .. import costmodel
from . import _kernels

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
K1_VARIANTS = ("fp32", "mma_sync", "wgmma")   # the C entry point's codes
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


# --- launch plan ------------------------------------------------------------
_SMEM_PER_BLOCK = 232448      # H100: dynamic shared memory a block may use
_SMEM_PER_SM = 233472         # the SM's 228 KB, 1 KB of it reserved per block
_CHUNK = 64                   # wgmma: channels per halo row (128 bytes)
_SLOTS = 128                  # wgmma: tile pixels (two warpgroups of 64)
_WGMMA_THREADS = 288          # 8 consumer warps + 1 producer warp
_HALO_STAGE_MAX = 48 * 1024   # wgmma: one halo box at most
_MAX_W_STAGES = 4             # wgmma: more measured no faster (PERF.md)


def _legacy_tile(N, H, W, bm):
    """(NB, RH, TW) of the fp32 (bm 256) and mma_sync (bm 128) kernels:
    TW columns (the whole row when W <= bm), RH rows (as many as fit bm
    pixels, balanced over the image's row blocks), and several images
    per tile (at most 1024 halo pixels) when one tile holds a whole
    image."""
    TW = min(W, bm)
    rows = min(bm // TW, H)
    n_rb = -(-H // rows)
    RH = -(-H // n_rb)
    NB = 1
    if RH == H and TW == W:
        fit = min(bm // (H * W), 1024 // ((H + 2) * (W + 2)), N)
        NB = max(fit, 1)
    return NB, RH, TW


def _wgmma_tile(N, H, W):
    """(NB, RH, TW) of the wgmma kernel's rectangular 128-slot tile: the
    fewest tiles (tensor-core work is per tile, used or not), then the
    smallest halo; several images to a tile where one holds a whole
    image."""
    best = None
    for TW in range(1, min(_SLOTS, W) + 1):
        RH = min(H, _SLOTS // TW)
        n_rb = -(-H // RH)
        RH = -(-H // n_rb)
        NB = 1
        if RH == H and TW == W:
            per_image = (H + 2) * (W + 2) * 2 * _CHUNK
            NB = max(1, min(N, _SLOTS // (H * W),
                            _HALO_STAGE_MAX // per_image))
        halo = NB * (RH + 2) * (TW + 2)
        if halo * 2 * _CHUNK > _HALO_STAGE_MAX:
            continue
        key = (-(-N // NB) * n_rb * -(-W // TW), halo, -TW)
        if best is None or key < best[0]:
            best = (key, (NB, RH, TW))
    return best[1]


def _wgmma_tiling(N, H, W):
    """("flat", tile) where 128-pixel runs of N*H*W need fewer tiles
    than the best rectangles (every slot of a flat tile but the last
    computes a pixel) and their halo box fits (which keeps its width W +
    2 within TMA's 256, too); else ("rect", tile)."""
    rect = _wgmma_tile(N, H, W)
    NB, RH, TW = rect
    rows = _flat_rows(W)
    if ((rows + 2) * (W + 2) * 2 * _CHUNK <= _HALO_STAGE_MAX and
            -(-N * H * W // _SLOTS) < -(-N // NB) * -(-H // RH) * -(-W // TW)):
        return "flat", (1, rows, W)
    return "rect", rect


def _flat_rows(W):
    """The most image rows (of x viewed as [N*H, W]) that 128
    consecutive pixels can touch."""
    return (_SLOTS - 1 + W - 1) // W + 1


def _wgmma_plan(N, H, W, C, O, BN, tiling, tile):
    """The wgmma kernel's plan for BN (16, 32, 64 or 128) and the tiling
    and tile of _wgmma_tiling: the halo ring (two stages, one where C
    fits one 64-channel chunk) of boxes TW + 2 pixels wide, a weight
    ring of up to 4 stages, the threads and shared memory.  BN <= 64
    leaves room for two blocks on an SM (one's epilogue and fill under
    the other's main loop); BN 128 takes one block and most of the SM's
    registers."""
    NB, RH, TW = tile
    budget = _SMEM_PER_BLOCK if BN > 64 else _SMEM_PER_SM // 2 - 1024
    chunks = -(-C // _CHUNK)
    halo_bytes = NB * (RH + 2) * (TW + 2) * 2 * _CHUNK
    halo_stride = -(-halo_bytes // 1024) * 1024
    halo_stages = min(2, chunks)
    w_tile = BN * 2 * _CHUNK
    staging = 8 * 16 * (2 * BN + 16)
    free = budget - 1024 - halo_stages * halo_stride
    w_stages = max(2, min(_MAX_W_STAGES,
                          (free - 16 * (halo_stages + _MAX_W_STAGES))
                          // w_tile))
    ring = halo_stages * halo_stride + w_stages * w_tile
    if tiling == "flat":
        grid_x = -(-N * H * W // _SLOTS)
    else:
        grid_x = -(-N // NB) * -(-H // RH) * -(-W // TW)
    return dict(tiling=tiling, tile=tuple(tile), BN=BN,
                halo_stages=halo_stages, w_stages=w_stages,
                threads=_WGMMA_THREADS,
                smem_bytes=1024 + max(ring, staging) + 2 * _CHUNK +
                16 * (halo_stages + w_stages),
                halo_box=(_CHUNK, TW + 2, RH + 2, NB), w_box=(_CHUNK, 1, BN),
                grid=(grid_x, -(-O // BN)))


def k1_plan(N, H, W, C, O, dtype, aligned=True):
    """The launch plan of K1 for x [N, H, W, C] and O output channels in
    ``dtype`` (``aligned``: x and the K-major weights the wgmma kernel
    reads start on 16-byte boundaries).  Keys:
    ``variant`` (one of K1_VARIANTS); ``tiling`` and ``tile``: ``rect``
    (NB, RH, TW), a block owns NB images x RH rows x TW columns of
    output pixels, or ``flat`` (wgmma only; 1, rows, W), a block owns
    128 consecutive pixels of N*H*W, which touch at most ``rows`` image
    rows; ``BN`` output channels per block; ``halo_stages`` and
    ``w_stages`` (the wgmma kernel's TMA rings; 1 and 1 for the
    single-stage kernels); ``threads``; ``smem_bytes``; ``grid`` (pixel
    tiles, BN blocks); and for wgmma the TMA boxes ``halo_box``
    (channels, TW + 2 halo columns, halo rows, NB) and ``w_box``
    (channels, 1, BN).  The plan is computed once per argument tuple:
    the tile search is a Python loop, and the executor calls K1 13 times
    per ResNet-50 step."""
    return dict(_k1_plan(N, H, W, C, O, dtype, bool(aligned)))


@functools.lru_cache(maxsize=1024)
def _k1_plan(N, H, W, C, O, dtype, aligned):
    if dtype not in _KERNEL_DTYPES:
        raise TypeError("K1 takes float32 or bfloat16, got %s" % (dtype,))
    if dtype == torch.float32:
        variant, bm, BN, threads = "fp32", 256, 64, 256
    elif C % 8 or O % 8 or not aligned:
        variant, bm, BN, threads = "mma_sync", 128, 64, 256
    else:
        variant = "wgmma"
    plan = dict(variant=variant)
    if variant != "wgmma":
        NB, RH, TW = _legacy_tile(N, H, W, bm)
        halo = NB * (RH + 2) * (TW + 2)
        smem = (4 * (16 * halo + 9 * 16 * BN) if variant == "fp32" else
                2 * 24 * (halo + 9 * BN))
        plan.update(tiling="rect", tile=(NB, RH, TW), BN=BN, halo_stages=1,
                    w_stages=1, threads=threads, smem_bytes=smem,
                    grid=(-(-N // NB) * -(-H // RH) * -(-W // TW),
                          -(-O // BN)))
    else:
        BN = next(b for b in (16, 32, 64, 128) if O <= b or b == 128)
        plan.update(_wgmma_plan(N, H, W, C, O, BN, *_wgmma_tiling(N, H, W)))
    return tuple(plan.items())


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


def _k1_work(x, w, scale=None, shift=None, relu=True):
    N, H, W, C = x.shape
    return costmodel.kernel_work(
        "K1", n=N, h=H, w=W, c=C, o=w.shape[3], esz=x.element_size(),
        affine=scale is not None or shift is not None)


@costmodel.hand_kernel("K1", _k1_work)
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
    # view, one copy otherwise (counted in input_copies)
    copied = not x.is_contiguous()
    xc = x.contiguous()
    wm = None
    if x.dtype == torch.bfloat16 and C % 8 == 0 and O % 8 == 0:
        # K-major [O, 9C], columns (dy, dx, c): the B tile TMA loads (no
        # copy when w is the HWIO view of such storage)
        wm = w.permute(3, 0, 1, 2).contiguous()
    plan = k1_plan(N, H, W, C, O, x.dtype,
                   aligned=xc.data_ptr() % 16 == 0 and wm is not None and
                   wm.data_ptr() % 16 == 0)
    if plan["variant"] != "wgmma":
        wm = w.reshape(9 * C, O).contiguous()     # rows (dy, dx, c)
    sc = None if scale is None else scale.float().contiguous()
    sh = None if shift is None else shift.float().contiguous()
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    lib = _kernels.load("conv3x3_bn_relu")
    NB, RH, TW = plan["tile"]
    with torch.cuda.device(x.device):
        rc = lib.paddle_conv3x3_bn_relu(
            K1_VARIANTS.index(plan["variant"]), xc.data_ptr(), wm.data_ptr(),
            None if sc is None else sc.data_ptr(),
            None if sh is None else sh.data_ptr(), out.data_ptr(),
            N, H, W, C, O, int(bool(relu)), int(plan["tiling"] == "flat"),
            NB, RH, TW, plan["BN"], plan["halo_stages"],
            plan["w_stages"], plan["smem_bytes"], *plan["grid"],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("conv3x3_bn_relu kernel launch failed (%s): %s %s"
                           % (plan["variant"],
                              _kernels.cuda_error_string(lib, rc),
                              lib.paddle_conv3x3_error_detail().decode()))
    with _count_lock:
        conv3x3_bn_relu.launches += 1
        conv3x3_bn_relu.launches_by_variant[plan["variant"]] += 1
        conv3x3_bn_relu.input_copies += copied
    return out


conv3x3_bn_relu.launches = 0
conv3x3_bn_relu.launches_by_variant = dict.fromkeys(K1_VARIANTS, 0)
conv3x3_bn_relu.input_copies = 0


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
