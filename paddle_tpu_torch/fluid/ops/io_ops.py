"""Checkpoint ops: save / load / save_combine / load_combine (reference
``operators/save_op.cc``, ``load_op.cc``, ``save_combine_op.cc``,
``load_combine_op.cc``; counterpart ``paddle_tpu/fluid/ops/io_ops.py``).

In the reference, checkpointing IS a program: a block of save ops run by
the executor.  The port runs ops eagerly, so each rule does its file
I/O where the op stands in the block.

Format, as in the JAX package: ``save`` writes ``<path>.npy``, the
*_combine ops one ``<path>.npz`` of every var.  Files are published
through ``checkpoint.write_file_atomic`` (tmp file, fsync, rename), so a
killed save program never leaves a torn file at the published path.  The
load side also reads reference-written files — a raw LoDTensor stream for
``load`` and back-to-back streams for ``load_combine`` — when no
.npy/.npz exists at the path.  bfloat16 travels as its bits.
"""

import io as _io
import os

import numpy as np

from ..data_types import from_host, to_host
from ..registry import register_op


def _publish(path, data):
    from ..checkpoint import write_file_atomic
    write_file_atomic(path, data, "opfile:" + os.path.basename(path))


def _out_dtypes(ctx, names):
    dts = []
    for n in names:
        var = ctx.block._find_var_recursive(n)
        if var is None or var.shape is None or \
                any(s is None or s < 0 for s in var.shape):
            raise ValueError("%s op %r needs a static var shape"
                             % (ctx.op.type, n))
        dts.append(var.dtype)
    return dts


@register_op("save", nondiff_inputs=("X",), stop_gradient=True)
def _save(ctx, op):
    from ..checkpoint import npy_bytes
    path = ctx.attr("file_path")
    real = path if path.endswith(".npy") else path + ".npy"
    _publish(real, npy_bytes(to_host(ctx.i("X"))))


@register_op("load", stop_gradient=True)
def _load(ctx, op):
    path = ctx.attr("file_path")
    out_name = op.output("Out")[0]
    dtype, = _out_dtypes(ctx, [out_name])
    # load_as_fp16 (reference load_op.cc attr): cast to fp16 on load,
    # overriding the declared var dtype
    if ctx.attr("load_as_fp16", False):
        dtype = "float16"
    # our own .npy takes precedence (as io.load_vars); a raw
    # extension-less file is a reference save_op LoDTensor stream
    npy = path if path.endswith(".npy") else path + ".npy"
    if os.path.isfile(npy):
        arr = np.load(npy)
    else:
        from .. import proto_compat
        with open(path, "rb") as f:
            arr, _ = proto_compat.read_lod_tensor(f)
    ctx.set("Out", from_host(arr, ctx.state.device, dtype))


@register_op("save_combine", nondiff_inputs=("X",), stop_gradient=True)
def _save_combine(ctx, op):
    path = ctx.attr("file_path")
    real = path if path.endswith(".npz") else path + ".npz"
    names = [n for n in op.input("X") if n]
    buf = _io.BytesIO()
    np.savez(buf, **{n: to_host(ctx.env[n]) for n in names})
    _publish(real, buf.getvalue())


@register_op("load_combine", stop_gradient=True)
def _load_combine(ctx, op):
    path = ctx.attr("file_path")
    names = [n for n in op.output("Out") if n]
    dtypes = _out_dtypes(ctx, names)
    # .npz first (our save_combine), else reference back-to-back
    # LoDTensor streams
    npz = path if path.endswith(".npz") else path + ".npz"
    if os.path.isfile(npz):
        with np.load(npz) as f:
            arrs = [f[n] for n in names]
    else:
        from .. import proto_compat
        with open(path, "rb") as f:
            arrs = proto_compat.read_combined(f, len(names))
    for i, (arr, dt) in enumerate(zip(arrs, dtypes)):
        ctx.set("Out", from_host(arr, ctx.state.device, dt), idx=i)
