"""Build and bind the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` exposes a plain C interface.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/`` at the repository root, named by a hash of the source
and the flags, and loaded with ``ctypes``.  A failed build raises with
nvcc's stderr; nothing falls back to a plain version.  ``build_all``
starts one nvcc per source, all at once.

Nothing here runs at import: the host that imports the package needs no
CUDA toolkit until a kernel is launched.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p = ctypes.c_void_p
_i64 = ctypes.c_int64
_i = ctypes.c_int
# C entry points of each library: name -> (restype, argtypes)
SIGNATURES = {
    "flash_attention_fwd": {
        # (dtype, q, k, v, bias, bias strides b/h/q/k, heads, out, lse,
        #  BH, S_q, S_kv, D, scale, causal, stream) -> cudaError_t
        "paddle_flash_attention_fwd": (
            _i, [_i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _p, _p,
                 _i, _i, _i, _i, ctypes.c_float, _i, _p]),
        "paddle_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "flash_attention_bwd": {
        # (dtype, q, k, v, bias, bias strides b/h/q/k, heads, dout, lse,
        #  delta, outputs..., BH, S_q, S_kv, D, scale, causal, stream)
        #  -> cudaError_t; outputs: dq | dk, dv | dbias
        "paddle_flash_attention_bwd_dq": (
            _i, [_i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _p, _p, _p,
                 _p, _i, _i, _i, _i, ctypes.c_float, _i, _p]),
        "paddle_flash_attention_bwd_dkv": (
            _i, [_i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _p, _p, _p,
                 _p, _p, _i, _i, _i, _i, ctypes.c_float, _i, _p]),
        "paddle_flash_attention_bwd_dbias": (
            _i, [_i, _p, _p, _p, _p, _i64, _i64, _i64, _i64, _i, _p, _p, _p,
                 _p, _i, _i, _i, _i, ctypes.c_float, _i, _p]),
        "paddle_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "conv3x3_bn_relu": {
        # (variant, x, w, scale, shift, out, N, H, W, C, O, relu, flat,
        #  NB, RH, TW, BN, halo stages, weight stages, smem bytes, grid x,
        #  grid y, stream) -> cudaError_t; the plan is conv_ops.k1_plan's
        "paddle_conv3x3_bn_relu": (
            _i, [_i, _p, _p, _p, _p, _p] + [_i] * 16 + [_p]),
        "paddle_conv3x3_error_detail": (ctypes.c_char_p, []),
        "paddle_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "layer_norm": {
        # (dtype, x, scale, bias, y, M, D, eps, stream) -> cudaError_t
        "paddle_layer_norm": (
            _i, [_i, _p, _p, _p, _p, _i, _i, ctypes.c_float, _p]),
        "paddle_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
}

_lock = threading.Lock()
_libs = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc():
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name):
    src = CSRC / (name + ".cu")
    h = hashlib.sha256(src.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("%s.%d.%d.tmp" % (so.name, os.getpid(),
                                         threading.get_ident()))
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, so


def _finish(name, started):
    proc, tmp, so = started
    out, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed building %s (exit %d):\n%s%s"
                           % (name, proc.returncode, out, err))
    # ptxas -v report (registers, shared memory, spills) beside the library
    so.with_suffix(".log").write_text(out + err)
    os.replace(tmp, so)


def build_all():
    """Compile every source not yet built, one nvcc each, all started
    together.  Returns {name: seconds} for the ones compiled now."""
    names = [s.stem for s in sources()]
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        times = {}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
                times[n] = time.perf_counter() - t0
    return times


def build_log(name):
    """nvcc/ptxas output of the built library (registers, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (res, args) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _libs[name] = lib
    return lib


def cuda_error_string(lib, code):
    return "%s (cudaError %d)" % (
        lib.paddle_cuda_error_string(code).decode(), code)
