"""Data type registry for the program IR.

Canonical string names inside the IR (as in ``paddle_tpu``), mapped to
``torch`` dtypes at the execution boundary and to numpy dtypes for feeds
and fetches.  Unlike the JAX package, nothing narrows here: torch keeps
64-bit integer feeds as int64 (JAX without x64 runs them as int32).
numpy has no bfloat16, so a bf16 tensor comes back to the host as
float32 (:func:`to_numpy`) when it is fetched; checkpoints, ``save_vars``
and model exports keep its bits instead (:func:`to_host`): a 2-byte
``V2`` payload, the layout ``paddle_tpu``'s ``.npy`` files give bf16.
"""

import numpy as np
import torch


_NAME_TO_TORCH = {
    "bool": torch.bool,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
}

_TORCH_TO_NAME = {v: k for k, v in _NAME_TO_TORCH.items()}

FLOATING = ("float16", "float32", "float64", "bfloat16")


def canonical_dtype(dtype):
    """Normalize numpy/torch dtypes and strings to a name."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NAME[dtype]
    if isinstance(dtype, str):
        if dtype in _NAME_TO_TORCH:
            return dtype
        return np.dtype(dtype).name
    return np.dtype(dtype).name


def torch_dtype(dtype):
    return _NAME_TO_TORCH[canonical_dtype(dtype)]


def np_dtype(dtype):
    """numpy dtype of a declared var dtype; bfloat16 has none."""
    name = canonical_dtype(dtype)
    if name == "bfloat16":
        raise TypeError("numpy has no bfloat16; feed float32 and cast")
    return np.dtype(name)


def is_floating(dtype):
    return canonical_dtype(dtype) in FLOATING


def to_numpy(t):
    """Host copy of a tensor; bfloat16 widens to float32 (numpy has no
    bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# numpy's view of a bfloat16 payload: two bytes per element.  An ``.npy``
# of it carries descr '<V2', as numpy writes ml_dtypes' bfloat16 (the
# JAX package's host type, which this package must not import)
BF16_HOST = np.dtype("V2")


def is_bf16_host(dtype):
    """True for a host array dtype that holds bf16 bits: ``V2`` (this
    package) or ml_dtypes' ``bfloat16`` (whose kind is ``V`` too)."""
    dtype = np.dtype(dtype)
    return dtype.kind == "V" and dtype.itemsize == 2 and not dtype.names


def host_dtype_name(dtype):
    """The IR name of a host array dtype: ``bfloat16`` for bf16 bits."""
    return "bfloat16" if is_bf16_host(dtype) else np.dtype(dtype).name


def host_np_dtype(dtype):
    """The host array dtype that holds a declared var dtype bit for bit:
    ``V2`` for bfloat16, else the numpy dtype of the same name."""
    name = canonical_dtype(dtype)
    return BF16_HOST if name == "bfloat16" else np.dtype(name)


def to_host(t):
    """Host copy of a tensor that keeps its bits: bfloat16 becomes its
    2-byte payload (``V2``), every other dtype stays itself."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_HOST)
    return t.numpy()


# a declared 64-bit variable that the JAX package holds (and saves) in
# 32 bits: a load or restore widens such a value, which is exact
_NARROWED = {("int64", "int32"), ("float64", "float32")}


def widens(declared, dtype):
    """True when a host array of ``dtype`` holds a ``declared`` 64-bit
    variable in 32 bits, as the JAX package holds int64 and float64."""
    return (canonical_dtype(declared), host_dtype_name(dtype)) in _NARROWED


def from_host(arr, device, dtype=None):
    """Tensor on ``device`` from a host array: bf16 bits (``V2`` or
    ml_dtypes' ``bfloat16``) become a bfloat16 tensor, bit for bit.
    ``dtype`` (an IR name) converts the result, e.g. to widen an int32
    entry into a declared int64 variable."""
    arr = np.ascontiguousarray(arr)
    if is_bf16_host(arr.dtype):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.dtype != torch_dtype(dtype):
        t = t.to(torch_dtype(dtype))
    return t.to(device)
