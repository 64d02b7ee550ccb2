"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu's Fluid framework.

Programs are built as the same Fluid-style op-list IR from Python and run
by an executor that walks each block op by op on ``torch`` tensors.  The
TPU's Pallas kernels become CUDA C++ kernels written for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

The package imports ``torch``, numpy and the standard library only; it
never imports ``jax`` or ``paddle_tpu``.  Its layout mirrors
``paddle_tpu`` so each module's counterpart is found by name.

Subpackages load on first use (``paddle_tpu_torch.fluid``, ``.models``,
``.parallel``,
``.reader``, ``.dataset``, ``.batch``), so ``python -m paddle_tpu_torch.distributed.
launch`` supervises its ranks without importing torch.
"""

import importlib

_SUBPACKAGES = ("fluid", "models", "reader", "dataset", "distributed",
               "parallel", "tools")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module("." + name, __name__)
    if name == "batch":
        # the function, not its module (``paddle.batch``)
        fn = importlib.import_module(".batch", __name__).batch
        globals()["batch"] = fn
        return fn
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
