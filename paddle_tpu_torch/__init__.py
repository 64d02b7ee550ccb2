"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu's Fluid framework.

Programs are built as the same Fluid-style op-list IR from Python and run
by an executor that walks each block op by op on ``torch`` tensors.  The
TPU's Pallas kernels become CUDA C++ kernels written for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

The package imports ``torch``, numpy and the standard library only; it
never imports ``jax`` or ``paddle_tpu``.  Its layout mirrors
``paddle_tpu`` so each module's counterpart is found by name.
"""

from . import fluid  # noqa: F401
from . import models  # noqa: F401
from . import reader  # noqa: F401
from .batch import batch  # noqa: F401
