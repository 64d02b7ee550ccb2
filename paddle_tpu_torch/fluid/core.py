"""``fluid.core`` names the runtime raises (counterpart
``paddle_tpu/fluid/core_shim.py``; reference: the pybind ``core``
module)."""


class EOFException(Exception):
    """Raised by Executor.run at pass end when pulling from a program-bound
    DataLoader (reference: fluid.core.EOFException from the C++ reader
    stack)."""
