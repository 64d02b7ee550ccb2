"""fluid.contrib of the port: ``mixed_precision`` only (counterpart
``paddle_tpu/fluid/contrib``)."""

from . import mixed_precision  # noqa: F401
