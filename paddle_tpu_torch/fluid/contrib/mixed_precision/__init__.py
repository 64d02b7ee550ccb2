"""Automatic mixed precision (counterpart ``paddle_tpu/fluid/contrib/
mixed_precision``; reference ``contrib/mixed_precision``)."""

from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
