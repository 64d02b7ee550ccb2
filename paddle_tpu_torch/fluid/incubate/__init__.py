"""Incubating APIs (counterpart ``paddle_tpu/fluid/incubate``): fleet."""

from . import fleet  # noqa: F401
