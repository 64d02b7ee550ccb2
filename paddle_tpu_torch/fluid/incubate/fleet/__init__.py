"""Fleet (counterpart ``paddle_tpu/fluid/incubate/fleet``): the
collective mode (``fleet.collective``); the parameter-server mode is
ROADMAP queue 1 item 13b."""

from . import base  # noqa: F401
