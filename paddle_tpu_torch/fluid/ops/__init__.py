"""Import all op lowering modules so registration side-effects run."""

from . import compat_ops     # noqa: F401
from . import math_ops       # noqa: F401
from . import tensor_ops     # noqa: F401
from . import nn_ops         # noqa: F401
from . import attention_ops  # noqa: F401
from . import conv_ops       # noqa: F401
from . import norm_ops       # noqa: F401
from . import optimizer_ops  # noqa: F401
