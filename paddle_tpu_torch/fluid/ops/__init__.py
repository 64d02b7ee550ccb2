"""Import all op lowering modules so registration side-effects run."""

from . import compat_ops     # noqa: F401
from . import math_ops       # noqa: F401
from . import tensor_ops     # noqa: F401
from . import nn_ops         # noqa: F401
from . import attention_ops  # noqa: F401
from . import conv_ops       # noqa: F401
from . import norm_ops       # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import io_ops         # noqa: F401
from . import collective_ops  # noqa: F401
from . import sequence_ops   # noqa: F401
from . import rnn_ops        # noqa: F401
from . import crf_ops        # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import generation_ops  # noqa: F401
from . import distributed_ops  # noqa: F401
from . import lod_machinery_ops  # noqa: F401
from . import moe_ops        # noqa: F401
from . import misc_ops       # noqa: F401
from . import misc_ops2      # noqa: F401
from . import misc_ops3      # noqa: F401
from . import misc_ops4      # noqa: F401
from . import detection_ops  # noqa: F401
from . import detection_ops2  # noqa: F401
from . import detection_ops3  # noqa: F401
