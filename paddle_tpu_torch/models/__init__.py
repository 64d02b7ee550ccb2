"""paddle_tpu_torch.models — model program builders ported so far."""

from . import bert  # noqa: F401
from . import deepfm  # noqa: F401
from . import lenet  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
from . import mobilenet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import book  # noqa: F401
from . import crnn_ctc  # noqa: F401
