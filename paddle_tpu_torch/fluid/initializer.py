"""Parameter initializers (reference: python/paddle/fluid/initializer.py).

Initializers are *ops appended to the startup program*: running the
startup program materializes every parameter.  The random initializer
ops lower to draws from an explicit ``torch.Generator`` seeded per op
(``lowering.LowerCtx.generator``).
"""

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed,
                               "__op_seed__": block.program.next_op_seed()})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed,
                               "__op_seed__": block.program.next_op_seed()})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed,
                               "__op_seed__": block.program.next_op_seed()})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He initialisation: uniform in ``±sqrt(6 / fan_in)`` or normal of
    std ``sqrt(2 / fan_in)``."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fi))
            NormalInitializer(0.0, std, self.seed)(var, block)


# Reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
