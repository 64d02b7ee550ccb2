"""Weight-decay regularizers (counterpart ``paddle_tpu/fluid/
regularizer.py``; reference ``python/paddle/fluid/regularizer.py``).

``append_regularization_ops`` rewrites each (param, grad) pair into
``grad + coeff·penalty'(param)``, emitted as ``scale`` (and for L1
``sign``) plus ``sum`` ops in ``OpRole.Optimize``, with the JAX package's
variable names, so both packages build the same program.
"""

from .framework import OpRole, OP_ROLE_KEY


class WeightDecayRegularizer:
    def append_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """penalty'(p) = coeff·p."""

    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = regularization_coeff

    def append_op(self, param, grad, block):
        decay = block.create_var(
            name=grad.name + "@L2DECAY", shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.regularization_coeff,
                               OP_ROLE_KEY: OpRole.Optimize})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """penalty'(p) = coeff·sign(p)."""

    def __init__(self, regularization_coeff=0.0):
        self.regularization_coeff = regularization_coeff

    def append_op(self, param, grad, block):
        sign = block.create_var(
            name=grad.name + "@SIGN", shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={OP_ROLE_KEY: OpRole.Optimize})
        decay = block.create_var(
            name=grad.name + "@L1DECAY", shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.regularization_coeff,
                               OP_ROLE_KEY: OpRole.Optimize})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    """[(param, grad)] → [(param, grad + decay)]; a parameter's own
    regularizer wins over ``regularization``."""
    result = []
    for param, grad in params_grads:
        regularizer = param.regularizer or regularization
        if regularizer is None or grad is None:
            result.append((param, grad))
            continue
        block = grad.block
        decay = regularizer.append_op(param, grad, block)
        new_grad = block.create_var(name=grad.name + "@REG",
                                    shape=param.shape, dtype=grad.dtype)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]},
                        attrs={OP_ROLE_KEY: OpRole.Optimize})
        result.append((param, new_grad))
    return result


# reference-compatible aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
