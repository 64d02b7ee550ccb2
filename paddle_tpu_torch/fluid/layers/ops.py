"""Unary layers (reference: layers/layer_function_generator.py, which
generates them from OpProto; counterpart paddle_tpu/fluid/layers/ops.py
:9-31, the same ``_UNARY`` list): one function per op type, each
appending that op on X."""

from ..layer_helper import LayerHelper

_UNARY = [
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt", "square",
    "abs", "floor", "ceil", "round", "reciprocal", "sin", "cos",
    "softsign", "softplus", "sign", "erf", "logsigmoid",
    "acos", "asin", "atan",
]

__all__ = list(_UNARY)


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s (operators/activation_op.cc)." % op_type
    return layer


for _name in _UNARY:
    globals()[_name] = _make_unary(_name)
