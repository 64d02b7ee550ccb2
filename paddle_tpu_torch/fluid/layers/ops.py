"""Unary layers (reference: layers/layer_function_generator.py, which
generates them from OpProto; counterpart paddle_tpu/fluid/layers/ops.py
:9-31, the same ``_UNARY`` list): one function per op type, each
appending that op on X; the attribute-carrying unaries of JAX ops.py
:36-57 (``relu6``, ``leaky_relu``, ``gelu``, ...), whose keyword
arguments named in their defaults become attributes; and ``cumsum``."""

from ..layer_helper import LayerHelper

_UNARY = [
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt", "square",
    "abs", "floor", "ceil", "round", "reciprocal", "sin", "cos",
    "softsign", "softplus", "sign", "erf", "logsigmoid",
    "acos", "asin", "atan",
]

_ATTR_UNARY = {
    "relu6": ("relu6", {"threshold": 6.0}),
    "leaky_relu": ("leaky_relu", {"alpha": 0.02}),
    "gelu": ("gelu", {"approximate": False}),
    "hard_sigmoid": ("hard_sigmoid", {"slope": 0.2, "offset": 0.5}),
    "swish": ("swish", {"beta": 1.0}),
    "stanh": ("stanh", {"scale_a": 0.67, "scale_b": 1.7159}),
    "pow_": ("pow", {"factor": 1.0}),
    "log_softmax": ("log_softmax", {"axis": -1}),
}

__all__ = list(_UNARY) + list(_ATTR_UNARY) + ["cumsum"]


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


def _make_attr_unary(op_type, attr_defaults):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        attrs = dict(attr_defaults)
        attrs.update({k: v for k, v in kwargs.items() if k in attr_defaults})
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


for _name, (_op, _defaults) in _ATTR_UNARY.items():
    globals()[_name] = _make_attr_unary(_op, _defaults)


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    """The running sum of ``x`` along ``axis`` (JAX ops.py:60)."""
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out
