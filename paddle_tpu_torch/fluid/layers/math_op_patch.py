"""Operator-overload support for Variables (reference: layers/math_op_patch.py).

The slice ports ``+``, ``-``, ``*`` and ``/`` between two Variables
(``elementwise_add``/``_sub``/``_mul``/``_div``, ``axis=-1``: Y aligns
to X's trailing dims) and with a float scalar on the Variable's right,
lowered to a ``scale`` op as in the JAX package."""

from ..data_types import is_floating
from ..framework import Variable
from ..layer_helper import LayerHelper


def scale(x, scale_val=1.0, bias=0.0):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale_val), "bias": float(bias)})
    return out


# (scale, bias) of ``x <op> y`` for a float scalar y (math_op_patch.py:36)
_SCALAR = {
    "elementwise_add": lambda y: (1.0, y),
    "elementwise_sub": lambda y: (1.0, -y),
    "elementwise_mul": lambda y: (y, 0.0),
    "elementwise_div": lambda y: (1.0 / y, 0.0),
}


def binary(x, y, op_type):
    if op_type not in _SCALAR:
        raise NotImplementedError("%s between Variables is not ported"
                                  % op_type)
    if isinstance(y, (int, float)):
        if not is_floating(x.dtype):
            raise NotImplementedError(
                "a scalar with an integer Variable is not ported (the JAX "
                "package fills a tensor for it, "
                "fill_constant_batch_size_like)")
        return scale(x, *_SCALAR[op_type](y))
    if not isinstance(y, Variable):
        raise TypeError("cannot apply %s to a Variable and %r"
                        % (op_type, y))
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape if (x.shape and y.shape and
                            len(x.shape) >= len(y.shape)) else y.shape
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
