"""Operator-overload support for Variables (reference: layers/math_op_patch.py;
counterpart paddle_tpu/fluid/layers/math_op_patch.py, whose branch order
this copies so both packages emit the same ops).

``+``, ``-``, ``*`` and ``/`` between two Variables are
``elementwise_add``/``_sub``/``_mul``/``_div`` with ``axis=-1`` (Y aligns
to X's trailing dims).  A scalar on a float Variable's right is a
``scale`` op; a scalar on the left, or beside an integer Variable, is
filled into a tensor shaped like the Variable first
(``fill_constant_batch_size_like``), so ``1.0 - v`` is a fill and an
``elementwise_sub``."""

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


def _fill_like(ref, value):
    """A tensor of ``value`` shaped like ``ref`` (math_op_patch.py:16)."""
    helper = LayerHelper("fill")
    out = helper.create_variable_for_type_inference(ref.dtype)
    out.shape = ref.shape
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [ref]}, outputs={"Out": [out]},
                     attrs={"shape": [s if s and s > 0 else 1
                                      for s in (ref.shape or (1,))],
                            "value": float(value), "dtype": ref.dtype})
    return out


# (scale, bias) of ``x <op> y`` for a float scalar y (math_op_patch.py:36)
_SCALAR = {
    "elementwise_add": lambda y: (1.0, y),
    "elementwise_sub": lambda y: (1.0, -y),
    "elementwise_mul": lambda y: (y, 0.0),
    "elementwise_div": lambda y: (1.0 / y, 0.0),
}


def binary(x, y, op_type):
    # a scalar beside an integer Variable is filled (scale would cast it
    # to the integer dtype)
    if isinstance(y, (int, float)) and not (
            isinstance(x, Variable) and is_floating(x.dtype)):
        y = _fill_like(x, y)
    if isinstance(y, (int, float)):
        if op_type in _SCALAR:
            return scale(x, *_SCALAR[op_type](y))
        y = _fill_like(x, y)
    if isinstance(x, (int, float)):
        x = _fill_like(y, x)
    if not (isinstance(x, Variable) and isinstance(y, Variable)):
        raise TypeError("cannot apply %s to %r and %r" % (op_type, x, y))
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape if (x.shape and y.shape and
                            len(x.shape) >= len(y.shape)) else y.shape
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out
