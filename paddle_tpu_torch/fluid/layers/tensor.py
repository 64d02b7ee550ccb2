"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py):
``assign``, which BERT's causal composition path and the Transformer's
positional table call, ``create_parameter`` and ``fill_constant``."""

import numpy as np

from ..layer_helper import LayerHelper
from ..data_types import canonical_dtype
from ..param_attr import ParamAttr


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(input.dtype))
        output.shape = input.shape
        helper.append_op("assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": canonical_dtype(str(input.dtype)),
                                "values": input.flatten().tolist()})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    output.shape = input.shape
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Create a standalone trainable parameter (reference tensor.py
    create_parameter)."""
    helper = LayerHelper("create_parameter")
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, list(shape), dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "value": float(value)})
    return out
