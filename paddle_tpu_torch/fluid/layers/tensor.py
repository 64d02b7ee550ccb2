"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py;
counterpart paddle_tpu/fluid/layers/tensor.py): ``assign``, which BERT's
causal composition path and the Transformer's positional table call,
``create_parameter``, ``fill_constant``, ``cast``, ``concat`` and
``sums`` (DeepFM and the global-norm clip), and the book models'
``fill_constant_batch_size_like``, ``zeros_like`` and ``range``; the
fills ``zeros``, ``ones``, ``ones_like``, the global variables
``create_tensor``/``create_global_var``, ``argmax``/``argmin``/
``argsort``, ``reverse``, ``has_nan``/``has_inf`` and
``tensor_array_to_tensor``."""

import numpy as np

from ..framework import Variable
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


def create_tensor(dtype, name=None, persistable=False):
    """An empty variable of ``dtype`` in the global block (JAX
    tensor.py:10), for an op to write into."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(name=helper.name, dtype=dtype,
                                         persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable that the startup program fills with ``value``
    (JAX tensor.py:16)."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=helper.name, shape=shape,
                                        dtype=dtype, persistable=persistable)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


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


def cast(x, dtype):
    """x in ``dtype`` (JAX tensor.py:53)."""
    helper = LayerHelper("cast")
    dtype = canonical_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = x.shape
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    """The ``input`` list joined along ``axis`` (JAX tensor.py:63)."""
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        shape = list(shapes[0])
        ax = axis % len(shape)
        if all(s[ax] is not None and s[ax] >= 0 for s in shapes):
            shape[ax] = sum(s[ax] for s in shapes)
        out.shape = tuple(shape)
    helper.append_op("concat", inputs={"X": input}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def sums(input, out=None):
    """The sum of the ``input`` list, one ``sum`` op (JAX tensor.py:98)."""
    helper = LayerHelper("sums")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    out.shape = input[0].shape
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(shape)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": canonical_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def isfinite(x):
    """One ``(1,)`` bool: every entry of ``x`` finite (JAX tensor.py:211)."""
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("isfinite", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def range(start, end, step, dtype="int64"):
    """``arange(start, end, step)`` (JAX tensor.py:154): Python bounds
    become static attrs, Variables the Start/End/Step inputs."""
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype)
    if not isinstance(start, Variable) and not isinstance(end, Variable) \
            and not isinstance(step, Variable):
        helper.append_op("range", outputs={"Out": [out]},
                         attrs={"static_start": start, "static_end": end,
                                "static_step": step})
        return out
    s = fill_constant([1], dtype, start) if not isinstance(start, Variable) \
        else start
    e = fill_constant([1], dtype, end) if not isinstance(end, Variable) \
        else end
    st = fill_constant([1], dtype, step) if not isinstance(step, Variable) \
        else step
    helper.append_op("range", inputs={"Start": [s], "End": [e], "Step": [st]},
                     outputs={"Out": [out]})
    return out


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def ones_like(x, out=None):
    """``x``'s shape and dtype filled with 1: a ``fill_any_like`` op (JAX
    tensor.py:194)."""
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0})
    return out


def argmax(x, axis=0):
    """int64 index of the largest entry along ``axis``, the first among
    ties (JAX tensor.py:125)."""
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argsort(x, axis=-1, name=None):
    """``(sorted x, int64 order)`` along ``axis``, ascending and stable
    (JAX tensor.py:143)."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ids = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def reverse(x, axis):
    """``x`` flipped along ``axis`` (an int or a list; JAX tensor.py:177)."""
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("reverse", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out


def has_nan(x):
    """One ``(1,)`` bool: some entry of ``x`` is NaN (JAX tensor.py:220)."""
    helper = LayerHelper("has_nan")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("has_nan", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_inf(x):
    """One ``(1,)`` bool: some entry of ``x`` is infinite (JAX
    tensor.py:230)."""
    helper = LayerHelper("has_inf")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op("has_inf", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def tensor_array_to_tensor(input, axis=1, name=None):
    """A tensor array joined into one tensor along ``axis``, with each
    entry's size along it (JAX tensor.py:238): ``(out, out_index)``."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference("float32")
    out_index = helper.create_variable_for_type_inference("int32")
    helper.append_op("tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [out_index]},
                     attrs={"axis": int(axis)})
    return out, out_index
