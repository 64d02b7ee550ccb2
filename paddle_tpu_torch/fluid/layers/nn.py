"""NN layers of the slice (reference: python/paddle/fluid/layers/nn.py;
counterpart paddle_tpu/fluid/layers/nn.py, whose build-time shape
inference these copy so both packages build the same program).

Each function appends ops to the current block and returns the output
Variable.  Shapes are build-time metadata (batch dim may be -1).
"""

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer (reference nn.py fc → mul + elementwise_add)."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(helper.param_attr, [in_dim, size],
                                    inp.dtype)
        out = helper.create_variable_for_type_inference(inp.dtype)
        out.shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = _append_bias(helper, pre_bias, helper.bias_attr,
                           dim_start=num_flatten_dims)
    return helper.append_activation(pre_act, act)


def _append_bias(helper, x, bias_attr, dim_start=1):
    if bias_attr is False:
        return x
    size = x.shape[-1]
    b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("elementwise_add", inputs={"X": [x], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference nn.py embedding → lookup_table op).

    ``is_sparse`` selected SelectedRows grads in the reference; the port's
    (and the JAX package's) table gradient is dense, so the flag is
    accepted and ignored.
    """
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, list(size), dtype)
    out = helper.create_variable_for_type_inference(dtype)
    in_shape = input.shape or (-1, 1)
    if in_shape and in_shape[-1] == 1:
        out.shape = tuple(in_shape[:-1]) + (size[1],)
    else:
        out.shape = tuple(in_shape) + (size[1],)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, norm_shape, "float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, norm_shape, "float32",
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    mean = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference("uint8",
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "fix_seed": seed is not None, "seed": seed or 0,
                            "dropout_implementation": dropout_implementation,
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    softmax_out.shape = logits.shape
    loss = helper.create_variable_for_type_inference(logits.dtype)
    loss.shape = tuple(logits.shape[:-1]) + (1,)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index,
                            "numeric_stable_mode": numeric_stable_mode})
    if return_softmax:
        return loss, softmax_out
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (1,)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xs = list(x.shape or ())
    ys = list(y.shape or ())
    if xs and ys:
        if transpose_x and len(xs) >= 2:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) >= 2:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        out.shape = tuple(batch) + (xs[-2] if len(xs) >= 2 else 1, ys[-1])
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        known = [s for s in shape if s > 0]
        new_shape = list(shape)
        for i, s in enumerate(new_shape):
            if s == 0:
                new_shape[i] = x.shape[i]
        out.shape = tuple(new_shape)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape[p] for p in perm)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        shape = list(input.shape)
        for a in sorted(axes):
            shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
        out.shape = tuple(shape)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op("unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        shape = list(input.shape)
        for a, s, e in zip(axes, starts, ends):
            dim = shape[a]
            if dim is None or dim < 0:
                shape[a] = -1
                continue
            s2 = max(s + dim, 0) if s < 0 else min(s, dim)
            e2 = max(e + dim, 0) if e < 0 else min(e, dim)
            shape[a] = max(e2 - s2, 0)
        out.shape = tuple(shape)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None and index.shape is not None:
        out.shape = tuple(index.shape[:1]) + tuple(input.shape[1:])
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out
