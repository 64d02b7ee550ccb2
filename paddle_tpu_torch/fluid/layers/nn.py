"""NN layers of the slice (reference: python/paddle/fluid/layers/nn.py;
counterpart paddle_tpu/fluid/layers/nn.py, whose build-time shape
inference these copy so both packages build the same program).

Each function appends ops to the current block and returns the output
Variable.  Shapes are build-time metadata (batch dim may be -1).
"""

import numpy as np

from ..data_types import canonical_dtype
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out(size, k, p, s, d=1):
    if size is None or size < 0:
        return -1
    return (size + 2 * p - (d * (k - 1) + 1)) // s + 1


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


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """2-D convolution, NCHW (reference nn.py conv2d; JAX nn.py:96).  The
    filter is OIHW with the default init ``Normal(0, sqrt(2 / fan_in))``;
    ``groups == C == num_filters > 1`` emits ``depthwise_conv2d``."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    fsize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    groups = groups or 1
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    default_init = NormalInitializer(0.0, float(np.sqrt(2.0 / fan_in)))
    w = helper.create_parameter(helper.param_attr, filter_shape, input.dtype,
                                default_initializer=default_init)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (input.shape[0], num_filters,
                 _conv_out(input.shape[2], fsize[0], padding[0], stride[0],
                           dilation[0]),
                 _conv_out(input.shape[3], fsize[1], padding[1], stride[1],
                           dilation[1]))
    op_type = "depthwise_conv2d" if (groups == num_channels and
                                     num_channels == num_filters and
                                     groups > 1) else "conv2d"
    helper.append_op(op_type, inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": list(stride), "paddings": list(padding),
                            "dilations": list(dilation), "groups": groups})
    pre_act = out
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters],
                                    input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        pre_act.shape = out.shape
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [pre_act]}, attrs={"axis": 1})
    return helper.append_activation(pre_act, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 2-D convolution, NCHW (JAX nn.py:136): the filter is
    ``[C_in, num_filters / groups, kh, kw]``; ``filter_size`` is required
    and ``output_size`` is not read (the output side is ``(H - 1) s - 2 p
    + d (k - 1) + 1``), as in the JAX package."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        raise ValueError("filter_size required")
    fsize = _pair(filter_size)
    filter_shape = [num_channels, num_filters // (groups or 1)] + list(fsize)
    w = helper.create_parameter(helper.param_attr, filter_shape, input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)

    def _out(size, k, p, s, d):
        if size is None or size < 0:
            return -1
        return (size - 1) * s - 2 * p + d * (k - 1) + 1

    out.shape = (input.shape[0], num_filters,
                 _out(input.shape[2], fsize[0], padding[0], stride[0],
                      dilation[0]),
                 _out(input.shape[3], fsize[1], padding[1], stride[1],
                      dilation[1]))
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": list(stride), "paddings": list(padding),
                            "dilations": list(dilation),
                            "groups": groups or 1})
    pre_act = out
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters],
                                    input.dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(input.dtype)
        pre_act.shape = out.shape
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [pre_act]}, attrs={"axis": 1})
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """Max or average pooling, NCHW (JAX nn.py:193)."""
    helper = LayerHelper("pool2d", name=name)
    ksize = _pair(pool_size)
    stride = _pair(pool_stride)
    padding = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(input.dtype)
    if global_pooling:
        out.shape = (input.shape[0], input.shape[1], 1, 1)
    else:
        def _posz(size, k, p, s):
            if size is None or size < 0:
                return -1
            if ceil_mode:
                return -(-(size + 2 * p - k) // s) + 1
            return (size + 2 * p - k) // s + 1
        out.shape = (input.shape[0], input.shape[1],
                     _posz(input.shape[2], ksize[0], padding[0], stride[0]),
                     _posz(input.shape[3], ksize[1], padding[1], stride[1]))
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": list(ksize),
                            "strides": list(stride),
                            "paddings": list(padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch normalization (JAX nn.py:214): float32 scale (1) and bias
    (0) parameters, float32 running mean (0) and variance (1) that the op
    updates in place (``MeanOut``/``VarianceOut`` name the same
    variables)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, [channels], "float32",
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, [channels], "float32",
                                   is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or helper.name + ".mean",
        shape=(channels,), dtype="float32", persistable=True,
        stop_gradient=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_or_get_global_variable(
        moving_variance_name or helper.name + ".variance",
        shape=(channels,), dtype="float32", persistable=True,
        stop_gradient=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def topk(input, k, name=None):
    """(values, int64 indices) of the k largest entries of the last axis
    (JAX nn.py:692)."""
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    if input.shape is not None:
        values.shape = tuple(input.shape[:-1]) + (k,)
        indices.shape = values.shape
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    return values, indices


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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    """Elementwise logistic loss of logits x against float labels (JAX
    nn.py:340)."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def clip(x, min, max, name=None):
    """x clipped to [min, max] (JAX nn.py:729)."""
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    """x scaled to L2 norm ``max_norm`` where its norm is larger (JAX
    nn.py:738)."""
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


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


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    """``x mod y`` with the divisor's sign (JAX nn_extras2.py:619)."""
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def _logical(op_type, inputs, x):
    """A bool Variable shaped like ``x`` (JAX nn_extras2.py:114)."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("bool")
    if x.shape:
        out.shape = x.shape
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs={})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", {"X": [x], "Y": [y]}, x)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", {"X": [x], "Y": [y]}, x)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", {"X": [x], "Y": [y]}, x)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", {"X": [x]}, x)


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    """A reduce op over ``dim`` (an int or a list), or over every axis
    when ``dim`` is None (``reduce_all``; the declared shape is (1,), the
    value 0-d, as in the JAX package)."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        out.shape = (1,)
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        if input.shape:
            nd = len(input.shape)
            axes = set(d % nd for d in dims)
            if keep_dim:
                out.shape = tuple(1 if i in axes else s
                                  for i, s in enumerate(input.shape))
            else:
                out.shape = tuple(s for i, s in enumerate(input.shape)
                                  if i not in axes)
        attrs = {"dim": list(dims), "keep_dim": keep_dim,
                 "reduce_all": False}
    helper.append_op(op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    if input.shape is not None:
        base = input.shape[:-1] if input.shape[-1] == 1 else input.shape
        out.shape = tuple(base) + (depth,)
    helper.append_op("one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """``(1 − eps)·label + eps·prior`` (uniform over the last axis when
    ``prior_dist`` is None), built from ``scale`` ops as the JAX package
    builds it; there is no label_smooth op."""
    if prior_dist is None:
        num_classes = label.shape[-1]
        return scale(label, 1.0 - epsilon, epsilon / float(num_classes))
    return elementwise_add(scale(label, 1.0 - epsilon),
                           scale(prior_dist, epsilon))


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """``-log`` of the label's probability in ``input`` (probabilities,
    not logits): ``[..., 1]`` (JAX layers/nn.py:327)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        out.shape = tuple(input.shape[:-1]) + (1,)
    helper.append_op("cross_entropy", inputs={"X": [input],
                                              "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape is not None:
        nd = len(input.shape)
        drop = set(a % nd for a in axes)
        out.shape = tuple(s for i, s in enumerate(input.shape)
                          if not (i in drop and s == 1))
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op("squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    if xs[0].shape is not None:
        shape = list(xs[0].shape)
        shape.insert(axis if axis >= 0 else axis + len(shape) + 1, len(xs))
        out.shape = tuple(shape)
    helper.append_op("stack", inputs={"X": xs}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(s * t if s and s > 0 else -1
                          for s, t in zip(x.shape, expand_times))
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def where(condition, x, y):
    """X where ``condition`` holds, else Y (the JAX package's select)."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("where", inputs={"Condition": [condition], "X": [x],
                                      "Y": [y]},
                     outputs={"Out": [out]})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    nd = len(input.shape)
    axis = dim % nd
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
        sizes = [input.shape[axis] // num] * num \
            if input.shape[axis] > 0 else [-1] * num
    else:
        sections = list(num_or_sections)
        num = 0
        sizes = sections
    outs = []
    for s in sizes:
        o = helper.create_variable_for_type_inference(input.dtype)
        shape = list(input.shape)
        shape[axis] = s
        o.shape = tuple(shape)
        outs.append(o)
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs={"axis": axis, "num": num, "sections": sections})
    return outs


def huber_loss(input, label, delta):
    """Huber loss on ``label - input`` (JAX nn.py:363); the Residual
    output is a temporary."""
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """``x`` flattened to 2-D at ``x_num_col_dims`` times ``y`` flattened
    at ``y_num_col_dims`` (JAX nn.py:382): one ``mul`` op."""
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(x.shape[:x_num_col_dims]) + tuple(
        y.shape[y_num_col_dims:])
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def flatten(x, axis=1, name=None):
    """``x`` as ``[prod(shape[:axis]), prod(shape[axis:])]``: a
    ``flatten2`` op (JAX nn.py:534)."""
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        lead = int(np.prod([s for s in x.shape[:axis]])) if axis > 0 else 1
        trail = int(np.prod([s for s in x.shape[axis:]]))
        out.shape = (lead if all(s > 0 for s in x.shape[:axis]) else -1,
                     trail)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


def gather_nd(input, index, name=None):
    """``input`` at the coordinates in the last dim of ``index`` (JAX
    nn.py:662)."""
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    """``input`` with rows ``index`` set to (or, without ``overwrite``,
    increased by) ``updates`` (JAX nn.py:670)."""
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x / sqrt(sum(x², axis) + epsilon)``, composed of elementwise,
    reduce and ``rsqrt`` ops as the JAX layer composes it (nn.py:718)."""
    sq = elementwise_mul(x, x)
    ssum = reduce_sum(sq, dim=axis, keep_dim=True)
    norm = scale(ssum, 1.0, epsilon)
    helper = LayerHelper("l2_normalize")
    rsq = helper.create_variable_for_type_inference(x.dtype)
    rsq.shape = norm.shape
    helper.append_op("rsqrt", inputs={"X": [norm]}, outputs={"Out": [rsq]})
    return elementwise_mul(x, rsq, axis=0 if axis == 0 else -1)


def pad(x, paddings, pad_value=0.0, name=None):
    """``x`` padded with ``pad_value``: ``paddings`` holds (before, after)
    for each dim in order (JAX nn.py:748)."""
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(
            (s + paddings[2 * i] + paddings[2 * i + 1]) if s and s > 0 else -1
            for i, s in enumerate(x.shape))
    helper.append_op("pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, seed=0, input_dim_idx=0,
                                   output_dim_idx=0):
    """Uniform draws in ``[min, max)`` of ``shape`` with the batch dim
    taken from ``input`` (JAX nn.py:761)."""
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    out.shape = tuple(shape)
    helper.append_op("uniform_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": min, "max": max,
                            "seed": seed, "dtype": canonical_dtype(dtype),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """Normal draws of ``shape`` (JAX nn.py:779)."""
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    out.shape = tuple(shape)
    helper.append_op("gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": mean, "std": std,
                            "seed": seed, "dtype": canonical_dtype(dtype),
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    """Uniform draws in ``[min, max)`` of ``shape`` (JAX nn.py:792)."""
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    out.shape = tuple(shape)
    helper.append_op("uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": min, "max": max,
                            "seed": seed, "dtype": canonical_dtype(dtype),
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return out
