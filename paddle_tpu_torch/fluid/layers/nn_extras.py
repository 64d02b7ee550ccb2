"""Layers of the extended op zoo (counterpart paddle_tpu/fluid/layers/
nn_extras.py; reference builders in ``python/paddle/fluid/layers/
nn.py``): the attribute activations, ``prelu``, ``maxout``, the losses,
``group_norm``, ``instance_norm``, ``spectral_norm``, the image and shape
layers, ``sampling_id``, ``shard_index``, ``linspace``, ``diag``,
``roll``, ``im2sequence`` and ``smooth_l1``, with the JAX layers'
signatures, defaults and parameters.  ``py_func`` is ROADMAP item
13c.3c."""

import numpy as np

from ..framework import default_main_program
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "prelu", "maxout", "smooth_l1", "kldiv_loss", "log_loss", "rank_loss",
    "margin_rank_loss", "bpr_loss", "group_norm", "instance_norm",
    "spectral_norm", "pad2d", "pixel_shuffle", "space_to_depth",
    "shuffle_channel", "affine_channel", "temporal_shift", "grid_sampler",
    "sampling_id", "shard_index", "linspace", "diag", "roll",
    "im2sequence", "elu", "softshrink", "hard_shrink", "tanh_shrink",
    "thresholded_relu", "brelu", "soft_relu",
]


def _simple(op_type, inputs, attrs=None, outs=("Out",), dtype=None,
            shape_of=None, extra_outputs=()):
    """One op of ``op_type`` whose output has the first input's dtype
    (or ``dtype``) and ``shape_of``'s shape; ``extra_outputs`` slots get
    a variable each.  Returns the first output."""
    helper = LayerHelper(op_type)
    first = next(iter(inputs.values()))[0]
    out = helper.create_variable_for_type_inference(dtype or first.dtype)
    if shape_of is not None and shape_of.shape:
        out.shape = shape_of.shape
    outputs = {outs[0]: [out]}
    for slot in extra_outputs:
        outputs[slot] = [helper.create_variable_for_type_inference(
            first.dtype)]
    helper.append_op(op_type, inputs=inputs, outputs=outputs,
                     attrs=attrs or {})
    return out


def _attr_act(op_type, attr_names):
    """The layer of an activation whose attributes come by position, in
    ``attr_names``' order, or by name."""
    def layer(x, *args, name=None, **kwargs):
        attrs = dict(zip(attr_names, args))
        attrs.update((k, v) for k, v in kwargs.items() if k in attr_names)
        return _simple(op_type, {"X": [x]}, attrs, shape_of=x)
    layer.__name__ = op_type
    return layer


elu = _attr_act("elu", ("alpha",))
softshrink = _attr_act("softshrink", ("lambda_",))
hard_shrink = _attr_act("hard_shrink", ("threshold",))
tanh_shrink = _attr_act("tanh_shrink", ())
thresholded_relu = _attr_act("thresholded_relu", ("threshold",))
brelu = _attr_act("brelu", ("t_min", "t_max"))
soft_relu = _attr_act("soft_relu", ("threshold",))


def prelu(x, mode="all", param_attr=None, name=None):
    """``where(x > 0, x, alpha·x)`` with a learned Alpha (initial 0.25):
    one value (``all``), one a channel (``channel``) or one an entry of
    a sample (``element``)."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(
        helper.param_attr, alpha_shape, x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    return _simple("maxout", {"X": [x]}, {"groups": groups})


def kldiv_loss(x, target, reduction="mean", name=None):
    return _simple("kldiv_loss", {"X": [x], "Target": [target]},
                   {"reduction": reduction}, outs=("Loss",))


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss", {"Predicted": [input], "Labels": [label]},
                   {"epsilon": epsilon}, outs=("Loss",), shape_of=input)


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss", {"Label": [label], "Left": [left],
                                 "Right": [right]}, shape_of=left)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _simple("margin_rank_loss",
                   {"Label": [label], "X1": [left], "X2": [right]},
                   {"margin": margin}, extra_outputs=("Activated",),
                   shape_of=left)


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": [input], "Label": [label]},
                   outs=("Y",))


def _norm(op_type, input, epsilon=1e-5, param_attr=None, bias_attr=None,
          act=None, name=None, extra_attrs=None):
    """``group_norm``/``instance_norm`` with a Scale (initial 1) and a
    Bias a channel; the statistics' outputs are plain variables."""
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    C = int(input.shape[1])
    scale = helper.create_parameter(
        helper.param_attr, [C], input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, [C], input.dtype,
                                   is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    mean = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"epsilon": epsilon}
    attrs.update(extra_attrs or {})
    inputs = {"X": [input]}
    if scale is not None:
        inputs["Scale"] = [scale]
    if bias is not None:
        inputs["Bias"] = [bias]
    group = op_type == "group_norm"
    outputs = {"Y": [out], "Mean" if group else "SavedMean": [mean],
               "Variance" if group else "SavedVariance": [var]}
    helper.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    return helper.append_activation(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, name=None):
    return _norm("group_norm", input, epsilon=epsilon,
                 param_attr=param_attr, bias_attr=bias_attr, act=act,
                 name=name, extra_attrs={"groups": groups})


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    return _norm("instance_norm", input, epsilon=epsilon,
                 param_attr=param_attr, bias_attr=bias_attr, name=name)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Weight over its largest singular value; U ``[h]`` and V ``[w]``
    (``h`` the ``dim`` size, ``w`` the rest) are ``Normal(0, 1)``
    parameters that take no gradient and are never written back."""
    helper = LayerHelper("spectral_norm", name=name)
    shape = [int(s) for s in weight.shape]
    h = shape[dim]
    w = int(np.prod(shape)) // h
    u = helper.create_parameter(
        None, [h], weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    v = helper.create_parameter(
        None, [w], weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(weight.dtype)
    out.shape = weight.shape
    helper.append_op("spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    """NCHW padded by ``[top, bottom, left, right]``."""
    return _simple("pad2d", {"X": [input]},
                   {"paddings": list(paddings), "mode": mode,
                    "pad_value": pad_value})


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", {"X": [x]},
                   {"upscale_factor": upscale_factor})


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": [x]}, {"blocksize": blocksize})


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": [x]}, {"group": group},
                   shape_of=x)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    return _simple("affine_channel",
                   {"X": [x], "Scale": [scale], "Bias": [bias]},
                   shape_of=x)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """TSM's shift over the ``seg_num`` frames of each clip of ``[N·T,
    C, H, W]``: ``int(C·ratio)`` channels from the frame before, as many
    again from the frame after."""
    return _simple("temporal_shift", {"X": [x]},
                   {"seg_num": seg_num, "shift_ratio": shift_ratio},
                   shape_of=x)


def grid_sampler(x, grid, name=None):
    return _simple("grid_sampler", {"X": [x], "Grid": [grid]},
                   outs=("Output",))


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    """One class a row of probabilities, drawn from the op's stream
    (``min``, ``max`` and ``seed`` are not read, as in the JAX layer)."""
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    if x.shape:
        out.shape = (x.shape[0],)
    helper.append_op("sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"__op_seed__":
                            default_main_program().next_op_seed()})
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _simple("shard_index", {"X": [input]},
                   {"index_num": index_num, "nshards": nshards,
                    "shard_id": shard_id, "ignore_value": ignore_value},
                   shape_of=input)


def linspace(start, stop, num, dtype="float32"):
    return _simple("linspace", {"Start": [start], "Stop": [stop]},
                   {"num": int(num)}, dtype=dtype)


def diag(diagonal):
    return _simple("diag", {"Diagonal": [diagonal]})


def roll(x, shifts, dims=None):
    if isinstance(shifts, int):
        shifts = [shifts]
    attrs = {"shifts": list(shifts)}
    if dims is not None:
        attrs["dims"] = [dims] if isinstance(dims, int) else list(dims)
    return _simple("roll", {"X": [x]}, attrs, shape_of=x)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """``[N, C, H, W]`` → ``[N, Ho·Wo, C·kh·kw]``, one step a window
    position; ``padding`` is one int, ``[h, w]`` or ``[up, left, down,
    right]``.  As in the JAX layer, the output's static shape is left
    unset: a caller that needs it sets it."""
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    pads = _pair(padding)
    if len(pads) == 2:
        pads = pads + pads
    return _simple("im2sequence", {"X": [input]},
                   {"kernels": _pair(filter_size),
                    "strides": _pair(stride), "paddings": pads})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    """``smooth_l1_loss`` of x against y, one sum a row: ``[N, 1]``."""
    helper = LayerHelper("smooth_l1_loss")
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    diff = helper.create_variable_for_type_inference(x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [out]},
                     attrs={"sigma": sigma})
    return out
