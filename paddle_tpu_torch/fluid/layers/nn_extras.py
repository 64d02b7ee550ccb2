"""Layers of the extended op zoo (counterpart paddle_tpu/fluid/layers/
nn_extras.py; reference builders in ``python/paddle/fluid/layers/
nn.py``), so far ``im2sequence`` and ``smooth_l1``; the rest of the JAX
file is ROADMAP item 13c.3."""

from ..layer_helper import LayerHelper

__all__ = ["im2sequence", "smooth_l1"]


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
