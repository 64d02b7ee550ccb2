"""Sequence layers over padded batches plus explicit lengths
(counterpart paddle_tpu/fluid/layers/sequence.py; reference
``python/paddle/fluid/layers/nn.py`` sequence_*): the book models'
``sequence_mask``, ``sequence_pool`` with ``sequence_first_step`` and
``sequence_last_step``, and ``sequence_conv``.  Each takes a ``length``
Variable ``[batch]`` beside the padded ``[batch, time, ...]`` data, in
place of the reference's LoD."""

from ..data_types import canonical_dtype
from ..layer_helper import LayerHelper

__all__ = ["sequence_mask", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_conv"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths ``[B]`` → mask ``[B, maxlen]``; ``maxlen`` must be a
    static int."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    if maxlen is None or (isinstance(maxlen, int) and maxlen < 0):
        raise ValueError("sequence_mask needs a static maxlen")
    out.shape = (x.shape[0] if x.shape else -1, int(maxlen))
    helper.append_op("sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"maxlen": int(maxlen),
                            "out_dtype": canonical_dtype(dtype)})
    return out


def sequence_pool(input, pool_type, length=None, is_test=False):
    assert length is not None, \
        "sequence layers need an explicit length tensor (no LoD)"
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        out.shape = (input.shape[0],) + tuple(input.shape[2:])
    helper.append_op("sequence_pool",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "FIRST", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "LAST", length=length)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, bias_attr=None, param_attr=None, act=None,
                  length=None, name=None):
    """Context-window convolution over time: Filter
    ``[filter_size·D, num_filters]``, window start
    ``-((filter_size − 1) // 2)``, then the bias and ``act``."""
    assert length is not None
    helper = LayerHelper("sequence_conv", name=name,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    D = input.shape[-1]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=[int(filter_size) * int(D),
                                       num_filters], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        out.shape = tuple(input.shape[:2]) + (num_filters,)
    helper.append_op(
        "sequence_conv",
        inputs={"X": [input], "Filter": [filter_param], "Length": [length]},
        outputs={"Out": [out]},
        attrs={"contextLength": int(filter_size),
               "contextStart": -int((filter_size - 1) // 2),
               "contextStride": int(filter_stride)})
    if helper.bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr,
                                       shape=[num_filters],
                                       dtype=input.dtype, is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype)
        tmp.shape = out.shape
        helper.append_op("elementwise_add",
                         inputs={"X": [out], "Y": [bias]},
                         outputs={"Out": [tmp]}, attrs={"axis": -1})
        out = tmp
    return helper.append_activation(out, act)
