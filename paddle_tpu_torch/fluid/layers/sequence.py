"""Sequence layers over padded batches plus explicit lengths
(counterpart paddle_tpu/fluid/layers/sequence.py; reference
``python/paddle/fluid/layers/nn.py`` sequence_*): every layer of the JAX
file.  Each takes a ``length`` Variable ``[batch]`` beside the padded
``[batch, time, ...]`` data, in place of the reference's LoD."""

from ..data_types import canonical_dtype
from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "sequence_softmax", "sequence_reverse",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_concat", "sequence_conv", "sequence_slice",
    "sequence_enumerate",
]


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


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    """Softmax over each row's valid steps; input ``[B, T]`` or ``[B, T,
    1]``."""
    assert length is not None
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("sequence_softmax",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_reverse(x, length=None, name=None):
    """Each row's valid prefix reversed."""
    assert length is not None
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("sequence_reverse",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Y": [out]})
    return out


def sequence_expand(x, length=None, ref_length=None, max_out_len=None,
                    name=None):
    """Each row's sequence tiled along time to cover ``ref_length``
    (the attention decoder's broadcast)."""
    assert length is not None and ref_length is not None
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand",
                     inputs={"X": [x], "Length": [length],
                             "RefLength": [ref_length]},
                     outputs={"Out": [out]},
                     attrs={"max_out_len": int(max_out_len or -1)})
    return out


def sequence_expand_as(x, length=None, maxlen=None, y=None, name=None):
    """x ``[B, D]`` → ``[B, maxlen, D]`` masked by length."""
    assert length is not None
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Length": [length]}
    if y is not None:
        inputs["Y"] = [y]
    if x.shape and maxlen:
        out.shape = (x.shape[0], int(maxlen)) + tuple(x.shape[1:])
    helper.append_op("sequence_expand_as", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"maxlen": int(maxlen or -1)})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, length=None, name=None):
    """Flat-compact ``[N, ...]`` plus lengths → (padded ``[B, maxlen,
    ...]``, length), as the reference's sequence_pad returns."""
    assert length is not None and maxlen is not None
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    len_out = helper.create_variable_for_type_inference("int64")
    len_out.stop_gradient = True
    inputs = {"X": [x], "Length": [length]}
    if pad_value is not None:
        inputs["PadValue"] = [pad_value]
    helper.append_op("sequence_pad", inputs=inputs,
                     outputs={"Out": [out], "Length": [len_out]},
                     attrs={"padded_length": int(maxlen)})
    return out, len_out


def sequence_unpad(x, length=None, name=None):
    """Padded ``[B, T, ...]`` → flat-compact ``[B·T, ...]`` (zeros
    after the valid rows)."""
    assert length is not None
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape:
        flat = (x.shape[0] * x.shape[1]
                if x.shape[0] > 0 and x.shape[1] > 0 else -1)
        out.shape = (flat,) + tuple(x.shape[2:])
    helper.append_op("sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, length=None, name=None):
    """Per-row concatenation along time; returns (Out, OutLength)."""
    assert length is not None and len(input) == len(length)
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    out_len = helper.create_variable_for_type_inference("int64")
    out_len.stop_gradient = True
    helper.append_op("sequence_concat",
                     inputs={"X": list(input), "Length": list(length)},
                     outputs={"Out": [out], "OutLength": [out_len]})
    return out, out_len


def sequence_slice(input, offset, length, name=None):
    """Per row the steps ``[offset, offset + length)``, packed to the
    front."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    """Windows of ``win_size`` ids at every step, ``pad_value`` past the
    row's length: ``[B, T, win_size]``."""
    assert length is not None
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        out.shape = tuple(input.shape[:2]) + (int(win_size),)
    helper.append_op("sequence_enumerate",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out]},
                     attrs={"win_size": int(win_size),
                            "pad_value": int(pad_value)})
    return out
