"""Layers closing more of the reference's ``layers/nn.py`` (counterpart
paddle_tpu/fluid/layers/nn_extras2.py): the 3-D vision ones
(``conv3d``, ``conv3d_transpose``, ``pool3d``), ``lrn``,
``pad_constant_like``, ``selu``, ``crop``, ``mean_iou``,
``bilinear_tensor_product``, ``teacher_student_sigmoid_loss``,
``continuous_value_model``, ``unfold`` and ``size``; the sequence, RNN
and CTC ones: ``add_position_encoding``, ``ctc_greedy_decoder``,
``edit_distance``, ``warpctc``, ``row_conv``, ``chunk_eval``,
``gru_unit``, ``lstm_unit``, ``dynamic_lstmp``, ``lstm``,
``sequence_reshape``, ``sequence_scatter`` and ``sequence_erase``; the
detection ones: ``roi_pool``, ``psroi_pool``, ``deformable_conv`` and
``deformable_roi_pooling``; and the shape and loss ones: ``sum``,
``shape``, ``pow``, ``unstack``, ``dice_loss``, ``npair_loss``,
``image_resize_short`` and ``autoincreased_step_counter``.  The rest of
the JAX file is ROADMAP item 13c.3b-ii."""

from ..layer_helper import LayerHelper
from .nn_extras import _simple

__all__ = [
    "conv3d", "conv3d_transpose", "pool3d", "lrn", "pad_constant_like",
    "selu", "crop", "mean_iou", "bilinear_tensor_product",
    "teacher_student_sigmoid_loss", "continuous_value_model", "unfold",
    "size",
    "add_position_encoding", "ctc_greedy_decoder", "edit_distance",
    "warpctc", "row_conv", "chunk_eval", "gru_unit", "lstm_unit",
    "dynamic_lstmp", "lstm", "sequence_reshape", "sequence_scatter",
    "sequence_erase", "roi_pool", "psroi_pool", "deformable_conv",
    "deformable_roi_pooling", "sum", "shape", "pow", "unstack",
    "dice_loss", "npair_loss", "image_resize_short",
    "autoincreased_step_counter",
]


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """NCDHW convolution by ``[num_filters, C/groups, kd, kh, kw]``
    weights, then a bias a channel (unless ``bias_attr`` is False) and
    ``act``."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    C = int(input.shape[1])
    k = _triple(filter_size)
    w = helper.create_parameter(helper.param_attr,
                                [num_filters, C // groups] + k,
                                input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation),
                            "groups": groups})
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_filters],
                                    input.dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": 1})
        out = out2
    return helper.append_activation(out, act)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """The transposed NCDHW convolution by ``[C, num_filters, kd, kh,
    kw]`` weights, then ``act``; no bias, as in the JAX layer."""
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    C = int(input.shape[1])
    k = _triple(filter_size)
    w = helper.create_parameter(helper.param_attr,
                                [C, num_filters] + k, input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding)})
    return helper.append_activation(out, act)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None):
    return _simple("pool3d", {"X": [input]},
                   {"pooling_type": pool_type,
                    "ksize": _triple(pool_size),
                    "strides": _triple(pool_stride),
                    "paddings": _triple(pool_padding),
                    "global_pooling": global_pooling})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalisation across channels (the layer's k is
    1.0, the op's default 2.0)."""
    return _simple("lrn", {"X": [input]},
                   {"n": n, "k": k, "alpha": alpha, "beta": beta},
                   extra_outputs=("MidOut",), shape_of=input)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": [x], "Y": [y]},
                   {"pad_value": pad_value}, shape_of=x)


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _simple("selu", {"X": [x]}, attrs, shape_of=x)


def crop(x, shape=None, offsets=None, name=None):
    return _simple("crop", {"X": [x]},
                   {"shape": list(shape), "offsets": list(offsets or
                                                          [0] * len(shape))})


def mean_iou(input, label, num_classes):
    """(mean IoU float32, wrong int32 ``[C]``, correct int32 ``[C]``)."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    wrong = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    correct = helper.create_variable_for_type_inference("int32",
                                                        stop_gradient=True)
    helper.append_op("mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": int(num_classes)})
    return miou, wrong, correct


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """``out[b, s] = x[b]·W[s]·y[b] + bias[s]`` with W ``[size, M, N]``."""
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        helper.param_attr, [size, int(x.shape[-1]), int(y.shape[-1])],
        x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [1, size], x.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """The bounds are not read, as in the JAX layer."""
    return _simple("teacher_student_sigmoid_loss",
                   {"X": [input], "Label": [label]}, outs=("Y",))


def continuous_value_model(input, cvm, use_cvm=True):
    return _simple("cvm", {"X": [input], "CVM": [cvm]},
                   {"use_cvm": use_cvm}, outs=("Y",))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """``[N, C·kh·kw, L]`` sliding blocks; ``paddings`` one int, ``[h,
    w]`` or ``[top, left, bottom, right]``."""
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]
    pads = _pair(paddings)
    if len(pads) == 2:
        pads = pads + pads
    return _simple("unfold", {"X": [x]},
                   {"kernel_sizes": _pair(kernel_sizes),
                    "strides": _pair(strides), "paddings": pads,
                    "dilations": _pair(dilations)}, outs=("Y",))


def size(input):
    return _simple("size", {"Input": [input]}, dtype="int64")


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """``alpha·input + beta·pe``, the reference's sinusoid table."""
    return _simple("add_position_encoding", {"X": [input]},
                   {"alpha": alpha, "beta": beta}, shape_of=input)


def ctc_greedy_decoder(input, blank, length=None, name=None):
    """The argmax of every step, then the CTC collapse (``top_k`` and
    ``ctc_align``, as the reference composes them); input ``[B, T, C]``
    with its length.  Returns (ids ``[B, T]`` packed to the front, their
    count)."""
    from . import nn as nn_layers
    assert length is not None
    ids = nn_layers.topk(input, 1)[1]
    ids = nn_layers.squeeze(ids, [-1])
    helper = LayerHelper("ctc_align")
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    oln = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("ctc_align",
                     inputs={"Input": [ids], "Length": [length]},
                     outputs={"Output": [out], "OutputLength": [oln]},
                     attrs={"blank": int(blank)})
    return out, oln


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """The Levenshtein distance of each row of ``input`` to ``label``
    over their lengths; returns (distances ``[B, 1]``, sequence
    count)."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    seq_num = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op("edit_distance",
                     inputs={"Hyps": [input], "Refs": [label],
                             "HypsLength": [input_length],
                             "RefsLength": [label_length]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """The CTC loss of logits ``[B, T, C]`` against padded labels
    ``[B, L]``; returns ``[B, 1]``."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        loss.shape = (input.shape[0], 1)
    helper.append_op("warpctc",
                     inputs={"Logits": [input], "Label": [label],
                             "LogitsLength": [input_length],
                             "LabelLength": [label_length]},
                     outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
                     attrs={"blank": int(blank),
                            "norm_by_times": norm_by_times})
    return loss


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution over ``future_context_size + 1`` steps."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    D = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                [future_context_size + 1, D], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


def chunk_eval(input, label, chunk_scheme, num_chunk_types, length=None,
               excluded_chunk_types=None):
    """(precision, recall, F1, inferred, labelled and correct chunk
    counts) of tag rows under ``chunk_scheme``."""
    helper = LayerHelper("chunk_eval")
    outs = {}
    for slot, dtype in (("Precision", "float32"), ("Recall", "float32"),
                        ("F1-Score", "float32"),
                        ("NumInferChunks", "int64"),
                        ("NumLabelChunks", "int64"),
                        ("NumCorrectChunks", "int64")):
        outs[slot] = [helper.create_variable_for_type_inference(
            dtype, stop_gradient=True)]
    helper.append_op("chunk_eval",
                     inputs={"Inference": [input], "Label": [label],
                             "Length": [length]},
                     outputs=outs,
                     attrs={"chunk_scheme": chunk_scheme,
                            "num_chunk_types": int(num_chunk_types)})
    return (outs["Precision"][0], outs["Recall"][0], outs["F1-Score"][0],
            outs["NumInferChunks"][0], outs["NumLabelChunks"][0],
            outs["NumCorrectChunks"][0])


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step; ``size`` is 3D.  Returns (hidden, reset hidden,
    gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    D = size // 3
    w = helper.create_parameter(helper.param_attr, [D, 3 * D], input.dtype)
    b = helper.create_parameter(helper.bias_attr, [1, 3 * D], input.dtype,
                                is_bias=True)
    out_h = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Hidden": [out_h], "Gate": [gate],
                              "ResetHiddenPrev": [reset]},
                     attrs={"origin_mode": origin_mode})
    return out_h, reset, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """``fc([x, h])`` then one ``lstm_unit`` step; returns (h, c)."""
    from . import nn as nn_layers
    from .tensor import concat
    D = int(cell_t_prev.shape[-1])
    gates = nn_layers.fc(concat([x_t, hidden_t_prev], axis=-1),
                         size=4 * D, param_attr=param_attr,
                         bias_attr=bias_attr)
    helper = LayerHelper("lstm_unit")
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def dynamic_lstmp(input, size, proj_size, length=None, param_attr=None,
                  bias_attr=None, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="identity",
                  dtype="float32", name=None):
    """The LSTM with a projection over a pre-projected input ``[B, T,
    4D]`` (``size`` = 4D); returns (projection ``[B, T, P]``, cell)."""
    assert length is not None
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = size // 4
    w = helper.create_parameter(helper.param_attr, [proj_size, 4 * D],
                                dtype)
    proj_w = helper.create_parameter(None, [D, proj_size], dtype)
    b = helper.create_parameter(helper.bias_attr, [1, 4 * D], dtype,
                                is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    if input.shape:
        proj.shape = tuple(input.shape[:2]) + (proj_size,)
        cell.shape = tuple(input.shape[:2]) + (D,)
    inputs = {"Input": [input], "Weight": [w], "ProjWeight": [proj_w],
              "Length": [length]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op("lstmp", inputs=inputs,
                     outputs={"Projection": [proj], "Cell": [cell]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return proj, cell


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         length=None, dropout_prob=0.0, is_bidirec=False, name=None):
    """The reference's cuDNN-style stacked LSTM, composed as the JAX
    layer composes it (nn_extras2.py:521): per layer an ``fc`` to 4H and
    a ``dynamic_lstm`` (and a reversed pair, concatenated, when
    ``is_bidirec``), dropout between layers.  ``init_h``/``init_c`` are
    not read.  Returns (out, last step, last step)."""
    from . import nn as nn_layers
    from . import sequence as seq_layers
    from .rnn import dynamic_lstm
    from .tensor import concat
    assert length is not None
    h = input
    for _ in range(num_layers):
        proj = nn_layers.fc(h, size=4 * hidden_size, num_flatten_dims=2)
        fwd, _ = dynamic_lstm(proj, 4 * hidden_size, length=length)
        if is_bidirec:
            proj_b = nn_layers.fc(h, size=4 * hidden_size,
                                  num_flatten_dims=2)
            bwd, _ = dynamic_lstm(proj_b, 4 * hidden_size, length=length,
                                  is_reverse=True)
            h = concat([fwd, bwd], axis=-1)
        else:
            h = fwd
        if dropout_prob:
            h = nn_layers.dropout(h, dropout_prob)
    last = seq_layers.sequence_last_step(h, length=length)
    return h, last, last


def sequence_reshape(input, new_dim, length=None):
    """``[B, T, D]`` → ``[B, T·D / new_dim, new_dim]``."""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    oln = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("sequence_reshape",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out], "OutLength": [oln]},
                     attrs={"new_dim": int(new_dim)})
    return out


def sequence_scatter(input, index, updates, length=None, name=None):
    """``input`` ``[B, D]`` with each row's valid ``updates`` added at
    ``index``."""
    return _simple("sequence_scatter",
                   {"X": [input], "Ids": [index], "Updates": [updates],
                    "Length": [length]}, shape_of=input)


def sequence_erase(input, tokens, length=None, name=None):
    """Each row with the ids in ``tokens`` removed, the rest shifted
    left."""
    helper = LayerHelper("sequence_erase")
    out = helper.create_variable_for_type_inference(input.dtype)
    oln = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("sequence_erase",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out], "OutLength": [oln]},
                     attrs={"tokens": list(tokens)})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_id=None):
    helper = LayerHelper("roi_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    helper.append_op("roi_pool", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch_id=None, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    helper.append_op("psroi_pool", inputs=inputs, outputs={"Out": [out]},
                     attrs={"output_channels": int(output_channels),
                            "spatial_scale": spatial_scale,
                            "pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width)})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, name=None):
    """Modulated deformable convolution (ops/detection_ops3.py)."""
    helper = LayerHelper("deformable_conv", name=name)
    dtype = input.dtype
    C = int(input.shape[1])
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    w = helper.create_parameter(
        param_attr, [num_filters, C // groups, k[0], k[1]], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if mask is not None:
        inputs["Mask"] = [mask]
    two = (lambda v: list(v) if isinstance(v, (list, tuple)) else [v, v])
    helper.append_op("deformable_conv", inputs=inputs,
                     outputs={"Output": [out]},
                     attrs={"strides": two(stride),
                            "paddings": two(padding),
                            "dilations": two(dilation),
                            "groups": int(groups),
                            "deformable_groups": int(deformable_groups),
                            "im2col_step": int(im2col_step)})
    if bias_attr:
        b = helper.create_parameter(bias_attr, [num_filters], dtype,
                                    is_bias=True)
        out2 = helper.create_variable_for_type_inference(dtype)
        helper.append_op("elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": 1})
        out = out2
    return out


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1,),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """Deformable (PS-)ROI pooling (ops/detection_ops3.py
    deformable_psroi_pooling)."""
    helper = LayerHelper("deformable_roi_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    top = helper.create_variable_for_type_inference("float32")
    inputs = {"Input": [input], "ROIs": [rois]}
    if trans is not None and not no_trans:
        inputs["Trans"] = [trans]
    # reference nn.py deformable_roi_pooling: position-sensitive output
    # channels = C / pooled_height / pooled_width
    out_dim = int(input.shape[1]) if not position_sensitive else \
        int(input.shape[1]) // (int(pooled_height) * int(pooled_width))
    helper.append_op(
        "deformable_psroi_pooling", inputs=inputs,
        outputs={"Output": [out], "TopCount": [top]},
        attrs={"no_trans": bool(no_trans),
               "spatial_scale": float(spatial_scale),
               "output_dim": out_dim,
               "group_size": [int(g) for g in group_size],
               "pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "part_size": [int(p) for p in
                             (part_size or (pooled_height, pooled_width))],
               "sample_per_part": int(sample_per_part),
               "trans_std": float(trans_std)})
    return out


def sum(x):
    """The sum of the list ``x`` (or of ``x`` alone): one ``sum`` op (JAX
    nn_extras2.py:330)."""
    from . import tensor as tensor_layers
    return tensor_layers.sums(x if isinstance(x, (list, tuple)) else [x])


def shape(input):
    """``input``'s shape as an int32 tensor (JAX nn_extras2.py:335)."""
    return _simple("shape", {"Input": [input]}, dtype="int32")


def pow(x, factor=1.0, name=None):
    """``x ** factor`` (JAX nn_extras2.py:629)."""
    return _simple("pow", {"X": [x]}, {"factor": factor}, shape_of=x)


def unstack(x, axis=0, num=None):
    """The slices of ``x`` along ``axis``, that axis dropped (JAX
    nn_extras2.py:347)."""
    helper = LayerHelper("unstack")
    if num is None:
        num = int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def dice_loss(input, label, epsilon=1e-5):
    """``1 - 2 |X∩Y| / (|X| + |Y| + epsilon)`` over the whole batch,
    composed as the JAX layer composes it (nn_extras2.py:358)."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers
    label_f = tensor_layers.cast(label, input.dtype)
    inter = nn_layers.reduce_sum(nn_layers.elementwise_mul(input, label_f))
    union = nn_layers.elementwise_add(nn_layers.reduce_sum(input),
                                      nn_layers.reduce_sum(label_f))
    two_inter = nn_layers.scale(inter, 2.0)
    denom = nn_layers.scale(union, 1.0, bias=epsilon)
    ratio = nn_layers.elementwise_div(two_inter, denom)
    return nn_layers.scale(ratio, -1.0, bias=1.0)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The N-pair loss (JAX nn_extras2.py:372): soft-label cross entropy
    of ``softmax(anchor positiveᵀ)`` against the row-normalized
    same-label matrix, plus ``l2_reg / 4`` times the mean squared norms
    of both embeddings."""
    from . import nn as nn_layers
    from . import ops as op_layers
    from . import tensor as tensor_layers
    sim = nn_layers.matmul(anchor, positive, transpose_y=True)
    prob = nn_layers.softmax(sim)
    lab = nn_layers.reshape(labels, [-1, 1])
    labf = tensor_layers.cast(lab, anchor.dtype)
    diff = nn_layers.elementwise_sub(
        labf, nn_layers.transpose(labf, [1, 0]))
    # 1 where the labels are equal: 1 - sign(|li - lj|)
    eq_f = nn_layers.scale(op_layers.sign(op_layers.abs(diff)), -1.0,
                           bias=1.0)
    row_sum = nn_layers.reduce_sum(eq_f, dim=1, keep_dim=True)
    targets = nn_layers.elementwise_div(eq_f, row_sum)
    ce = nn_layers.cross_entropy(prob, targets, soft_label=True)
    loss_ce = nn_layers.reduce_mean(ce)
    l2 = nn_layers.scale(
        nn_layers.elementwise_add(
            nn_layers.reduce_mean(nn_layers.reduce_sum(
                nn_layers.elementwise_mul(anchor, anchor), dim=1)),
            nn_layers.reduce_mean(nn_layers.reduce_sum(
                nn_layers.elementwise_mul(positive, positive), dim=1))),
        l2_reg * 0.25)
    return nn_layers.elementwise_add(loss_ce, l2)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """``input`` resized so that its shorter side is ``out_short_len``,
    the aspect kept (JAX nn_extras2.py:417)."""
    from .detection import image_resize
    H, W = int(input.shape[2]), int(input.shape[3])
    short = min(H, W)
    out_shape = [int(H * out_short_len / short),
                 int(W * out_short_len / short)]
    return image_resize(input, out_shape=out_shape, resample=resample)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 ``(1,)`` counter that reads ``begin`` on the
    first run and grows by ``step`` a run (JAX nn_extras2.py:547): the
    startup sets ``begin - step``, one in-place ``increment`` a run."""
    from . import control_flow as cf
    from ..initializer import ConstantInitializer
    from .. import unique_name
    helper = LayerHelper("step_counter")
    counter = helper.create_or_get_global_variable(
        name=counter_name or unique_name.generate("@STEP_COUNTER@"),
        dtype="int64", shape=(1,), persistable=True)
    counter.stop_gradient = True
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin - step)))
    cf.increment(counter, value=float(step), in_place=True)
    return counter
