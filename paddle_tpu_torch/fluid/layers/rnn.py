"""Recurrent, structured-prediction and generation layers (counterpart
paddle_tpu/fluid/layers/rnn.py; reference ``python/paddle/fluid/layers/
nn.py``): ``fused_attention``, ``switch_moe``, the book models'
``dynamic_lstm``, ``linear_chain_crf``, ``crf_decoding``, ``cos_sim``,
``nce``, ``beam_search`` and ``beam_search_decode``, and ``dynamic_gru``
and ``hsigmoid``.  Every sequence layer takes
an explicit ``length`` Variable ``[batch]`` over padded ``[batch, time,
...]`` data, in place of the reference's LoD."""

from ..layer_helper import LayerHelper


def dynamic_lstm(input, size, length=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=True,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None):
    """LSTM over a pre-projected input [B, T, 4*D]; size = 4*D.

    Returns (hidden, cell), both [B, T, D].
    """
    assert length is not None, \
        "dynamic_lstm needs an explicit length tensor (no LoD)"
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    D = size // 4
    weight = helper.create_parameter(helper.param_attr, [D, 4 * D], dtype)
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(helper.bias_attr, bias_size, dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    if input.shape:
        hidden.shape = tuple(input.shape[:2]) + (D,)
        cell.shape = hidden.shape
    inputs = {"Input": [input], "Weight": [weight], "Length": [length]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op("lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, length=None, h_0=None, param_attr=None,
                bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", origin_mode=False,
                dtype="float32", name=None):
    """GRU over a pre-projected input [B, T, 3*D]; size = D.

    Returns hidden [B, T, D].
    """
    assert length is not None, \
        "dynamic_gru needs an explicit length tensor (no LoD)"
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    D = size
    weight = helper.create_parameter(helper.param_attr, [D, 3 * D], dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, 3 * D], dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    if input.shape:
        hidden.shape = tuple(input.shape[:2]) + (D,)
    inputs = {"Input": [input], "Weight": [weight], "Length": [length]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op("gru", inputs=inputs, outputs={"Hidden": [hidden]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation,
                            "origin_mode": origin_mode})
    return hidden


def linear_chain_crf(input, label, length=None, param_attr=None):
    """CRF negative log-likelihood; input [B, T, C], label [B, T] int.

    The transition parameter is [C+2, C] (row 0 start, row 1 stop), the
    reference's exact layout, so a trained ``crfw`` feeds crf_decoding.
    """
    assert length is not None, \
        "linear_chain_crf needs an explicit length tensor (no LoD)"
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         [num_tags + 2, num_tags],
                                         input.dtype)
    nll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    nll.shape = (input.shape[0], 1)
    helper.append_op("linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label], "Length": [length]},
                     outputs={"LogLikelihood": [nll], "Alpha": [alpha]})
    return nll


def crf_decoding(input, length=None, param_attr=None, label=None):
    """Viterbi decode; returns [B, T, 1] int64 path (or 0/1 correctness
    indicators when ``label`` is given, the chunk_eval contract)."""
    assert length is not None
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         [num_tags + 2, num_tags],
                                         input.dtype)
    path = helper.create_variable_for_type_inference("int64",
                                                     stop_gradient=True)
    path.shape = tuple(input.shape[:2]) + (1,)
    inputs = {"Emission": [input], "Transition": [transition],
              "Length": [length]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    if X.shape:
        out.shape = tuple(X.shape[:-1]) + (1,)
    helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """NCE loss layer (reference nn.py nce → nce op); returns [B, 1] cost."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = input.shape[-1]
    weight = helper.create_parameter(helper.param_attr,
                                     [num_total_classes, dim], input.dtype)
    bias = helper.create_parameter(helper.bias_attr,
                                   [num_total_classes, 1], input.dtype,
                                   is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64",
                                                              stop_gradient=True)
    cost.shape = (input.shape[0], 1)
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    inputs = {"Input": [input], "Label": [label], "Weight": [weight]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    if custom_dist is not None:
        inputs["CustomDistProbs"] = [custom_dist]
        sampler_id = 2
    helper.append_op("nce", inputs=inputs,
                     outputs={"Cost": [cost],
                              "SampleLogits": [sample_logits],
                              "SampleLabels": [sample_labels]},
                     attrs={"num_total_classes": int(num_total_classes),
                            "num_neg_samples": int(num_neg_samples or 10),
                            "sampler": sampler_id, "seed": seed,
                            "is_sparse": is_sparse,
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None,
             is_custom=False, is_sparse=False):
    """Hierarchical sigmoid; returns [B, 1].  The default tree has
    ``num_classes − 1`` nodes; a custom one (``is_custom``) takes
    ``num_classes`` rows and the caller's PathTable/PathCode."""
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    if is_custom:
        assert path_table is not None and path_code is not None
        num_nodes = num_classes
    else:
        num_nodes = num_classes - 1
    weight = helper.create_parameter(helper.param_attr, [num_nodes, dim],
                                     input.dtype)
    bias = helper.create_parameter(helper.bias_attr, [1, num_nodes],
                                   input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (input.shape[0], 1)
    inputs = {"X": [input], "Label": [label], "W": [weight]}
    if bias is not None:
        inputs["Bias"] = [bias]
    if path_table is not None:
        inputs["PathTable"] = [path_table]
        inputs["PathCode"] = [path_code]
    helper.append_op("hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out], "PreOut": [pre_out]},
                     attrs={"num_classes": int(num_classes),
                            "is_sparse": is_sparse})
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None):
    """One beam-search step on static [B, K] beams.

    ``ids``/``scores``: [B, K, C] per-beam candidate ids and *accumulated*
    log-probs (typically from topk over log-softmax + pre_scores).
    Returns (selected_ids, selected_scores, parent_idx), all [B, beam_size].
    """
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    parent = helper.create_variable_for_type_inference("int64",
                                                       stop_gradient=True)
    if scores.shape:
        sel_ids.shape = (scores.shape[0], int(beam_size))
        sel_scores.shape = sel_ids.shape
        parent.shape = sel_ids.shape
    helper.append_op("beam_search",
                     inputs={"pre_ids": [pre_ids],
                             "pre_scores": [pre_scores],
                             "ids": [ids], "scores": [scores]},
                     outputs={"selected_ids": [sel_ids],
                              "selected_scores": [sel_scores],
                              "parent_idx": [parent]},
                     attrs={"beam_size": int(beam_size),
                            "end_id": int(end_id), "level": int(level),
                            "is_accumulated": bool(is_accumulated)})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id,
                       name=None):
    """Backtrack stacked per-step beams [T, B, K] into sentences.

    Returns (sentence_ids [B, K, T], sentence_scores [B, K]).
    """
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference("int64",
                                                         stop_gradient=True)
    sent_scores = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "Scores": [scores],
                             "ParentIdx": [parent_idx]},
                     outputs={"SentenceIds": [sent_ids],
                              "SentenceScores": [sent_scores]},
                     attrs={"beam_size": int(beam_size),
                            "end_id": int(end_id)})
    return sent_ids, sent_scores



def fused_attention(q, k, v, attn_bias=None, scale=1.0, causal=False,
                    dropout_prob=0.0, is_test=False, name=None):
    """Fused attention core (ops/attention_ops.py flash-attention kernel):
    q [B, H, S_q, D], k/v [B, H, S_kv, D] (cross-attention supported),
    optional additive bias [B, 1|H, S_q, S_kv].
    ``causal=True`` applies the decoder triangular mask inside the kernel
    (static block indices — no [S, S] mask tensor).  ``dropout_prob``
    applies upscale_in_train dropout to the attention probabilities
    (clone(for_test=True) flips ``is_test`` and disables it; the
    train-mode route is not ported yet)."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    out.shape = q.shape
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["BiasQK"] = [attn_bias]
    helper.append_op("fused_attention", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale),
                            "causal": bool(causal),
                            "attn_dropout": float(dropout_prob),
                            "is_test": bool(is_test),
                            "__op_seed__":
                                helper.main_program.next_op_seed()})
    return out


def switch_moe(x, num_experts, ffn_dim, capacity_factor=1.25, act="relu",
               param_attr=None, with_aux_loss=True, name=None):
    """Switch-routed mixture-of-experts FFN block (ops/moe_ops.py; JAX
    layers/rnn.py:299).

    x [..., D] → (out [..., D], aux_loss [1]) — ``aux_loss`` is the
    switch load-balance term (add a small multiple to the training
    loss), or None when ``with_aux_loss=False``.  Beyond-reference
    feature (the reference predates MoE); expert-parallel execution via
    ``fluid.transpiler.ExpertParallelTranspiler`` or fleet
    ``DistributedStrategy(ep_degree=N)``.
    """
    helper = LayerHelper("switch_moe", param_attr=param_attr, name=name)
    D = int(x.shape[-1])
    E, F = int(num_experts), int(ffn_dim)

    if param_attr is False:
        raise ValueError("switch_moe requires parameters; param_attr=False "
                         "is not supported")

    def attr_for(suffix):
        # three distinct parameters: a user-supplied NAMED ParamAttr must
        # not collapse them onto one variable, so suffix a COPY's name
        # (copy.copy keeps subclass fields like WeightNormParamAttr.dim;
        # rebuilding via ParamAttr(**__dict__) would TypeError on them)
        import copy
        from ..param_attr import ParamAttr
        attr = copy.copy(ParamAttr._to_attr(param_attr))
        if getattr(attr, "name", None):
            attr.name = attr.name + "." + suffix
        return attr

    router_w = helper.create_parameter(attr_for("router"), [D, E], x.dtype)
    w1 = helper.create_parameter(attr_for("w1"), [E, D, F], x.dtype)
    w2 = helper.create_parameter(attr_for("w2"), [E, F, D], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    outputs = {"Out": [out]}
    aux = None
    if with_aux_loss:
        aux = helper.create_variable_for_type_inference("float32")
        aux.shape = (1,)
        outputs["AuxLoss"] = [aux]
    helper.append_op("switch_moe",
                     inputs={"X": [x], "RouterW": [router_w],
                             "W1": [w1], "W2": [w2]},
                     outputs=outputs,
                     attrs={"capacity_factor": float(capacity_factor),
                            "act": act})
    return out, aux
