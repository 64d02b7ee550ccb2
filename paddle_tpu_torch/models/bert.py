"""BERT-base (counterpart paddle_tpu/models/bert.py): the configs, the
encoder the port serves, and the pretraining heads and program it
trains (MLM + NSP losses, Adam), with the same ops and names as the JAX
package.

Reference shape: the Paddle LARK/ERNIE BERT program construction (the
reference repo itself ships the transformer machinery it uses in
unittests/dist_transformer.py); architecture is standard post-LN BERT
(Devlin et al.): token+position+segment embeddings → N encoder layers
(self-attention + FFN, gelu) → MLM + NSP heads.

Fixed max_seq_len (bucketed padding replaces the reference's LoD ragged
batching); the attention mask enters as an additive bias broadcast over
heads, which the fused path reads through a stride-0 head dimension.
"""

import math

from .. import fluid


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=None, max_position=512,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 max_seq_len=128, use_fused_attention=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size or hidden_size * 4
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.max_seq_len = max_seq_len
        # flash-attention core (ops/attention_ops.py, the Hopper kernel
        # on the card); False builds the matmul/softmax composition
        self.use_fused_attention = use_fused_attention


def base_config(**kw):
    return BertConfig(**kw)


def tiny_config(**kw):
    """Small config for tests/dryruns."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("max_position", 64)
    return BertConfig(**kw)


def _param(name_hint, init_range=0.02):
    return fluid.ParamAttr(
        initializer=fluid.initializer.TruncatedNormal(scale=init_range))


def _causal_bias_cached(S_q, S_k):
    """Additive [1, 1, S_q, S_k] triangular -1e4 mask, built ONCE per
    program per shape (stacked decoder layers share it)."""
    import numpy as np

    if not S_q or S_q < 0 or not S_k or S_k < 0:
        raise ValueError(
            "causal=True on the composed attention path needs static "
            "sequence lengths; pass an explicit causal attn_bias instead")
    program = fluid.default_main_program()
    cache = getattr(program, "_causal_bias_cache", None)
    if cache is None:
        cache = program._causal_bias_cache = {}
    key = (int(S_q), int(S_k))
    if key not in cache:
        tri = np.triu(np.full(key, -1e4, dtype=np.float32), k=1)
        bias = fluid.layers.assign(tri.reshape(1, 1, key[0], key[1]))
        bias.stop_gradient = True
        cache[key] = bias
    return cache[key]


def multi_head_attention(q_in, kv_in, attn_bias, cfg, cache=None,
                         causal=False):
    """Standard MHA; ``q_in``/``kv_in`` are [B, S, H]; ``attn_bias`` is an
    additive float mask [B, 1, S_q, S_kv] (0 keep, -1e4 drop).
    ``causal=True`` applies the decoder triangular mask — in-kernel on the
    fused path (no [S, S] mask tensor), via an additive bias otherwise."""
    h, n_head = cfg.hidden_size, cfg.num_heads
    d_head = h // n_head

    q = fluid.layers.fc(q_in, h, num_flatten_dims=2, param_attr=_param("q"))
    k = fluid.layers.fc(kv_in, h, num_flatten_dims=2, param_attr=_param("k"))
    v = fluid.layers.fc(kv_in, h, num_flatten_dims=2, param_attr=_param("v"))

    def heads(x, S):
        # [B, S, H] -> [B, n_head, S, d_head]; keep S static when known
        # so stacked layers (decoder self-attention) retain shapes
        S_dim = int(S) if S and S > 0 else -1
        x = fluid.layers.reshape(x, [0, S_dim, n_head, d_head])
        return fluid.layers.transpose(x, [0, 2, 1, 3])

    S_q_in = q_in.shape[1] if q_in.shape else None
    S_kv_in = kv_in.shape[1] if kv_in.shape else None
    q, k, v = heads(q, S_q_in), heads(k, S_kv_in), heads(v, S_kv_in)
    if getattr(cfg, "use_fused_attention", False):
        # flash-attention (ops/attention_ops.py): no [S, S] score
        # matrix in device memory; same math as the composition below
        ctxs = fluid.layers.fused_attention(
            q, k, v, attn_bias, scale=1.0 / math.sqrt(d_head),
            causal=causal, dropout_prob=float(cfg.attn_dropout or 0.0))
    else:
        scores = fluid.layers.matmul(q, k, transpose_y=True,
                                     alpha=1.0 / math.sqrt(d_head))
        if attn_bias is not None:
            scores = scores + attn_bias
        if causal:
            scores = scores + _causal_bias_cached(S_q_in, S_kv_in)
        weights = fluid.layers.softmax(scores)
        if cfg.attn_dropout:
            weights = fluid.layers.dropout(
                weights, cfg.attn_dropout,
                dropout_implementation="upscale_in_train")
        ctxs = fluid.layers.matmul(weights, v)
    ctxs = fluid.layers.transpose(ctxs, [0, 2, 1, 3])
    ctxs = fluid.layers.reshape(
        ctxs, [0, int(S_q_in) if S_q_in and S_q_in > 0 else -1, h])
    return fluid.layers.fc(ctxs, h, num_flatten_dims=2, param_attr=_param("o"))


def _post_ln(x, residual, dropout):
    if dropout:
        x = fluid.layers.dropout(x, dropout,
                                 dropout_implementation="upscale_in_train")
    return fluid.layers.layer_norm(x + residual, begin_norm_axis=2)


def encoder_layer(x, attn_bias, cfg):
    attn = multi_head_attention(x, x, attn_bias, cfg)
    x = _post_ln(attn, x, cfg.hidden_dropout)
    ffn = fluid.layers.fc(x, cfg.ffn_size, num_flatten_dims=2, act="gelu",
                          param_attr=_param("ffn1"))
    ffn = fluid.layers.fc(ffn, cfg.hidden_size, num_flatten_dims=2,
                          param_attr=_param("ffn2"))
    return _post_ln(ffn, x, cfg.hidden_dropout)


def bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg):
    """Returns [B, S, H] sequence output.  ``input_mask`` is float [B, S, 1]."""
    emb = fluid.layers.embedding(
        src_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=fluid.ParamAttr(name="word_embedding",
                                   initializer=fluid.initializer.TruncatedNormal(scale=0.02)))
    pos = fluid.layers.embedding(
        pos_ids, size=[cfg.max_position, cfg.hidden_size],
        param_attr=_param("pos"))
    sent = fluid.layers.embedding(
        sent_ids, size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=_param("sent"))
    x = emb + pos + sent
    x = fluid.layers.layer_norm(x, begin_norm_axis=2)
    if cfg.hidden_dropout:
        x = fluid.layers.dropout(x, cfg.hidden_dropout,
                                 dropout_implementation="upscale_in_train")

    # [B, S, 1] x [B, 1, S] -> [B, S, S] pairwise keep-mask, then additive
    # bias broadcast over heads as [B, 1, S, S].
    mask2d = fluid.layers.matmul(input_mask, input_mask, transpose_y=True)
    attn_bias = fluid.layers.scale(mask2d, scale=1e4, bias=-1.0,
                                   bias_after_scale=False)
    attn_bias = fluid.layers.unsqueeze(attn_bias, [1])
    attn_bias.stop_gradient = True

    for _ in range(cfg.num_layers):
        x = encoder_layer(x, attn_bias, cfg)
    return x


def pretrain_heads(enc_out, mask_pos, cfg):
    """MLM logits over masked positions + NSP logits over pooled [CLS].

    ``mask_pos`` is int32 [B*max_pred, 1]: flat indices into the [B*S, H]
    reshaped sequence output (the reference BERT uses the same flat-gather
    trick to keep shapes static).
    """
    h = cfg.hidden_size
    flat = fluid.layers.reshape(enc_out, [-1, h])
    masked = fluid.layers.gather(flat, fluid.layers.reshape(mask_pos, [-1]))
    masked = fluid.layers.fc(masked, h, act="gelu", param_attr=_param("mlm"))
    masked = fluid.layers.layer_norm(masked)
    # decode with the tied word embedding: [P, H] x [V, H]^T
    word_emb = fluid.default_main_program().global_block().var("word_embedding")
    mlm_logits = fluid.layers.matmul(masked, word_emb, transpose_y=True)

    first_tok = fluid.layers.slice(enc_out, axes=[1], starts=[0], ends=[1])
    pooled = fluid.layers.fc(fluid.layers.reshape(first_tok, [-1, h]),
                             h, act="tanh", param_attr=_param("pool"))
    nsp_logits = fluid.layers.fc(pooled, 2, param_attr=_param("nsp"))
    return mlm_logits, nsp_logits


def build_pretrain(cfg=None, lr=1e-4, max_pred_per_seq=20, optimizer=None):
    """Full BERT pretraining program: encoder + MLM + NSP + Adam (or a
    caller-supplied ``optimizer`` — e.g. RecomputeOptimizer/DGC wrappers;
    it must expose ``minimize``)."""
    cfg = cfg or base_config()
    S = cfg.max_seq_len
    src_ids = fluid.layers.data(name="src_ids", shape=[S, 1], dtype="int64")
    pos_ids = fluid.layers.data(name="pos_ids", shape=[S, 1], dtype="int64")
    sent_ids = fluid.layers.data(name="sent_ids", shape=[S, 1], dtype="int64")
    input_mask = fluid.layers.data(name="input_mask", shape=[S, 1],
                                   dtype="float32")
    mask_pos = fluid.layers.data(name="mask_pos", shape=[1], dtype="int32")
    mask_label = fluid.layers.data(name="mask_label", shape=[1], dtype="int64")
    nsp_label = fluid.layers.data(name="nsp_label", shape=[1], dtype="int64")

    enc_out = bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg)
    mlm_logits, nsp_logits = pretrain_heads(enc_out, mask_pos, cfg)

    mlm_loss = fluid.layers.softmax_with_cross_entropy(mlm_logits, mask_label)
    nsp_loss = fluid.layers.softmax_with_cross_entropy(nsp_logits, nsp_label)
    loss = fluid.layers.mean(mlm_loss) + fluid.layers.mean(nsp_loss)
    opt = optimizer or fluid.optimizer.AdamOptimizer(learning_rate=lr)
    opt.minimize(loss)
    return {"loss": loss, "mlm_logits": mlm_logits, "nsp_logits": nsp_logits,
            "enc_out": enc_out, "optimizer": opt, "config": cfg}
