"""Transformer NMT (counterpart paddle_tpu/models/transformer.py;
BASELINE.json config 4, "Transformer NMT (variable-length sequences)"):
the encoder-decoder of Vaswani et al. with label smoothing and a
Noam-scheduled Adam, with the same ops and names as the JAX package.

Reference shape: python/paddle/fluid/tests/unittests/dist_transformer.py
(the WMT16 transformer the reference trains in its distributed
loss-parity harness).  Variable length is padding to ``max_len`` with
float keep-masks: a ``[B, 1, 1, S]`` additive pad bias on the encoder's
self-attention and on the cross-attention, and the causal mask of the
decoder's self-attention inside the flash kernels (or an additive
``[1, 1, S, S]`` bias on the composition route).
"""

import math

import numpy as np

from .. import fluid
from .bert import multi_head_attention, _post_ln, _param


class TransformerConfig:
    def __init__(self, src_vocab_size=30000, trg_vocab_size=30000,
                 hidden_size=512, num_layers=6, num_heads=8, ffn_size=2048,
                 max_len=256, dropout=0.1, label_smooth_eps=0.1,
                 use_fused_attention=True):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size
        self.max_len = max_len
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        # reused by bert helpers; attention dropout routes through the
        # fused op's composition path (flash engages when dropout is off)
        self.attn_dropout = dropout
        self.hidden_dropout = dropout
        self.use_fused_attention = use_fused_attention


def base_config(**kw):
    return TransformerConfig(**kw)


def tiny_config(**kw):
    kw.setdefault("src_vocab_size", 256)
    kw.setdefault("trg_vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("ffn_size", 128)
    kw.setdefault("max_len", 16)
    return TransformerConfig(**kw)


def _positional_encoding(seq_len, d_model):
    """Fixed sinusoid table as a numpy constant baked into the program."""
    pos = np.arange(seq_len)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2).astype(np.float64)
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((seq_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def _embed(ids, vocab_size, cfg, emb_name):
    h = cfg.hidden_size
    emb = fluid.layers.embedding(
        ids, size=[vocab_size, h],
        param_attr=fluid.ParamAttr(
            name=emb_name,
            initializer=fluid.initializer.Normal(0.0, h ** -0.5)))
    emb = fluid.layers.scale(emb, scale=math.sqrt(h))
    pe = fluid.layers.assign(_positional_encoding(cfg.max_len, h))
    pe.stop_gradient = True
    x = emb + pe
    if cfg.dropout:
        x = fluid.layers.dropout(x, cfg.dropout,
                                 dropout_implementation="upscale_in_train")
    return x


def _pad_bias(mask):
    """[B, S, 1] keep-mask → additive [B, 1, 1, S] pad bias."""
    m = fluid.layers.transpose(mask, [0, 2, 1])          # [B, 1, S]
    bias = fluid.layers.scale(m, scale=1e4, bias=-1.0, bias_after_scale=False)
    bias = fluid.layers.unsqueeze(bias, [1])             # [B, 1, 1, S]
    bias.stop_gradient = True
    return bias


def encoder(src_ids, src_mask, cfg):
    x = _embed(src_ids, cfg.src_vocab_size, cfg, "src_word_emb")
    bias = _pad_bias(src_mask)
    for _ in range(cfg.num_layers):
        attn = multi_head_attention(x, x, bias, cfg)
        x = _post_ln(attn, x, cfg.dropout)
        ffn = fluid.layers.fc(x, cfg.ffn_size, num_flatten_dims=2, act="relu",
                              param_attr=_param("ffn1"))
        ffn = fluid.layers.fc(ffn, cfg.hidden_size, num_flatten_dims=2,
                              param_attr=_param("ffn2"))
        x = _post_ln(ffn, x, cfg.dropout)
    return x


def decoder(trg_ids, enc_out, src_mask, cfg):
    x = _embed(trg_ids, cfg.trg_vocab_size, cfg, "trg_word_emb")
    # the triangular mask goes in-kernel on the fused-attention path
    # (multi_head_attention(causal=True)): no [S, S] bias tensor
    cross_bias = _pad_bias(src_mask)
    for _ in range(cfg.num_layers):
        attn = multi_head_attention(x, x, None, cfg, causal=True)
        x = _post_ln(attn, x, cfg.dropout)
        cross = multi_head_attention(x, enc_out, cross_bias, cfg)
        x = _post_ln(cross, x, cfg.dropout)
        ffn = fluid.layers.fc(x, cfg.ffn_size, num_flatten_dims=2, act="relu",
                              param_attr=_param("ffn1"))
        ffn = fluid.layers.fc(ffn, cfg.hidden_size, num_flatten_dims=2,
                              param_attr=_param("ffn2"))
        x = _post_ln(ffn, x, cfg.dropout)
    return x


def build_train(cfg=None, lr=2.0, warmup_steps=4000):
    """Training program with label smoothing + Noam LR Adam (reference
    dist_transformer.py uses the same schedule)."""
    cfg = cfg or base_config()
    S = cfg.max_len
    src_ids = fluid.layers.data(name="src_ids", shape=[S, 1], dtype="int64")
    src_mask = fluid.layers.data(name="src_mask", shape=[S, 1],
                                 dtype="float32")
    trg_ids = fluid.layers.data(name="trg_ids", shape=[S, 1], dtype="int64")
    trg_mask = fluid.layers.data(name="trg_mask", shape=[S, 1],
                                 dtype="float32")
    label = fluid.layers.data(name="label", shape=[S, 1], dtype="int64")

    enc_out = encoder(src_ids, src_mask, cfg)
    dec_out = decoder(trg_ids, enc_out, src_mask, cfg)
    logits = fluid.layers.fc(dec_out, cfg.trg_vocab_size, num_flatten_dims=2,
                             param_attr=_param("proj"))

    flat_logits = fluid.layers.reshape(logits, [-1, cfg.trg_vocab_size])
    flat_label = fluid.layers.reshape(label, [-1, 1])
    if cfg.label_smooth_eps:
        smooth = fluid.layers.label_smooth(
            fluid.layers.one_hot(flat_label, cfg.trg_vocab_size),
            epsilon=cfg.label_smooth_eps)
        loss = fluid.layers.softmax_with_cross_entropy(
            flat_logits, smooth, soft_label=True)
    else:
        loss = fluid.layers.softmax_with_cross_entropy(flat_logits, flat_label)
    # mask padded target positions out of the loss
    w = fluid.layers.reshape(trg_mask, [-1, 1])
    loss = loss * w
    avg_loss = fluid.layers.reduce_sum(loss) / fluid.layers.reduce_sum(w)

    lr_var = fluid.layers.noam_decay(cfg.hidden_size, warmup_steps,
                                     learning_rate=lr)
    opt = fluid.optimizer.AdamOptimizer(
        learning_rate=lr_var, beta1=0.9, beta2=0.997, epsilon=1e-9)
    opt.minimize(avg_loss)
    return {"loss": avg_loss, "logits": logits, "enc_out": enc_out,
            "optimizer": opt, "config": cfg}
