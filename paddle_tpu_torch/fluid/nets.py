"""Composite network helpers (counterpart paddle_tpu/fluid/nets.py;
reference python/paddle/fluid/nets.py — simple_img_conv_pool :28,
img_conv_group :136, sequence_conv_pool :249, glu :307,
scaled_dot_product_attention :345), built from the port's layers."""

import math

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """[conv (+bn +dropout)]xN + pool — the VGG building block."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _extend(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        assert len(obj) == len(conv_num_filter)
        return list(obj)

    conv_padding = _extend(conv_padding)
    conv_filter_size = _extend(conv_filter_size)
    param_attr = _extend(param_attr)
    conv_with_batchnorm = _extend(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _extend(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i],
                            act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(tmp, dropout_prob=drop_rate)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, length=None,
                       param_attr=None, act="sigmoid", pool_type="max",
                       bias_attr=None):
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act,
                                    bias_attr=bias_attr, length=length)
    return layers.sequence_pool(conv_out, pool_type=pool_type,
                                length=length)


def glu(input, dim=-1):
    """Gated linear unit: split in half on ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled-dot-product attention over [B, S, D] tensors
    (reference nets.py :345; projections + head split + softmax(QK^T)V)."""
    assert queries.shape[-1] % num_heads == 0

    def compute_qkv(q, k, v):
        if num_heads == 1:
            return q, k, v
        q = layers.fc(q, size=q.shape[-1], num_flatten_dims=2)
        k = layers.fc(k, size=k.shape[-1], num_flatten_dims=2)
        v = layers.fc(v, size=v.shape[-1], num_flatten_dims=2)
        return q, k, v

    def split_heads(x):
        if num_heads == 1:
            return x
        hidden = x.shape[-1]
        r = layers.reshape(x, [0, 0, num_heads, hidden // num_heads])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, [0, 0, int(t.shape[2]) * int(t.shape[3])])

    q, k, v = compute_qkv(queries, keys, values)
    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    d = int(queries.shape[-1]) // num_heads
    scores = layers.matmul(q, k, transpose_y=True,
                           alpha=1.0 / math.sqrt(d))
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)
