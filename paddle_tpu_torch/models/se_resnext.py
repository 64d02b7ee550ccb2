"""SE-ResNeXt (counterpart paddle_tpu/models/se_resnext.py; reference
shape: tests/unittests/dist_se_resnext.py): ResNeXt grouped bottlenecks
(Xie et al., arXiv:1611.05431) with squeeze-excitation channel gates
(Hu et al., arXiv:1709.01507).  The grouped 3x3 conv is one ``conv2d``
with ``groups=cardinality``.
"""

from .. import fluid

# depth -> (block counts, cardinality)
_CFG = {50: ([3, 4, 6, 3], 32),
        101: ([3, 4, 23, 3], 32),
        152: ([3, 8, 36, 3], 64)}
_FILTERS = [128, 256, 512, 1024]
_REDUCTION = 16


def _conv_bn(x, filters, ksize, stride=1, groups=1, act=None):
    conv = fluid.layers.conv2d(
        x, num_filters=filters, filter_size=ksize, stride=stride,
        padding=(ksize - 1) // 2, groups=groups, bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act)


def _squeeze_excitation(x, channels, reduction):
    pool = fluid.layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = fluid.layers.fc(pool, size=channels // reduction, act="relu")
    excite = fluid.layers.fc(squeeze, size=channels, act="sigmoid")
    # [B, C] gate scales the [B, C, H, W] feature map channel-wise
    return fluid.layers.elementwise_mul(x, excite, axis=0)


def _block(x, filters, stride, cardinality):
    c0 = _conv_bn(x, filters, 1, act="relu")
    c1 = _conv_bn(c0, filters, 3, stride=stride, groups=cardinality,
                  act="relu")
    c2 = _conv_bn(c1, filters * 2, 1)
    se = _squeeze_excitation(c2, filters * 2, _REDUCTION)
    if x.shape[1] != filters * 2 or stride != 1:
        short = _conv_bn(x, filters * 2, 1, stride=stride)
    else:
        short = x
    return fluid.layers.elementwise_add(short, se, act="relu")


def se_resnext(img, class_dim=1000, depth=50, dropout=0.2):
    """Image [B, 3, H, W] -> softmax probs [B, class_dim]."""
    if depth not in _CFG:
        raise ValueError("supported depths: %s" % sorted(_CFG))
    counts, cardinality = _CFG[depth]
    if depth == 152:
        x = _conv_bn(img, 64, 3, stride=2, act="relu")
        x = _conv_bn(x, 64, 3, act="relu")
        x = _conv_bn(x, 128, 3, act="relu")
    else:
        x = _conv_bn(img, 64, 7, stride=2, act="relu")
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                            pool_type="max")
    for stage, count in enumerate(counts):
        for i in range(count):
            x = _block(x, _FILTERS[stage],
                       stride=2 if i == 0 and stage else 1,
                       cardinality=cardinality)
    pool = fluid.layers.pool2d(x, pool_type="avg", global_pooling=True)
    if dropout:
        pool = fluid.layers.dropout(pool, dropout)
    return fluid.layers.fc(pool, size=class_dim, act="softmax")


def build_train(class_dim=1000, depth=50, lr=0.1, momentum=0.9,
                image_size=224, dropout=0.2):
    """Training program handles (the dist_se_resnext.py runner shape)."""
    img = fluid.layers.data(name="img", shape=[3, image_size, image_size],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    probs = se_resnext(img, class_dim=class_dim, depth=depth,
                       dropout=dropout)
    loss = fluid.layers.mean(fluid.layers.cross_entropy(probs, label))
    acc = fluid.layers.accuracy(input=probs, label=label)
    opt = fluid.optimizer.MomentumOptimizer(
        learning_rate=lr, momentum=momentum,
        regularization=fluid.regularizer.L2Decay(1e-4))
    opt.minimize(loss)
    return {"loss": loss, "acc": acc, "probs": probs}
