"""MobileNet-v1 (counterpart paddle_tpu/models/mobilenet.py; reference:
PaddlePaddle models, image_classification mobilenet.py): depthwise 3x3
convs (``conv2d`` with ``groups`` equal to the channels, which the layer
emits as ``depthwise_conv2d``), pointwise 1x1 convs and batch norm.
"""

from .. import fluid


def conv_bn(input, filters, filter_size, stride=1, padding=0, groups=1,
            act="relu"):
    conv = fluid.layers.conv2d(
        input, num_filters=filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=groups, act=None,
        bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act)


def depthwise_separable(input, filters1, filters2, stride, scale=1.0):
    """depthwise 3x3 (groups == channels) then pointwise 1x1."""
    ch = int(filters1 * scale)
    dw = conv_bn(input, filters=ch, filter_size=3, stride=stride,
                 padding=1, groups=ch)
    return conv_bn(dw, filters=int(filters2 * scale), filter_size=1)


def mobilenet_v1(img, class_dim=1000, scale=1.0):
    blocks = [
        # (filters_in, filters_out, stride)
        (32, 64, 1),
        (64, 128, 2), (128, 128, 1),
        (128, 256, 2), (256, 256, 1),
        (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    h = conv_bn(img, filters=int(32 * scale), filter_size=3, stride=2,
                padding=1)
    for fin, fout, stride in blocks:
        h = depthwise_separable(h, fin, fout, stride, scale)
    pool = fluid.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return fluid.layers.fc(pool, size=class_dim, act="softmax")


def tiny(img, class_dim=10):
    """Small variant for tests: 3 separable blocks at scale 0.25."""
    h = conv_bn(img, filters=8, filter_size=3, stride=2, padding=1)
    h = depthwise_separable(h, 32, 64, 1, scale=0.25)
    h = depthwise_separable(h, 64, 128, 2, scale=0.25)
    h = depthwise_separable(h, 128, 128, 1, scale=0.25)
    pool = fluid.layers.pool2d(h, pool_type="avg", global_pooling=True)
    return fluid.layers.fc(pool, size=class_dim, act="softmax")
