"""ResNet for ImageNet (counterpart paddle_tpu/models/resnet.py): ResNet
v1.5 (stride 2 in the 3x3 conv of the bottleneck) built with the port's
layers, with the same ops and names as the JAX package.

Reference shape: python/paddle/fluid/tests/unittests/dist_se_resnext.py
(conv_bn_layer / bottleneck_block program construction).  The program is
NCHW; ``FLAGS_conv_pallas`` routes its 3x3 stride-1 convs through the
hand-written kernel K1 (``fluid/ops/conv_ops.py``), and
``contrib.mixed_precision.decorate(opt, use_pure_bf16=True)`` runs it in
pure bf16.
"""

from .. import fluid

DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False, name=name)
    return fluid.layers.batch_norm(input=conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def basic_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1)
    short = shortcut(input, num_filters, stride)
    return fluid.layers.relu(short + conv1)


def bottleneck_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1)
    short = shortcut(input, num_filters * 4, stride)
    return fluid.layers.relu(short + conv2)


def resnet(img, class_dim=1000, depth=50):
    block_type, counts = DEPTH_CFG[depth]
    block_fn = bottleneck_block if block_type == "bottleneck" else basic_block
    num_filters = [64, 128, 256, 512]

    conv = conv_bn_layer(img, 64, 7, stride=2, act="relu")
    conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = block_fn(conv, num_filters[stage], stride)
    pool = fluid.layers.pool2d(conv, pool_type="avg", global_pooling=True)
    logits = fluid.layers.fc(
        pool, size=class_dim,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-0.01, 0.01)))
    return logits


def build_train(class_dim=1000, depth=50, lr=0.1, momentum=0.9,
                weight_decay=1e-4, image_size=224):
    """Full training program: loss + top1/top5 acc + momentum/WD optimizer."""
    img = fluid.layers.data(name="img", shape=[3, image_size, image_size],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logits = resnet(img, class_dim=class_dim, depth=depth)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    acc1 = fluid.layers.accuracy(logits, label, k=1)
    acc5 = fluid.layers.accuracy(logits, label, k=5)
    opt = fluid.optimizer.MomentumOptimizer(
        learning_rate=lr, momentum=momentum,
        regularization=fluid.regularizer.L2Decay(weight_decay))
    opt.minimize(avg_loss)
    return {"img": img, "label": label, "loss": avg_loss,
            "acc1": acc1, "acc5": acc5, "logits": logits, "optimizer": opt}
