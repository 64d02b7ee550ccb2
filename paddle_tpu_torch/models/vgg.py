"""VGG for ImageNet (counterpart paddle_tpu/models/vgg.py): the model of
the reference's float16 inference tables (paddle/contrib/float16/
README.md), conv3x3 stacks with batch norm, 2x2 max pools and three fc
layers, NCHW, built with the port's layers.
"""

from .. import fluid

VGG_CFG = {
    11: [1, 1, 2, 2, 2],
    13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3],
    19: [2, 2, 4, 4, 4],
}


def conv_block(input, num_filter, groups, batch_norm=True):
    conv = input
    for _ in range(groups):
        conv = fluid.layers.conv2d(conv, num_filters=num_filter,
                                   filter_size=3, padding=1,
                                   act=None if batch_norm else "relu")
        if batch_norm:
            conv = fluid.layers.batch_norm(conv, act="relu")
    return fluid.layers.pool2d(conv, pool_size=2, pool_stride=2,
                               pool_type="max")


def vgg(img, class_dim=1000, depth=16, batch_norm=True):
    groups = VGG_CFG[depth]
    filters = [64, 128, 256, 512, 512]
    conv = img
    for f, g in zip(filters, groups):
        conv = conv_block(conv, f, g, batch_norm=batch_norm)
    fc1 = fluid.layers.fc(conv, size=4096, act=None)
    fc1 = fluid.layers.relu(fluid.layers.dropout(fc1, 0.5))
    fc2 = fluid.layers.fc(fc1, size=4096, act=None)
    fc2 = fluid.layers.relu(fluid.layers.dropout(fc2, 0.5))
    return fluid.layers.fc(fc2, size=class_dim)


def build_train(class_dim=1000, depth=16, lr=0.01, image_size=224):
    img = fluid.layers.data(name="img", shape=[3, image_size, image_size],
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logits = vgg(img, class_dim=class_dim, depth=depth)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    opt = fluid.optimizer.MomentumOptimizer(
        learning_rate=lr, momentum=0.9,
        regularization=fluid.regularizer.L2Decay(5e-4))
    opt.minimize(loss)
    return {"img": img, "label": label, "loss": loss, "logits": logits}
