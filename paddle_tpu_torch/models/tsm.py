"""TSM, the temporal-shift ResNet-50 video classifier of Fluid 1.5's model
zoo (PaddlePaddle/models ``PaddleCV/video``: ``models/tsm/
tsm_res_model.py`` ``TSM_ResNet``, ``models/tsm/tsm.py`` ``TSM`` (its
input, loss and optimizer) and ``configs/tsm.txt``).

``base_config()`` is the model zoo's: a ResNet-50 (stages ``[3, 4, 6,
3]`` of bottlenecks over widths 64, 128, 256 and 512, four times that
out) over clips of ``seg_num`` 8 frames of 3 x 224 x 224, fed as ``[N,
8, 3, 224, 224]`` and reshaped to ``[N·8, 3, 224, 224]``.  Each
bottleneck first shifts its input with ``temporal_shift(x, seg_num,
1/8)`` (one eighth of the channels from the frame before, one eighth
from the frame after), then runs 1x1 → 3x3 (the stride on the 3x3) →
1x1 ``conv_bn_layer``s (convs without bias, each followed by batch norm,
relu on the first two), adds the shortcut (a 1x1 ``conv_bn_layer`` of
the unshifted input where the shape changes, else the input) and
applies relu.  The stem is a 7x7/2 conv with batch norm and relu, then a
3x3/2 max pool.  After the last stage: global average pooling, dropout
0.5, a reshape to ``[N, 8, 2048]``, the mean over the 8 segments and an
``fc`` to 400 classes with softmax (weights ``Uniform(±1/sqrt(2048))``;
the bias with learning rate 2 and no weight decay).  The loss is the
mean of ``cross_entropy(ignore_index=-1)``, under Momentum 0.9 with
``L2Decay(1e-4)`` on ``piecewise_decay`` from 0.01, times 0.1 at epochs
40 and 60, counted in steps as ``tsm.py`` counts them: ``step =
int(total_videos / batch_size + 1) = int(239781 / 128 + 1) = 1874`` a
epoch, boundaries ``[74960, 112440]``.  The batch is the config's 128
clips over its 8 cards: 16 clips, 128 frames a card.  Parameter names
are the zoo's (``res2a_branch2a_weights``, ``bn2a_branch2a_scale``, ...).

``test_config()`` is a narrow copy for the CPU tests: one bottleneck a
stage, every width divided by 8 (the narrowest shifted input, the
stem's 8 channels, still moves one channel each way), 4 frames of 32 x
32, 10 classes, 2 clips, dropout off (the two packages' random streams
never match), and boundaries ``[1, 2]`` so that three steps run at the
three rates.

Where this differs from the model zoo, and why:

- The zoo feeds the batch's size as ``-1``; the programs here take a
  fixed ``[clips, seg_num, 3, size, size]`` (``base_config``'s 16).
- With ``dropout`` 0 (``test_config``, and the card's step-1 check
  against the CPU) the dropout op is left out, where the zoo has none
  to leave out: the zoo always trains at 0.5.
- The frames are synthetic (``feeds``): uniform pixels normalised with
  the config's mean and std, labels uniform in ``[0, classes)``.

``build(cfg)`` appends the training program and its optimizer to the
current programs (call it under ``program_guard`` and
``unique_name.guard``) and returns ``feeds`` (names), ``loss`` and the
class probabilities ``out``.  ``feeds(cfg, seed)`` yields synthetic
numpy batches.  ``shift(x, cfg)`` is the bottleneck's shift.

The module imports the fluid package relative to its own, so the same
builders serve any package laid out as this one is.
"""

import math

import numpy as np

from .. import fluid

layers = fluid.layers

_BASE = dict(clips=16, seg_num=8, image=224, classes=400,
             depth=[3, 4, 6, 3], width_div=1, dropout=0.5,
             lr=0.01, lr_decay=0.1, lr_boundaries=[40 * 1874, 60 * 1874],
             momentum=0.9, l2=1e-4, shift_ratio=1.0 / 8,
             mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])


def base_config():
    return dict(_BASE)


def test_config():
    return dict(_BASE, clips=2, seg_num=4, image=32, classes=10,
                depth=[1, 1, 1, 1], width_div=8, dropout=0.0,
                lr_boundaries=[1, 2])


def images_per_step(cfg):
    return cfg["clips"] * cfg["seg_num"]


def conv_bn_layer(input, num_filters, filter_size, stride=1, act=None,
                  name=None):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=1, act=None,
                         param_attr=fluid.ParamAttr(name=name + "_weights"),
                         bias_attr=False)
    bn_name = "bn_" + name if name == "conv1" else "bn" + name[3:]
    return layers.batch_norm(
        input=conv, act=act, is_test=False,
        param_attr=fluid.ParamAttr(name=bn_name + "_scale"),
        bias_attr=fluid.ParamAttr(bn_name + "_offset"),
        moving_mean_name=bn_name + "_mean",
        moving_variance_name=bn_name + "_variance")


def shift(x, cfg):
    """The bottleneck's temporal shift (``shift_module``)."""
    return layers.temporal_shift(x, cfg["seg_num"], cfg["shift_ratio"])


def shortcut(input, ch_out, stride, name):
    if input.shape[1] != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name)
    return input


def bottleneck_block(input, num_filters, stride, cfg, name):
    shifted = shift(input, cfg)
    conv0 = conv_bn_layer(shifted, num_filters, 1, act="relu",
                          name=name + "_branch2a")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu",
                          name=name + "_branch2b")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, name=name + "_branch2c")
    short = shortcut(input, num_filters * 4, stride, name + "_branch1")
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def tsm_resnet(frames, cfg):
    """``TSM_ResNet.net``: class probabilities ``[N, classes]`` of clips
    ``[N, seg_num, 3, size, size]``."""
    div = cfg["width_div"]
    size = cfg["image"]
    x = layers.reshape(x=frames, shape=[-1, 3, size, size])
    conv = conv_bn_layer(x, 64 // div, 7, 2, act="relu", name="conv1")
    conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max")
    for block, count in enumerate(cfg["depth"]):
        for i in range(count):
            conv = bottleneck_block(
                conv, 64 * 2 ** block // div,
                2 if i == 0 and block != 0 else 1, cfg,
                name="res%d%s" % (block + 2, chr(97 + i)))
    pool = layers.pool2d(input=conv, pool_size=7, pool_type="avg",
                         global_pooling=True)
    if cfg["dropout"]:
        pool = layers.dropout(x=pool, dropout_prob=cfg["dropout"],
                              is_test=False)
    feature = layers.reshape(x=pool, shape=[-1, cfg["seg_num"],
                                            pool.shape[1]])
    out = layers.reduce_mean(feature, dim=1)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    return layers.fc(
        input=out, size=cfg["classes"], act="softmax",
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)),
        bias_attr=fluid.ParamAttr(
            learning_rate=2.0, regularizer=fluid.regularizer.L2Decay(0.0)))


FEEDS = ("image", "label")


def build(cfg):
    """The training program: the mean cross entropy and Momentum.
    Returns {"feeds", "loss", "out"}."""
    N, T, S = cfg["clips"], cfg["seg_num"], cfg["image"]
    image = layers.data("image", [N, T, 3, S, S], dtype="float32",
                        append_batch_size=False)
    label = layers.data("label", [N, 1], dtype="int64",
                        append_batch_size=False)
    out = tsm_resnet(image, cfg)
    loss = layers.mean(layers.cross_entropy(input=out, label=label,
                                            ignore_index=-1))
    values = [cfg["lr"] * cfg["lr_decay"] ** i
              for i in range(len(cfg["lr_boundaries"]) + 1)]
    fluid.optimizer.Momentum(
        learning_rate=layers.piecewise_decay(
            boundaries=cfg["lr_boundaries"], values=values),
        momentum=cfg["momentum"],
        regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    return dict(feeds=list(FEEDS), loss=loss, out=out)


def feeds(cfg, seed):
    """Endless synthetic batches from ``seed``: pixels uniform in ``[0,
    1)``, normalised per channel by the config's mean and std; labels
    uniform in ``[0, classes)``."""
    rng = np.random.RandomState(seed)
    N, T, S = cfg["clips"], cfg["seg_num"], cfg["image"]
    mean = np.asarray(cfg["mean"], np.float32).reshape(1, 1, 3, 1, 1)
    std = np.asarray(cfg["std"], np.float32).reshape(1, 1, 3, 1, 1)
    while True:
        pixels = rng.uniform(0.0, 1.0, (N, T, 3, S, S)).astype(np.float32)
        yield {"image": (pixels - mean) / std,
               "label": rng.randint(0, cfg["classes"], (N, 1))
               .astype(np.int64)}
