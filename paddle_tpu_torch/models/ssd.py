"""MobileNet-SSD object detection, the detector of Fluid 1.5's model zoo
(PaddlePaddle/models ``PaddleCV/ssd/mobilenet_ssd.py``: ``conv_bn``,
``depthwise_separable``, ``extra_block`` and ``mobile_net``; ``train.py``:
``train_parameters["pascalvoc"]`` and ``optimizer_setting``).

``base_config()`` is the model zoo's: batch 64 of 3 x 300 x 300 images,
MobileNet-v1 at scale 1.0 (each conv without bias, then batch norm with
relu, conv weights ``MSRA`` at learning rate 0.1), ``module11`` 19 x 19
x 512 and ``module13`` 10 x 10 x 1024, four extra blocks (a 1x1 then a
3x3 stride-2 ``conv_bn``: 256/512, 128/256, 128/256, 64/128, giving 5,
3, 2 and 1), and ``multi_box_head`` over the six maps (1x1 heads, min
sizes 60 to 285, max sizes none then 150 to 300, ratios 2 and then 2,
3, flipped): 1917 priors, 21 classes.  The loss is ``reduce_sum`` of
``ssd_loss``, under RMSProp on ``piecewise_decay([10320, 15480, 20640,
25800], [1e-3, 5e-4, 2.5e-4, 1e-4, 1e-5])`` (40, 60, 80 and 100 epochs
of 16551 images) with ``L2Decay(5e-5)``.  ``test_config()`` is a narrow
copy (scale 0.25, 96 x 96 images, the prior sizes scaled with the image,
6 classes, batch 4) for the CPU tests.

``build(cfg)`` appends the training program and its optimizer to the
current programs (call it under ``program_guard`` and
``unique_name.guard``) and returns ``feeds`` (names), ``loss`` and the
head's outputs.  ``build_eval(cfg)`` is the evaluation program: the
network with batch norm on its moving statistics, ``detection_output``
(NMS at 0.45, the layer's ``nms_top_k`` 400, ``keep_top_k`` 200 and
``score_threshold`` 0.01), then a ``detection_map`` op (VOC 11-point,
overlap 0.5, difficult boxes not evaluated, as the model zoo's
``DetectionMAP``) against the ground-truth slab ``[label, x1, y1, x2,
y2, difficult]``, padding rows labelled -1; built in a fresh
``unique_name.guard``, its parameters have the training program's names.
``feeds(cfg, seed)`` yields synthetic numpy batches: images in ``[-1,
1]``, 1 to G boxes an image with labels in ``[1, classes)``, padded with
zero rows to the static ``[B, G, 4]`` / ``[B, G, 1]`` layout.

The module imports the fluid package relative to its own, so the same
builders serve any package laid out as this one is.
"""

import numpy as np

from .. import fluid

layers = fluid.layers

_BASE = dict(batch=64, image=300, scale=1.0, classes=21, max_boxes=16,
             min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
             max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
             boundaries=[10320, 15480, 20640, 25800],
             lr_values=[1e-3, 5e-4, 2.5e-4, 1e-4, 1e-5], l2=5e-5,
             nms_threshold=0.45)


def base_config():
    return dict(_BASE)


def test_config():
    f = 96 / 300.0
    return dict(_BASE, batch=4, image=96, scale=0.25, classes=6,
                max_boxes=4, min_sizes=[s * f for s in _BASE["min_sizes"]],
                max_sizes=[[]] + [s * f for s in _BASE["max_sizes"][1:]])


def map_sides(cfg):
    """The six head maps' sides (module11, module13, the extra blocks)."""
    def down(n):
        return (n + 2 - 3) // 2 + 1
    n = cfg["image"]
    for _ in range(4):                  # conv0 and three stride-2 blocks
        n = down(n)
    sides = [n, down(n)]
    for _ in range(4):
        sides.append(down(sides[-1]))
    return sides


def num_priors(cfg):
    per = [3] + [6] * 5                 # (1, 2, 1/2), then + (3, 1/3), max
    return sum(s * s * p for s, p in zip(map_sides(cfg), per))


def conv_bn(input, filter_size, num_filters, stride, padding, num_groups=1,
            act="relu", is_test=False):
    attr = fluid.ParamAttr(learning_rate=0.1,
                           initializer=fluid.initializer.MSRA())
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, groups=num_groups, act=None,
                         param_attr=attr, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def depthwise_separable(input, num_filters1, num_filters2, num_groups,
                        stride, scale, is_test=False):
    dw = conv_bn(input, 3, int(num_filters1 * scale), stride, 1,
                 num_groups=int(num_groups * scale), is_test=is_test)
    return conv_bn(dw, 1, int(num_filters2 * scale), 1, 0, is_test=is_test)


def extra_block(input, num_filters1, num_filters2, num_groups, stride,
                scale, is_test=False):
    pw = conv_bn(input, 1, int(num_filters1 * scale), 1, 0,
                 num_groups=int(num_groups * scale), is_test=is_test)
    return conv_bn(pw, 3, int(num_filters2 * scale), stride, 1,
                   num_groups=int(num_groups * scale), is_test=is_test)


def mobile_net(img, cfg, is_test=False):
    """The backbone and ``multi_box_head``: (mbox_locs ``[B, P, 4]``,
    mbox_confs ``[B, P, classes]``, priors ``[P, 4]``, variances)."""
    scale = cfg["scale"]
    t = is_test
    tmp = conv_bn(img, 3, int(32 * scale), 2, 1, is_test=t)
    for f1, f2, g, s in ((32, 64, 32, 1), (64, 128, 64, 2),
                         (128, 128, 128, 1), (128, 256, 128, 2),
                         (256, 256, 256, 1), (256, 512, 256, 2)):
        tmp = depthwise_separable(tmp, f1, f2, g, s, scale, is_test=t)
    for _ in range(5):
        tmp = depthwise_separable(tmp, 512, 512, 512, 1, scale, is_test=t)
    module11 = tmp
    tmp = depthwise_separable(tmp, 512, 1024, 512, 2, scale, is_test=t)
    module13 = depthwise_separable(tmp, 1024, 1024, 1024, 1, scale,
                                   is_test=t)
    module14 = extra_block(module13, 256, 512, 1, 2, scale, is_test=t)
    module15 = extra_block(module14, 128, 256, 1, 2, scale, is_test=t)
    module16 = extra_block(module15, 128, 256, 1, 2, scale, is_test=t)
    module17 = extra_block(module16, 64, 128, 1, 2, scale, is_test=t)
    return layers.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=img, num_classes=cfg["classes"], min_ratio=20, max_ratio=90,
        min_sizes=cfg["min_sizes"], max_sizes=cfg["max_sizes"],
        aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2., 3.],
                       [2., 3.]],
        base_size=cfg["image"], offset=0.5, flip=True)


def _inputs(cfg):
    B, G = cfg["batch"], cfg["max_boxes"]
    image = layers.data("image", [B, 3, cfg["image"], cfg["image"]],
                        dtype="float32", append_batch_size=False)
    gt_box = layers.data("gt_box", [B, G, 4], dtype="float32",
                         append_batch_size=False)
    gt_label = layers.data("gt_label", [B, G, 1], dtype="int32",
                           append_batch_size=False)
    difficult = layers.data("is_difficult", [B, G, 1], dtype="int32",
                            append_batch_size=False)
    return image, gt_box, gt_label, difficult


FEEDS = ("image", "gt_box", "gt_label", "is_difficult")


def build(cfg):
    """The training program: ``reduce_sum(ssd_loss)`` and RMSProp.
    Returns {"feeds", "loss", "locs", "confs", "priors", "prior_vars"}."""
    image, gt_box, gt_label, _ = _inputs(cfg)
    locs, confs, box, box_var = mobile_net(image, cfg)
    loss = layers.reduce_sum(layers.ssd_loss(locs, confs, gt_box, gt_label,
                                             box, box_var))
    fluid.optimizer.RMSProp(
        learning_rate=layers.piecewise_decay(cfg["boundaries"],
                                             cfg["lr_values"]),
        regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    return dict(feeds=list(FEEDS), loss=loss, locs=locs, confs=confs,
                priors=box, prior_vars=box_var)


def build_eval(cfg):
    """Detection and its mAP, batch norm on its moving statistics.
    Returns {"feeds", "outs": [the ``[B, 200, 6]`` slab, mAP ``[1]``]}."""
    image, gt_box, gt_label, difficult = _inputs(cfg)
    locs, confs, box, box_var = mobile_net(image, cfg, is_test=True)
    nmsed = layers.detection_output(locs, confs, box, box_var,
                                    nms_threshold=cfg["nms_threshold"])
    # padding rows (label 0, zero box) become label -1: l + sign(l) - 1
    lab = layers.cast(gt_label, "float32")
    lab = layers.scale(layers.elementwise_add(lab, layers.sign(lab)),
                       scale=1.0, bias=-1.0)
    gt = layers.concat([lab, gt_box, layers.cast(difficult, "float32")],
                       axis=2)
    helper = fluid.layer_helper.LayerHelper("detection_map")
    outs = {slot: helper.create_variable_for_type_inference(dt)
            for slot, dt in (("MAP", "float32"), ("AccumPosCount", "int32"),
                             ("AccumTruePos", "float32"),
                             ("AccumFalsePos", "float32"))}
    helper.append_op("detection_map",
                     inputs={"DetectRes": [nmsed], "Label": [gt]},
                     outputs={k: [v] for k, v in outs.items()},
                     attrs={"overlap_threshold": 0.5,
                            "evaluate_difficult": False,
                            "ap_type": "11point"})
    return dict(feeds=list(FEEDS), outs=[nmsed, outs["MAP"]])


def feeds(cfg, seed):
    """Endless synthetic batches from ``seed``: images uniform in ``[-1,
    1)``; per image 1 to G boxes (corners in ``[0, 1]``, sides from 0.05
    to 0.6) with labels in ``[1, classes)`` and a difficult flag (one in
    ten), zero rows after."""
    rng = np.random.RandomState(seed)
    B, G, S = cfg["batch"], cfg["max_boxes"], cfg["image"]
    while True:
        n = rng.randint(1, G + 1, B)
        wh = rng.uniform(0.05, 0.6, (B, G, 2))
        xy = rng.uniform(0.0, 1.0, (B, G, 2)) * (1.0 - wh)
        box = np.concatenate([xy, xy + wh], axis=2).astype(np.float32)
        label = rng.randint(1, cfg["classes"], (B, G, 1)).astype(np.int32)
        diff = (rng.rand(B, G, 1) < 0.1).astype(np.int32)
        pad = np.arange(G)[None, :] >= n[:, None]
        box[pad] = 0.0
        label[pad] = 0
        diff[pad] = 0
        yield {"image": rng.uniform(-1.0, 1.0, (B, 3, S, S))
               .astype(np.float32),
               "gt_box": box, "gt_label": label, "is_difficult": diff}
