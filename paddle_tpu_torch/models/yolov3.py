"""YOLOv3 on DarkNet-53, the detector of Fluid 1.5's model zoo
(PaddlePaddle/models ``PaddleCV/yolov3``: ``models/darknet.py``
``conv_bn_layer``, ``downsample``, ``basicblock``, ``layer_warp`` and
``add_DarkNet53_conv_body``; ``models/yolov3.py`` ``YOLOv3``;
``config.py`` and ``train.py``'s optimizer).

``base_config()`` is the model zoo's: DarkNet-53 (stages ``[1, 2, 8, 8,
4]`` of basic blocks, widths 32 to 1024, each conv without bias, then
batch norm, then ``leaky_relu`` at 0.1; conv weights ``Normal(0, 0.02)``,
batch-norm scales ``Normal(0, 0.02)`` and offsets 0, both without weight
decay), three ``yolo_detection_block``s of 512, 256 and 128 channels,
two 1x1 route convs each followed by a nearest 2x upsampling, and a 1x1
output conv with bias on each of the three maps: 75 convolutions, 72 of
them followed by ``leaky_relu``.  80 classes, the nine COCO anchors,
anchor masks ``[[6, 7, 8], [3, 4, 5], [0, 1, 2]]``, 608 x 608 images
(maps of 19², 38² and 76²), ``ignore_thresh`` 0.7, label smoothing on,
50 ground-truth slots an image (``max_box_num``), the per-card batch of
8.  The loss is the sum over the three maps of the batch mean of
``yolov3_loss``, under Momentum 0.9 with ``L2Decay(5e-4)`` on
``linear_lr_warmup(piecewise_decay([400000, 450000], [1e-3, 1e-4,
1e-5]), 4000, 0, 1e-3)``.  ``test_config()`` is a narrow copy for the
CPU tests: one block a stage, every width divided by 8, 64 x 64 images,
4 classes, batch 2, 6 ground-truth slots.

Where this differs from the model zoo, and why:

- The zoo's ``_upsample`` hands ``resize_nearest`` a dynamic
  ``actual_shape`` built from ``fluid.layers.shape``; the JAX package's
  ``resize_nearest`` takes no ``actual_shape``, so both packages resize
  by ``scale=2`` from the static shape, which is the same output at a
  fixed input size.
- The zoo trains on randomly chosen input sizes (320 to 608, one
  program each); this path fixes 608 (``base_config``).
- The zoo feeds ``gt_score`` from mixup; mixup is off here and the
  scores are ones.

``build(cfg)`` appends the training program and its optimizer to the
current programs (call it under ``program_guard`` and
``unique_name.guard``) and returns ``feeds`` (names), ``loss`` and the
three head outputs.  ``build_eval(cfg)`` is the evaluation program: the
network with batch norm on its moving statistics, ``yolo_box`` on each
map against the images' sizes, the scores transposed to ``[N, C, M]``,
the boxes and scores of the three maps joined, then ``multiclass_nms``
with the zoo's ``valid_thresh`` 0.005, ``nms_topk`` 400, ``nms_posk``
100 and ``nms_thresh`` 0.45 (no background class): a ``[N, 100, 6]``
slab of ``[label, score, x1, y1, x2, y2]`` rows, label -1 on the
padding.  Built in a fresh ``unique_name.guard``, its parameters have
the training program's names.  ``feeds(cfg, seed)`` yields synthetic
numpy batches: images in ``[-1, 1]``, 1 to 16 ground-truth boxes an
image (center form, normalized) with labels in ``[0, classes)`` and
zero rows after them; ``eval_feed(cfg, feed)`` is the evaluation
program's feed of a batch's images.

The module imports the fluid package relative to its own, so the same
builders serve any package laid out as this one is.
"""

import numpy as np

from .. import fluid

layers = fluid.layers

_BASE = dict(batch=8, image=608, classes=80, max_boxes=50,
             stages=[1, 2, 8, 8, 4], width_div=1,
             anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                      90, 156, 198, 373, 326],
             anchor_masks=[[6, 7, 8], [3, 4, 5], [0, 1, 2]],
             ignore_thresh=0.7, label_smooth=True,
             lr=1e-3, lr_steps=[400000, 450000], lr_gamma=0.1,
             warmup=4000, momentum=0.9, l2=5e-4,
             valid_thresh=0.005, nms_topk=400, nms_posk=100,
             nms_thresh=0.45, feed_boxes=16)


def base_config():
    return dict(_BASE)


def test_config():
    """Narrow and shallow, with a 2-step warm-up, so that three steps
    run at the rates 0, lr / 2 and lr: the last two move the weights."""
    return dict(_BASE, batch=2, image=64, classes=4, max_boxes=6,
                stages=[1, 1, 1, 1, 1], width_div=8, feed_boxes=6, warmup=2)


def map_sides(cfg):
    """The three output maps' sides: the image over 32, 16 and 8."""
    return [cfg["image"] // d for d in (32, 16, 8)]


def _attr(name, initializer=None, decay=True):
    """A named parameter, ``Normal(0, 0.02)`` unless ``initializer``;
    ``decay=False`` gives it ``L2Decay(0)``, which wins over the
    optimizer's."""
    return fluid.ParamAttr(
        initializer=initializer or fluid.initializer.Normal(0.0, 0.02),
        regularizer=None if decay else fluid.regularizer.L2Decay(0.0),
        name=name)


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="leaky",
                  is_test=True, name=None):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None,
                         param_attr=_attr(name + ".conv.weights"),
                         bias_attr=False)
    bn = name + ".bn"
    out = layers.batch_norm(
        input=conv, act=None, is_test=is_test,
        param_attr=_attr(bn + ".scale", decay=False),
        bias_attr=_attr(bn + ".offset", fluid.initializer.Constant(0.0),
                        decay=False),
        moving_mean_name=bn + ".mean", moving_variance_name=bn + ".var")
    if act == "leaky":
        out = layers.leaky_relu(out, alpha=0.1)
    return out


def basicblock(input, ch_out, is_test=True, name=None):
    conv1 = conv_bn_layer(input, ch_out, 1, 1, 0, is_test=is_test,
                          name=name + ".0")
    conv2 = conv_bn_layer(conv1, ch_out * 2, 3, 1, 1, is_test=is_test,
                          name=name + ".1")
    return layers.elementwise_add(x=input, y=conv2, act=None)


def darknet53(image, cfg, is_test=True):
    """The DarkNet-53 body: the last three stages' outputs, deepest
    first (1024, 512 and 256 channels at base width)."""
    div = cfg["width_div"]
    conv1 = conv_bn_layer(image, 32 // div, 3, 1, 1, is_test=is_test,
                          name="yolo_input")
    down = conv_bn_layer(conv1, conv1.shape[1] * 2, 3, 2, 1, is_test=is_test,
                         name="yolo_input.downsample")
    blocks = []
    stages = cfg["stages"]
    for i, count in enumerate(stages):
        block = down
        for j in range(count):
            block = basicblock(block, 32 * 2 ** i // div, is_test=is_test,
                               name="stage.%d.%d" % (i, j))
        blocks.append(block)
        if i < len(stages) - 1:
            down = conv_bn_layer(block, block.shape[1] * 2, 3, 2, 1,
                                 is_test=is_test,
                                 name="stage.%d.downsample" % i)
    return blocks[-1:-4:-1]


def yolo_detection_block(input, channel, is_test=True, name=None):
    conv = input
    for j in range(2):
        conv = conv_bn_layer(conv, channel, 1, 1, 0, is_test=is_test,
                             name="%s.%d.0" % (name, j))
        conv = conv_bn_layer(conv, channel * 2, 3, 1, 1, is_test=is_test,
                             name="%s.%d.1" % (name, j))
    route = conv_bn_layer(conv, channel, 1, 1, 0, is_test=is_test,
                          name=name + ".2")
    tip = conv_bn_layer(route, channel * 2, 3, 1, 1, is_test=is_test,
                        name=name + ".tip")
    return route, tip


def yolo_heads(image, cfg, is_test=True):
    """The three head outputs ``[N, 3 (5 + classes), s, s]``, deepest
    map first."""
    div = cfg["width_div"]
    outputs = []
    route = None
    blocks = darknet53(image, cfg, is_test)
    for i, block in enumerate(blocks):
        if i > 0:
            block = layers.concat(input=[route, block], axis=1)
        route, tip = yolo_detection_block(block, 512 // 2 ** i // div,
                                          is_test=is_test,
                                          name="yolo_block.%d" % i)
        filters = len(cfg["anchor_masks"][i]) * (cfg["classes"] + 5)
        outputs.append(layers.conv2d(
            input=tip, num_filters=filters, filter_size=1, stride=1,
            padding=0, act=None,
            param_attr=_attr("yolo_output.%d.conv.weights" % i),
            bias_attr=_attr("yolo_output.%d.conv.bias" % i,
                            fluid.initializer.Constant(0.0), decay=False)))
        if i < len(blocks) - 1:
            route = conv_bn_layer(route, 256 // 2 ** i // div, 1, 1, 0,
                                  is_test=is_test,
                                  name="yolo_transition.%d" % i)
            route = layers.resize_nearest(route, scale=2)
    return outputs


FEEDS = ("image", "gt_box", "gt_label", "gt_score")


def _image(cfg):
    return layers.data("image", [cfg["batch"], 3, cfg["image"],
                                 cfg["image"]], dtype="float32",
                       append_batch_size=False)


def build(cfg):
    """The training program: the three maps' ``yolov3_loss`` and
    Momentum.  Returns {"feeds", "loss", "outputs"}."""
    B, G = cfg["batch"], cfg["max_boxes"]
    image = _image(cfg)
    gt_box = layers.data("gt_box", [B, G, 4], dtype="float32",
                         append_batch_size=False)
    gt_label = layers.data("gt_label", [B, G], dtype="int32",
                           append_batch_size=False)
    gt_score = layers.data("gt_score", [B, G], dtype="float32",
                           append_batch_size=False)
    outputs = yolo_heads(image, cfg, is_test=False)
    loss = None
    downsample = 32
    for i, out in enumerate(outputs):
        term = layers.reduce_mean(layers.yolov3_loss(
            x=out, gt_box=gt_box, gt_label=gt_label, gt_score=gt_score,
            anchors=cfg["anchors"], anchor_mask=cfg["anchor_masks"][i],
            class_num=cfg["classes"], ignore_thresh=cfg["ignore_thresh"],
            downsample_ratio=downsample,
            use_label_smooth=cfg["label_smooth"],
            name="yolo_loss%d" % i))
        loss = term if loss is None else loss + term
        downsample //= 2
    values = [cfg["lr"] * cfg["lr_gamma"] ** i
              for i in range(len(cfg["lr_steps"]) + 1)]
    lr = layers.linear_lr_warmup(
        learning_rate=layers.piecewise_decay(boundaries=cfg["lr_steps"],
                                             values=values),
        warmup_steps=cfg["warmup"], start_lr=0.0, end_lr=cfg["lr"])
    fluid.optimizer.Momentum(
        learning_rate=lr, momentum=cfg["momentum"],
        regularization=fluid.regularizer.L2Decay(cfg["l2"])).minimize(loss)
    return dict(feeds=list(FEEDS), loss=loss, outputs=outputs)


def build_eval(cfg):
    """Detection: the ``[N, nms_posk, 6]`` NMS slab, batch norm on its
    moving statistics.  Returns {"feeds", "outs": [slab]}."""
    image = _image(cfg)
    im_shape = layers.data("im_shape", [cfg["batch"], 2], dtype="int32",
                           append_batch_size=False)
    boxes, scores = [], []
    downsample = 32
    for i, out in enumerate(yolo_heads(image, cfg, is_test=True)):
        mask_anchors = []
        for m in cfg["anchor_masks"][i]:
            mask_anchors += cfg["anchors"][2 * m:2 * m + 2]
        b, s = layers.yolo_box(x=out, img_size=im_shape,
                               anchors=mask_anchors,
                               class_num=cfg["classes"],
                               conf_thresh=cfg["valid_thresh"],
                               downsample_ratio=downsample,
                               name="yolo_box%d" % i)
        boxes.append(b)
        scores.append(layers.transpose(s, perm=[0, 2, 1]))
        downsample //= 2
    slab = layers.multiclass_nms(
        bboxes=layers.concat(boxes, axis=1),
        scores=layers.concat(scores, axis=2),
        score_threshold=cfg["valid_thresh"], nms_top_k=cfg["nms_topk"],
        keep_top_k=cfg["nms_posk"], nms_threshold=cfg["nms_thresh"],
        background_label=-1, name="multiclass_nms")
    return dict(feeds=["image", "im_shape"], outs=[slab])


def feeds(cfg, seed):
    """Endless synthetic batches from ``seed``: images uniform in ``[-1,
    1)``; per image 1 to ``feed_boxes`` boxes in center form ``[cx, cy,
    w, h]`` inside the unit square (sides 0.02 to 0.6) with labels in
    ``[0, classes)`` and scores 1, zero rows after them (the loss treats
    a zero-area row as absent)."""
    rng = np.random.RandomState(seed)
    B, G, S = cfg["batch"], cfg["max_boxes"], cfg["image"]
    while True:
        n = rng.randint(1, cfg["feed_boxes"] + 1, B)
        wh = rng.uniform(0.02, 0.6, (B, G, 2))
        c = wh / 2 + rng.uniform(0.0, 1.0, (B, G, 2)) * (1.0 - wh)
        box = np.concatenate([c, wh], axis=2).astype(np.float32)
        label = rng.randint(0, cfg["classes"], (B, G)).astype(np.int32)
        pad = np.arange(G)[None, :] >= n[:, None]
        box[pad] = 0.0
        label[pad] = 0
        yield {"image": rng.uniform(-1.0, 1.0, (B, 3, S, S))
               .astype(np.float32),
               "gt_box": box, "gt_label": label,
               "gt_score": np.ones((B, G), np.float32)}


def eval_feed(cfg, feed):
    """The evaluation program's feed: ``feed``'s images and their height
    and width (``im_shape``, int32)."""
    return {"image": feed["image"],
            "im_shape": np.full((cfg["batch"], 2), cfg["image"], np.int32)}
