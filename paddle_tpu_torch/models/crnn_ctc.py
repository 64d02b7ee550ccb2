"""CRNN-CTC text recognition, the OCR program of Fluid 1.5's model zoo
(PaddlePaddle/models ``fluid/PaddleCV/ocr_recognition/crnn_ctc_model.py``:
``ocr_convs``, ``encoder_net`` and ``ctc_train_net``, at ``train.py``'s
batch of 32), on padded batches with explicit lengths.

``base_config()`` is the model zoo's widths: images ``[32, 1, 48, 512]``,
four groups of two 3x3 convolutions (16, 32, 64, 128 channels), each
followed by batch norm with relu, a 2x2 ceil-mode max pool after the
first three groups (``[32, 128, 6, 64]``), ``im2sequence`` with a
``[6, 1]`` window (64 steps of 768 features), a forward and a reversed
``dynamic_gru`` of 200 with relu candidates, each fed by its own ``fc``
to 600, and an ``fc`` over both to 96 classes (95 and the blank).  The
loss is ``warpctc(blank=95, norm_by_times=True)``, its mean over the
batch (the model zoo sums it), under ``Momentum(1e-3, 0.9)`` with
``L2Decay(4e-4)`` on every parameter.  The two fc layers before the GRUs
carry no bias: each GRU adds its own.  ``test_config()`` is a narrow
copy for the CPU tests.

``build(cfg)`` appends the training program and its optimizer to the
current programs (call it under ``program_guard`` and
``unique_name.guard``) and returns ``feeds`` (names) and ``loss``.
``build_eval(cfg)`` is the inference program: the encoder with batch
norm on its moving statistics, ``ctc_greedy_decoder`` (``top_k`` and
``ctc_align``) and ``edit_distance`` against the labels; built in a
fresh ``unique_name.guard``, its parameters have the training program's
names, so it runs on the trained scope.  ``feeds(cfg, seed)`` yields
synthetic numpy batches: images, label ids in ``[0, classes)`` with
lengths from 1 to ``max_label``, padded, and the constant sequence
length.

The module imports the fluid package relative to its own, so the same
builders serve any package laid out as this one is.
"""

import numpy as np

from .. import fluid

layers = fluid.layers

_BASE = dict(batch=32, channels=1, height=48, width=512,
             conv=(16, 32, 64, 128), rnn=200, classes=95, max_label=24,
             lr=1e-3, momentum=0.9, l2=4e-4)
_TEST = dict(_BASE, batch=4, height=16, width=64, conv=(4, 8, 8, 16),
             rnn=16, classes=10, max_label=3)


def base_config():
    return dict(_BASE)


def test_config():
    return dict(_TEST)


def _pooled(n):
    """A side after the three 2x2 ceil-mode pools."""
    for _ in range(3):
        n = -(-n // 2)
    return n


def steps(cfg):
    """The encoder's time steps: the width after the three pools."""
    return _pooled(cfg["width"])


def _attr(regularizer, std, lr=1.0):
    return fluid.ParamAttr(regularizer=regularizer, learning_rate=lr,
                           initializer=fluid.initializer.Normal(0.0, std))


def ocr_convs(images, cfg, regularizer, is_test):
    """Four groups of two conv + batch norm + relu, a ceil-mode max pool
    after each of the first three; the first group's convolutions take
    the ``Normal(0, 5e-4)`` init, the rest ``Normal(0, 1e-2)``."""
    b = _attr(regularizer, 0.0)
    w0 = _attr(regularizer, 0.0005)
    w1 = _attr(regularizer, 0.01)
    x = images
    for g, ch in enumerate(cfg["conv"]):
        for _ in range(2):
            x = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                              param_attr=w0 if g == 0 else w1)
            x = layers.batch_norm(x, act="relu", param_attr=w1,
                                  bias_attr=b, is_test=is_test)
        if g < 3:
            x = layers.pool2d(x, pool_size=2, pool_type="max",
                              pool_stride=2, ceil_mode=True)
    return x


def encoder_net(images, seq_len, cfg, regularizer=None, is_test=False):
    """The convolutions, ``im2sequence`` over the full feature height,
    the two GRUs and the class fc: logits ``[B, T, classes + 1]``."""
    conv = ocr_convs(images, cfg, regularizer, is_test)
    fh = _pooled(cfg["height"])
    seq = layers.im2sequence(conv, filter_size=[fh, 1], stride=[1, 1])
    # im2sequence leaves its static shape unset; the fc reads it
    seq.shape = (cfg["batch"], steps(cfg), cfg["conv"][-1] * fh)
    para = _attr(regularizer, 0.02)
    gru_bias = _attr(regularizer, 0.02, lr=2.0)
    H = cfg["rnn"]
    grus = []
    for reverse in (False, True):
        proj = layers.fc(seq, size=3 * H, num_flatten_dims=2,
                         param_attr=para, bias_attr=False)
        grus.append(layers.dynamic_gru(
            proj, size=H, length=seq_len, param_attr=para,
            bias_attr=gru_bias, is_reverse=reverse,
            candidate_activation="relu"))
    return layers.fc(grus, size=cfg["classes"] + 1, num_flatten_dims=2,
                     param_attr=_attr(regularizer, 0.02),
                     bias_attr=_attr(regularizer, 0.0))


def _inputs(cfg):
    B = cfg["batch"]
    images = layers.data("pixel", [B, cfg["channels"], cfg["height"],
                                   cfg["width"]], dtype="float32",
                         append_batch_size=False)
    label = layers.data("label", [B, cfg["max_label"]], dtype="int32",
                        append_batch_size=False)
    label_len = layers.data("label_len", [B], dtype="int64",
                            append_batch_size=False)
    seq_len = layers.data("seq_len", [B], dtype="int64",
                          append_batch_size=False)
    return images, label, label_len, seq_len


FEEDS = ("pixel", "label", "label_len", "seq_len")


def build(cfg):
    """The training program: CTC loss, its mean, and Momentum with L2
    decay.  Returns {"feeds", "loss"}."""
    images, label, label_len, seq_len = _inputs(cfg)
    logits = encoder_net(images, seq_len, cfg,
                         regularizer=fluid.regularizer.L2Decay(cfg["l2"]))
    cost = layers.warpctc(logits, label, blank=cfg["classes"],
                          norm_by_times=True, input_length=seq_len,
                          label_length=label_len)
    loss = layers.mean(cost)
    fluid.optimizer.Momentum(learning_rate=cfg["lr"],
                             momentum=cfg["momentum"]).minimize(loss)
    return dict(feeds=list(FEEDS), loss=loss)


def build_eval(cfg):
    """The greedy decode and its edit distance to the labels, batch norm
    on its moving statistics.  Returns {"feeds", "outs": [decoded ids
    ``[B, T]``, their lengths, distances ``[B, 1]``, sequence count]}."""
    images, label, label_len, seq_len = _inputs(cfg)
    logits = encoder_net(images, seq_len, cfg, is_test=True)
    ids, ids_len = layers.ctc_greedy_decoder(logits, blank=cfg["classes"],
                                             length=seq_len)
    dist, seq_num = layers.edit_distance(
        ids, layers.cast(label, "int64"), normalized=False,
        input_length=ids_len, label_length=label_len)
    return dict(feeds=list(FEEDS), outs=[ids, ids_len, dist, seq_num])


def feeds(cfg, seed):
    """Endless synthetic batches from ``seed``: images uniform in
    ``[0, 1)``, label ids in ``[0, classes)`` with lengths from 1 to
    ``max_label`` (zeros after), every sequence ``steps(cfg)`` long."""
    rng = np.random.RandomState(seed)
    B, L = cfg["batch"], cfg["max_label"]
    while True:
        label_len = rng.randint(1, L + 1, B).astype(np.int64)
        label = rng.randint(0, cfg["classes"], (B, L)).astype(np.int32)
        label[np.arange(L)[None, :] >= label_len[:, None]] = 0
        yield {"pixel": rng.rand(B, cfg["channels"], cfg["height"],
                                 cfg["width"]).astype(np.float32),
               "label": label, "label_len": label_len,
               "seq_len": np.full(B, steps(cfg), np.int64)}
