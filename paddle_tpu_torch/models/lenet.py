"""LeNet-5 on MNIST (counterpart paddle_tpu/models/lenet.py; BASELINE.json
config 1, the minimum end-to-end configuration), with the same ops and
names as the JAX package.

Reference shape: python/paddle/fluid/tests/unittests/dist_mnist.py
(cnn_model) and tests/book/test_recognize_digits.py.  Its 5x5 convs are
library convolutions (cuDNN on the card); no hand-written kernel runs.
"""

from .. import fluid


def lenet(img, label, num_classes=10):
    """Classic LeNet: conv-pool x2 + three FCs; returns (avg_loss, acc, logits)."""
    conv1 = fluid.layers.conv2d(img, num_filters=6, filter_size=5,
                                padding=2, act="relu")
    pool1 = fluid.layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = fluid.layers.conv2d(pool1, num_filters=16, filter_size=5,
                                act="relu")
    pool2 = fluid.layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = fluid.layers.fc(pool2, size=120, act="relu")
    fc2 = fluid.layers.fc(fc1, size=84, act="relu")
    logits = fluid.layers.fc(fc2, size=num_classes)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(logits, label)
    return avg_loss, acc, logits


def build_train(num_classes=10, lr=1e-3):
    img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    avg_loss, acc, logits = lenet(img, label, num_classes)
    opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
    opt.minimize(avg_loss)
    return {"img": img, "label": label, "loss": avg_loss, "acc": acc,
            "logits": logits}
