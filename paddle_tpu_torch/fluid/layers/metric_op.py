"""Metric layers (reference: python/paddle/fluid/layers/metric_op.py;
counterpart paddle_tpu/fluid/layers/metric_op.py): ``accuracy``."""

from ..layer_helper import LayerHelper
from . import nn


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` [N, classes] against int ``label``
    [N, 1]: a ``top_k`` op, then an ``accuracy`` op."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = nn.topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out
