"""Metric layers (reference: python/paddle/fluid/layers/metric_op.py;
counterpart paddle_tpu/fluid/layers/metric_op.py): ``accuracy`` and
``auc``."""

from ..initializer import ConstantInitializer
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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """The streaming AUC (JAX metric_op.py:27): an ``auc`` op over two
    persistable ``(num_thresholds + 1,)`` float32 histograms, zeroed by
    the startup program and updated in place every run.  ``topk`` and
    ``slide_steps`` are not read, as in the JAX package.  Returns
    ``(auc, [stat_pos, stat_neg])``."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_or_get_global_variable(
        helper.name + ".stat_pos", shape=(num_thresholds + 1,),
        dtype="float32", persistable=True, stop_gradient=True)
    helper.set_variable_initializer(stat_pos, ConstantInitializer(0.0))
    stat_neg = helper.create_or_get_global_variable(
        helper.name + ".stat_neg", shape=(num_thresholds + 1,),
        dtype="float32", persistable=True, stop_gradient=True)
    helper.set_variable_initializer(stat_neg, ConstantInitializer(0.0))
    auc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    helper.append_op("auc",
                     inputs={"Predict": [input], "Label": [label],
                             "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]
