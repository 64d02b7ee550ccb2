"""AMP op lists (counterpart ``paddle_tpu/fluid/contrib/mixed_precision/
fp16_lists.py``; reference ``contrib/mixed_precision/fp16_lists.py``).

Only the conv and matmul rules change precision (``lowering.
amp_operands``); the lists exist for API parity and to let users veto
the AMP dtype for specific ops.
"""

white_list = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul",
              "mul"}

black_list = {"exp", "square", "log", "mean", "sum", "cos_sim",
              "softmax", "softmax_with_cross_entropy",
              "sigmoid_cross_entropy_with_logits", "cross_entropy",
              "cross_entropy2"}

gray_list = {"elementwise_add", "elementwise_sub", "elementwise_mul",
             "elementwise_div", "elementwise_max", "elementwise_min",
             "elementwise_pow", "batch_norm", "tanh", "sigmoid",
             "lookup_table", "relu", "layer_norm", "slice", "concat",
             "dropout", "reshape2", "transpose2", "pool2d", "top_k",
             "scale", "gelu"}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
