"""AMP op lists (a copy of paddle_tpu/fluid/contrib/mixed_precision/
fp16_lists.py).  White: the compute-bound ops that run in reduced
precision (on the card's tensor cores); black: the numerically sensitive
ops pinned to float32; gray: they follow their inputs."""

from __future__ import annotations

white_list = {
    "matmul", "matmul_v2", "mul", "bmm", "conv2d", "depthwise_conv2d",
    "conv3d", "conv2d_transpose", "fc",
}

black_list = {
    "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "mean", "reduce_mean", "reduce_sum", "exp", "log", "square", "sqrt",
    "rsqrt", "softmax", "log_softmax", "layer_norm", "batch_norm",
    "sync_batch_norm", "instance_norm", "group_norm", "sum",
    "sigmoid_cross_entropy_with_logits", "bce_loss", "huber_loss",
    "kldiv_loss", "squared_l2_norm", "p_norm", "cumsum", "logsumexp",
}

gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "relu", "relu6", "gelu", "sigmoid", "tanh",
    "leaky_relu", "swish", "silu", "hard_swish", "hard_sigmoid", "elu",
    "softplus", "softsign", "prelu", "maxout", "dropout", "pool2d", "pad",
    "pad2d", "pad3d", "reshape", "reshape2", "transpose", "transpose2",
    "squeeze", "squeeze2", "unsqueeze", "unsqueeze2", "flatten", "flatten2",
    "flatten_contiguous_range", "concat", "split", "stack", "slice",
    "strided_slice", "gather", "gather_nd", "expand", "expand_v2", "tile",
    "scale", "clip", "abs", "sign", "where", "lookup_table",
    "lookup_table_v2", "label_smooth", "top_k", "top_k_v2", "maximum",
    "minimum",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        self.black_varnames = set(custom_black_varnames or ())
        for w in custom_white_list or ():
            self.white_list.add(w)
            self.black_list.discard(w)
            self.gray_list.discard(w)
        for b in custom_black_list or ():
            self.black_list.add(b)
            self.white_list.discard(b)
            self.gray_list.discard(b)
