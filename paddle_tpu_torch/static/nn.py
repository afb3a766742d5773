"""paddle.static.nn (counterpart of paddle_tpu/static/nn.py): the
static-graph layers, re-exported from the port's fluid.layers.  The
reference's others (conv2d_transpose, conv3d, the norms but batch_norm,
prelu, sequence_softmax, py_func, cond / case / switch_case /
while_loop, bilinear_tensor_product, spectral_norm, data_norm, nce,
deform_conv2d, multi_box_head, conv3d_transpose) wait for their rules
(ROADMAP queue 1 items 6 and 8)."""

from ..fluid.layers import (  # noqa: F401
    batch_norm, conv2d, embedding, fc, sequence_conv, sequence_pool,
    crf_decoding, create_parameter, row_conv,
)

__all__ = ["fc", "embedding", "conv2d", "batch_norm", "sequence_conv",
           "sequence_pool", "crf_decoding", "create_parameter", "row_conv"]
