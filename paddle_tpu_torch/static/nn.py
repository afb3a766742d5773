"""paddle.static.nn (counterpart of paddle_tpu/static/nn.py): the
static-graph layers, re-exported from the port's fluid.layers."""

from ..fluid.layers import (  # noqa: F401
    batch_norm, conv2d, conv2d_transpose, conv3d, embedding, fc,
    group_norm, instance_norm, layer_norm, prelu, sequence_conv,
    sequence_pool, sequence_softmax, crf_decoding, create_parameter,
    bilinear_tensor_product, row_conv, spectral_norm, data_norm, nce,
    deform_conv2d, conv3d_transpose, py_func, multi_box_head,
)
from ..fluid.layers.control_flow import (  # noqa: F401
    case, cond, switch_case, while_loop,
)

__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "batch_norm", "instance_norm",
           "layer_norm", "group_norm", "prelu", "sequence_conv",
           "sequence_pool", "sequence_softmax", "py_func", "cond", "case",
           "switch_case", "while_loop", "crf_decoding", "create_parameter",
           "bilinear_tensor_product", "row_conv", "spectral_norm",
           "data_norm", "nce", "deform_conv2d", "multi_box_head"]
