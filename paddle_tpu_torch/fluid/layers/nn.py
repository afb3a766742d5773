"""Neural-network layers (counterpart of paddle_tpu/fluid/layers/nn.py,
the functions the ResNet and MNIST programs and the fixture programs
call).  Each layer creates parameters via LayerHelper and appends ops; the
work is in the op rules (paddle_tpu_torch/ops/)."""

from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "adaptive_pool2d", "batch_norm",
    "softmax", "relu", "sigmoid", "tanh", "square", "mean", "mul",
    "elementwise_add", "elementwise_sub", "reduce_mean", "scale",
    "reshape", "topk", "accuracy",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected: flattens trailing dims, a `mul` against a created
    weight, optional bias + activation."""
    helper = LayerHelper("fc", name=name, act=act, bias_attr=bias_attr)
    input_shape = input.shape
    in_features = 1
    for s in input_shape[num_flatten_dims:]:
        in_features *= int(s)
    w = helper.create_parameter(param_attr, shape=[in_features, size],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("mul", inputs={"X": [input], "Y": [w]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    out = helper.append_bias_op(out, bias_attr)
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table_v2.  is_sparse is accepted for API parity; the
    gradient is dense."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table_v2",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": padding_idx,
                            "is_sparse": is_sparse})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", name=name, act=act, bias_attr=bias_attr)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    dilation = ([dilation, dilation] if isinstance(dilation, int)
                else list(dilation))
    if isinstance(padding, str):
        padding_algorithm = padding.upper()
        padding = [0, 0]
    else:
        padding_algorithm = "EXPLICIT"
        padding = ([padding, padding] if isinstance(padding, int)
                   else list(padding))
    channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w_shape = [num_filters, channels // groups] + list(filter_size)
    import math

    fan_in = (channels // groups) * filter_size[0] * filter_size[1]
    std = math.sqrt(2.0 / fan_in)
    from ..initializer import NormalInitializer

    w = helper.create_parameter(param_attr, shape=w_shape, dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op_type = ("depthwise_conv2d"
               if groups == channels and num_filters % channels == 0
               and groups > 1 else "conv2d")
    helper.append_op(op_type,
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "padding_algorithm": padding_algorithm,
                            "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        if b is not None:
            pre_act = helper.create_variable_for_type_inference(input.dtype)
            helper.append_op("elementwise_add",
                             inputs={"X": [out], "Y": [b]},
                             outputs={"Out": [pre_act]},
                             attrs={"axis": 1 if data_format == "NCHW" else -1})
            out = pre_act
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    pool_size = ([pool_size, pool_size] if isinstance(pool_size, int)
                 else list(pool_size))
    pool_stride = ([pool_stride, pool_stride]
                   if isinstance(pool_stride, int) else list(pool_stride))
    if isinstance(pool_padding, str):
        padding_algorithm = pool_padding.upper()
        pool_padding = [0, 0]
    else:
        padding_algorithm = "EXPLICIT"
        pool_padding = ([pool_padding, pool_padding]
                        if isinstance(pool_padding, int) else list(pool_padding))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "strides": pool_stride, "paddings": pool_padding,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "adaptive": False,
                            "padding_algorithm": padding_algorithm,
                            "data_format": data_format})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    pool_size = ([pool_size, pool_size] if isinstance(pool_size, int)
                 else list(pool_size))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "strides": [1, 1], "paddings": [0, 0],
                            "global_pooling": False, "adaptive": True,
                            "ceil_mode": False, "exclusive": True,
                            "padding_algorithm": "EXPLICIT",
                            "data_format": "NCHW"})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    helper = LayerHelper("batch_norm", name=name, act=act)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype
    scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    from ..param_attr import ParamAttr

    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False,
                  initializer=ConstantInitializer(0.0)),
        shape=[c], dtype=dtype)
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False,
                  initializer=ConstantInitializer(1.0)),
        shape=[c], dtype=dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True

    y = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype,
                                                           stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype,
                                                          stop_gradient=True)
    reserve = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var],
                 "ReserveSpace": [reserve]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


# -- simple wrappers --------------------------------------------------------

def _unary_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


softmax = _unary_layer("softmax")
relu = _unary_layer("relu")
sigmoid = _unary_layer("sigmoid")
tanh = _unary_layer("tanh")
square = _unary_layer("square")

def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out, act)

    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_sub = _binary_layer("elementwise_sub")


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            dim = [dim] if isinstance(dim, int) else list(dim)
            attrs = {"dim": dim, "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_mean = _reduce_layer("reduce_mean")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out, act)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64",
                                                        stop_gradient=True)
    helper.append_op("top_k_v2", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": int(k), "axis": -1, "largest": True,
                            "sorted": True})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (a top_k_v2 op, then accuracy)."""
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference(dtype="float32",
                                                    stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        dtype="int32", stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": [input], "Indices": [indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]})
    return acc
