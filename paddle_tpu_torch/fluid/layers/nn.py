"""Neural-network layers (counterpart of paddle_tpu/fluid/layers/nn.py):
the layers of the ported programs (fc, embedding, conv2d, the pools,
batch_norm), the activation, math, compare, logical, reduce and
elementwise wrappers, the CTC and CRF layers, and the layers of the nn
bucket's rules (the transposed and 3-D convolutions, the norms,
dropout, prelu, maxout, label_smooth, unfold, the resizes,
bilinear_tensor_product, spectral_norm, data_norm, nce,
deform_conv2d), Print over the control-flow bucket's `print`, and the
misc bucket's py_func and auc.  Each layer creates its parameters
through LayerHelper and appends ops; the work is in the op rules
(paddle_tpu_torch/ops/).  The reference's layers whose rules are not
ported yet are left out (ROADMAP queue 1 item 8)."""

from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "adaptive_pool2d", "batch_norm",
    "softmax", "log_softmax", "relu", "relu6", "sigmoid", "tanh", "sqrt",
    "square", "abs", "exp", "log", "floor", "ceil", "round", "sin", "cos",
    "gelu", "leaky_relu", "elu", "softplus", "softsign", "swish",
    "hard_sigmoid", "hard_swish", "erf", "rsqrt", "reciprocal", "sign",
    "mean", "mul", "matmul", "bmm", "dot", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_pow", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_floordiv", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "reduce_all", "reduce_any",
    "clip", "clip_by_norm", "scale", "pow", "reshape", "transpose",
    "flatten", "topk", "accuracy", "one_hot", "l2_normalize", "pad",
    "pad2d", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_not", "logical_xor", "maximum", "minimum", "cumsum",
    "isfinite", "warpctc", "ctc_greedy_decoder", "edit_distance",
    "linear_chain_crf", "crf_decoding", "row_conv",
    "conv2d_transpose", "conv3d", "layer_norm", "instance_norm",
    "group_norm", "dropout", "prelu", "maxout", "label_smooth", "unfold",
    "image_resize", "resize_nearest", "resize_bilinear", "interpolate",
    "bilinear_tensor_product", "spectral_norm", "data_norm", "nce",
    "deform_conv2d", "conv3d_transpose", "Print", "py_func", "auc",
    "multi_box_head",
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
log_softmax = _unary_layer("log_softmax")
relu = _unary_layer("relu")
relu6 = _unary_layer("relu6")
sigmoid = _unary_layer("sigmoid")
tanh = _unary_layer("tanh")
sqrt = _unary_layer("sqrt")
rsqrt = _unary_layer("rsqrt")
square = _unary_layer("square")
abs = _unary_layer("abs")
exp = _unary_layer("exp")
log = _unary_layer("log")
floor = _unary_layer("floor")
ceil = _unary_layer("ceil")
round = _unary_layer("round")
sin = _unary_layer("sin")
cos = _unary_layer("cos")
erf = _unary_layer("erf")
reciprocal = _unary_layer("reciprocal")
sign = _unary_layer("sign")
softsign = _unary_layer("softsign")
softplus = _unary_layer("softplus")


def gelu(x, approximate=False):
    helper = LayerHelper("gelu")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("gelu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"approximate": approximate})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("leaky_relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return out


def elu(x, alpha=1.0):
    helper = LayerHelper("elu")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("elu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return out


def swish(x, beta=1.0):
    helper = LayerHelper("swish")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("swish", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"beta": beta})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5):
    helper = LayerHelper("hard_sigmoid")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("hard_sigmoid", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"slope": slope, "offset": offset})
    return out


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0):
    helper = LayerHelper("hard_swish")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("hard_swish", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"threshold": threshold, "scale": scale,
                            "offset": offset})
    return out


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


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def bmm(x, y, name=None):
    helper = LayerHelper("bmm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("bmm", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def dot(x, y, name=None):
    helper = LayerHelper("dot", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("dot", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
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
elementwise_mul = _binary_layer("elementwise_mul")
elementwise_div = _binary_layer("elementwise_div")
elementwise_pow = _binary_layer("elementwise_pow")
elementwise_max = _binary_layer("elementwise_max")
elementwise_min = _binary_layer("elementwise_min")
elementwise_mod = _binary_layer("elementwise_mod")
elementwise_floordiv = _binary_layer("elementwise_floordiv")


def _compare_layer(op_type):
    def layer(x, y, cond=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = cond or helper.create_variable_for_type_inference(dtype="bool")
        out.stop_gradient = True
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


equal = _compare_layer("equal")
not_equal = _compare_layer("not_equal")
less_than = _compare_layer("less_than")
less_equal = _compare_layer("less_equal")
greater_than = _compare_layer("greater_than")
greater_equal = _compare_layer("greater_equal")


def _logical_layer(op_type, unary=False):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(dtype="bool")
        ins = {"X": [x]} if unary else {"X": [x], "Y": [y]}
        helper.append_op(op_type, inputs=ins, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    return layer


logical_and = _logical_layer("logical_and")
logical_or = _logical_layer("logical_or")
logical_xor = _logical_layer("logical_xor")
logical_not = _logical_layer("logical_not", unary=True)
maximum = _binary_layer("elementwise_max")
minimum = _binary_layer("elementwise_min")


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


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": float(factor)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op("flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
    return out


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
    """(Paddle's layers/metric_op.py accuracy): top-k accuracy."""
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


def one_hot(input, depth, allow_out_of_range=False):
    from .tensor import one_hot as _oh

    return _oh(input, depth, allow_out_of_range)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    sq = square(x)
    summed = reduce_sum(sq, dim=axis, keep_dim=True)
    norm = sqrt(elementwise_add(summed, fill_like_scalar(summed, epsilon)))
    return elementwise_div(x, norm)


def fill_like_scalar(x, value):
    from .tensor import _like

    return _like(x, value)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(x, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("pad2d", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    from .tensor import cumsum as _cumsum

    return _cumsum(x, axis, exclusive, reverse)


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference(dtype="bool",
                                                    stop_gradient=True)
    helper.append_op("isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss (Paddle's layers/nn.py warpctc; operators/warpctc_op.cc).
    Dense contract: input (T, B, C) raw logits, label (B, L) padded,
    lengths explicit (the LoD-form variable-length encoding collapses to
    the length vectors)."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    helper.append_op("warpctc", inputs=ins, outputs={"Loss": [loss]},
                     attrs={"blank": blank,
                            "norm_by_times": norm_by_times},
                     infer_shape=False)
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decode (Paddle's layers/nn.py ctc_greedy_decoder):
    argmax over classes, collapse repeats, drop blanks; returns
    (decoded (B, T) front-packed, lengths (B, 1))."""
    from .tensor import argmax

    helper = LayerHelper("ctc_greedy_decoder")
    ids = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference(dtype="int64")
    out_len = helper.create_variable_for_type_inference(dtype="int32")
    ins = {"Input": [ids]}
    if input_length is not None:
        ins["InputLength"] = [input_length]
    helper.append_op("ctc_align", inputs=ins,
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": blank, "padding_value": 0},
                     infer_shape=False)
    return out, out_len


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance (Paddle's layers/nn.py edit_distance)."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference(dtype="float32")
    seq_num = helper.create_variable_for_type_inference(dtype="int64")
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    helper.append_op("edit_distance", inputs=ins,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized}, infer_shape=False)
    return out, seq_num


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Linear-chain CRF negative log-likelihood (Paddle's
    layers/nn.py linear_chain_crf over linear_chain_crf_op.cc).
    `input` is dense emissions (B, T, D) — ragged batches pass
    `length` (B,) instead of LoD.  Creates the (D+2, D) transition
    parameter (row 0 start, row 1 end, 2.. tag->tag) and returns the
    per-sequence NLL (B, 1); crf_decoding shares the transition by
    ParamAttr name."""
    helper = LayerHelper("linear_chain_crf")
    size = int(input.shape[-1])
    transition = helper.create_parameter(param_attr, [size + 2, size],
                                         dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(dtype=input.dtype)
    emission_exps = helper.create_variable_for_type_inference(
        dtype=input.dtype)
    transition_exps = helper.create_variable_for_type_inference(
        dtype=input.dtype)
    log_likelihood = helper.create_variable_for_type_inference(
        dtype=input.dtype)
    ins = {"Emission": [input], "Transition": [transition],
           "Label": [label]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("linear_chain_crf", inputs=ins,
                     outputs={"LogLikelihood": [log_likelihood],
                              "Alpha": [alpha],
                              "EmissionExps": [emission_exps],
                              "TransitionExps": [transition_exps]},
                     infer_shape=False)
    return log_likelihood


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode against a linear_chain_crf-trained transition
    (Paddle's layers/nn.py crf_decoding over crf_decoding_op.h).
    `param_attr.name` must name the transition parameter created by
    linear_chain_crf.  With `label`, returns the 0/1 per-position
    correctness mask instead of the path."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("crf_decoding")
    attr = ParamAttr._to_attr(param_attr)
    transition = helper.get_parameter(attr.name)
    out = helper.create_variable_for_type_inference(dtype="int64")
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    if length is not None:
        ins["Length"] = [length]
    helper.append_op("crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [out]}, infer_shape=False)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Paddle's layers/nn.py row_conv (lookahead convolution)."""
    helper = LayerHelper("row_conv")
    w = helper.create_parameter(
        param_attr,
        shape=[future_context_size + 1, int(input.shape[-1])],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out, act)


# -- the layers of the nn bucket's rules (nn.py:131-1234 of the reference) --

def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name, act=act)
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    dilation = ([dilation, dilation] if isinstance(dilation, int)
                else list(dilation))
    padding = ([padding, padding] if isinstance(padding, int)
               else list(padding))
    if filter_size is None:
        assert output_size is not None
        output_size = ([output_size, output_size]
                       if isinstance(output_size, int) else list(output_size))
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0]
             - 1) // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1]
             - 1) // dilation[1] + 1]
    elif isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    channels = input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[channels, num_filters // groups] + filter_size,
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "padding_algorithm": "EXPLICIT"})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        if b is not None:
            pre = helper.create_variable_for_type_inference(input.dtype)
            helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                             outputs={"Out": [pre]}, attrs={"axis": 1})
            out = pre
    return helper.append_activation(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", name=name, act=act)
    fs = ([filter_size] * 3 if isinstance(filter_size, int)
          else list(filter_size))
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    dilation = [dilation] * 3 if isinstance(dilation, int) else list(dilation)
    channels = input.shape[1]
    w = helper.create_parameter(param_attr,
                                shape=[num_filters, channels // groups] + fs,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv3d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "padding_algorithm": "EXPLICIT"})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        if b is not None:
            pre = helper.create_variable_for_type_inference(input.dtype)
            helper.append_op("elementwise_add", inputs={"X": [out], "Y": [b]},
                             outputs={"Out": [pre]}, attrs={"axis": 1})
            out = pre
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_size = 1
    for s in input.shape[begin_norm_axis:]:
        norm_size *= int(s)
    inputs = {"X": [input]}
    if scale:
        s_p = helper.create_parameter(param_attr, shape=[norm_size],
                                      dtype=dtype,
                                      default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s_p]
    if shift:
        b_p = helper.create_parameter(bias_attr, shape=[norm_size],
                                      dtype=dtype, is_bias=True)
        if b_p is not None:
            inputs["Bias"] = [b_p]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = input.shape[1]
    dtype = input.dtype
    inputs = {"X": [input]}
    if param_attr is not False:
        scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                        default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [scale]
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                       is_bias=True)
        inputs["Bias"] = [bias]
    y = helper.create_variable_for_type_inference(dtype)
    sm = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    sv = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": [y], "SavedMean": [sm],
                              "SavedVariance": [sv]},
                     attrs={"epsilon": epsilon})
    return y


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", name=name, act=act)
    c = input.shape[1]
    dtype = input.dtype
    inputs = {"X": [input]}
    if param_attr is not False:
        scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                        default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [scale]
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                       is_bias=True)
        inputs["Bias"] = [bias]
    y = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(y, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8",
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0, "fix_seed": seed is not None,
                            "dropout_implementation": dropout_implementation})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, shape=alpha_shape,
                                    dtype=x.dtype,
                                    default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None, axis=1):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("maxout", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"groups": groups, "axis": axis})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    ins = {"X": [label]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist]
    helper.append_op("label_smooth", inputs=ins, outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col patches (reference layers/nn.py unfold; unfold_op.cc)."""
    pair = lambda v: [v, v] if isinstance(v, int) else list(v)
    helper = LayerHelper("unfold", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("unfold", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"kernel_sizes": pair(kernel_sizes),
                            "strides": pair(strides),
                            "paddings": pair(paddings),
                            "dilations": pair(dilations)})
    return out


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 name=None):
    op = ("bilinear_interp_v2" if resample.upper() == "BILINEAR"
          else "nearest_interp_v2")
    helper = LayerHelper("image_resize", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    attrs = {}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    else:
        attrs["out_h"] = attrs["out_w"] = -1
        attrs["scale"] = scale
    helper.append_op(op, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "NEAREST", name)


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "BILINEAR", name)


def interpolate(input, out_shape=None, scale=None, mode="nearest",
                align_corners=False, name=None):
    return image_resize(input, out_shape, scale,
                        "BILINEAR" if mode == "bilinear" else "NEAREST", name)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """reference layers/nn.py bilinear_tensor_product: out_k = x W_k y^T
    (+ bias, + act), weight (size, x_dim, y_dim)."""
    helper = LayerHelper("bilinear_tensor_product", name=name)
    w = helper.create_parameter(
        param_attr, shape=[size, int(x.shape[1]), int(y.shape[1])],
        dtype=x.dtype)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("bilinear_tensor_product",
                     inputs={"X": [x], "Y": [y], "Weight": [w]},
                     outputs={"Out": [out]})
    out = helper.append_bias_op(out, bias_attr)
    return helper.append_activation(out, act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """reference layers/nn.py spectral_norm: weight normalized by its
    largest singular value via power iteration; u/v are persistable
    power-iteration state."""
    helper = LayerHelper("spectral_norm", name=name)
    shape = [int(s) for s in weight.shape]
    h = shape[dim]
    w = 1
    for i, s in enumerate(shape):
        if i != dim:
            w *= s
    from ..initializer import NormalInitializer

    u = helper.create_parameter(
        None, shape=[h], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    v = helper.create_parameter(
        None, shape=[w], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype=weight.dtype)
    # U/V outputs alias the persistable vectors so the power iteration
    # REFINES across steps (the kernel persists them only when these
    # slots are declared — same pattern as batch_norm's MeanOut)
    helper.append_op("spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out], "U": [u], "V": [v]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              enable_scale_and_shift=False, name=None, moving_mean_name=None,
              moving_variance_name=None, do_model_average_for_mean_and_var=True,
              slot_dim=-1, summary_decay_rate=0.9999999):
    """reference layers/nn.py data_norm: normalization by accumulated
    batch statistics (CTR models); the three stat tensors are
    persistable state initialized like the reference (size ~0, sum 0,
    square-sum ~0 -> initial mean 0 / scale 1)."""
    from ..initializer import ConstantInitializer

    if enable_scale_and_shift:
        raise NotImplementedError(
            "data_norm(enable_scale_and_shift=True) is not supported "
            "on this build; apply an explicit fc/elementwise affine "
            "after data_norm instead (silently dropping the learnable "
            "affine would change model capacity)")
    helper = LayerHelper("data_norm", name=name)
    c = int(input.shape[-1])
    batch_size = helper.create_parameter(
        None, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1e4))
    batch_sum = helper.create_parameter(
        None, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(0.0))
    batch_square_sum = helper.create_parameter(
        None, shape=[c], dtype=input.dtype,
        default_initializer=ConstantInitializer(1e4))
    for t in (batch_size, batch_sum, batch_square_sum):
        t.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    # the *Out slots alias the persistable stats so they ACCUMULATE
    # across steps (the kernel only writes them when declared)
    helper.append_op("data_norm",
                     inputs={"X": [input], "BatchSize": [batch_size],
                             "BatchSum": [batch_sum],
                             "BatchSquareSum": [batch_square_sum]},
                     outputs={"Y": [out],
                              "BatchSizeOut": [batch_size],
                              "BatchSumOut": [batch_sum],
                              "BatchSquareSumOut": [batch_square_sum]},
                     attrs={"epsilon": epsilon})
    return helper.append_activation(out, act)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """reference layers/nn.py nce (noise-contrastive estimation loss)."""
    if sampler != "uniform" or custom_dist is not None:
        raise NotImplementedError(
            f"nce sampler={sampler!r}/custom_dist is not supported on "
            "this build (the lowering draws uniform noise); running a "
            "different distribution silently would change the loss")
    helper = LayerHelper("nce", name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("nce",
                     inputs={"Input": [input], "Label": [label],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Cost": [cost]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples or 10,
                            "seed": seed, "sampler": 0},
                     infer_shape=False)
    return cost


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None,
                  name=None):
    """reference static/nn/common.py deform_conv2d over the
    deformable_conv lowering."""
    helper = LayerHelper("deformable_conv", name=name)
    c_in = int(x.shape[1])
    k = [filter_size, filter_size] if isinstance(filter_size, int) \
        else list(filter_size)
    w = helper.create_parameter(
        weight_attr, shape=[num_filters, c_in // groups] + k,
        dtype=x.dtype)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    pair = lambda v: [v, v] if isinstance(v, int) else list(v)
    ins = {"Input": [x], "Offset": [offset], "Filter": [w]}
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op("deformable_conv", inputs=ins,
                     outputs={"Output": [out]},
                     attrs={"strides": pair(stride),
                            "paddings": pair(padding),
                            "dilations": pair(dilation),
                            "groups": groups,
                            "deformable_groups": deformable_groups,
                            "im2col_step": im2col_step})
    # per-FILTER bias on the channel axis (append_bias_op would size
    # it by the trailing spatial dim and broadcast per column)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=x.dtype, is_bias=True)
        if b is not None:
            pre = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op("elementwise_add",
                             inputs={"X": [out], "Y": [b]},
                             outputs={"Out": [pre]}, attrs={"axis": 1})
            out = pre
    return out


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None,
                     data_format="NCDHW"):
    """reference layers/nn.py conv3d_transpose over the
    conv3d_transpose lowering."""
    helper = LayerHelper("conv3d_transpose", name=name, act=act)
    trip = lambda v: [v] * 3 if isinstance(v, int) else list(v)
    stride, dilation, padding = trip(stride), trip(dilation), trip(padding)
    assert filter_size is not None, \
        "conv3d_transpose requires filter_size on this build"
    if output_size is not None:
        raise NotImplementedError(
            "conv3d_transpose(output_size=...) is not supported here "
            "(the reference uses it to disambiguate stride>1 output "
            "shapes); size the output via filter_size/stride/padding")
    filter_size = trip(filter_size)
    channels = int(input.shape[1])
    w = helper.create_parameter(
        param_attr, shape=[channels, num_filters // groups] + filter_size,
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv3d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "padding_algorithm": "EXPLICIT",
                            "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        if b is not None:
            pre = helper.create_variable_for_type_inference(input.dtype)
            helper.append_op("elementwise_add",
                             inputs={"X": [out], "Y": [b]},
                             outputs={"Out": [pre]}, attrs={"axis": 1})
            out = pre
    return helper.append_activation(out, act)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Debug print op (reference layers/control_flow.py Print:284): passes
    `input` through and prints it on the host when the op runs
    (ops/control_flow_ops.py `print`)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", inputs={"In": input},
                     outputs={"Out": out},
                     attrs={"message": message or "",
                            "first_n": first_n,
                            "summarize": summarize})
    return out


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python function as an op: `func` gets numpy copies of `x`
    and returns arrays for `out`, vars the caller created with static
    shapes and dtypes.  A backward_func is not supported, as in the
    reference: the outputs are stop_gradient."""
    if backward_func is not None:
        raise NotImplementedError(
            "py_func backward_func is not supported; compute the "
            "backward in-graph or mark outputs stop_gradient")
    from ...ops.misc_ops import register_py_func

    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        o.stop_gradient = True
    fid = register_py_func(func)
    helper.append_op("py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)},
                     attrs={"forward_callable_id": fid},
                     infer_shape=False)
    return out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=0):
    """Streaming AUC: returns (auc_out, [auc_out], [stat_pos,
    stat_neg]), the histograms persistable global vars that each run
    updates."""
    from .tensor import create_global_var

    helper = LayerHelper("auc")
    n = num_thresholds + 1
    stat_pos = create_global_var([n], 0.0, "float32", persistable=True,
                                 name=helper.name + ".stat_pos")
    stat_neg = create_global_var([n], 0.0, "float32", persistable=True,
                                 name=helper.name + ".stat_neg")
    auc_out = helper.create_variable_for_type_inference(
        dtype="float32", stop_gradient=True)
    helper.append_op(
        "auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"num_thresholds": num_thresholds,
               "slide_steps": slide_steps, "curve": curve},
        infer_shape=False)
    return auc_out, [auc_out], [stat_pos, stat_neg]


def multi_box_head(inputs, image, base_size, num_classes,
                   aspect_ratios, min_ratio=None, max_ratio=None,
                   min_sizes=None, max_sizes=None, steps=None,
                   step_w=None, step_h=None, offset=0.5, variance=None,
                   flip=True, clip=False, kernel_size=1, pad=0,
                   stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """The SSD head (Paddle's layers/detection.py multi_box_head): per
    feature map a conv head for the box locations, one for the class
    confidences and a prior_box grid, each concatenated over the maps.
    Returns (mbox_locs, mbox_confs, prior_boxes, variances)."""
    from .detection import prior_box as _prior_box
    from .tensor import concat

    n_maps = len(inputs)
    if min_sizes is None:
        # reference ratio schedule: evenly spaced in [min_ratio,
        # max_ratio] percent of base_size, first map at half min
        assert min_ratio is not None and max_ratio is not None
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / max(1, n_maps - 2))
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    variance = list(variance or (0.1, 0.1, 0.2, 0.2))
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i]
        mins = [mins] if not isinstance(mins, (list, tuple)) else mins
        maxs = ([maxs] if maxs is not None
                and not isinstance(maxs, (list, tuple)) else maxs)
        ar = [ar] if not isinstance(ar, (list, tuple)) else list(ar)
        box, var = _prior_box(
            x, image, mins, maxs, ar, variance, flip, clip,
            steps=((lambda sv: [sv, sv] if not isinstance(
                sv, (list, tuple)) else list(sv))(steps[i])
                if steps else
                [step_w[i] if step_w else 0.0,
                 step_h[i] if step_h else 0.0]),
            offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        # priors per spatial cell, computed like the reference op's
        # ExpandAspectRatios (prior_box_op.h): [1.0] + each new ar
        # (+ its flip), times min sizes, plus one per max size
        import math as _math

        # NB math.fabs, not abs: this module defines a layer named
        # `abs` that shadows the builtin
        expanded = [1.0]
        for a in ar:
            if not any(_math.fabs(a - e) < 1e-6 for e in expanded):
                expanded.append(a)
                if flip and _math.fabs(a - 1.0) > 1e-6:
                    expanded.append(1.0 / a)
        num_priors = len(expanded) * len(mins) + len(maxs or [])
        loc = conv2d(x, num_priors * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(x, num_priors * num_classes, kernel_size,
                      stride=stride, padding=pad)
        # NCHW -> (N, priors, 4 / classes)
        loc = transpose(loc, [0, 2, 3, 1])
        conf = transpose(conf, [0, 2, 3, 1])
        locs.append(reshape(loc, [0, -1, 4]))
        confs.append(reshape(conf, [0, -1, num_classes]))
        boxes_all.append(reshape(box, [-1, 4]))
        vars_all.append(reshape(var, [-1, 4]))
    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    prior_boxes = concat(boxes_all, axis=0)
    box_vars = concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, prior_boxes, box_vars
