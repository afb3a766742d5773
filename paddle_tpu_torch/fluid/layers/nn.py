"""Neural-network layers (counterpart of paddle_tpu/fluid/layers/nn.py):
the layers of the ported programs (fc, embedding, conv2d, the pools,
batch_norm), the activation, math, compare, logical, reduce and
elementwise wrappers, and the CTC and CRF layers.  Each layer creates
its parameters through LayerHelper and appends ops; the work is in the
op rules (paddle_tpu_torch/ops/).  The reference's layers whose rules
are not ported yet are left out (ROADMAP queue 1 items 6 and 8)."""

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
