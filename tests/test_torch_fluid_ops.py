"""Every op rule of the port against the reference's rule of the same op
type, one op at a time on the CPU: the same numpy inputs go through
`paddle_tpu.ops.registry`'s rule (its gradient by `jax.vjp` over that
rule) and through a one-op block of the port's registry followed by the
`<type>_grad` op that `append_backward` would emit (so the port's generic
autograd gradient is what is tested), with the same cotangents.  Forward
outputs and input gradients are compared in float32, and again in float64
under `jax.enable_x64` for the rules that take it.

Tolerances.  F32 (rtol 2e-5, atol 2e-6): one op in float32, whose only
difference is summation order (convolution and matmul sums of at most a
few hundred products, batch statistics over at most 128 values).  F64
(rtol 1e-11, atol 1e-12): the same in float64.  The two random ops draw
other bits than JAX's by design; they are held to their distribution
instead: over 40000 draws the sample mean and standard deviation lie
within 5 standard errors of the attrs' (a false alarm once in ~10^6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid import framework as JFW
from paddle_tpu.ops import registry as JREG

from paddle_tpu_torch.fluid import framework as TFW
from paddle_tpu_torch.ops import registry as TREG

F32 = dict(rtol=2e-5, atol=2e-6)
F64 = dict(rtol=1e-11, atol=1e-12)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype(np.float64)


def _probs(n, c, seed=0):
    z = _f(n, c, seed=seed)
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _ids(shape, high, seed=0):
    return _rng(seed).randint(0, high, shape).astype(np.int64)


# name -> (op type, {slot: [numpy]}, attrs, output slots that get
# cotangents (empty: forward only))
CASES = {
    "conv2d_pad1": ("conv2d", {"Input": [_f(2, 3, 8, 8)],
                               "Filter": [_f(4, 3, 3, 3, seed=1)]},
                    {"strides": [1, 1], "paddings": [1, 1],
                     "dilations": [1, 1], "groups": 1,
                     "padding_algorithm": "EXPLICIT",
                     "data_format": "NCHW"}, ["Output"]),
    "conv2d_stride2_same": ("conv2d", {"Input": [_f(2, 3, 9, 9)],
                                       "Filter": [_f(4, 3, 3, 3, seed=1)]},
                            {"strides": [2, 2], "paddings": [0, 0],
                             "dilations": [1, 1], "groups": 1,
                             "padding_algorithm": "SAME",
                             "data_format": "NCHW"}, ["Output"]),
    "conv2d_asym_nhwc": ("conv2d", {"Input": [_f(2, 7, 7, 4)],
                                    "Filter": [_f(6, 2, 3, 3, seed=1)]},
                         {"strides": [2, 1], "paddings": [0, 1, 1, 0],
                          "dilations": [1, 2], "groups": 2,
                          "padding_algorithm": "EXPLICIT",
                          "data_format": "NHWC"}, ["Output"]),
    "pool2d_max": ("pool2d", {"X": [_f(2, 3, 9, 9)]},
                   {"pooling_type": "max", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1],
                    "global_pooling": False, "adaptive": False,
                    "ceil_mode": False, "exclusive": True,
                    "padding_algorithm": "EXPLICIT",
                    "data_format": "NCHW"}, ["Out"]),
    "pool2d_avg_exclusive": ("pool2d", {"X": [_f(2, 3, 8, 8)]},
                             {"pooling_type": "avg", "ksize": [3, 3],
                              "strides": [2, 2], "paddings": [1, 1],
                              "global_pooling": False, "adaptive": False,
                              "ceil_mode": False, "exclusive": True,
                              "padding_algorithm": "EXPLICIT",
                              "data_format": "NCHW"}, ["Out"]),
    "pool2d_avg_inclusive_asym": ("pool2d", {"X": [_f(2, 3, 8, 8)]},
                                  {"pooling_type": "avg", "ksize": [2, 2],
                                   "strides": [2, 2],
                                   "paddings": [0, 1, 1, 0],
                                   "global_pooling": False,
                                   "adaptive": False, "ceil_mode": False,
                                   "exclusive": False,
                                   "padding_algorithm": "EXPLICIT",
                                   "data_format": "NCHW"}, ["Out"]),
    "pool2d_adaptive_1x1": ("pool2d", {"X": [_f(2, 3, 5, 5)]},
                            {"pooling_type": "avg", "ksize": [1, 1],
                             "strides": [1, 1], "paddings": [0, 0],
                             "global_pooling": False, "adaptive": True,
                             "ceil_mode": False, "exclusive": True,
                             "padding_algorithm": "EXPLICIT",
                             "data_format": "NCHW"}, ["Out"]),
    "pool2d_adaptive_3x3_max": ("pool2d", {"X": [_f(2, 3, 8, 7)]},
                                {"pooling_type": "max", "ksize": [3, 3],
                                 "strides": [1, 1], "paddings": [0, 0],
                                 "global_pooling": False, "adaptive": True,
                                 "ceil_mode": False, "exclusive": True,
                                 "padding_algorithm": "EXPLICIT",
                                 "data_format": "NCHW"}, ["Out"]),
    "pool2d_global_max": ("pool2d", {"X": [_f(2, 3, 4, 4)]},
                          {"pooling_type": "max", "ksize": [2, 2],
                           "strides": [1, 1], "paddings": [0, 0],
                           "global_pooling": True, "adaptive": False,
                           "ceil_mode": False, "exclusive": True,
                           "padding_algorithm": "EXPLICIT",
                           "data_format": "NCHW"}, ["Out"]),
    "batch_norm_train": ("batch_norm", {
        "X": [_f(4, 3, 4, 4) * 2 + 1], "Scale": [_f(3, seed=1)],
        "Bias": [_f(3, seed=2)], "Mean": [_f(3, seed=3)],
        "Variance": [np.abs(_f(3, seed=4)) + 0.5]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
         "data_layout": "NCHW", "use_global_stats": False}, ["Y"]),
    "batch_norm_train_2d_nhwc": ("batch_norm", {
        "X": [_f(8, 5)], "Scale": [_f(5, seed=1)], "Bias": [_f(5, seed=2)],
        "Mean": [_f(5, seed=3)], "Variance": [np.abs(_f(5, seed=4)) + 0.5]},
        {"momentum": 0.8, "epsilon": 1e-3, "is_test": False,
         "data_layout": "NHWC", "use_global_stats": False}, ["Y"]),
    "batch_norm_is_test": ("batch_norm", {
        "X": [_f(2, 3, 4, 4)], "Scale": [_f(3, seed=1)],
        "Bias": [_f(3, seed=2)], "Mean": [_f(3, seed=3)],
        "Variance": [np.abs(_f(3, seed=4)) + 0.5]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": True,
         "data_layout": "NCHW", "use_global_stats": False}, ["Y"]),
    "relu": ("relu", {"X": [_f(3, 5)]}, {}, ["Out"]),
    "tanh": ("tanh", {"X": [_f(3, 5)]}, {}, ["Out"]),
    "sigmoid": ("sigmoid", {"X": [_f(3, 5)]}, {}, ["Out"]),
    "square": ("square", {"X": [_f(3, 5)]}, {}, ["Out"]),
    "elementwise_add": ("elementwise_add", {"X": [_f(2, 3, 5)],
                                            "Y": [_f(5, seed=1)]},
                        {"axis": -1}, ["Out"]),
    "elementwise_add_axis1": ("elementwise_add", {"X": [_f(2, 3, 4, 4)],
                                                  "Y": [_f(3, seed=1)]},
                              {"axis": 1}, ["Out"]),
    "elementwise_sub": ("elementwise_sub", {"X": [_f(4, 1)],
                                            "Y": [_f(4, 1, seed=1)]},
                        {"axis": -1}, ["Out"]),
    "mul": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(12, 5, seed=1)]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, ["Out"]),
    "mul_col2": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5, seed=1)]},
                 {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"]),
    "softmax": ("softmax", {"X": [_f(3, 6)]}, {"axis": -1}, ["Out"]),
    "cross_entropy": ("cross_entropy", {
        "X": [_probs(5, 6)],
        "Label": [np.array([[1], [0], [-100], [5], [2]], np.int64)]},
        {"soft_label": False, "ignore_index": -100}, ["Y"]),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy", {
        "Logits": [_f(5, 6)],
        "Label": [np.array([[1], [0], [3], [5], [2]], np.int64)]},
        {"soft_label": False, "ignore_index": -100, "axis": -1,
         "numeric_stable_mode": True}, ["Loss", "Softmax"]),
    "softmax_with_cross_entropy_soft": ("softmax_with_cross_entropy", {
        "Logits": [_f(4, 6)], "Label": [_probs(4, 6, seed=1)]},
        {"soft_label": True, "ignore_index": -100, "axis": -1,
         "numeric_stable_mode": True}, ["Loss"]),
    "mean": ("mean", {"X": [_f(3, 4)]}, {}, ["Out"]),
    "reduce_mean_dim": ("reduce_mean", {"X": [_f(3, 4, 5)]},
                        {"dim": [1], "keep_dim": False,
                         "reduce_all": False}, ["Out"]),
    "reduce_mean_all": ("reduce_mean", {"X": [_f(3, 4)]},
                        {"dim": [0], "keep_dim": False,
                         "reduce_all": True}, ["Out"]),
    "top_k_v2_ties": ("top_k_v2", {"X": [np.array(
        [[1., 3., 3., 0., 3., 2.], [5., 5., 1., 5., 0., 5.]])]},
        {"k": 3, "axis": -1, "largest": True, "sorted": True}, ["Out"]),
    "accuracy": ("accuracy", {
        "Out": [_probs(5, 6)], "Indices": [_ids((5, 2), 6)],
        "Label": [_ids((5, 1), 6, seed=1)]}, {}, []),
    "lookup_table_v2": ("lookup_table_v2", {
        "W": [_f(10, 4)], "Ids": [np.array([[1, 3], [3, 9], [0, 1]],
                                           np.int64)]},
        {"padding_idx": -1, "is_sparse": False}, ["Out"]),
    "lookup_table_v2_padding": ("lookup_table_v2", {
        "W": [_f(10, 4)], "Ids": [np.array([[1, 3], [3, 9], [0, 1]],
                                           np.int64)]},
        {"padding_idx": 3, "is_sparse": False}, ["Out"]),
    "concat": ("concat", {"X": [_f(2, 3), _f(2, 1, seed=1),
                                _f(2, 4, seed=2)]}, {"axis": 1}, ["Out"]),
    "reshape2": ("reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [0, -1]},
                 ["Out"]),
    "fill_constant": ("fill_constant", {}, {"shape": [2, 3],
                                            "dtype": "float32",
                                            "value": 1.5}, []),
    "fill_constant_int64": ("fill_constant", {}, {"shape": [4],
                                                  "dtype": "int64",
                                                  "value": 7.0}, []),
    "scale": ("scale", {"X": [_f(3, 4)]},
              {"scale": 2.0, "bias": 0.5, "bias_after_scale": True},
              ["Out"]),
    "scale_bias_first": ("scale", {"X": [_f(3, 4)]},
                         {"scale": -3.0, "bias": 0.25,
                          "bias_after_scale": False}, ["Out"]),
    "sum": ("sum", {"X": [_f(3, 4), _f(3, 4, seed=1), _f(3, 4, seed=2)]},
            {}, ["Out"]),
    "assign": ("assign", {"X": [_f(3, 4)]}, {}, ["Out"]),
    "sgd": ("sgd", {"Param": [_f(4, 3)], "Grad": [_f(4, 3, seed=1)],
                    "LearningRate": [np.array([0.1])]}, {}, []),
    "momentum": ("momentum", {
        "Param": [_f(4, 3)], "Grad": [_f(4, 3, seed=1)],
        "Velocity": [_f(4, 3, seed=2)], "LearningRate": [np.array([0.1])]},
        {"mu": 0.9, "use_nesterov": False}, []),
    "momentum_l2_nesterov": ("momentum", {
        "Param": [_f(4, 3)], "Grad": [_f(4, 3, seed=1)],
        "Velocity": [_f(4, 3, seed=2)], "LearningRate": [np.array([0.1])]},
        {"mu": 0.8, "use_nesterov": True,
         "regularization_method": "l2_decay",
         "regularization_coeff": 1e-2}, []),
    "adam": ("adam", {
        "Param": [_f(4, 3)], "Grad": [_f(4, 3, seed=1)],
        "LearningRate": [np.array([0.01])],
        "Moment1": [_f(4, 3, seed=2) * 0.1],
        "Moment2": [np.abs(_f(4, 3, seed=3)) * 0.1],
        "Beta1Pow": [np.array([0.9 ** 3])],
        "Beta2Pow": [np.array([0.999 ** 3])]},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, []),
}


def _pos(*shape, seed=0):
    return np.abs(_f(*shape, seed=seed)) + 0.5


def _spd(n, seed=0):
    a = _f(n, n, seed=seed)
    return a @ a.T + n * np.eye(n)


def _special(*shape, seed=0):
    x = _f(*shape, seed=seed)
    x.flat[1], x.flat[3], x.flat[4] = np.inf, -np.inf, np.nan
    return x


_NEG_INTS = np.array([-7, 7, -7, 7, 5, -5, 0, -1], np.int64)
_NEG_DIVS = np.array([3, -3, -3, 3, -2, 2, 4, 3], np.int64)
_TIES = np.array([[1., 3., 3., 0., 3., 2.], [5., 5., 1., 5., 0., 5.]])
_BOOLS = np.array([[True, False, True], [True, True, True]])


def _unary_case(op, x):
    return (op, {"X": [x]}, {}, ["Out"])


def _binary_case(op, x, y, axis=-1, grads=True):
    return (op, {"X": [x], "Y": [y]}, {"axis": axis},
            ["Out"] if grads else [])


def _reduce_case(op, x, dim, keep=False, all_=False, grads=True):
    return (op, {"X": [x]}, {"dim": dim, "keep_dim": keep,
                             "reduce_all": all_}, ["Out"] if grads else [])


# the rules the 2.x tensor API reaches (math_ops.py and tensor_ops.py)
CASES.update({
    # -- elementwise binary: numpy broadcasting and Paddle's axis ------------
    "elementwise_mul": _binary_case("elementwise_mul", _f(2, 3, 4),
                                    _f(3, 1, seed=1), axis=1),
    "elementwise_div": _binary_case("elementwise_div", _f(2, 3),
                                    _pos(2, 3, seed=1)),
    "elementwise_min": _binary_case("elementwise_min", _f(2, 3, 4),
                                    _f(4, seed=1)),
    "elementwise_max": _binary_case("elementwise_max", _f(2, 3, 4),
                                    _f(3, 4, seed=1)),
    "elementwise_pow": _binary_case("elementwise_pow", _pos(3, 4),
                                    _f(3, 4, seed=1)),
    "elementwise_mod": _binary_case("elementwise_mod", _f(3, 4) * 5,
                                    _pos(3, 4, seed=1)),
    "elementwise_mod_negative_ints": _binary_case(
        "elementwise_mod", _NEG_INTS, _NEG_DIVS, grads=False),
    "elementwise_floordiv_negative_ints": _binary_case(
        "elementwise_floordiv", _NEG_INTS, _NEG_DIVS, grads=False),
    "elementwise_floordiv": _binary_case("elementwise_floordiv",
                                         _f(3, 4) * 5, _pos(3, 4, seed=1),
                                         grads=False),
    # -- products --------------------------------------------------------------
    "matmul_v2_batched": ("matmul_v2", {"X": [_f(2, 3, 4)],
                                        "Y": [_f(4, 5, seed=1)]},
                          {"trans_x": False, "trans_y": False}, ["Out"]),
    "matmul_v2_trans_y": ("matmul_v2", {"X": [_f(2, 1, 4)],
                                        "Y": [_f(2, 6, 4, seed=1)]},
                          {"trans_x": False, "trans_y": True}, ["Out"]),
    "matmul_v2_trans_x_vector": ("matmul_v2", {"X": [_f(4, 3)],
                                               "Y": [_f(4, seed=1)]},
                                 {"trans_x": True, "trans_y": False},
                                 ["Out"]),
    "bmm": ("bmm", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 5, seed=1)]}, {},
            ["Out"]),
    "dot": ("dot", {"X": [_f(3, 4)], "Y": [_f(3, 4, seed=1)]}, {}, ["Out"]),
    "mv": ("mv", {"X": [_f(3, 4)], "Vec": [_f(4, seed=1)]}, {}, ["Out"]),
    "addmm": ("addmm", {"Input": [_f(3, 5)], "X": [_f(3, 4, seed=1)],
                        "Y": [_f(4, 5, seed=2)]},
              {"Alpha": 0.5, "Beta": -2.0}, ["Out"]),
    "kron": ("kron", {"X": [_f(2, 3)], "Y": [_f(3, 2, seed=1)]}, {},
             ["Out"]),
    "trace_offset": ("trace", {"Input": [_f(3, 4, 2)]},
                     {"offset": 1, "axis1": 0, "axis2": 1}, ["Out"]),
    # -- reductions ------------------------------------------------------------
    "reduce_sum": _reduce_case("reduce_sum", _f(2, 3, 4), [0, -1], True),
    "reduce_sum_all": _reduce_case("reduce_sum", _f(2, 3), [], all_=True),
    "reduce_max": _reduce_case("reduce_max", _f(2, 3, 4), [1]),
    "reduce_min_all": _reduce_case("reduce_min", _f(3, 4), [], True, True),
    "reduce_prod": _reduce_case("reduce_prod", _f(2, 3, 4), [0, 2]),
    "reduce_any": _reduce_case("reduce_any", _BOOLS, [1], grads=False),
    "reduce_all": _reduce_case("reduce_all", _BOOLS, [0, 1], True,
                               grads=False),
    "logsumexp": ("logsumexp", {"X": [_f(2, 3, 4)]},
                  {"axis": [1, 2], "keepdim": True, "reduce_all": False},
                  ["Out"]),
    "logsumexp_all": ("logsumexp", {"X": [_f(3, 4)]},
                      {"axis": [], "keepdim": False, "reduce_all": True},
                      ["Out"]),
    "frobenius_norm": ("frobenius_norm", {"X": [_f(2, 3, 4)]},
                       {"dim": [-2, -1], "keep_dim": False,
                        "reduce_all": False}, ["Out"]),
    "frobenius_norm_every_axis": ("frobenius_norm", {"X": [_f(3, 4)]},
                                  {"dim": [0, 1], "keep_dim": True,
                                   "reduce_all": True}, ["Out"]),
    # -- unary -------------------------------------------------------------------
    **{op: _unary_case(op, _f(3, 4)) for op in (
        "exp", "expm1", "abs", "ceil", "floor", "round", "sin", "cos",
        "tan", "atan", "sinh", "cosh", "sign", "erf")},
    **{op: _unary_case(op, _pos(3, 4)) for op in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal")},
    **{op: _unary_case(op, np.tanh(_f(3, 4))) for op in ("asin", "acos")},
    "logical_not": ("logical_not", {"X": [_BOOLS]}, {}, []),
    **{op: ("isfinite_v2" if op == "isfinite" else op + "_v2",
            {"X": [_special(3, 4)]}, {}, [])
       for op in ("isfinite", "isinf", "isnan")},
    "pow": ("pow", {"X": [_pos(3, 4)]}, {"factor": 2.5}, ["Out"]),
    "stanh": ("stanh", {"X": [_f(3, 4)]}, {"scale_a": 0.5, "scale_b": 2.0},
              ["Out"]),
    "clip": ("clip", {"X": [_f(3, 4)]}, {"min": -0.5, "max": 0.7}, ["Out"]),
    "cast_float16": ("cast", {"X": [_f(3, 4)]}, {"out_dtype": "float16"},
                     ["Out"]),
    "cast_int32": ("cast", {"X": [_f(3, 4) * 4]}, {"out_dtype": "int32"},
                   []),
    "cumsum": ("cumsum", {"X": [_f(3, 4)]}, {"axis": 1}, ["Out"]),
    "cumsum_flatten_exclusive_reverse": (
        "cumsum", {"X": [_f(3, 4)]},
        {"axis": -1, "flatten": True, "exclusive": True, "reverse": True},
        ["Out"]),
    "cumprod": ("cumprod", {"X": [_f(3, 4)]}, {"dim": 0}, ["Out"]),
    "cholesky": ("cholesky", {"X": [_spd(4)]}, {"upper": False}, ["Out"]),
    "cholesky_upper": ("cholesky", {"X": [_spd(3, seed=1)]},
                       {"upper": True}, ["Out"]),
    "histogram_data_range": ("histogram", {"X": [_f(4, 5)]},
                             {"bins": 6, "min": 0, "max": 0}, []),
    "histogram_fixed_range": ("histogram", {"X": [_f(4, 5)]},
                              {"bins": 4, "min": -1, "max": 1}, []),
    # -- creation ------------------------------------------------------------------
    "fill_any_like": ("fill_any_like", {"X": [_f(2, 3)]},
                      {"value": 2.5, "dtype": None}, []),
    "fill_any_like_int": ("fill_any_like", {"X": [_f(2, 3)]},
                          {"value": 3.0, "dtype": "int64"}, []),
    "eye": ("eye", {}, {"num_rows": 3, "num_columns": 4,
                        "dtype": "float32"}, []),
    "range_attrs": ("range", {}, {"start": 1, "end": 11, "step": 3,
                                  "dtype": "int64"}, []),
    "range_inputs": ("range", {"Start": [np.array(0.5)],
                               "End": [np.array(3.0)],
                               "Step": [np.array(0.75)]},
                     {"dtype": "float32"}, []),
    "linspace": ("linspace", {}, {"start": -1.0, "stop": 2.0, "num": 7,
                                  "dtype": "float32"}, []),
    "increment": ("increment", {"X": [_f(1)]}, {"step": 2.0}, ["Out"]),
    # -- manipulation ----------------------------------------------------------------
    "transpose2": ("transpose2", {"X": [_f(2, 3, 4)]}, {"axis": [1, 2, 0]},
                   ["Out"]),
    "squeeze2_axes": ("squeeze2", {"X": [_f(2, 1, 3, 1)]},
                      {"axes": [1, -1]}, ["Out"]),
    "squeeze2_all": ("squeeze2", {"X": [_f(1, 3, 1)]}, {"axes": []},
                     ["Out"]),
    "unsqueeze2": ("unsqueeze2", {"X": [_f(2, 3)]}, {"axes": [0, -1]},
                   ["Out"]),
    "flatten_contiguous_range": ("flatten_contiguous_range",
                                 {"X": [_f(2, 3, 4, 5)]},
                                 {"start_axis": 1, "stop_axis": 2},
                                 ["Out"]),
    "stack": ("stack", {"X": [_f(2, 3), _f(2, 3, seed=1),
                              _f(2, 3, seed=2)]}, {"axis": 1}, ["Y"]),
    "unstack": ("unstack", {"X": [_f(3, 2, 4)]}, {"axis": 1, "num": 2},
                ["Y"]),
    "unbind": ("unbind", {"X": [_f(3, 2, 4)]}, {"axis": -1}, ["Out"]),
    "split_sections": ("split", {"X": [_f(6, 3)]},
                       {"axis": 0, "sections": [2, -1, 1]}, ["Out"]),
    "split_num": ("split", {"X": [_f(2, 6)]}, {"axis": 1, "num": 3},
                  ["Out"]),
    "slice": ("slice", {"Input": [_f(4, 3, 5)]},
              {"axes": [0, 2], "starts": [-3, 1], "ends": [100, -1]},
              ["Out"]),
    "slice_decrease": ("slice", {"Input": [_f(4, 3)]},
                       {"axes": [0], "starts": [2], "ends": [3],
                        "decrease_axis": [0]}, ["Out"]),
    "strided_slice": ("strided_slice", {"Input": [_f(6, 5)]},
                      {"axes": [0, 1], "starts": [1, 4], "ends": [6, 0],
                       "strides": [2, -1]}, ["Out"]),
    "expand_v2": ("expand_v2", {"X": [_f(3, 1)]}, {"shape": [2, -1, 4]},
                  ["Out"]),
    "expand_as_v2": ("expand_as_v2", {"X": [_f(1, 4)]},
                     {"target_shape": [3, 4]}, ["Out"]),
    "tile": ("tile", {"X": [_f(2, 3)]}, {"repeat_times": [2, 1, 3]},
             ["Out"]),
    "flip": ("flip", {"X": [_f(2, 3, 4)]}, {"axis": [0, -1]}, ["Out"]),
    "roll_axes": ("roll", {"X": [_f(3, 4)]},
                  {"shifts": [1, -2], "axis": [0, 1]}, ["Out"]),
    "roll_flat": ("roll", {"X": [_f(3, 4)]}, {"shifts": [5], "axis": []},
                  ["Out"]),
    "tril": ("tril_triu", {"X": [_f(4, 5)]}, {"diagonal": -1,
                                              "lower": True}, ["Out"]),
    "triu": ("tril_triu", {"X": [_f(2, 4, 5)]}, {"diagonal": 1,
                                                 "lower": False}, ["Out"]),
    "diag_v2_vector": ("diag_v2", {"X": [_f(3)]},
                       {"offset": 1, "padding_value": 0.5}, ["Out"]),
    "diag_v2_matrix": ("diag_v2", {"X": [_f(4, 5)]}, {"offset": -1},
                       ["Out"]),
    "meshgrid": ("meshgrid", {"X": [_f(3), _f(4, seed=1)]}, {}, ["Out"]),
    "gather": ("gather", {"X": [_f(5, 3)], "Index": [np.array(
        [4, 0, 2, 0], np.int64)]}, {"axis": 0}, ["Out"]),
    "gather_column_index_axis1": ("gather", {"X": [_f(2, 5, 3)],
                                             "Index": [np.array(
                                                 [[3], [1]], np.int64)]},
                                  {"axis": 1}, ["Out"]),
    "gather_nd": ("gather_nd", {"X": [_f(3, 4, 5)], "Index": [np.array(
        [[2, 1], [0, 3], [2, 1]], np.int64)]}, {}, ["Out"]),
    "index_select": ("index_select", {"X": [_f(3, 5)], "Index": [np.array(
        [4, 1, 1], np.int64)]}, {"dim": 1}, ["Out"]),
    "index_sample": ("index_sample", {"X": [_f(3, 5)], "Index": [np.array(
        [[4, 0], [1, 1], [2, 3]], np.int64)]}, {}, ["Out"]),
    "scatter_overwrite": ("scatter", {"X": [_f(5, 3)], "Ids": [np.array(
        [3, 0], np.int64)], "Updates": [_f(2, 3, seed=1)]},
        {"overwrite": True}, ["Out"]),
    "scatter_add_repeated_ids": ("scatter", {"X": [_f(5, 3)],
                                             "Ids": [np.array(
                                                 [[3], [0], [3]], np.int64)],
                                             "Updates": [_f(3, 3, seed=1)]},
                                 {"overwrite": False}, ["Out"]),
    "scatter_nd_add": ("scatter_nd_add", {"X": [_f(3, 4)], "Index": [
        np.array([[1, 2], [0, 0], [1, 2]], np.int64)],
        "Updates": [_f(3, seed=1)]}, {}, ["Out"]),
    "where": ("where", {"Condition": [_f(3, 4) > 0], "X": [_f(3, 4)],
                        "Y": [_f(3, 4, seed=1)]}, {}, ["Out"]),
    "multiplex": ("multiplex", {"X": [_f(4, 3), _f(4, 3, seed=1),
                                      _f(4, 3, seed=2)],
                                "Ids": [np.array([[2], [0], [1], [2]],
                                                 np.int64)]}, {}, ["Out"]),
    # -- search --------------------------------------------------------------------
    "arg_max_keepdims_ties": ("arg_max", {"X": [_TIES]},
                              {"axis": 1, "keepdims": True,
                               "flatten": False, "dtype": "int64"}, []),
    "arg_max_flatten_int32": ("arg_max", {"X": [_f(3, 4)]},
                              {"axis": -1, "keepdims": False,
                               "flatten": True, "dtype": "int32"}, []),
    "arg_min_ties": ("arg_min", {"X": [-_TIES]},
                     {"axis": 1, "keepdims": False, "flatten": False}, []),
    "arg_min_flatten_vector": ("arg_min", {"X": [_f(6)]},
                               {"axis": -1, "flatten": True}, []),
    "argsort_ties": ("argsort", {"X": [_TIES]},
                     {"axis": -1, "descending": False}, ["Out"]),
    "argsort_ties_descending_axis0": ("argsort", {"X": [_TIES.T.copy()]},
                                      {"axis": 0, "descending": True},
                                      ["Out"]),
    "unique": ("unique", {"X": [np.array([[3, 1, 3], [2, 1, 3]],
                                         np.int64)]}, {"axis": []}, []),
    "unique_float_vector_axis": ("unique", {"X": [np.array(
        [0.5, -1.0, 0.5, 2.0])]}, {"axis": [0]}, []),
})


def _act_case(op, x, **attrs):
    return (op, {"X": [x]}, attrs, ["Out"])


_ROUNDED = np.round(_f(3, 4) * 2) / 2  # ties between x and y
_ROUNDED_Y = np.round(_f(3, 4, seed=1) * 2) / 2
_BOOLS_Y = np.array([[False, False, True], [True, False, True]])
_WIDE = _f(3, 4) * 3  # reaches the kinks and clips of the activations


def _lstm_ins(b=2, t=5, h=3, seed=0, init=False):
    ins = {"Input": [_f(b, t, 4 * h, seed=seed)],
           "Weight": [_f(h, 4 * h, seed=seed + 1, scale=0.5)],
           "Bias": [_f(1, 4 * h, seed=seed + 2, scale=0.5)]}
    if init:
        ins["H0"] = [_f(b, h, seed=seed + 3)]
        ins["C0"] = [_f(b, h, seed=seed + 4)]
    return ins


def _rnn_ins(mode, layers, ndir, t=4, b=3, i=2, h=3, lens=True):
    g = {"LSTM": 4, "GRU": 3}.get(mode, 1)
    ws, bs = [], []
    for li in range(layers):
        for d in range(ndir):
            k = li * 10 + d
            ws += [_f(g * h, i if li == 0 else h * ndir, seed=k, scale=0.5),
                   _f(g * h, h, seed=k + 1, scale=0.5)]
            bs += [_f(g * h, seed=k + 2, scale=0.5),
                   _f(g * h, seed=k + 3, scale=0.5)]
    pre = [_f(layers * ndir, b, h, seed=40)]
    if mode == "LSTM":
        pre.append(_f(layers * ndir, b, h, seed=41))
    ins = {"Input": [_f(t, b, i, seed=42)], "PreState": pre,
           "WeightList": ws + bs}
    if lens:
        ins["SequenceLength"] = [np.array([4, 2, 3], np.int64)]
    return ins


def _rnn_attrs(mode, layers, ndir, h=3):
    return {"mode": mode, "num_layers": layers, "is_bidirec": ndir == 2,
            "hidden_size": h, "dropout_prob": 0.0, "is_test": True}


_CRF_EMISSION = _f(3, 6, 4)
_CRF_TRANS = _f(6, 4, seed=1)
_CRF_LABEL = _ids((3, 6), 4, seed=2)
_CRF_LENGTH = np.array([6, 3, 1], np.int64)
# every emission and transition an integer of a few values: Viterbi meets
# equal scores, where the first index wins
_CRF_TIES = np.round(_f(3, 6, 4, seed=3))
_CRF_TIES_TRANS = np.round(_f(6, 4, seed=4))
_SEQ_X = _f(3, 5, 4)
_SEQ_LEN = np.array([5, 2, 0], np.int64)

# the rules of the 1.x layer surface, the recurrences, CTC, CRF and the
# sentiment program's sequence rules
CASES.update({
    # -- comparisons and logical ops -----------------------------------------
    **{op: _binary_case(op, _ROUNDED, _ROUNDED_Y, grads=False) for op in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal")},
    "less_than_axis": _binary_case("less_than", _f(2, 3, 4), _f(3, seed=1),
                                   axis=1, grads=False),
    **{op: _binary_case(op, _BOOLS, _BOOLS_Y, grads=False) for op in (
        "logical_and", "logical_or", "logical_xor")},
    "maximum": _binary_case("maximum", _f(3, 4), _f(3, 4, seed=1)),
    "minimum": _binary_case("minimum", _f(2, 3, 4), _f(4, seed=1)),
    "isfinite_any_nonfinite": ("isfinite", {"X": [_special(3, 4)]}, {}, []),
    "isfinite_all_finite": ("isfinite", {"X": [_f(3, 4)]}, {}, []),
    # -- products and norms -------------------------------------------------
    "matmul_transposes_alpha": ("matmul", {"X": [_f(2, 4, 3)],
                                           "Y": [_f(2, 5, 4, seed=1)]},
                                {"transpose_X": True, "transpose_Y": True,
                                 "alpha": 0.5}, ["Out"]),
    "matmul_broadcast": ("matmul", {"X": [_f(2, 3, 4)],
                                    "Y": [_f(4, 5, seed=1)]}, {}, ["Out"]),
    "log_softmax": ("log_softmax", {"X": [_f(3, 5)]}, {"axis": 0},
                    ["Out"]),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_f(3, 4)]}, {}, ["Out"]),
    "p_norm": ("p_norm", {"X": [_f(3, 4)]},
               {"porder": 2.0, "axis": 1, "keepdim": False}, ["Out"]),
    "p_norm_3_keepdim": ("p_norm", {"X": [_f(2, 3, 4)]},
                         {"porder": 3.0, "axis": -1, "keepdim": True},
                         ["Out"]),
    "p_norm_inf": ("p_norm", {"X": [_f(3, 4)]},
                   {"porder": float("inf"), "axis": 0}, []),
    "clip_by_norm_clipped": ("clip_by_norm", {"X": [_f(3, 4)]},
                             {"max_norm": 1.0}, ["Out"]),
    "clip_by_norm_within": ("clip_by_norm", {"X": [_f(3, 4)]},
                            {"max_norm": 100.0}, ["Out"]),
    "dist": ("dist", {"X": [_f(3, 4)], "Y": [_f(3, 4, seed=1)]},
             {"p": 2.0}, ["Out"]),
    "dist_p3_broadcast": ("dist", {"X": [_f(3, 4)], "Y": [_f(4, seed=1)]},
                          {"p": 3.0}, ["Out"]),
    "cross_first_axis_of_3": ("cross", {"X": [_f(2, 3)],
                                        "Y": [_f(2, 3, seed=1)]}, {},
                              ["Out"]),
    "cross_dim0": ("cross", {"X": [_f(3, 4)], "Y": [_f(3, 4, seed=1)]},
                   {"dim": 0}, ["Out"]),
    # -- activations ----------------------------------------------------------
    "gelu": _act_case("gelu", _WIDE, approximate=False),
    "gelu_tanh": _act_case("gelu", _WIDE, approximate=True),
    "leaky_relu": _act_case("leaky_relu", _WIDE, alpha=0.1),
    "relu6": _act_case("relu6", _WIDE * 2, threshold=6.0),
    "elu": _act_case("elu", _WIDE, alpha=0.5),
    "softplus": _act_case("softplus", _WIDE, beta=2.0, threshold=1.5),
    "swish": _act_case("swish", _WIDE, beta=1.5),
    "hard_sigmoid": _act_case("hard_sigmoid", _WIDE, slope=0.3, offset=0.4),
    "hard_swish": _act_case("hard_swish", _WIDE, threshold=6.0, scale=6.0,
                            offset=3.0),
    "hard_shrink": _act_case("hard_shrink", _WIDE, threshold=0.3),
    "softshrink": _act_case("softshrink", _WIDE, **{"lambda": 0.4}),
    **{op: _unary_case(op, _WIDE) for op in (
        "logsigmoid", "tanh_shrink", "softsign", "silu", "mish", "asinh")},
    "acosh": _unary_case("acosh", _pos(3, 4) + 1.0),
    "atanh": _unary_case("atanh", np.tanh(_f(3, 4)) * 0.9),
    # -- the v1 shape ops and the rest of the tensor bucket ------------------
    "reshape": ("reshape", {"X": [_f(2, 3, 4)]}, {"shape": [0, -1]},
                ["Out"]),
    "transpose": ("transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]},
                  ["Out"]),
    "squeeze": ("squeeze", {"X": [_f(2, 1, 3)]}, {"axes": [1]}, ["Out"]),
    "unsqueeze": ("unsqueeze", {"X": [_f(2, 3)]}, {"axes": [1]}, ["Out"]),
    "flatten": ("flatten", {"X": [_f(2, 3, 4)]}, {"axis": 2}, ["Out"]),
    "flatten2": ("flatten2", {"X": [_f(2, 3, 4)]}, {"axis": 1}, ["Out"]),
    "expand": ("expand", {"X": [_f(1, 3, 2)]},
               {"expand_times": [2, 1, 3]}, ["Out"]),
    "top_k": ("top_k", {"X": [_f(3, 6)]}, {"k": 2}, ["Out"]),
    "broadcast_to": ("broadcast_to", {"X": [_f(3, 1)]},
                     {"shape": [2, 3, 4]}, ["Out"]),
    "reverse": ("reverse", {"X": [_f(2, 3, 4)]}, {"axis": [0, -1]},
                ["Out"]),
    "pad": ("pad", {"X": [_f(2, 3)]},
            {"paddings": [1, 0, 0, 2], "pad_value": 0.5}, ["Out"]),
    "pad2d_constant": ("pad2d", {"X": [_f(2, 3, 4, 5)]},
                       {"paddings": [1, 0, 2, 1], "mode": "constant",
                        "pad_value": -1.0, "data_format": "NCHW"}, ["Out"]),
    "pad2d_reflect": ("pad2d", {"X": [_f(2, 3, 4, 5)]},
                      {"paddings": [1, 2, 2, 1], "mode": "reflect",
                       "data_format": "NCHW"}, ["Out"]),
    "pad2d_edge_nhwc": ("pad2d", {"X": [_f(2, 4, 5, 3)]},
                        {"paddings": [2, 0, 1, 3], "mode": "edge",
                         "data_format": "NHWC"}, ["Out"]),
    "pad3d_constant": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                       {"paddings": [1, 0, 0, 2, 1, 1], "mode": "constant",
                        "value": 0.25, "data_format": "NCDHW"}, ["Out"]),
    "pad3d_reflect": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                      {"paddings": [1, 2, 1, 0, 2, 1], "mode": "reflect",
                       "data_format": "NCDHW"}, ["Out"]),
    "pad3d_replicate_ndhwc": ("pad3d", {"X": [_f(1, 3, 4, 5, 2)]},
                              {"paddings": [2, 0, 1, 1, 0, 3],
                               "mode": "replicate", "data_format": "NDHWC"},
                              ["Out"]),
    "pad3d_circular": ("pad3d", {"X": [_f(1, 2, 3, 4, 5)]},
                       {"paddings": [1, 2, 1, 0, 2, 1], "mode": "circular",
                        "data_format": "NCDHW"}, ["Out"]),
    "one_hot_out_of_range": ("one_hot", {"X": [np.array(
        [[1], [4], [0], [5]], np.int64)]}, {"depth": 5}, []),
    "one_hot_v2": ("one_hot_v2", {"X": [_ids((2, 3), 4)]}, {"depth": 4},
                   []),
    "masked_fill": ("masked_fill", {"X": [_f(3, 4)],
                                    "Mask": [_f(3, 4, seed=1) > 0]},
                    {"value": 2.5}, ["Out"]),
    "masked_select": ("masked_select", {"X": [_f(3, 4)],
                                        "Mask": [_f(1, 4, seed=1) > 0]},
                      {}, ["Y"]),
    "assign_value": ("assign_value", {}, {"values": [0.5, 1., 2., 3., 4.,
                                                     -1.],
                                          "shape": [2, 3],
                                          "dtype": "float32"}, []),
    "assign_value_int64": ("assign_value", {}, {"values": [3, 1, 4],
                                                "shape": [3],
                                                "dtype": "int64"}, []),
    "shape": ("shape", {"Input": [_f(2, 3, 4)]}, {}, []),
    "size": ("size", {"Input": [_f(2, 3, 4)]}, {}, []),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [_f(5, 3)]},
        {"shape": [-1, 7], "input_dim_idx": 0, "output_dim_idx": 0,
         "value": 1.5, "dtype": "float32"}, []),
    "fill_constant_batch_size_like_dim1": (
        "fill_constant_batch_size_like", {"Input": [_f(5, 3)]},
        {"shape": [2, -1], "input_dim_idx": 1, "output_dim_idx": 1,
         "value": 4.0, "dtype": "int64"}, []),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_f(3, 4)]}, {}, []),
    "inverse": ("inverse", {"Input": [_spd(3)]}, {}, ["Output"]),
    **{f"segment_pool_{p.lower()}": (
        "segment_pool", {"X": [_f(5, 3)],
                         "SegmentIds": [np.array([0, 0, 1, 3, 3],
                                                 np.int64)]},
        {"pooltype": p}, ["Out"]) for p in ("SUM", "MEAN", "MAX", "MIN")},
    # -- the nn bucket: cos_sim and the losses of fluid.layers.loss ----------
    "cos_sim": ("cos_sim", {"X": [_f(4, 3)], "Y": [_f(4, 3, seed=1)]}, {},
                ["Out"]),
    "cos_sim_one_row_y": ("cos_sim", {"X": [_f(4, 3)],
                                      "Y": [_f(1, 3, seed=1)]}, {},
                          ["Out"]),
    "bce_loss": ("bce_loss", {"X": [_probs(4, 3)],
                              "Label": [_probs(4, 3, seed=1)]}, {},
                 ["Out"]),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(3, 4)], "Label": [_probs(3, 4, seed=1)]},
        {"ignore_index": -100, "normalize": False}, ["Out"]),
    "sigmoid_cross_entropy_with_logits_ignore_normalize": (
        "sigmoid_cross_entropy_with_logits",
        {"X": [_f(3, 4)], "Label": [np.where(
            _f(3, 4, seed=2) > 0.5, -100.0, _probs(3, 4, seed=1))]},
        {"ignore_index": -100, "normalize": True}, ["Out"]),
    "huber_loss": ("huber_loss", {"X": [_f(4, 1)], "Y": [_f(4, 1, seed=1)]},
                   {"delta": 0.8}, ["Out"]),
    "smooth_l1_loss": ("smooth_l1_loss", {"X": [_f(3, 4)],
                                          "Y": [_f(3, 4, seed=1)]},
                       {"sigma": 1.5}, ["Out"]),
    **{f"kldiv_loss_{r}": ("kldiv_loss", {
        "X": [np.log(_probs(3, 4))],
        "Target": [np.where(_f(3, 4, seed=2) > 1.0, 0.0,
                            _probs(3, 4, seed=1))]},
        {"reduction": r}, ["Loss"])
       for r in ("mean", "sum", "batchmean", "none")},
    # -- the recurrences -------------------------------------------------------
    "lstm_default_activations": ("lstm", _lstm_ins(), {
        "is_reverse": False, "gate_activation": "sigmoid",
        "cell_activation": "tanh", "candidate_activation": "tanh"},
        ["Hidden", "Cell"]),
    "lstm_default_activations_reverse": ("lstm", _lstm_ins(seed=5), {
        "is_reverse": True}, ["Hidden", "Cell"]),
    "lstm_srl_activations_reverse": ("lstm", _lstm_ins(seed=7), {
        "is_reverse": True, "gate_activation": "sigmoid",
        "cell_activation": "sigmoid", "candidate_activation": "relu"},
        ["Hidden", "Cell"]),
    "lstm_initial_state": ("lstm", _lstm_ins(seed=9, init=True), {
        "is_reverse": False}, ["Hidden", "Cell"]),
    "gru": ("gru", {"Input": [_f(2, 4, 9)],
                    "Weight": [_f(3, 9, seed=1, scale=0.5)],
                    "Bias": [_f(1, 9, seed=2)]},
            {"is_reverse": False, "origin_mode": False}, ["Hidden"]),
    "gru_origin_reverse_h0": ("gru", {
        "Input": [_f(2, 4, 9)], "Weight": [_f(3, 9, seed=1, scale=0.5)],
        "Bias": [_f(1, 9, seed=2)], "H0": [_f(2, 3, seed=3)]},
        {"is_reverse": True, "origin_mode": True,
         "gate_activation": "sigmoid", "activation": "relu"}, ["Hidden"]),
    "gru_unit": ("gru_unit", {"Input": [_f(2, 9)],
                              "HiddenPrev": [_f(2, 3, seed=1)],
                              "Weight": [_f(3, 9, seed=2)],
                              "Bias": [_f(1, 9, seed=3)]},
                 {"gate_activation": 1, "activation": 2,
                  "origin_mode": False}, ["Hidden", "Gate"]),
    "gru_unit_origin_relu": ("gru_unit", {
        "Input": [_f(2, 9)], "HiddenPrev": [_f(2, 3, seed=1)],
        "Weight": [_f(3, 9, seed=2)]},
        {"gate_activation": 1, "activation": 3, "origin_mode": True},
        ["Hidden"]),
    "lstm_unit": ("lstm_unit", {"X": [_f(2, 12)],
                                "C_prev": [_f(2, 3, seed=1)]},
                  {"forget_bias": 1.0}, ["H", "C"]),
    "lstmp_peepholes_clips": ("lstmp", {
        "Input": [_f(2, 4, 12)], "Weight": [_f(2, 12, seed=1, scale=0.5)],
        "ProjWeight": [_f(3, 2, seed=2, scale=0.5)],
        "Bias": [_f(1, 21, seed=3, scale=0.5)]},
        {"use_peepholes": True, "is_reverse": True, "cell_clip": 0.8,
         "proj_clip": 0.5}, ["Projection", "Cell"]),
    "lstmp_h0": ("lstmp", {
        "Input": [_f(2, 4, 12)], "Weight": [_f(2, 12, seed=1, scale=0.5)],
        "ProjWeight": [_f(3, 2, seed=2, scale=0.5)],
        "Bias": [_f(1, 12, seed=3, scale=0.5)], "H0": [_f(2, 3, seed=4)],
        "C0": [_f(2, 3, seed=5)]},
        {"use_peepholes": False, "proj_activation": "identity"},
        ["Projection"]),
    "rnn_lstm_bidirectional_2_layers": (
        "rnn", _rnn_ins("LSTM", 2, 2), _rnn_attrs("LSTM", 2, 2), ["Out"]),
    "rnn_gru": ("rnn", _rnn_ins("GRU", 1, 1), _rnn_attrs("GRU", 1, 1),
                ["Out"]),
    "rnn_tanh_no_lengths": ("rnn", _rnn_ins("RNN_TANH", 1, 2, lens=False),
                            _rnn_attrs("RNN_TANH", 1, 2), ["Out"]),
    # -- beams -----------------------------------------------------------------
    "beam_search": ("beam_search", {
        "pre_ids": [np.array([[3], [1], [2], [4]], np.int64)],
        "pre_scores": [_f(4, 1)], "ids": [_ids((4, 3), 9, seed=1)],
        "scores": [_f(4, 3, seed=2)]},
        {"beam_size": 2, "end_id": 1, "is_accumulated": False}, []),
    "beam_search_accumulated_no_ids": ("beam_search", {
        "pre_ids": [np.array([[3], [1], [2], [4]], np.int64)],
        "pre_scores": [_f(4, 1)], "scores": [_f(4, 5, seed=2)]},
        {"beam_size": 2, "end_id": 1}, []),
    "beam_search_decode": ("beam_search_decode", {
        "Ids": [_ids((3, 4), 9)],
        "ParentIdx": [np.array([[0, 1, 2, 3], [1, 1, 3, 2], [0, 0, 2, 2]],
                               np.int64)],
        "Scores": [_f(3, 4)]}, {}, []),
    "gather_tree": ("gather_tree", {
        "Ids": [_ids((3, 2, 2), 9)],
        "Parents": [np.array([[[0, 1], [1, 0]], [[1, 1], [0, 1]],
                              [[1, 0], [0, 0]]], np.int64)]}, {}, []),
    # -- CTC ----------------------------------------------------------------------
    "warpctc": ("warpctc", {
        "Logits": [_f(6, 2, 4)],
        "Label": [np.array([[1, 2], [3, 0]], np.int64)],
        "LogitsLength": [np.array([6, 5], np.int64)],
        "LabelLength": [np.array([2, 1], np.int64)]},
        {"blank": 0, "norm_by_times": False}, ["Loss"]),
    "warpctc_norm_by_times_repeats": ("warpctc", {
        "Logits": [_f(5, 2, 3)],
        "Label": [np.array([[1, 1], [2, 1]], np.int64)]},
        {"blank": 0, "norm_by_times": True}, ["Loss"]),
    "ctc_align": ("ctc_align", {
        "Input": [np.array([[0, 1, 1, 0, 2, 2], [3, 3, 0, 3, 1, 1]],
                           np.int64)],
        "InputLength": [np.array([[6], [4]], np.int64)]},
        {"blank": 0, "padding_value": -1}, []),
    "edit_distance": ("edit_distance", {
        "Hyps": [np.array([[1, 2, 3, 4], [2, 2, 1, 0]], np.int64)],
        "Refs": [np.array([[1, 3, 4], [2, 1, 1]], np.int64)],
        "HypsLength": [np.array([4, 3], np.int64)],
        "RefsLength": [np.array([3, 2], np.int64)]},
        {"normalized": True}, []),
    "edit_distance_raw": ("edit_distance", {
        "Hyps": [np.array([[1, 2, 3, 4], [2, 2, 1, 0]], np.int64)],
        "Refs": [np.array([[1, 3, 4], [2, 1, 1]], np.int64)]},
        {"normalized": False}, []),
    "row_conv": ("row_conv", {"X": [_f(2, 5, 3)],
                              "Filter": [_f(3, 3, seed=1)]}, {}, ["Out"]),
    # -- CRF ----------------------------------------------------------------------
    "linear_chain_crf": ("linear_chain_crf", {
        "Emission": [_CRF_EMISSION], "Transition": [_CRF_TRANS],
        "Label": [_CRF_LABEL], "Length": [_CRF_LENGTH]}, {},
        ["LogLikelihood"]),
    "linear_chain_crf_full_rows": ("linear_chain_crf", {
        "Emission": [_CRF_EMISSION * 3], "Transition": [_CRF_TRANS],
        "Label": [_CRF_LABEL]}, {}, ["LogLikelihood"]),
    "crf_decoding": ("crf_decoding", {
        "Emission": [_CRF_EMISSION], "Transition": [_CRF_TRANS],
        "Length": [_CRF_LENGTH]}, {}, []),
    "crf_decoding_ties": ("crf_decoding", {
        "Emission": [_CRF_TIES], "Transition": [_CRF_TIES_TRANS],
        "Length": [_CRF_LENGTH]}, {}, []),
    "crf_decoding_label_mask": ("crf_decoding", {
        "Emission": [_CRF_EMISSION], "Transition": [_CRF_TRANS],
        "Label": [_CRF_LABEL], "Length": [_CRF_LENGTH]}, {}, []),
    # -- the sentiment program's sequence rules ----------------------------------
    **{f"sequence_pool_{p.lower()}": (
        "sequence_pool", {"X": [_SEQ_X], "Length": [_SEQ_LEN]},
        {"pooltype": p, "pad_value": 0.5}, ["Out"])
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")},
    "sequence_conv": ("sequence_conv", {
        "X": [_SEQ_X], "Filter": [_f(12, 5, seed=1)],
        "Length": [_SEQ_LEN]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1},
        ["Out"]),
    "sequence_conv_full_rows_lookback": ("sequence_conv", {
        "X": [_SEQ_X], "Filter": [_f(8, 5, seed=1)]},
        {"contextLength": 2, "contextStart": -2}, ["Out"]),
})


# int64 feeds and int outputs are exact; these rules also take float64
# (linspace makes float32 whatever the feeds: under x64 the reference
# computes its steps in float32 and lands within a float32 unit of the
# exact values the port gives; warpctc computes in float32 in both, as
# the reference casts the logits)
FLOAT64_OK = set(CASES) - {"fill_constant", "fill_constant_int64",
                           "linspace", "warpctc",
                           "warpctc_norm_by_times_repeats"}

RANDOM = ("gaussian_random", "uniform_random", "shuffle_batch", "nce")


def _cast(arrs, dtype):
    return [a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a
            for a in arrs]


def _names(slots):
    return {slot: [f"{slot}_{i}" for i in range(n)]
            for slot, n in slots.items()}


def _reference(op_type, ins, attrs, ct_slots, cts):
    """The reference rule's outputs and its jax.vjp input gradients;
    `cts` is the cotangents, or a function of the outputs (numpy) that
    draws them."""
    prog = JFW.Program()
    op = JFW.Operator(prog.global_block(), 0, op_type,
                      _names({s: len(v) for s, v in ins.items()}), {},
                      dict(attrs))
    fn = JREG._FORWARD[op_type]
    ctx = JREG.LowerCtx(jax.random.PRNGKey(0))
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    outs = fn(ctx, op, jins)
    paths = [(s, i) for s, v in jins.items() for i, a in enumerate(v)
             if jnp.issubdtype(a.dtype, jnp.floating)]
    grads = {}
    if callable(cts):
        cts = cts({s: [np.asarray(a) for a in v] for s, v in outs.items()})
    if ct_slots and paths:
        def f(dvals):
            merged = {s: list(v) for s, v in jins.items()}
            for (s, i), d in zip(paths, dvals):
                merged[s][i] = d
            o = fn(ctx, op, merged)
            return [o[s][0] for s in ct_slots]

        _, vjp = jax.vjp(f, [jins[s][i] for s, i in paths])
        (dvals,) = vjp([jnp.asarray(c) for c in cts])
        grads = {p: np.asarray(d) for p, d in zip(paths, dvals)}
    return ({s: [np.asarray(a) for a in v] for s, v in outs.items()},
            grads)


def _port(op_type, ins, attrs, out_slots, ct_slots, cts):
    """A one-op port block plus its `<type>_grad` op, run through
    `registry.lower_block`; returns the outputs and input gradients."""
    prog = TFW.Program()
    blk = prog.global_block()
    in_names = _names({s: len(v) for s, v in ins.items()})
    out_names = {s: [f"out_{s}"] for s in out_slots}
    blk.ops.append(TFW.Operator(blk, 0, op_type, in_names, out_names,
                                dict(attrs)))
    env = {n: torch.from_numpy(np.array(a))
           for s, v in ins.items() for n, a in zip(in_names[s], v)}
    grad_names = {}
    if ct_slots:
        g_ins = {**in_names, **out_names}
        for s, c in zip(ct_slots, cts):
            g_ins[f"{s}@GRAD"] = [f"ct_{s}"]
            env[f"ct_{s}"] = torch.from_numpy(np.array(c))
        grad_names = {f"{s}@GRAD": [f"{n}@GRAD" for n in names]
                      for s, names in in_names.items()}
        g_attrs = dict(attrs, fwd_op_id=0, fwd_op_type=op_type,
                       fwd_input_slots=list(in_names),
                       fwd_output_slots=list(out_names), op_role=1)
        blk.ops.append(TFW.Operator(blk, 1, op_type + "_grad", g_ins,
                                    grad_names, g_attrs))
    TREG.lower_block(TREG.LowerCtx(0, device="cpu"), blk, env)
    outs = {s: [env[n[0]].numpy()] for s, n in out_names.items()}
    grads = {}
    for s, names in in_names.items():
        for i, n in enumerate(names):
            if f"{n}@GRAD" in env:
                grads[(s, i)] = env[f"{n}@GRAD"].numpy()
    return outs, grads


def _check(name, dtype, cases=None):
    op_type, ins, attrs, ct_slots = (CASES if cases is None else cases)[name]
    ins = {s: _cast(v, dtype) for s, v in ins.items()}
    tol = F64 if dtype == "float64" else F32
    drawn = []

    def draw(outs):
        rng = _rng(7)
        drawn.extend(np.asarray(rng.randn(*outs[s][0].shape),
                                dtype=outs[s][0].dtype) for s in ct_slots)
        return drawn

    with jax.enable_x64(dtype == "float64"):
        want, want_grads = _reference(op_type, ins, attrs, ct_slots, draw)
    got, got_grads = _port(op_type, ins, attrs, list(want), ct_slots,
                           drawn)
    for slot, vals in want.items():
        w, g = vals[0], got[slot][0]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=slot, **tol)
        else:  # the reference narrows int64 to int32 with x64 off
            np.testing.assert_array_equal(g, w, err_msg=slot)
    assert set(got_grads) == set(want_grads)
    for path, w in want_grads.items():
        np.testing.assert_allclose(got_grads[path], w, err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_matches_the_reference_float32(name):
    _check(name, "float32")


@pytest.mark.parametrize("name", sorted(FLOAT64_OK))
def test_rule_matches_the_reference_float64(name):
    _check(name, "float64")


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("gaussian_random", {"mean": 0.5, "std": 2.0}, 0.5, 2.0),
    ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4.0 / 12 ** 0.5),
])
def test_random_rules_draw_their_distribution(op_type, attrs, mean, std):
    n = 40000
    attrs = dict(attrs, shape=[200, 200], dtype="float32", seed=0)
    got, _ = _port(op_type, {}, attrs, ["Out"], [], [])
    x = got["Out"][0].astype(np.float64)
    assert x.shape == (200, 200) and got["Out"][0].dtype == np.float32
    assert abs(x.mean() - mean) < 5 * std / n ** 0.5
    assert abs(x.std() - std) < 5 * std / (2 * n) ** 0.5
    if op_type == "uniform_random":
        assert x.min() >= -1.0 and x.max() <= 3.0
    again, _ = _port(op_type, {}, attrs, ["Out"], [], [])
    np.testing.assert_array_equal(again["Out"][0], got["Out"][0])
    other, _ = _port(op_type, {}, dict(attrs, seed=5), ["Out"], [], [])
    assert not np.array_equal(other["Out"][0], got["Out"][0])


def test_shuffle_batch_permutes_rows_by_its_seed():
    """The rows (all dims but the last flattened) in the order of
    ShuffleIdx, a permutation; the same seed gives the same one, another
    seed another (torch's draw, not JAX's)."""
    x = _f(4, 3, 5)
    attrs = {"startup_seed": 0}
    outs = []
    for seed in (3, 3, 4):
        got, _ = _port("shuffle_batch", {"X": [x], "Seed": [np.array([7])]},
                       dict(attrs, seed=seed),
                       ["Out", "ShuffleIdx", "SeedOut"], [], [])
        outs.append(got)
    perm = outs[0]["ShuffleIdx"][0]
    assert sorted(perm.tolist()) == list(range(12))
    np.testing.assert_array_equal(outs[0]["Out"][0],
                                  x.reshape(12, 5)[perm].reshape(x.shape))
    np.testing.assert_array_equal(outs[1]["Out"][0], outs[0]["Out"][0])
    assert not np.array_equal(outs[2]["ShuffleIdx"][0], perm)
    assert outs[0]["SeedOut"][0].tolist() == [7]


def test_every_rule_is_covered():
    """Each registered port rule has a case here, in
    test_torch_fluid_ops_nn.py (the nn and vision buckets), in
    test_torch_fluid_ops_seq.py (the sequence bucket and the control-flow
    bucket's single-op rules; select_output by its own test there), in
    test_torch_fluid_ops_opt.py (the optimizer, random and misc buckets;
    the drawing and host rules by their own tests there) or in
    test_torch_fluid_ops_det.py (the detection and quantize buckets), or
    runs in the programs of test_torch_control_flow.py (the sub-block and
    tensor-array rules) or test_torch_fluid_optimizer.py
    (recompute_segment_grad), under its reference op-type name."""
    from test_torch_control_flow import PROGRAM_RULES
    from test_torch_fluid_ops_det import CASES as DET_CASES
    from test_torch_fluid_ops_nn import CASES as NN_CASES
    from test_torch_fluid_ops_opt import CASES as OPT_CASES
    from test_torch_fluid_ops_opt import HELD_BELOW as OPT_HELD
    from test_torch_fluid_ops_opt import PROGRAM_RULES as OPT_PROGRAM
    from test_torch_fluid_ops_opt import RANDOM as OPT_RANDOM
    from test_torch_fluid_ops_seq import CASES as SEQ_CASES

    covered = {c[0] for c in list(CASES.values()) + list(NN_CASES.values())
               + list(SEQ_CASES.values()) + list(OPT_CASES.values())
               + list(DET_CASES.values())} \
        | set(RANDOM) | PROGRAM_RULES | {"select_output"} | OPT_RANDOM \
        | OPT_HELD | OPT_PROGRAM
    assert set(TREG.registered_ops()) == covered
    assert covered <= set(JREG.registered_ops())


def test_top_k_orders_ties_by_index():
    """jax.lax.top_k's rule: equal values keep their index order."""
    got, _ = _port("top_k_v2", {"X": [np.array([[2., 7., 7., 7., 1.]])]},
                   {"k": 3, "axis": -1, "largest": True}, ["Out", "Indices"],
                   [], [])
    assert got["Indices"][0].tolist() == [[1, 2, 3]]


def _both_rules(op_type, ins, attrs, outputs):
    """Every output of the reference's rule and of the port's, with the
    output slots `outputs` declared (some rules compute a slot only
    when the op declares it).  Float inputs go in as float32."""
    ins = {s: _cast(v, "float32") for s, v in ins.items()}
    out_names = {s: [f"{s}_0"] for s in outputs}
    jop = JFW.Operator(JFW.Program().global_block(), 0, op_type,
                       _names({s: len(v) for s, v in ins.items()}),
                       out_names, dict(attrs))
    want = JREG._FORWARD[op_type](JREG.LowerCtx(jax.random.PRNGKey(0)), jop,
                                  {s: [jnp.asarray(a) for a in v]
                                   for s, v in ins.items()})
    top = TFW.Operator(TFW.Program().global_block(), 0, op_type,
                       _names({s: len(v) for s, v in ins.items()}),
                       out_names, dict(attrs))
    got = TREG.forward_rule(op_type)(
        TREG.LowerCtx(0, device="cpu"), top,
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()})
    return want, got


@pytest.mark.parametrize("name,slot", [
    ("split_sections", "Out"), ("split_num", "Out"), ("unstack", "Y"),
    ("unbind", "Out"), ("meshgrid", "Out")])
def test_multi_output_rules_give_every_output(name, slot):
    """The harness above compares each slot's first tensor; these rules
    give several: every one matches (values are moved, not computed)."""
    op_type, ins, attrs, _ = CASES[name]
    want, got = _both_rules(op_type, ins, attrs, [slot])
    assert len(got[slot]) == len(want[slot]) > 1
    for w, g in zip(want[slot], got[slot]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("x", [
    np.array([[3, 1, 3], [2, 1, 3]], np.int64),
    np.array([0.5, -1.0, 0.5, 2.0, 2.0, 2.0])])
def test_unique_rule_index_and_counts(x):
    """With Index and Counts declared, the static-shape unique gives the
    inverse map and the counts (0 for the padding) as the reference's
    jnp.unique(size=) does, in the `dtype` attr."""
    want, got = _both_rules("unique", {"X": [x]},
                            {"axis": [], "dtype": "int32"},
                            ["Out", "Index", "Counts"])
    for slot in ("Out", "Index", "Counts"):
        np.testing.assert_array_equal(got[slot][0].numpy(),
                                      np.asarray(want[slot][0]),
                                      err_msg=slot)
    assert got["Counts"][0].dtype == torch.int32


@pytest.mark.parametrize("op_type,ins,attrs,ignored", [
    ("frobenius_norm", {"X": [_f(3, 4)]},
     {"dim": [], "keep_dim": False, "reduce_all": True}, "reduce_all"),
    ("arg_min", {"X": [_f(3, 4)]}, {"axis": -1, "flatten": True},
     "flatten"),
    ("unique", {"X": [np.array([[3, 1], [3, 2]], np.int64)]},
     {"axis": [0]}, "axis"),
])
def test_rules_raise_where_the_reference_ignores_an_attr(op_type, ins,
                                                         attrs, ignored):
    """Where the reference's rule ignores an attr that would change the
    answer, the port's rule raises.  The reference's answer there is
    pinned: the ignored attr made no difference to it."""
    with pytest.raises(NotImplementedError, match=ignored):
        _both_rules(op_type, ins, attrs, ["Out"])
    without = dict(attrs)
    without[ignored] = {"reduce_all": False, "flatten": False,
                        "axis": []}[ignored]
    out = {}
    for a in (attrs, without):
        op = JFW.Operator(JFW.Program().global_block(), 0, op_type,
                          _names({s: len(v) for s, v in ins.items()}), {},
                          dict(a))
        out[id(a)] = np.asarray(JREG._FORWARD[op_type](
            JREG.LowerCtx(jax.random.PRNGKey(0)), op,
            {s: [jnp.asarray(v) for v in vs]
             for s, vs in ins.items()})["Out"][0])
    np.testing.assert_array_equal(out[id(attrs)], out[id(without)])
