"""The op rules of the nn and vision buckets (and the misc bucket's
bilinear_tensor_product) against the reference's, in the two-registry
harness of test_torch_fluid_ops.py: the same numpy inputs through each
package's rule, forward outputs and the port's generic autograd
gradient against `jax.vjp` of the reference's rule, in float32, and in
float64 for the first case of each op type.  Then the forms the harness cannot hold: conv2d_transpose's
output_padding against a numpy scatter oracle, the drawing rules (nce,
sample_logits, dropout in training) by their formulas and statistics,
and the attrs the reference does not read.

Tolerances: the harness's F32 (rtol 2e-5, atol 2e-6) and F64 (rtol
1e-11, atol 1e-12), one op whose only difference is the summation
order; the dropout rate within 5 standard errors of 40000 draws.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_fluid_ops import (F64, JFW, JREG, _WIDE, _both_rules,
                                  _check, _f, _ids, _names, _port, _pos,
                                  _probs, _reference, _rng)


# -- the nn bucket's remainder and the vision bucket ---------------------------

def _conv_attrs(strides, paddings, dilations=None, groups=1, algo="EXPLICIT",
                fmt="NCHW", **kw):
    n = len(strides)
    return dict(strides=strides, paddings=paddings,
                dilations=dilations or [1] * n, groups=groups,
                padding_algorithm=algo, data_format=fmt, **kw)


def _pool_attrs(ptype, ksize, strides, paddings, **kw):
    return dict(dict(pooling_type=ptype, ksize=ksize, strides=strides,
                     paddings=paddings, global_pooling=False, adaptive=False,
                     ceil_mode=False, exclusive=True,
                     padding_algorithm="EXPLICIT"), **kw)


def _interp_case(op, x, **attrs):
    return (op, {"X": [x]}, attrs, ["Out"])


_IMG = _f(2, 3, 5, 6)
_VOL = _f(1, 2, 4, 5, 5)
_UNPOOL_IDX = np.stack([np.stack([_rng(10 * n + c).permutation(36)[:9]
                                  for c in range(3)]) for n in range(2)]
                       ).reshape(2, 3, 3, 3).astype(np.int32)
_GRID = _f(2, 4, 5, 2, seed=5) * 0.7
_OFFSET = _f(1, 2 * 2 * 9, 5, 5, seed=3) * 0.7
_HS_PATH = np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3], [0, 2, -1]], np.int64)
_HS_CODE = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]], np.int64)

CASES = {
    "depthwise_conv2d": ("depthwise_conv2d", {
        "Input": [_f(2, 4, 6, 6)], "Filter": [_f(4, 1, 3, 3, seed=1)]},
        _conv_attrs([1, 1], [1, 1]), ["Output"]),
    "depthwise_conv2d_stride_nhwc": ("depthwise_conv2d", {
        "Input": [_f(2, 7, 7, 4)], "Filter": [_f(8, 1, 3, 3, seed=1)]},
        _conv_attrs([2, 2], [0, 0], groups=4, algo="SAME", fmt="NHWC"),
        ["Output"]),
    "conv2d_transpose": ("conv2d_transpose", {
        "Input": [_f(2, 3, 5, 5)], "Filter": [_f(3, 4, 3, 3, seed=1)]},
        _conv_attrs([2, 2], [1, 1]), ["Output"]),
    "conv2d_transpose_groups_asym": ("conv2d_transpose", {
        "Input": [_f(2, 4, 4, 4)], "Filter": [_f(4, 3, 3, 3, seed=1)]},
        _conv_attrs([2, 1], [0, 1, 1, 0], [1, 2], groups=2), ["Output"]),
    "conv2d_transpose_same_nhwc": ("conv2d_transpose", {
        "Input": [_f(2, 4, 4, 3)], "Filter": [_f(3, 2, 4, 4, seed=1)]},
        _conv_attrs([2, 2], [0, 0], algo="SAME", fmt="NHWC"), ["Output"]),
    "conv3d": ("conv3d", {"Input": [_VOL], "Filter": [_f(3, 2, 3, 3, 3,
                                                          seed=1)]},
               _conv_attrs([1, 2, 1], [1, 1, 0]), ["Output"]),
    "conv3d_same_groups": ("conv3d", {
        "Input": [_f(1, 4, 5, 5, 5)], "Filter": [_f(4, 2, 3, 3, 3, seed=1)]},
        _conv_attrs([2, 2, 2], [0, 0, 0], groups=2, algo="SAME"),
        ["Output"]),
    "conv3d_transpose": ("conv3d_transpose", {
        "Input": [_f(1, 2, 3, 3, 3)], "Filter": [_f(2, 3, 2, 2, 2, seed=1)]},
        _conv_attrs([2, 2, 2], [0, 1, 0]), ["Output"]),
    "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose", {
        "Input": [_f(1, 3, 4, 4)], "Filter": [_f(3, 1, 3, 3, seed=1)]},
        _conv_attrs([2, 2], [1, 1], groups=0), ["Output"]),
    "pool3d_max": ("pool3d", {"X": [_VOL]},
                   _pool_attrs("max", [2, 3, 3], [2, 2, 2], [1, 1, 1]),
                   ["Out"]),
    "pool3d_avg_exclusive": ("pool3d", {"X": [_VOL]},
                             _pool_attrs("avg", [3, 3, 3], [1, 2, 2],
                                         [1, 0, 1]), ["Out"]),
    "pool3d_avg_inclusive": ("pool3d", {"X": [_VOL]},
                             _pool_attrs("avg", [2, 2, 2], [2, 2, 2],
                                         [1, 1, 1], exclusive=False),
                             ["Out"]),
    "pool3d_adaptive": ("pool3d", {"X": [_VOL]},
                        _pool_attrs("max", [3, 2, 4], [1, 1, 1], [0, 0, 0],
                                    adaptive=True), ["Out"]),
    "pool3d_global_avg": ("pool3d", {"X": [_VOL]},
                          _pool_attrs("avg", [2, 2, 2], [1, 1, 1],
                                      [0, 0, 0], global_pooling=True),
                          ["Out"]),
    "sync_batch_norm": ("sync_batch_norm", {
        "X": [_f(4, 3, 4, 4) * 2 + 1], "Scale": [_f(3, seed=1)],
        "Bias": [_f(3, seed=2)], "Mean": [_f(3, seed=3)],
        "Variance": [np.abs(_f(3, seed=4)) + 0.5]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
         "data_layout": "NCHW", "use_global_stats": False}, ["Y"]),
    "layer_norm": ("layer_norm", {"X": [_f(2, 3, 4) * 2 + 1],
                                  "Scale": [_f(12, seed=1)],
                                  "Bias": [_f(12, seed=2)]},
                   {"epsilon": 1e-5, "begin_norm_axis": 1}, ["Y"]),
    "layer_norm_last_no_affine": ("layer_norm", {"X": [_f(2, 3, 4)]},
                                  {"epsilon": 1e-3, "begin_norm_axis": 2},
                                  ["Y"]),
    "instance_norm": ("instance_norm", {"X": [_f(2, 3, 4, 4) * 2 + 1],
                                        "Scale": [_f(3, seed=1)],
                                        "Bias": [_f(3, seed=2)]},
                      {"epsilon": 1e-5}, ["Y"]),
    "instance_norm_no_affine": ("instance_norm", {"X": [_f(2, 3, 5)]},
                                {"epsilon": 1e-3}, ["Y"]),
    "group_norm": ("group_norm", {"X": [_f(2, 6, 3, 3) + 1],
                                  "Scale": [_f(6, seed=1)],
                                  "Bias": [_f(6, seed=2)]},
                   {"epsilon": 1e-5, "groups": 3}, ["Y"]),
    "lrn": ("lrn", {"X": [_f(2, 6, 3, 3)]},
            {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ["Out"]),
    "lrn_nhwc": ("lrn", {"X": [_f(2, 3, 3, 4)]},
                 {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.5,
                  "data_format": "NHWC"}, ["Out"]),
    "norm": ("norm", {"X": [_f(3, 4, 5)]}, {"axis": 1, "epsilon": 1e-10},
             ["Out"]),
    "spectral_norm": ("spectral_norm", {
        "Weight": [_f(4, 3, 2)], "U": [_f(3, seed=1)], "V": [_f(8, seed=2)]},
        {"dim": 1, "power_iters": 2, "eps": 1e-12}, ["Out"]),
    "data_norm": ("data_norm", {
        "X": [_f(5, 3)], "BatchSize": [np.full(3, 12.0)],
        "BatchSum": [_f(3, seed=1)], "BatchSquareSum": [_pos(3, seed=2) * 9]},
        {"epsilon": 1e-4}, ["Y"]),
    "dropout_is_test_upscale": ("dropout", {"X": [_f(3, 4)]},
                                {"dropout_prob": 0.3, "is_test": True,
                                 "dropout_implementation":
                                     "upscale_in_train"}, ["Out"]),
    "dropout_is_test_downgrade": ("dropout", {"X": [_f(3, 4)]},
                                  {"dropout_prob": 0.3, "is_test": True,
                                   "dropout_implementation":
                                       "downgrade_in_infer"}, ["Out"]),
    "dropout_p0_training": ("dropout", {"X": [_f(3, 4)]},
                            {"dropout_prob": 0.0, "is_test": False}, ["Out"]),
    "lookup_table": ("lookup_table", {
        "W": [_f(10, 4)], "Ids": [np.array([[[1], [3]], [[9], [0]]],
                                           np.int64)]},
        {"padding_idx": 9}, ["Out"]),
    "label_smooth": ("label_smooth", {"X": [np.eye(4)[[0, 2, 3]]]},
                     {"epsilon": 0.1}, ["Out"]),
    "label_smooth_prior": ("label_smooth", {
        "X": [np.eye(4)[[0, 2, 3]]], "PriorDist": [_probs(1, 4)]},
        {"epsilon": 0.2}, ["Out"]),
    "nearest_interp_v2_scale": _interp_case(
        "nearest_interp_v2", _IMG, scale=[1.5, 2.0], align_corners=False),
    "nearest_interp_corners": _interp_case(
        "nearest_interp", _IMG, out_h=7, out_w=4, align_corners=True),
    "bilinear_interp_v2_half_pixel": _interp_case(
        "bilinear_interp_v2", _IMG, out_h=8, out_w=9, align_corners=False,
        align_mode=0),
    "bilinear_interp_v2_scale_nhwc": _interp_case(
        "bilinear_interp_v2", _f(2, 5, 6, 3), scale=[0.6], align_corners=False,
        align_mode=0, data_layout="NHWC"),
    "bilinear_interp_corners": _interp_case(
        "bilinear_interp", _IMG, out_h=3, out_w=11, align_corners=True),
    "linear_interp": _interp_case("linear_interp", _f(2, 3, 7), out_w=12,
                                  align_corners=False, align_mode=1),
    "linear_interp_v2": _interp_case("linear_interp_v2", _f(2, 3, 7),
                                     out_w=5, align_corners=True),
    "trilinear_interp": _interp_case("trilinear_interp", _VOL, out_d=6,
                                     out_h=3, out_w=7, align_corners=False,
                                     align_mode=0),
    "trilinear_interp_v2": _interp_case("trilinear_interp_v2", _VOL,
                                        scale=[2.0], align_corners=True),
    "bicubic_interp": _interp_case("bicubic_interp", _IMG, out_h=9, out_w=4,
                                   align_corners=False),
    "bicubic_interp_v2": _interp_case("bicubic_interp_v2", _IMG, out_h=7,
                                      out_w=10, align_corners=True),
    "prelu_all": ("prelu", {"X": [_WIDE], "Alpha": [np.array([0.25])]},
                  {"mode": "all"}, ["Out"]),
    "prelu_channel": ("prelu", {"X": [_f(2, 3, 4, 4)],
                                "Alpha": [_f(3, seed=1)]},
                      {"mode": "channel"}, ["Out"]),
    "prelu_element": ("prelu", {"X": [_f(2, 3, 4)],
                                "Alpha": [_f(3, 4, seed=1)]},
                      {"mode": "element"}, ["Out"]),
    "maxout": ("maxout", {"X": [_f(2, 6, 3, 3)]}, {"groups": 2, "axis": 1},
               ["Out"]),
    "unfold": ("unfold", {"X": [_f(2, 3, 5, 5)]},
               {"kernel_sizes": [2, 3], "strides": [1, 2],
                "paddings": [1, 1], "dilations": [1, 1]}, ["Y"]),
    "unfold_four_pads_dilated": ("unfold", {"X": [_f(1, 2, 6, 5)]},
                                 {"kernel_sizes": [2, 2],
                                  "strides": [2, 1],
                                  "paddings": [0, 1, 2, 0],
                                  "dilations": [2, 1]}, ["Y"]),
    "spp_max": ("spp", {"X": [_f(2, 3, 8, 6)]},
                {"pyramid_height": 3, "pooling_type": "max"}, ["Out"]),
    "spp_avg": ("spp", {"X": [_f(2, 3, 5, 5)]},
                {"pyramid_height": 2, "pooling_type": "avg"}, ["Out"]),
    "selu": ("selu", {"X": [_WIDE]}, {}, ["Out"]),
    "cross_entropy2": ("cross_entropy2", {
        "X": [_probs(5, 6)],
        "Label": [np.array([[1], [0], [-100], [5], [2]], np.int64)]},
        {"soft_label": False, "ignore_index": -100}, ["Y"]),
    "hinge_loss": ("hinge_loss", {"Logits": [_f(6, 1)],
                                  "Labels": [np.array([[0.], [1.], [1.],
                                                       [0.], [1.], [0.]])]},
                   {}, ["Loss"]),
    "hierarchical_sigmoid": ("hierarchical_sigmoid", {
        "X": [_f(4, 5)], "W": [_f(5, 5, seed=1)],
        "Label": [np.array([[0], [5], [3], [2]], np.int64)],
        "Bias": [_f(5, 1, seed=2)]}, {"num_classes": 6}, ["Out"]),
    "hierarchical_sigmoid_custom_tree": ("hierarchical_sigmoid", {
        "X": [_f(4, 5)], "W": [_f(5, 5, seed=1)],
        "Label": [np.zeros((4, 1), np.int64)], "PathTable": [_HS_PATH],
        "PathCode": [_HS_CODE]}, {"num_classes": 6}, ["Out"]),
    "nll_loss_mean": ("nll_loss", {
        "X": [np.log(_probs(5, 4))], "Label": [_ids((5,), 4)],
        "Weight": [_pos(4, seed=1)]},
        {"ignore_index": 2, "reduction": "mean"}, ["Out"]),
    "nll_loss_none_4d": ("nll_loss", {
        "X": [_f(2, 3, 2, 2)], "Label": [_ids((2, 2, 2), 3)]},
        {"ignore_index": -100, "reduction": "none"}, ["Out"]),
    "nll_loss_sum": ("nll_loss", {"X": [_f(5, 4)], "Label": [_ids((5,), 4)]},
                     {"ignore_index": -100, "reduction": "sum"}, ["Out"]),
    "log_loss": ("log_loss", {"Predicted": [_probs(5, 2)[:, :1]],
                              "Labels": [np.array([[1.], [0.], [1.], [1.],
                                                   [0.]])]},
                 {"epsilon": 1e-4}, ["Loss"]),
    "rank_loss": ("rank_loss", {"Label": [np.array([[1.], [0.], [1.]])],
                                "Left": [_f(3, 1)], "Right": [_f(3, 1, seed=1)]},
                  {}, ["Out"]),
    "margin_rank_loss": ("margin_rank_loss", {
        "Label": [np.array([[1.], [-1.], [1.], [-1.]])], "X1": [_f(4, 1)],
        "X2": [_f(4, 1, seed=1)]}, {"margin": 0.1}, ["Out"]),
    "bpr_loss": ("bpr_loss", {"X": [_f(4, 5)],
                              "Label": [_ids((4, 1), 5, seed=1)]}, {},
                 ["Y"]),
    "center_loss": ("center_loss", {
        "X": [_f(5, 3)], "Label": [np.array([[0], [2], [0], [1], [2]],
                                            np.int64)],
        "Centers": [_f(3, 3, seed=1)], "CenterUpdateRate": [np.array([0.3])]},
        {"cluster_num": 3, "need_update": True}, ["Loss"]),
    "sample_logits_customized": ("sample_logits", {
        "Logits": [_f(3, 6)], "Labels": [np.array([[1], [4], [0]], np.int64)],
        "CustomizedSamples": [np.array([[1, 4, 2], [4, 4, 0], [0, 5, 3]],
                                       np.int64)],
        "CustomizedProbabilities": [_probs(3, 3, seed=2)]},
        {"use_customized_samples": True, "remove_accidental_hits": True},
        ["SampledLogits"]),
    # -- the vision bucket --------------------------------------------------------
    **{f"grid_sampler_{mode}_{pad}_{int(al)}": (
        "grid_sampler", {"X": [_f(2, 3, 4, 5)], "Grid": [_GRID]},
        {"mode": mode, "padding_mode": pad, "align_corners": al}, ["Output"])
       for mode, pad, al in [("bilinear", "zeros", True),
                             ("bilinear", "border", False),
                             ("bilinear", "reflection", True),
                             ("bilinear", "reflection", False),
                             ("nearest", "zeros", False)]},
    "affine_grid": ("affine_grid", {"Theta": [_f(2, 2, 3)]},
                    {"output_shape": [2, 3, 4, 5], "align_corners": True},
                    ["Output"]),
    "affine_grid_unaligned": ("affine_grid", {"Theta": [_f(2, 2, 3)]},
                              {"output_shape": [2, 1, 3, 2],
                               "align_corners": False}, ["Output"]),
    "affine_channel": ("affine_channel", {
        "X": [_f(2, 3, 4, 4)], "Scale": [_f(3, seed=1)],
        "Bias": [_f(3, seed=2)]}, {"data_layout": "NCHW"}, ["Out"]),
    "affine_channel_nhwc": ("affine_channel", {
        "X": [_f(2, 4, 4, 3)], "Scale": [_f(3, seed=1)],
        "Bias": [_f(3, seed=2)]}, {"data_layout": "NHWC"}, ["Out"]),
    "pixel_shuffle": ("pixel_shuffle", {"X": [_f(2, 8, 3, 3)]},
                      {"upscale_factor": 2}, ["Out"]),
    "pixel_shuffle_nhwc": ("pixel_shuffle", {"X": [_f(1, 3, 2, 9)]},
                           {"upscale_factor": 3, "data_format": "NHWC"},
                           ["Out"]),
    "space_to_depth": ("space_to_depth", {"X": [_f(2, 8, 4, 6)]},
                       {"blocksize": 2}, ["Out"]),
    "temporal_shift": ("temporal_shift", {"X": [_f(6, 8, 2, 2)]},
                       {"seg_num": 3, "shift_ratio": 0.25}, ["Out"]),
    "crop": ("crop", {"X": [_f(4, 5)]}, {"shape": [2, 3],
                                         "offsets": [1, 2]}, ["Out"]),
    "crop_tensor_like_y": ("crop_tensor", {"X": [_f(3, 4, 5)],
                                           "Y": [_f(2, 4, 2)]},
                           {"offsets": [1, 0, 3]}, ["Out"]),
    "crop_tensor_offsets": ("crop_tensor", {
        "X": [_f(4, 5)], "Offsets": [np.array([1, 4], np.int32)]},
        {"shape": [2, -1]}, ["Out"]),
    "pad_constant_like": ("pad_constant_like", {"X": [_f(4, 5)],
                                                "Y": [_f(2, 3, seed=1)]},
                          {"pad_value": 1.5}, ["Out"]),
    "expand_as": ("expand_as", {"X": [_f(2, 3)],
                                "target_tensor": [_f(4, 6, seed=1)]}, {},
                  ["Out"]),
    "max_pool2d_with_index": ("max_pool2d_with_index", {"X": [_f(2, 3, 6, 5)]},
                              {"ksize": [3, 3], "strides": [2, 2],
                               "paddings": [1, 1]}, ["Out"]),
    "max_pool2d_with_index_adaptive": ("max_pool2d_with_index", {
        "X": [_f(2, 3, 5, 7)]}, {"ksize": [2, 3], "adaptive": True},
        ["Out"]),
    "max_pool2d_with_index_global": ("max_pool2d_with_index", {
        "X": [_f(1, 2, 3, 4)]}, {"ksize": [2, 2], "global_pooling": True},
        ["Out"]),
    "max_pool3d_with_index": ("max_pool3d_with_index", {"X": [_VOL]},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                               "paddings": [0, 1, 1]}, ["Out"]),
    "max_pool3d_with_index_adaptive": ("max_pool3d_with_index", {
        "X": [_VOL]}, {"ksize": [2, 3, 2], "adaptive": True}, ["Out"]),
    "unpool": ("unpool", {"X": [_f(2, 3, 3, 3)], "Indices": [_UNPOOL_IDX]},
               {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
               ["Out"]),
    "deformable_conv": ("deformable_conv", {
        "Input": [_f(1, 4, 5, 5)], "Offset": [_OFFSET],
        "Mask": [_probs(18, 25, seed=4).reshape(1, 18, 5, 5) * 10],
        "Filter": [_f(6, 2, 3, 3, seed=1)]},
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 2, "deformable_groups": 2, "im2col_step": 1},
        ["Output"]),
    "deformable_conv_v1": ("deformable_conv_v1", {
        "Input": [_f(1, 4, 5, 5)], "Offset": [_OFFSET[:, :18, ::2, ::2]],
        "Filter": [_f(2, 4, 3, 3, seed=1)]},
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1, "deformable_groups": 1}, ["Output"]),
    "bilinear_tensor_product": ("bilinear_tensor_product", {
        "X": [_f(3, 4)], "Y": [_f(3, 5, seed=1)],
        "Weight": [_f(2, 4, 5, seed=2)], "Bias": [_f(1, 2, seed=3)]}, {},
        ["Out"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_matches_the_reference_float32(name):
    _check(name, "float32", CASES)


# float64: the first case of each op type (its other forms take the same
# code in float64 as in float32)
FLOAT64_CASES = sorted({c[0]: n for n, c in reversed(list(CASES.items()))}
                       .values())


@pytest.mark.parametrize("name", FLOAT64_CASES)
def test_rule_matches_the_reference_float64(name):
    _check(name, "float64", CASES)


# -- the nn and vision buckets: forms the two-registry harness cannot hold ------

def _scatter_transpose(x, w, stride, pad, out_pad):
    """conv2d_transpose by its definition (the comment of the reference's
    rule, nn_ops.py:119-122): x[n, c, i, j] W[c, o, ki, kj] lands at
    [i s + ki - pad, j s + kj - pad], the output (H - 1) s + k - 2 pad +
    out_pad a side."""
    n, cin, h, wd = x.shape
    _, cout, kh, kw = w.shape
    oh = (h - 1) * stride + kh - 2 * pad + out_pad
    ow = (wd - 1) * stride + kw - 2 * pad + out_pad
    out = np.zeros((n, cout, oh, ow))
    for i in range(h):
        for j in range(wd):
            for ki in range(kh):
                for kj in range(kw):
                    r, c = i * stride + ki - pad, j * stride + kj - pad
                    if 0 <= r < oh and 0 <= c < ow:
                        out[:, :, r, c] += np.einsum(
                            "nc,co->no", x[:, :, i, j], w[:, :, ki, kj])
    return out


@pytest.mark.parametrize("stride,pad,out_pad", [(2, 1, 1), (3, 1, 2),
                                                (2, 0, 1)])
def test_conv2d_transpose_output_padding_is_the_scatter(stride, pad,
                                                        out_pad):
    """The port's output_padding rows and columns take the scatter's
    contributions (the numpy oracle above, i.e. torch's
    conv_transpose2d); every other position, and the gradients under a
    cotangent that is 0 on those rows and columns, match the reference,
    whose rule zero-fills them (ROADMAP queue 3)."""
    x, w = _f(2, 3, 4, 4), _f(3, 2, 3, 3, seed=1)
    attrs = _conv_attrs([stride, stride], [pad, pad],
                        output_padding=[out_pad, out_pad])
    oracle = _scatter_transpose(x, w, stride, pad, out_pad)
    ct = _rng(7).randn(*oracle.shape)
    ct[:, :, -out_pad:, :] = 0.0
    ct[:, :, :, -out_pad:] = 0.0
    ins = {"Input": [x], "Filter": [w]}
    with jax.enable_x64(True):
        want, want_grads = _reference("conv2d_transpose", ins, attrs,
                                      ["Output"], [ct])
    got, got_grads = _port("conv2d_transpose", ins, attrs, ["Output"],
                           ["Output"], [ct])
    g, w_ = got["Output"][0], want["Output"][0]
    np.testing.assert_allclose(g, oracle, **F64)
    np.testing.assert_allclose(g[:, :, :-out_pad, :-out_pad],
                               w_[:, :, :-out_pad, :-out_pad], **F64)
    assert not w_[:, :, -out_pad:, :].any() and \
        not w_[:, :, :, -out_pad:].any()
    if pad:  # the scatter reaches min(pad, out_pad) of the added rows
        assert np.abs(g[:, :, -out_pad:, :]).max() > 0.1
    for path, wg in want_grads.items():
        np.testing.assert_allclose(got_grads[path], wg, err_msg=str(path),
                                   **F64)


def test_nce_costs_the_classes_it_drew():
    """nce draws its negatives from the op's generator (torch's bits):
    the cost is the reference formula (nn_ops.py:886-893) over the
    classes it reports in SampleLabels; the true classes lead each row,
    the drawn ones lie in [0, total), and the same seed draws the same."""
    x, w, b = _f(4, 3), _f(7, 3, seed=1), _f(7, seed=2)
    label = np.array([[1], [6], [0], [3]], np.int64)
    attrs = {"num_total_classes": 7, "num_neg_samples": 5, "seed": 3}
    ins = {"Input": [x], "Label": [label], "Weight": [w], "Bias": [b]}
    slots = ["Cost", "SampleLogits", "SampleLabels"]
    got, grads = _port("nce", ins, attrs, slots, ["Cost"],
                       [np.ones((4, 1))])
    ids = got["SampleLabels"][0]
    assert ids.shape == (4, 6) and (ids[:, :1] == label).all()
    assert ids.min() >= 0 and ids.max() < 7
    o = 1 / (1 + np.exp(-(np.einsum("btd,bd->bt", w[ids], x) + b[ids])))
    kq = 5 / 7
    cost = (-np.log(o[:, :1] / (o[:, :1] + kq)).sum(1)
            - np.log(kq / (o[:, 1:] + kq)).sum(1))[:, None]
    np.testing.assert_allclose(got["Cost"][0], cost, **F64)
    np.testing.assert_allclose(got["SampleLogits"][0], o, **F64)
    again, _ = _port("nce", ins, attrs, slots, [], [])
    np.testing.assert_array_equal(again["SampleLabels"][0], ids)
    assert set(grads) == {("Input", 0), ("Weight", 0), ("Bias", 0)}


def test_sample_logits_draws_log_uniform_ids():
    """Without customized samples the ids are drawn (torch's bits) and
    shared by the rows; the probabilities are 1 - (1 - p)^S of the
    log-uniform p, and each sampled logit is the logit at its id minus
    log q, less 1e20 on an accidental hit of a true label."""
    logits = _f(3, 6)
    labels = np.array([[1], [4], [0]], np.int64)
    attrs = {"num_samples": 4, "seed": 5, "remove_accidental_hits": True}
    got, _ = _port("sample_logits", {"Logits": [logits], "Labels": [labels]},
                   attrs, ["Samples", "Probabilities", "SampledLogits",
                           "SampledLabels"], [], [])
    smp = got["Samples"][0]
    assert smp.shape == (3, 5) and (smp[:, :1] == labels).all()
    assert (smp[:, 1:] == smp[:1, 1:]).all()
    p = (np.log(smp + 2.0) - np.log(smp + 1.0)) / np.log(7.0)
    q = -np.expm1(4 * np.log1p(-p))
    np.testing.assert_allclose(got["Probabilities"][0], q, **F64)
    hit = (smp[:, :, None] == labels[:, None, :]).any(-1)
    hit[:, :1] = False
    want = np.take_along_axis(logits, smp, 1) - 1e20 * hit - np.log(q)
    np.testing.assert_allclose(got["SampledLogits"][0], want, **F64)
    assert got["SampledLabels"][0].tolist() == [[0]] * 3


def test_dropout_rule_drops_at_its_rate_and_scales_by_its_mode():
    """Training dropout (torch's bits): about p of 40000 elements dropped
    (within 5 standard errors), the kept ones x / (1 - p) with
    upscale_in_train and x with downgrade_in_infer, Mask the kept ones;
    the same seed draws the same mask."""
    x = np.ones((200, 200))
    for impl, kept_value in (("upscale_in_train", 1 / 0.7),
                             ("downgrade_in_infer", 1.0)):
        attrs = {"dropout_prob": 0.3, "is_test": False, "seed": 11,
                 "dropout_implementation": impl}
        got, _ = _port("dropout", {"X": [x]}, attrs, ["Out", "Mask"], [], [])
        out, mask = got["Out"][0], got["Mask"][0]
        assert mask.dtype == np.uint8
        np.testing.assert_allclose(out[mask == 1], kept_value)
        assert (out[mask == 0] == 0).all()
        assert abs((mask == 0).mean() - 0.3) < 5 * (0.3 * 0.7 / 40000) ** 0.5
        again, _ = _port("dropout", {"X": [x]}, attrs, ["Out", "Mask"], [],
                         [])
        np.testing.assert_array_equal(again["Mask"][0], mask)


@pytest.mark.parametrize("op_type,ins,attrs,ignored", [
    ("maxout", {"X": [_f(2, 4, 3, 3)]}, {"groups": 2, "axis": -1}, "axis"),
    ("depthwise_conv2d_transpose", {"Input": [_f(1, 3, 4, 4)],
                                    "Filter": [_f(3, 1, 3, 3, seed=1)]},
     _conv_attrs([2, 2], [1, 1], groups=0, output_padding=[1, 1]),
     "output_padding"),
])
def test_nn_rules_raise_where_the_reference_reads_no_attr(op_type, ins,
                                                          attrs, ignored):
    """maxout reads no axis (it takes axis 1) and
    depthwise_conv2d_transpose no output_padding: the port's rules raise
    on a value that would change the answer; the reference's answer is
    pinned as the one without it."""
    with pytest.raises(NotImplementedError, match=ignored):
        _both_rules(op_type, ins, attrs, ["Out"])
    without = {k: v for k, v in attrs.items() if k != ignored}
    slot = "Out" if op_type == "maxout" else "Output"
    outs = []
    for a in (attrs, without):
        op = JFW.Operator(JFW.Program().global_block(), 0, op_type,
                          _names({s: len(v) for s, v in ins.items()}), {},
                          dict(a))
        outs.append(np.asarray(JREG._FORWARD[op_type](
            JREG.LowerCtx(jax.random.PRNGKey(0)), op,
            {s: [jnp.asarray(v) for v in vs]
             for s, vs in ins.items()})[slot][0]))
    np.testing.assert_array_equal(outs[0], outs[1])
