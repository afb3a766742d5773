"""The cases of the detection and quantize buckets' op rules
(tests/test_torch_fluid_ops_det.py), in numpy alone, so that
chip_smoke.py runs them on the card against the CPU without JAX: each
case is (op type, {slot: [numpy inputs]}, attrs, output slots that get
cotangents in the parity test)."""

import numpy as np


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float64)


def _probs(n, c, seed=0):
    z = _f(n, c, seed=seed)
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _ids(shape, high, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _rng(seed):
    return np.random.RandomState(seed)


def _boxes(*lead, seed=0, scale=1.0):
    """Corner boxes: x1, y1 in [0, 0.6) scale, sides in [0.1, 0.4)."""
    rng = _rng(seed)
    xy = rng.rand(*lead, 2) * 0.6
    wh = rng.rand(*lead, 2) * 0.3 + 0.1
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float64)


def _clustered(b, m, seed=0):
    """(b, m, 4) boxes in two clusters of near-duplicates: greedy NMS
    has something to suppress."""
    base = _boxes(b, 2, seed=seed)
    jit = _rng(seed + 1).rand(b, m, 4) * 0.04
    return base[:, np.arange(m) % 2] + jit


def _anchors(n, seed=0, scale=16.0):
    return _boxes(n, seed=seed, scale=scale)


_IMG = np.zeros((1, 3, 12, 16))
_PRIOR = {"min_sizes": [4.0], "max_sizes": [8.0], "aspect_ratios": [2.0],
          "flip": True, "clip": True, "variances": [0.1, 0.1, 0.2, 0.2],
          "offset": 0.5}
_NMS = {"score_threshold": 0.05, "nms_top_k": 4, "keep_top_k": 5,
        "nms_threshold": 0.3, "background_label": 0, "normalized": True}
_MATCH = np.array([[0, -1, 2, 1, -1], [-1, 1, -1, -1, 0]], np.int32)
_GT_PIX = np.array([[[1., 1., 7., 6.], [8., 2., 14., 9.], [0., 0., 0., 0.]],
                    [[3., 4., 11., 12.], [0., 0., 0., 0.],
                     [0., 0., 0., 0.]]])
_ANCH = np.array([[0., 0., 6., 6.], [1., 1., 7., 7.], [8., 1., 15., 9.],
                  [9., 3., 13., 8.], [2., 3., 10., 12.], [4., 5., 12., 13.],
                  [10., 10., 15., 15.], [0., 8., 5., 14.]])
_ROIS = np.array([[0.5, 0.7, 4.2, 3.9], [1.1, 0.3, 5.6, 5.2],
                  [2.2, 1.4, 3.9, 4.8]])
_QX = _f(3, 4) * 2
_QSTATE = {"InScale": [np.array([0.5])], "InAccum": [np.array([1.2])],
           "InState": [np.array([1.5])]}


def _quad(cx, cy, w, h, angle):
    c, s = np.cos(angle), np.sin(angle)
    pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    rot = pts @ np.array([[c, s], [-s, c]])
    return (rot + [cx, cy]).reshape(-1)


def _segms():
    square = [[1.0, 1.0], [6.0, 1.0], [6.0, 5.0], [1.0, 5.0]]
    tri = [[8.0, 2.0], [13.0, 3.0], [10.0, 9.0], [0.0, 0.0]]
    return np.array([[[square], [tri]]])


# name -> (op type, {slot: [numpy]}, attrs, output slots that get
# cotangents (empty: forward only))
CASES = {
    # -- the SSD set --------------------------------------------------------------
    "prior_box": ("prior_box", {"Input": [np.zeros((1, 2, 3, 4))],
                                "Image": [_IMG]}, _PRIOR, []),
    "prior_box_mmar_steps": ("prior_box", {
        "Input": [np.zeros((1, 2, 2, 3))], "Image": [_IMG]},
        dict(_PRIOR, aspect_ratios=[2.0, 3.0], min_sizes=[3.0, 5.0],
             max_sizes=[6.0, 9.0], clip=False, step_w=5.0, step_h=6.0,
             min_max_aspect_ratios_order=True), []),
    "density_prior_box": ("density_prior_box", {
        "Input": [np.zeros((1, 2, 3, 3))], "Image": [np.zeros((1, 3, 24,
                                                                24))]},
        {"fixed_sizes": [8.0, 12.0], "fixed_ratios": [1.0, 2.0],
         "densities": [2, 1], "clip": True,
         "variances": [0.1, 0.1, 0.2, 0.2]}, []),
    "box_coder_encode": ("box_coder", {
        "PriorBox": [_boxes(6)], "PriorBoxVar": [_boxes(6, seed=1) + 0.1],
        "TargetBox": [_boxes(3, seed=2)]},
        {"code_type": "encode_center_size"}, ["OutputBox"]),
    "box_coder_encode_var_attr": ("box_coder", {
        "PriorBox": [_boxes(5, scale=20)], "TargetBox": [_boxes(
            2, seed=2, scale=20)]},
        {"code_type": "encode_center_size", "box_normalized": False,
         "variance": [0.1, 0.1, 0.2, 0.2]}, ["OutputBox"]),
    "box_coder_decode": ("box_coder", {
        "PriorBox": [_boxes(6)], "PriorBoxVar": [_boxes(6, seed=1) + 0.1],
        "TargetBox": [_f(2, 6, 4, seed=3, scale=0.5)]},
        {"code_type": "decode_center_size"}, ["OutputBox"]),
    "box_coder_decode_axis1": ("box_coder", {
        "PriorBox": [_boxes(2, scale=20)],
        "TargetBox": [_f(2, 3, 4, seed=3, scale=0.5)]},
        {"code_type": "decode_center_size", "axis": 1,
         "box_normalized": False, "variance": [0.1, 0.1, 0.2, 0.2]},
        ["OutputBox"]),
    "iou_similarity": ("iou_similarity", {"X": [_boxes(4)],
                                          "Y": [_boxes(5, seed=1)]},
                       {}, ["Out"]),
    "iou_similarity_pixels": ("iou_similarity", {
        "X": [_boxes(3, scale=10)], "Y": [_boxes(4, seed=1, scale=10)]},
        {"box_normalized": False}, ["Out"]),
    "bipartite_match": ("bipartite_match", {
        "DistMat": [np.abs(_f(2, 3, 6)) * (_f(2, 3, 6, seed=1) > -0.5)]},
        {}, []),
    "bipartite_match_per_prediction": ("bipartite_match", {
        "DistMat": [_rng(4).rand(2, 3, 7)]},
        {"match_type": "per_prediction", "dist_threshold": 0.5}, []),
    "target_assign": ("target_assign", {"X": [_f(2, 3, 4)],
                                        "MatchIndices": [_MATCH]},
                      {"mismatch_value": 0}, ["Out"]),
    "target_assign_labels": ("target_assign", {
        "X": [_ids((2, 3, 1), 5)], "MatchIndices": [_MATCH]},
        {"mismatch_value": 7}, []),
    "mine_hard_examples": ("mine_hard_examples", {
        "ClsLoss": [np.abs(_f(2, 8))],
        "MatchIndices": [np.array([[0, -1, -1, 1, -1, -1, -1, -1],
                                   [-1, -1, 0, -1, -1, -1, -1, -1]],
                                  np.int32)],
        "MatchDist": [_rng(5).rand(2, 8)]},
        {"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.5}, []),
    "multiclass_nms": ("multiclass_nms", {
        "BBoxes": [_clustered(2, 6)],
        "Scores": [_probs(6, 3, seed=2).T.reshape(1, 3, 6).repeat(2, 0)
                   * np.array([1.0, 0.9])[:, None, None]]}, _NMS, []),
    "multiclass_nms2": ("multiclass_nms2", {
        "BBoxes": [_clustered(2, 6, seed=3)],
        "Scores": [_rng(6).rand(2, 3, 6)]},
        dict(_NMS, keep_top_k=-1, nms_top_k=-1), []),
    "multiclass_nms3_pixels": ("multiclass_nms3", {
        "BBoxes": [_clustered(1, 5, seed=4) * 20],
        "Scores": [_rng(7).rand(1, 3, 5)]},
        dict(_NMS, normalized=False, background_label=-1,
             nms_threshold=0.5), []),
    # -- the other NMS rules --------------------------------------------------------
    "matrix_nms": ("matrix_nms", {"BBoxes": [_clustered(2, 6)],
                                  "Scores": [_rng(6).rand(2, 3, 6)]},
                   dict(_NMS, post_threshold=0.1), []),
    "matrix_nms_gaussian": ("matrix_nms", {
        "BBoxes": [_clustered(2, 6, seed=5)],
        "Scores": [_rng(8).rand(2, 3, 6)]},
        dict(_NMS, use_gaussian=True, gaussian_sigma=2.0), []),
    "locality_aware_nms": ("locality_aware_nms", {
        "BBoxes": [_clustered(1, 5, seed=6)],
        "Scores": [_rng(9).rand(1, 2, 5)]},
        {"score_threshold": 0.1, "nms_top_k": 4, "keep_top_k": 4,
         "nms_threshold": 0.3, "background_label": -1}, []),
    "locality_aware_nms_quads": ("locality_aware_nms", {
        "BBoxes": [np.stack([_quad(5, 5, 4, 2, 0.1), _quad(5.3, 5.1, 4, 2,
                                                           0.15),
                             _quad(12, 4, 3, 3, 0.7),
                             _quad(5.1, 4.9, 3.8, 2.1, 0.05)])[None]],
        "Scores": [np.array([[[0.9, 0.6, 0.8, 0.3]]])]},
        {"score_threshold": 0.1, "nms_top_k": 4, "keep_top_k": 4,
         "nms_threshold": 0.2, "background_label": -1,
         "normalized": False}, []),
    # -- YOLO -----------------------------------------------------------------------
    "yolo_box": ("yolo_box", {
        "X": [_f(2, 16, 3, 3, seed=1)],
        "ImgSize": [np.array([[24, 32], [30, 20]], np.int32)]},
        {"anchors": [10, 13, 16, 30], "class_num": 3, "conf_thresh": 0.3,
         "downsample_ratio": 8, "scale_x_y": 1.2}, ["Boxes", "Scores"]),
    "yolov3_loss": ("yolov3_loss", {
        "X": [_f(2, 16, 4, 4, seed=2)],
        "GTBox": [np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.5, 0.4],
                             [0.0, 0.0, 0.0, 0.0]],
                            [[0.55, 0.2, 0.1, 0.15], [0.1, 0.8, 0.3, 0.3],
                             [0.9, 0.9, 0.15, 0.1]]])],
        "GTLabel": [np.array([[1, 2, 0], [0, 1, 2]], np.int32)],
        "GTScore": [np.array([[0.9, 0.7, 1.0], [1.0, 0.5, 0.8]])]},
        {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [1, 2],
         "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 8},
        ["Loss"]),
    "yolov3_loss_no_smooth": ("yolov3_loss", {
        "X": [_f(1, 16, 3, 3, seed=4)],
        "GTBox": [np.array([[[0.4, 0.5, 0.6, 0.5], [0.2, 0.2, 0.1, 0.1]]])],
        "GTLabel": [np.array([[2, 0]], np.int32)]},
        {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 2],
         "class_num": 3, "ignore_thresh": 0.3, "downsample_ratio": 8,
         "use_label_smooth": False, "scale_x_y": 1.1}, ["Loss"]),
    # -- RetinaNet ----------------------------------------------------------------
    "sigmoid_focal_loss": ("sigmoid_focal_loss", {
        "X": [_f(5, 3)], "Label": [np.array([[0], [1], [3], [2], [1]],
                                            np.int32)],
        "FgNum": [np.array([3], np.int32)]},
        {"gamma": 2.0, "alpha": 0.25}, ["Out"]),
    "retinanet_target_assign": ("retinanet_target_assign", {
        "Anchor": [_ANCH], "GtBoxes": [_GT_PIX],
        "GtLabels": [np.array([[3, 1, 0], [2, 0, 0]], np.int32)],
        "IsCrowd": [np.array([[0, 0, 0], [0, 0, 0]], np.int32)]},
        {"positive_overlap": 0.5, "negative_overlap": 0.4}, []),
    "retinanet_detection_output": ("retinanet_detection_output", {
        "BBoxes": [_f(2, 6, 4, seed=1, scale=0.2),
                   _f(2, 3, 4, seed=2, scale=0.2)],
        "Scores": [_rng(3).rand(2, 6, 3), _rng(4).rand(2, 3, 3)],
        "Anchors": [_anchors(6, seed=5), _anchors(3, seed=6)],
        "ImInfo": [np.array([[16., 16., 1.], [20., 14., 2.]])]},
        {"score_threshold": 0.05, "nms_top_k": 5, "keep_top_k": 6,
         "nms_threshold": 0.3}, []),
    # -- the R-CNN set ------------------------------------------------------------
    "anchor_generator": ("anchor_generator", {
        "Input": [np.zeros((1, 2, 3, 4))]},
        {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [16.0, 16.0], "offset": 0.5}, []),
    "box_clip": ("box_clip", {
        "Input": [_f(2, 5, 4, seed=1, scale=10) + 5],
        "ImInfo": [np.array([[12., 10., 1.], [25., 17., 2.]])]}, {},
        ["Output"]),
    "box_clip_2d": ("box_clip", {
        "Input": [_f(4, 4, seed=2, scale=10) + 5],
        "ImInfo": [np.array([[9., 11., 1.5]])]}, {}, ["Output"]),
    "generate_proposals": ("generate_proposals", {
        "Scores": [_f(2, 2, 3, 3, seed=1)],
        "BboxDeltas": [_f(2, 8, 3, 3, seed=2, scale=0.3)],
        "ImInfo": [np.array([[40., 44., 1.], [36., 48., 2.]])],
        "Anchors": [_anchors(18, seed=3, scale=40).reshape(3, 3, 2, 4)],
        "Variances": [np.full((3, 3, 2, 4), 1.0)]},
        {"pre_nms_topN": 12, "post_nms_topN": 6, "nms_thresh": 0.5,
         "min_size": 2.0}, []),
    "generate_proposals_v2": ("generate_proposals_v2", {
        "Scores": [_f(2, 2, 3, 3, seed=4)],
        "BboxDeltas": [_f(2, 8, 3, 3, seed=5, scale=0.3)],
        "ImShape": [np.array([[40., 44.], [36., 48.]])],
        "Anchors": [_anchors(18, seed=6, scale=40).reshape(3, 3, 2, 4)],
        "Variances": [np.full((3, 3, 2, 4), 0.5)]},
        {"pre_nms_topN": 10, "post_nms_topN": 8, "nms_thresh": 0.6,
         "min_size": 1.0}, []),
    # positives and negatives fewer than the subsample's sizes: the draws
    # change nothing (the sampled case is held below)
    "rpn_target_assign": ("rpn_target_assign", {
        "Anchor": [_ANCH], "GtBoxes": [_GT_PIX]},
        {"rpn_batch_size_per_im": 64, "rpn_fg_fraction": 0.5,
         "rpn_positive_overlap": 0.6, "rpn_negative_overlap": 0.3}, []),
    # one foreground (the gt itself) and at most one background an image
    "generate_proposal_labels": ("generate_proposal_labels", {
        "RpnRois": [np.array([[[0., 0., 3., 3.], [10., 10., 14., 13.]],
                              [[6., 7., 12., 13.], [20., 2., 23., 6.]]])],
        "GtClasses": [np.array([[2], [1]], np.int32)],
        "IsCrowd": [np.zeros((2, 1), np.int32)],
        "GtBoxes": [np.array([[[1., 1., 4., 4.]], [[4., 5., 9., 10.]]])],
        "ImInfo": [np.array([[30., 30., 1.], [30., 30., 1.]])]},
        {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.1, "class_nums": 3}, []),
    "generate_mask_labels": ("generate_mask_labels", {
        "ImInfo": [np.array([[20., 20., 2.]])],
        "GtClasses": [np.array([[1, 2]], np.int32)],
        "IsCrowd": [np.array([[0, 0]], np.int32)],
        "GtSegms": [_segms()],
        "GtSegmsVerts": [np.array([[[4], [3]]], np.int32)],
        "Rois": [np.array([[[2., 2., 12., 10.], [16., 4., 26., 18.],
                            [0., 0., 4., 4.]]])],
        "LabelsInt32": [np.array([[1, 2, 0]], np.int32)]},
        {"num_classes": 3, "resolution": 4}, []),
    "distribute_fpn_proposals": ("distribute_fpn_proposals", {
        "FpnRois": [np.array([[0., 0., 20., 20.], [0., 0., 300., 280.],
                              [5., 5., 90., 120.], [0., 0., 600., 500.],
                              [3., 3., 40., 30.], [0., 0., 900., 900.]])],
        "RoisNum": [np.array([5], np.int32)]},
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}, []),
    "collect_fpn_proposals": ("collect_fpn_proposals", {
        "MultiLevelRois": [_boxes(3, scale=20), _boxes(2, seed=1, scale=20)],
        "MultiLevelScores": [_rng(2).rand(3, 1), _rng(3).rand(2, 1)]},
        {"post_nms_topN": 4}, []),
    "box_decoder_and_assign": ("box_decoder_and_assign", {
        "PriorBox": [_anchors(4, seed=1)],
        "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2])],
        "TargetBox": [_f(4, 12, seed=2, scale=0.5)],
        "BoxScore": [_probs(4, 3, seed=3)]},
        {"box_clip": 4.135}, ["DecodeBox", "OutputAssignBox"]),
    # -- the ROI pools ---------------------------------------------------------------
    "roi_align": ("roi_align", {
        "X": [_f(2, 3, 6, 6)], "ROIs": [_ROIS * 2],
        "RoisNum": [np.array([1, 2], np.int32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5,
         "sampling_ratio": 2}, ["Out"]),
    "roi_align_default_ratio": ("roi_align", {
        "X": [_f(1, 2, 5, 7)], "ROIs": [_ROIS]},
        {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0},
        ["Out"]),
    "roi_pool": ("roi_pool", {
        "X": [_f(2, 3, 6, 6)], "ROIs": [_ROIS],
        "RoisNum": [np.array([2, 1], np.int32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0},
        ["Out"]),
    "psroi_pool": ("psroi_pool", {
        "X": [_f(2, 8, 6, 6)], "ROIs": [_ROIS],
        "RoisNum": [np.array([1, 2], np.int32)]},
        {"pooled_height": 2, "pooled_width": 2, "output_channels": 2,
         "spatial_scale": 1.0}, ["Out"]),
    "prroi_pool": ("prroi_pool", {
        "X": [_f(2, 3, 6, 6)], "ROIs": [_ROIS],
        "BatchRoINums": [np.array([2, 1], np.int32)]},
        {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 1.0},
        ["Out"]),
    "polygon_box_transform": ("polygon_box_transform", {
        "Input": [_f(1, 8, 3, 4)]}, {}, ["Output"]),
    # -- the quantize bucket ------------------------------------------------------
    "fake_quantize_abs_max": ("fake_quantize_abs_max", {"X": [_QX]},
                              {"bit_length": 8}, ["Out"]),
    "fake_quantize_dequantize_abs_max": (
        "fake_quantize_dequantize_abs_max", {"X": [_QX]}, {"bit_length": 4},
        ["Out"]),
    "fake_quantize_moving_average_abs_max": (
        "fake_quantize_moving_average_abs_max", dict(_QSTATE, X=[_QX]),
        {"moving_rate": 0.8}, ["Out"]),
    "fake_quantize_dequantize_moving_average_abs_max": (
        "fake_quantize_dequantize_moving_average_abs_max",
        dict(_QSTATE, X=[_QX]), {"moving_rate": 0.9}, ["Out"]),
    "fake_quantize_dequantize_moving_average_abs_max_test": (
        "fake_quantize_dequantize_moving_average_abs_max",
        dict(_QSTATE, X=[_QX]), {"is_test": True}, ["Out"]),
    "fake_quantize_range_abs_max": ("fake_quantize_range_abs_max", {
        "X": [_QX], "InScale": [np.array([5.0])]}, {}, ["Out"]),
    "fake_quantize_range_abs_max_grows": ("fake_quantize_range_abs_max", {
        "X": [_QX], "InScale": [np.array([0.5])]}, {"bit_length": 6},
        ["Out"]),
    "fake_channel_wise_quantize_abs_max": (
        "fake_channel_wise_quantize_abs_max", {"X": [_f(3, 2, 2, 2)]},
        {"quant_axis": 0}, ["Out"]),
    "fake_channel_wise_quantize_dequantize_abs_max": (
        "fake_channel_wise_quantize_dequantize_abs_max",
        {"X": [_f(2, 3, 2, seed=1)]}, {"quant_axis": 1}, ["Out"]),
    "fake_dequantize_max_abs": ("fake_dequantize_max_abs", {
        "X": [_f(3, 4) * 100], "Scale": [np.array([2.0])]},
        {"max_range": 127.0}, ["Out"]),
    "moving_average_abs_max_scale": ("moving_average_abs_max_scale", {
        "X": [_QX], "InAccum": [np.array([1.2])],
        "InState": [np.array([1.5])]}, {"moving_rate": 0.9}, []),
    "dequantize_abs_max": ("dequantize_abs_max", {
        "X": [_ids((3, 4), 255) - 127], "Scale": [np.array([0.5])]},
        {"max_range": 127.0}, []),
    "dequantize_log": ("dequantize_log", {
        "X": [np.array([[-128, -1, 0, 5], [127, -60, 64, 3]], np.int64)],
        "Dict": [np.exp(-np.arange(128) / 16.0)]}, {}, []),
    "fake_channel_wise_dequantize_max_abs": (
        "fake_channel_wise_dequantize_max_abs", {
            "X": [_f(3, 4, 2) * 50], "Scales": [np.array([1.0, 2.0, 0.5])]},
        {"quant_axis": 0}, ["Out"]),
    "fake_channel_wise_dequantize_max_abs_two": (
        "fake_channel_wise_dequantize_max_abs", {
            "X": [_f(2, 4, 3) * 50],
            "Scales": [np.array([1.0, 2.0, 0.5, 3.0]), np.array([0.25])]},
        {}, ["Out"]),
}
