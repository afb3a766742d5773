"""The detection layers of fluid.layers (counterpart of
paddle_tpu/fluid/layers/detection.py, Paddle's layers/detection.py:
prior_box, multiclass_nms, box_coder, yolo_box, iou_similarity,
bipartite_match, anchor_generator, box_clip, sigmoid_focal_loss,
roi_align, the SSD head detection_output and yolov3_loss).

The rules give dense outputs where Paddle gives ragged LoD results:
fixed-shape padded tensors and counts (ops/detection_ops.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "anchor_generator", "box_coder", "iou_similarity",
    "box_clip", "bipartite_match", "multiclass_nms", "yolo_box",
    "sigmoid_focal_loss", "roi_align", "detection_output",
    "yolov3_loss",
]


def _det_op(op_type, inputs, attrs, out_slots, dtype="float32", name=None):
    """out_slots: slot names; per-slot dtype via a (slot, dtype) tuple,
    plain slots default to `dtype`."""
    helper = LayerHelper(op_type, name=name)
    slots = [(s, dtype) if isinstance(s, str) else s for s in out_slots]
    outs = {s: [helper.create_variable_for_type_inference(dtype=dt)]
            for s, dt in slots}
    helper.append_op(op_type, inputs=inputs, outputs=outs,
                     attrs=attrs or {}, infer_shape=False)
    ret = [outs[s][0] for s, _ in slots]
    return ret[0] if len(ret) == 1 else tuple(ret)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    return _det_op("prior_box", {"Input": [input], "Image": [image]},
                   {"min_sizes": list(min_sizes),
                    "max_sizes": list(max_sizes or []),
                    "aspect_ratios": list(aspect_ratios),
                    "variances": list(variance), "flip": flip,
                    "clip": clip, "step_w": steps[0], "step_h": steps[1],
                    "offset": offset,
                    "min_max_aspect_ratios_order":
                        min_max_aspect_ratios_order},
                   ("Boxes", "Variances"), name=name)


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    return _det_op("anchor_generator", {"Input": [input]},
                   {"anchor_sizes": list(anchor_sizes),
                    "aspect_ratios": list(aspect_ratios),
                    "variances": list(variance), "stride": list(stride),
                    "offset": offset},
                   ("Anchors", "Variances"), name=name)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    return _det_op("box_coder", ins, attrs, ("OutputBox",), name=name)


def iou_similarity(x, y, box_normalized=True, name=None):
    return _det_op("iou_similarity", {"X": [x], "Y": [y]},
                   {"box_normalized": box_normalized}, ("Out",), name=name)


def box_clip(input, im_info, name=None):
    return _det_op("box_clip", {"Input": [input], "ImInfo": [im_info]},
                   {}, ("Output",), name=name)


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    return _det_op("bipartite_match", {"DistMat": [dist_matrix]},
                   {"match_type": match_type,
                    "dist_threshold": dist_threshold},
                   (("ColToRowMatchIndices", "int32"),
                    ("ColToRowMatchDist", "float32")), name=name)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=64, nms_threshold=0.3, normalized=True,
                   background_label=0, return_rois_num=True, name=None):
    """Dense NMS: returns (out (B, keep_top_k, 6), rois_num (B,)); rows
    past an image's count carry label -1."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    num = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op("multiclass_nms3",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out], "NmsRoisNum": [num]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": background_label},
                     infer_shape=False)
    return (out, num) if return_rois_num else out


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             name=None):
    return _det_op("yolo_box", {"X": [x], "ImgSize": [img_size]},
                   {"anchors": [int(a) for a in anchors],
                    "class_num": class_num, "conf_thresh": conf_thresh,
                    "downsample_ratio": downsample_ratio,
                    "clip_bbox": clip_bbox, "scale_x_y": scale_x_y},
                   ("Boxes", "Scores"), name=name)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25, name=None):
    return _det_op("sigmoid_focal_loss",
                   {"X": [x], "Label": [label], "FgNum": [fg_num]},
                   {"gamma": gamma, "alpha": alpha}, ("Out",), name=name)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    ins = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        ins["RoisNum"] = [rois_num]
    return _det_op("roi_align", ins,
                   {"pooled_height": pooled_height,
                    "pooled_width": pooled_width,
                    "spatial_scale": spatial_scale,
                    "sampling_ratio": sampling_ratio}, ("Out",), name=name)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, nms_eta=1.0,
                     return_rois_num=True, name=None):
    """SSD inference head (reference layers/detection.py
    detection_output:97): decode location predictions against the
    priors, then multiclass NMS.  loc (B, M, 4), scores (B, M, C) RAW
    class logits (softmax applied here, matching the reference),
    prior_box (M, 4), prior_box_var (M, 4).  Returns the
    dense (out (B, keep_top_k, 6), rois_num (B,)) contract."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", axis=0)
    from .nn import softmax, transpose

    # the reference layer softmaxes the raw class logits itself
    scores_t = transpose(softmax(scores), [0, 2, 1])  # (B, C, M)
    return multiclass_nms(decoded, scores_t,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label,
                          return_rois_num=return_rois_num, name=name)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3 training loss (reference layers/detection.py
    yolov3_loss:982).  Dense gt contract: gt_box (N, G, 4) normalized
    cxcywh with zero-area rows as padding."""
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    return _det_op("yolov3_loss", ins,
                   {"anchors": [float(a) for a in anchors],
                    "anchor_mask": [int(m) for m in anchor_mask],
                    "class_num": class_num,
                    "ignore_thresh": ignore_thresh,
                    "downsample_ratio": downsample_ratio,
                    "use_label_smooth": use_label_smooth,
                    "scale_x_y": scale_x_y},
                   ("Loss",), name=name)
