"""Detection rules (counterpart of paddle_tpu/ops/detection_ops.py): the
SSD set (prior_box, density_prior_box, box_coder, iou_similarity,
bipartite_match, target_assign, mine_hard_examples, multiclass_nms and
its v2/v3), the other NMS rules (matrix_nms, locality_aware_nms with its
polygon path), YOLO (yolo_box, yolov3_loss), RetinaNet
(sigmoid_focal_loss, retinanet_target_assign,
retinanet_detection_output), the R-CNN set (anchor_generator, box_clip,
generate_proposals and v2, rpn_target_assign, generate_proposal_labels,
generate_mask_labels, distribute/collect_fpn_proposals,
box_decoder_and_assign), the ROI pools (roi_align, roi_pool, psroi_pool,
prroi_pool) and polygon_box_transform.

Each rule computes what the reference's rule computes, slot for slot and
attr for attr, in its dense contract: where Paddle gives ragged LoD
results, the NMS rules give (B, keep_top_k, 6) padded with label -1 and
the counts, and the matching and sampling rules give full-length masks.

How the port runs them on the card:
- The priors and anchors are functions of the shapes and the attrs.
  They are built in numpy once and kept on the device, one copy per
  (op type, attrs, shapes, device) (`_const`), so a training step makes
  no host-to-device copy for them.
- No rule reads a device value on the host.  The reference's sequential
  algorithms (greedy NMS, bipartite matching, the locality-aware merge,
  the polygon clip) become a fixed number of iterations of torch ops,
  each batched over the images and the classes, where the reference
  writes a `lax.fori_loop` / `lax.scan` under `vmap`.
- `lax.top_k`, `jnp.argmax` and the stable `jnp.argsort` put the lower
  index first among equal values; `torch.topk` promises no order there,
  so every ranking here is a stable sort (`_top_k`, `_rank`).
- The random subsamples of rpn_target_assign and
  generate_proposal_labels draw from the op's own torch generator: the
  same seed gives other bits than `jax.random`, from the same
  distribution.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import first, register_op

# -- helpers ----------------------------------------------------------------------

_CONSTS: dict = {}
_CONSTS_MAX = 256


def _const(key, device, build):
    """The tensor `build()` (numpy, float32) on `device`, built once for
    `key` and the device and kept (at most _CONSTS_MAX entries, the
    oldest dropped first)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return [torch.from_numpy(a).to(dev) for a in build()]
    full = (key, str(dev))
    hit = _CONSTS.get(full)
    if hit is None:
        if len(_CONSTS) >= _CONSTS_MAX:
            _CONSTS.pop(next(iter(_CONSTS)))
        hit = [torch.from_numpy(a).to(dev) for a in build()]
        _CONSTS[full] = hit
    return hit


def _attr_tensor(values, dtype, device):
    """A list attr as a tensor on `device`, copied there once (_const)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return _const(("attr", tuple(values), str(dtype)), device,
                  lambda: [np.asarray(values, dtype=np_dtype)])[0]


def _attr_key(op, names):
    def frozen(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v
    return (op.type,) + tuple((n, frozen(op.attr(n, None))) for n in names)


def _top_k(x, k):
    """lax.top_k along the last dim: the k largest, the lower index first
    among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _rank(x):
    """jnp.argsort(jnp.argsort(x)) along the last dim: each element's
    place in the stable ascending order."""
    order = torch.argsort(x, dim=-1, stable=True)
    ar = torch.arange(x.shape[-1], device=x.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def _take(x, idx):
    """x (..., N, D) rows at idx (..., K) -> (..., K, D)."""
    idx = idx.long()
    lead = torch.broadcast_shapes(x.shape[:-2], idx.shape[:-1])
    x = x.expand(lead + x.shape[-2:])
    idx = idx.expand(lead + idx.shape[-1:])
    return torch.gather(x, -2, idx[..., None].expand(
        idx.shape + x.shape[-1:]))


def _scalar(v, like):
    """A 0-d tensor of `like`'s dtype and device, filled on the device (a
    copy from the host would synchronise)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


# -- trace-time constant generators (detection_ops.py:43-147) ---------------

def _expand_aspect_ratios(ars, flip):
    out = [1.0]
    for ar in ars:
        if all(abs(ar - o) > 1e-6 for o in out):
            out.append(ar)
            if flip:
                out.append(1.0 / ar)
    return out


_PRIOR_ATTRS = ("min_sizes", "max_sizes", "aspect_ratios", "flip",
                "variances", "step_w", "step_h", "offset",
                "min_max_aspect_ratios_order", "clip")


@register_op("prior_box")
def _prior_box(ctx, op, ins):
    """SSD priors: a function of the feature map's and the image's
    shapes and the attrs, built in numpy once per device."""
    feat = first(ins, "Input")
    img = first(ins, "Image")
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    ih, iw = int(img.shape[2]), int(img.shape[3])

    def build():
        min_sizes = [float(s) for s in op.attr("min_sizes", [])]
        max_sizes = [float(s) for s in op.attr("max_sizes", []) or []]
        ars = _expand_aspect_ratios(
            [float(a) for a in op.attr("aspect_ratios", [1.0])],
            op.attr("flip", False))
        variances = [float(v) for v in op.attr("variances",
                                               [0.1, 0.1, 0.2, 0.2])]
        step_w = op.attr("step_w", 0.0) or iw / fw
        step_h = op.attr("step_h", 0.0) or ih / fh
        offset = op.attr("offset", 0.5)
        mmar_order = op.attr("min_max_aspect_ratios_order", False)
        boxes = []
        for h in range(fh):
            for w in range(fw):
                cx = (w + offset) * step_w
                cy = (h + offset) * step_h

                def emit(bw, bh):
                    boxes.append([(cx - bw) / iw, (cy - bh) / ih,
                                  (cx + bw) / iw, (cy + bh) / ih])

                for s, mn in enumerate(min_sizes):
                    if mmar_order:
                        emit(mn / 2.0, mn / 2.0)
                        if max_sizes:
                            sq = math.sqrt(mn * max_sizes[s]) / 2.0
                            emit(sq, sq)
                        for ar in ars:
                            if abs(ar - 1.0) < 1e-6:
                                continue
                            emit(mn * math.sqrt(ar) / 2.0,
                                 mn / math.sqrt(ar) / 2.0)
                    else:
                        for ar in ars:
                            emit(mn * math.sqrt(ar) / 2.0,
                                 mn / math.sqrt(ar) / 2.0)
                        if max_sizes:
                            sq = math.sqrt(mn * max_sizes[s]) / 2.0
                            emit(sq, sq)
        num_priors = len(boxes) // (fh * fw)
        b = np.asarray(boxes, np.float32).reshape(fh, fw, num_priors, 4)
        if op.attr("clip", False):
            b = np.clip(b, 0.0, 1.0)
        v = np.broadcast_to(np.asarray(variances, np.float32),
                            (fh, fw, num_priors, 4)).copy()
        return b, v

    b, v = _const(_attr_key(op, _PRIOR_ATTRS) + (fh, fw, ih, iw),
                  ctx.device, build)
    return {"Boxes": [b], "Variances": [v]}


@register_op("anchor_generator")
def _anchor_generator(ctx, op, ins):
    """RPN anchors, built in numpy once per device."""
    feat = first(ins, "Input")
    fh, fw = int(feat.shape[2]), int(feat.shape[3])

    def build():
        sizes = [float(s) for s in op.attr("anchor_sizes", [64.0])]
        ars = [float(a) for a in op.attr("aspect_ratios", [1.0])]
        variances = [float(v) for v in op.attr("variances",
                                               [0.1, 0.1, 0.2, 0.2])]
        stride = [float(s) for s in op.attr("stride", [16.0, 16.0])]
        offset = op.attr("offset", 0.5)
        sw, sh = stride[0], stride[1]
        a = np.zeros((fh, fw, len(ars) * len(sizes), 4), np.float32)
        for hi in range(fh):
            for wi in range(fw):
                xc = wi * sw + offset * (sw - 1)
                yc = hi * sh + offset * (sh - 1)
                idx = 0
                for ar in ars:
                    for size in sizes:
                        area = sw * sh
                        base_w = round(math.sqrt(area / ar))
                        base_h = round(base_w * ar)
                        aw = size / sw * base_w
                        ah = size / sh * base_h
                        a[hi, wi, idx] = [xc - 0.5 * (aw - 1),
                                          yc - 0.5 * (ah - 1),
                                          xc + 0.5 * (aw - 1),
                                          yc + 0.5 * (ah - 1)]
                        idx += 1
        v = np.broadcast_to(np.asarray(variances, np.float32),
                            a.shape).copy()
        return a, v

    a, v = _const(_attr_key(op, ("anchor_sizes", "aspect_ratios",
                                 "variances", "stride", "offset"))
                  + (fh, fw), ctx.device, build)
    return {"Anchors": [a], "Variances": [v]}


@register_op("density_prior_box")
def _density_prior_box(ctx, op, ins):
    """Density priors, built in numpy once per device."""
    feat = first(ins, "Input")
    img = first(ins, "Image")
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    ih, iw = int(img.shape[2]), int(img.shape[3])

    def build():
        fixed_sizes = [float(s) for s in op.attr("fixed_sizes", [])]
        fixed_ratios = [float(r) for r in op.attr("fixed_ratios", [1.0])]
        densities = [int(d) for d in op.attr("densities", [])]
        variances = [float(v) for v in op.attr("variances",
                                               [0.1, 0.1, 0.2, 0.2])]
        step_w = op.attr("step_w", 0.0) or iw / fw
        step_h = op.attr("step_h", 0.0) or ih / fh
        offset = op.attr("offset", 0.5)
        step_avg = int((step_w + step_h) * 0.5)
        num_priors = sum(len(fixed_ratios) * d * d for d in densities)
        b = np.zeros((fh, fw, num_priors, 4), np.float32)
        for h in range(fh):
            for w in range(fw):
                cx = (w + offset) * step_w
                cy = (h + offset) * step_h
                idx = 0
                for size, density in zip(fixed_sizes, densities):
                    shift = step_avg // density
                    for r in fixed_ratios:
                        bw = size * math.sqrt(r)
                        bhh = size / math.sqrt(r)
                        dcx = cx - step_avg / 2.0 + shift / 2.0
                        dcy = cy - step_avg / 2.0 + shift / 2.0
                        for di in range(density):
                            for dj in range(density):
                                cxt = dcx + dj * shift
                                cyt = dcy + di * shift
                                b[h, w, idx] = [
                                    max((cxt - bw / 2.0) / iw, 0.0),
                                    max((cyt - bhh / 2.0) / ih, 0.0),
                                    min((cxt + bw / 2.0) / iw, 1.0),
                                    min((cyt + bhh / 2.0) / ih, 1.0)]
                                idx += 1
        if op.attr("clip", False):
            b = np.clip(b, 0.0, 1.0)
        v = np.broadcast_to(np.asarray(variances, np.float32),
                            b.shape).copy()
        return b, v

    b, v = _const(_attr_key(op, ("fixed_sizes", "fixed_ratios",
                                 "densities", "variances", "step_w",
                                 "step_h", "offset", "clip"))
                  + (fh, fw, ih, iw), ctx.device, build)
    return {"Boxes": [b], "Variances": [v]}


# -- box arithmetic (detection_ops.py:149-268) ------------------------------

def _wh_cxcy(box, normalized):
    off = 0.0 if normalized else 1.0
    w = box[..., 2] - box[..., 0] + off
    h = box[..., 3] - box[..., 1] + off
    cx = box[..., 0] + w / 2
    cy = box[..., 1] + h / 2
    return w, h, cx, cy


@register_op("box_coder")
def _box_coder(ctx, op, ins):
    """Center-size encode (target (N, 4) against prior (M, 4) -> (N, M,
    4)) and decode (a rank-3 target, priors along `axis`)."""
    prior = first(ins, "PriorBox")
    pvar = first(ins, "PriorBoxVar", None)
    target = first(ins, "TargetBox")
    code_type = op.attr("code_type", "encode_center_size")
    normalized = op.attr("box_normalized", True)
    axis = op.attr("axis", 0)
    var_attr = op.attr("variance", []) or []

    pw, ph, pcx, pcy = _wh_cxcy(prior, normalized)
    if code_type == "encode_center_size":
        tw, th, tcx, tcy = _wh_cxcy(target, normalized)
        ex = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        ey = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ew = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        eh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ex, ey, ew, eh], dim=-1)
        if pvar is not None:
            out = out / pvar[None, :, :]
        elif var_attr:
            out = out / _attr_tensor(var_attr, out.dtype, out.device)
        return {"OutputBox": [out]}
    if target.dim() == 2:
        raise ValueError(
            "box_coder decode_center_size needs a rank-3 TargetBox "
            f"(N, M, 4); got {tuple(target.shape)}. For pairwise decode "
            "expand deltas to (N, 1, 4) against a 1-prior axis or use "
            "axis=1")
    t = target
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (pw[None, :], ph[None, :],
                                pcx[None, :], pcy[None, :])
    else:
        pw_, ph_, pcx_, pcy_ = (pw[:, None], ph[:, None],
                                pcx[:, None], pcy[:, None])
    if pvar is not None:
        v = pvar[None, :, :] if axis == 0 else pvar[:, None, :]
        vx, vy, vw, vh = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    elif var_attr:
        vx, vy, vw, vh = var_attr
    else:
        vx = vy = vw = vh = 1.0
    dcx = vx * t[..., 0] * pw_ + pcx_
    dcy = vy * t[..., 1] * ph_ + pcy_
    dw = torch.exp(vw * t[..., 2]) * pw_
    dh = torch.exp(vh * t[..., 3]) * ph_
    off = 0.0 if normalized else 1.0
    out = torch.stack([dcx - dw / 2, dcy - dh / 2,
                       dcx + dw / 2 - off, dcy + dh / 2 - off], dim=-1)
    return {"OutputBox": [out]}


def _iou_matrix(a, b, normalized=True):
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    off = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
                     + off, min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
                     + off, min=0.0)
    inter = iw * ih
    aa = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    ab = (bx2 - bx1 + off) * (by2 - by1 + off)
    union = aa + ab - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


@register_op("iou_similarity")
def _iou_similarity(ctx, op, ins):
    return {"Out": [_iou_matrix(first(ins, "X"), first(ins, "Y"),
                                op.attr("box_normalized", True))]}


@register_op("box_clip")
def _box_clip(ctx, op, ins):
    """Clip boxes to round(im_info / scale) - 1; ImInfo rows (h, w,
    scale)."""
    boxes = first(ins, "Input")
    im_info = first(ins, "ImInfo")
    if boxes.dim() == 2:
        h = torch.round(im_info[0, 0] / im_info[0, 2]) - 1
        w = torch.round(im_info[0, 1] / im_info[0, 2]) - 1
    else:
        h = (torch.round(im_info[:, 0] / im_info[:, 2]) - 1)[:, None]
        w = (torch.round(im_info[:, 1] / im_info[:, 2]) - 1)[:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = torch.stack([torch.clamp(boxes[..., 0], zero, w),
                       torch.clamp(boxes[..., 1], zero, h),
                       torch.clamp(boxes[..., 2], zero, w),
                       torch.clamp(boxes[..., 3], zero, h)], dim=-1)
    return {"Output": [out]}


# -- matching and NMS (detection_ops.py:270-430) ----------------------------------

@register_op("bipartite_match")
def _bipartite_match(ctx, op, ins):
    """Greedy bipartite matching, min(N, M) rounds over all images at
    once: each round takes the largest distance left among free rows and
    unmatched columns; with match_type 'per_prediction' a column left
    unmatched takes its best row when that clears dist_threshold."""
    dist = first(ins, "DistMat")  # (N, M) rows gt, cols predictions
    if dist.dim() == 2:
        dist = dist[None]
    match_type = op.attr("match_type", "bipartite")
    thr = op.attr("dist_threshold", 0.5)
    b, n, m = dist.shape
    dev = dist.device
    row_free = torch.ones((b, n), dtype=torch.bool, device=dev)
    col_idx = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((b, m), dtype=dist.dtype, device=dev)
    bi = torch.arange(b, device=dev)
    neg = torch.full((), -1.0, dtype=dist.dtype, device=dev)
    for _ in range(min(n, m)):
        free = row_free[:, :, None] & (col_idx < 0)[:, None, :]
        masked = torch.where(free, dist, neg).reshape(b, n * m)
        flat = torch.argmax(masked, dim=1)
        val = torch.gather(masked, 1, flat[:, None])[:, 0]
        r, c = flat // m, flat % m
        ok = val > 0
        col_idx[bi, c] = torch.where(ok, r.to(torch.int32), col_idx[bi, c])
        col_dist[bi, c] = torch.where(ok, val, col_dist[bi, c])
        row_free[bi, r] = row_free[bi, r] & ~ok
    if match_type == "per_prediction":
        best_d = dist.max(dim=1).values
        best_r = torch.argmax(dist, dim=1).to(torch.int32)
        extra = (col_idx < 0) & (best_d >= thr)
        col_idx = torch.where(extra, best_r, col_idx)
        col_dist = torch.where(extra, best_d, col_dist)
    return {"ColToRowMatchIndices": [col_idx],
            "ColToRowMatchDist": [col_dist]}


def _nms_keep(boxes, scores, iou_thr, score_thr, normalized):
    """Greedy NMS over k candidates sorted by score, batched over the
    leading dims: boxes (..., k, 4), scores (..., k) -> keep (..., k)."""
    k = boxes.shape[-2]
    over = _iou_matrix(boxes, boxes, normalized) > iou_thr
    return _greedy_keep(over, scores > score_thr, k)


def _greedy_keep(over, valid, k):
    """k rounds: candidate i is kept when valid and not suppressed by a
    kept earlier one; a kept one suppresses every candidate it overlaps
    (`over[..., i, :]`)."""
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    for i in range(k):
        take = valid[..., i] & ~suppressed[..., i]
        keep[..., i] = take
        suppressed |= take[..., None] & over[..., i, :]
    return keep


def _multiclass_scaffold(boxes, scores, bg, keep_top_k, per_class,
                         box_dim=4):
    """All foreground classes of all images at once: per_class(boxes
    (B, M, D), class scores (B, F, M)) -> (scores after suppression
    (B, F, k), boxes (B, F, k, D), source index (B, F, k)); then the
    classes concatenated in class order, the global top keep_top_k kept,
    rows with no positive score padded with label -1 and zeros.  Returns
    (det (B, kk, 2 + D), count (B,), index (B, kk))."""
    b, c, _ = scores.shape
    dev, dt = boxes.device, boxes.dtype
    if all(cls == bg for cls in range(c)):  # every class is background
        kk = max(keep_top_k, 1)
        det = torch.cat([torch.full((b, kk, 1), -1.0, dtype=dt, device=dev),
                         torch.zeros((b, kk, 1 + box_dim), dtype=dt,
                                     device=dev)], -1)
        return (det, torch.zeros((b,), dtype=torch.int32, device=dev),
                torch.zeros((b, kk), dtype=torch.int32, device=dev))
    # the foreground classes by slicing (a list index would be copied
    # to the device)
    labels = torch.arange(c, dtype=dt, device=dev)
    if 0 <= bg < c:
        scores = torch.cat([scores[:, :bg], scores[:, bg + 1:]], 1)
        labels = torch.cat([labels[:bg], labels[bg + 1:]])
    ds, bx, idx = per_class(boxes, scores)
    k = ds.shape[-1]
    s_cat = ds.reshape(b, -1)
    b_cat = bx.reshape(b, -1, box_dim)
    l_cat = labels.repeat_interleave(k)
    i_cat = idx.reshape(b, -1).to(torch.int32)
    n = s_cat.shape[1]
    kk = min(keep_top_k, n) if keep_top_k > 0 else n
    s_fin, sel = _top_k(s_cat, kk)
    pos = s_fin > 0
    lab = torch.where(pos, l_cat[sel], _scalar(-1.0, s_fin))
    det = torch.cat([lab[..., None], torch.clamp(s_fin, min=0.0)[..., None],
                     _take(b_cat, sel)], dim=-1).to(dt)
    pad = torch.cat([torch.full((1,), -1.0, dtype=dt, device=dev),
                     torch.zeros((1 + box_dim,), dtype=dt, device=dev)])
    det = torch.where(pos[..., None], det, pad)
    return (det, pos.sum(-1).to(torch.int32),
            torch.gather(i_cat, 1, sel))


@register_op("multiclass_nms")
@register_op("multiclass_nms2")
@register_op("multiclass_nms3")
def _multiclass_nms(ctx, op, ins):
    """Dense contract: Out (B, keep_top_k, 6) = [label, score, x1, y1,
    x2, y2], rows past an image's count padded with label -1 and zeros;
    NmsRoisNum (B,) the counts, Index (B, keep_top_k) the source rows."""
    bboxes = first(ins, "BBoxes")   # (B, M, 4)
    scores = first(ins, "Scores")   # (B, C, M)
    bg = op.attr("background_label", 0)
    score_thr = op.attr("score_threshold", 0.0)
    nms_top_k = int(op.attr("nms_top_k", 64) or 64)
    iou_thr = op.attr("nms_threshold", 0.3)
    keep_top_k = int(op.attr("keep_top_k", 64) or 64)
    normalized = op.attr("normalized", True)
    m = scores.shape[2]
    k = min(nms_top_k, m) if nms_top_k > 0 else m

    def per_class(boxes, sc):
        s_top, idx = _top_k(sc, k)
        b_top = _take(boxes[:, None], idx)
        keep = _nms_keep(b_top, s_top, iou_thr, score_thr, normalized)
        return torch.where(keep, s_top, _scalar(-1.0, s_top)), b_top, idx

    det, counts, index = _multiclass_scaffold(bboxes, scores, bg,
                                              keep_top_k, per_class)
    outs = {"Out": [det]}
    if "Index" in op.outputs:
        outs["Index"] = [index]
    if "NmsRoisNum" in op.outputs:
        outs["NmsRoisNum"] = [counts]
    return outs


# -- YOLO, focal loss, ROI align (detection_ops.py:432-571) -----------------

@register_op("yolo_box")
def _yolo_box(ctx, op, ins):
    x = first(ins, "X")               # (B, A*(5+C), H, W)
    img_size = first(ins, "ImgSize")  # (B, 2) [h, w]
    anchors = [int(a) for a in op.attr("anchors", [])]
    class_num = int(op.attr("class_num", 1))
    conf_thresh = op.attr("conf_thresh", 0.01)
    downsample = int(op.attr("downsample_ratio", 32))
    clip_bbox = op.attr("clip_bbox", True)
    scale = op.attr("scale_x_y", 1.0)
    bias = -0.5 * (scale - 1.0)
    b, _, h, w = x.shape
    a = len(anchors) // 2
    dt, dev = x.dtype, x.device
    xr = x.reshape(b, a, 5 + class_num, h, w)
    img_h = img_size[:, 0].to(dt).reshape(b, 1, 1, 1)
    img_w = img_size[:, 1].to(dt).reshape(b, 1, 1, 1)
    grid_x = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    an_w = _attr_tensor(anchors[0::2], dt, dev).reshape(1, a, 1, 1)
    an_h = _attr_tensor(anchors[1::2], dt, dev).reshape(1, a, 1, 1)
    in_h = downsample * h
    in_w = downsample * w
    cx = (grid_x + torch.sigmoid(xr[:, :, 0]) * scale + bias) * img_w / w
    cy = (grid_y + torch.sigmoid(xr[:, :, 1]) * scale + bias) * img_h / h
    bw = torch.exp(xr[:, :, 2]) * an_w * img_w / in_w
    bh = torch.exp(xr[:, :, 3]) * an_h * img_h / in_h
    conf = torch.sigmoid(xr[:, :, 4])
    mask = conf >= conf_thresh
    x1 = cx - bw / 2
    y1 = cy - bh / 2
    x2 = cx + bw / 2
    y2 = cy + bh / 2
    if clip_bbox:
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.clamp(x1, zero, img_w - 1)
        y1 = torch.clamp(y1, zero, img_h - 1)
        x2 = torch.clamp(x2, zero, img_w - 1)
        y2 = torch.clamp(y2, zero, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(mask[..., None], boxes, _scalar(0.0, boxes))
    probs = torch.sigmoid(xr[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(mask[:, :, None], probs, _scalar(0.0, probs))
    return {"Boxes": [boxes.reshape(b, a * h * w, 4)],
            "Scores": [torch.movedim(probs, 2, -1)
                       .reshape(b, a * h * w, class_num)]}


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ctx, op, ins):
    """FL(p) with one-vs-all targets: label 0 is background, class c
    reads logit column c - 1; FgNum normalises."""
    x = first(ins, "X")          # (N, C)
    label = first(ins, "Label")  # (N, 1)
    fg_num = first(ins, "FgNum")  # (1,)
    gamma = op.attr("gamma", 2.0)
    alpha = op.attr("alpha", 0.25)
    c = x.shape[1]
    lab = label.reshape(-1).to(torch.int32)
    tgt = (lab[:, None] == (torch.arange(c, dtype=torch.int32,
                                         device=x.device)[None, :] + 1)
           ).to(x.dtype)
    fg = torch.clamp(fg_num.reshape(()).to(x.dtype), min=1.0)
    p = torch.sigmoid(x)
    logsig = torch.nn.functional.logsigmoid
    ce = tgt * (-logsig(x)) + (1 - tgt) * (-logsig(-x))
    w = tgt * alpha * torch.pow(1 - p, gamma) \
        + (1 - tgt) * (1 - alpha) * torch.pow(p, gamma)
    return {"Out": [w * ce / fg]}


def _rois_batch_index(rois_num, r, device):
    """Dense roi rows -> image indices from the per-image counts (the
    dense form of the reference's roi LoD)."""
    if rois_num is None:
        return torch.zeros((r,), dtype=torch.long, device=device)
    counts = rois_num.reshape(-1).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(r, device=device)
    return (ar[:, None] >= starts[None, :]).sum(1) - 1


@register_op("roi_align")
def _roi_align(ctx, op, ins):
    """The mean of bilinear samples in each bin, every roi at once.
    sampling_ratio <= 0 takes a fixed 2x2 grid a bin, as the reference
    does (its docstring: the adaptive count is a data-dependent shape)."""
    x = first(ins, "X")         # (B, C, H, W)
    rois = first(ins, "ROIs")   # (R, 4)
    rois_num = first(ins, "RoisNum", None)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    sscale = op.attr("spatial_scale", 1.0)
    ratio = int(op.attr("sampling_ratio", -1))
    _, c, hh, ww = x.shape
    r = rois.shape[0]
    dev = x.device
    bidx = _rois_batch_index(rois_num, r, dev)
    sr = ratio if ratio > 0 else 2
    x1, y1, x2, y2 = (rois * sscale).unbind(-1)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    ar_h = torch.arange(ph * sr, device=dev).to(rois.dtype)
    ar_w = torch.arange(pw * sr, device=dev).to(rois.dtype)
    gy = y1[:, None] + (ar_h[None] + 0.5) * rh[:, None] / (ph * sr)
    gx = x1[:, None] + (ar_w[None] + 0.5) * rw[:, None] / (pw * sr)
    yy = gy[:, :, None].expand(r, ph * sr, pw * sr)
    xx = gx[:, None, :].expand(r, ph * sr, pw * sr)
    y0 = torch.clamp(torch.floor(yy), 0, hh - 1)
    x0 = torch.clamp(torch.floor(xx), 0, ww - 1)
    y1i = torch.clamp(y0 + 1, 0, hh - 1).long()
    x1i = torch.clamp(x0 + 1, 0, ww - 1).long()
    y0i, x0i = y0.long(), x0.long()
    ly = torch.clamp(yy - y0, 0.0, 1.0)[..., None]
    lx = torch.clamp(xx - x0, 0.0, 1.0)[..., None]
    bb = bidx[:, None, None]
    v = (x[bb, :, y0i, x0i] * (1 - ly) * (1 - lx)
         + x[bb, :, y0i, x1i] * (1 - ly) * lx
         + x[bb, :, y1i, x0i] * ly * (1 - lx)
         + x[bb, :, y1i, x1i] * ly * lx)          # (R, PH*sr, PW*sr, C)
    inside = (yy >= -1) & (yy <= hh) & (xx >= -1) & (xx <= ww)
    samples = torch.where(inside[..., None], v, _scalar(0.0, v))
    samples = samples.reshape(r, ph, sr, pw, sr, c)
    return {"Out": [samples.mean(dim=(2, 4)).permute(0, 3, 1, 2)]}


@register_op("polygon_box_transform")
def _polygon_box_transform(ctx, op, ins):
    """EAST: on every cell the offsets become absolute quad coordinates,
    out = 4 * cell coordinate - in (x for even channels, y for odd)."""
    x = first(ins, "Input")  # (N, 8k, H, W)
    _, g, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device).expand(h, w)
    row = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] \
        .expand(h, w)
    base = torch.stack([col if i % 2 == 0 else row for i in range(g)])
    return {"Output": [4.0 * base[None] - x]}


@register_op("target_assign")
def _target_assign(ctx, op, ins):
    """out[b, j] = X[b, match[b, j]] where match >= 0, else
    mismatch_value; OutWeight 1 where matched (X already batched:
    (B, G, K))."""
    x = first(ins, "X")
    match = first(ins, "MatchIndices")
    mismatch = op.attr("mismatch_value", 0)
    m = match.to(torch.int32)
    safe = torch.clamp(m, 0, x.shape[1] - 1).long()
    gathered = torch.gather(x, 1, safe[..., None].expand(
        safe.shape + x.shape[2:]))
    matched = (m >= 0)[..., None]
    out = torch.where(matched, gathered, _scalar(mismatch, x))
    return {"Out": [out], "OutWeight": [matched.to(torch.float32)]}


@register_op("mine_hard_examples")
def _mine_hard_examples(ctx, op, ins):
    """SSD hard-negative mining, max_negative mode: per image, the
    unmatched priors whose best overlap is under neg_dist_threshold,
    ranked by ClsLoss (ties by prior index), the first num_pos *
    neg_pos_ratio of them.  NegIndices is the 0/1 mask (B, M)."""
    cls_loss = first(ins, "ClsLoss")                      # (B, M)
    match = first(ins, "MatchIndices").to(torch.int32)    # (B, M)
    match_dist = first(ins, "MatchDist")                  # (B, M)
    ratio = op.attr("neg_pos_ratio", 3.0)
    neg_dist_thr = op.attr("neg_dist_threshold", 0.5)
    mining = op.attr("mining_type", "max_negative")
    if mining != "max_negative":
        raise NotImplementedError(
            "mine_hard_examples: only max_negative mining is "
            "implemented (hard_example mode needs sample_size "
            "semantics nobody's TPU configs use)")
    is_neg = (match < 0) & (match_dist < neg_dist_thr)
    n_pos = (match >= 0).sum(1)
    n_neg_max = (n_pos.to(torch.float32) * ratio).to(torch.int32)
    neg_loss = torch.where(is_neg, cls_loss, _scalar(-math.inf, cls_loss))
    rank = _rank(-neg_loss)
    selected = is_neg & (rank < n_neg_max[:, None])
    return {"NegIndices": [selected.to(torch.int32)],
            "UpdatedMatchIndices": [match]}


# -- matrix NMS and proposals (detection_ops.py:695-837) ------------------------

@register_op("matrix_nms")
def _matrix_nms(ctx, op, ins):
    """Score decay instead of hard suppression: decay(i) = min over j < i
    of f(iou_ij, iou_max_j), f linear or gaussian; one (k, k) IoU matrix
    a class, no sequential loop.  Out (B, keep, 6), Index, RoisNum."""
    bboxes = first(ins, "BBoxes")   # (B, M, 4)
    scores = first(ins, "Scores")   # (B, C, M)
    bg = op.attr("background_label", 0)
    score_thr = op.attr("score_threshold", 0.0)
    post_thr = op.attr("post_threshold", 0.0)
    nms_top_k = int(op.attr("nms_top_k", 64) or 64)
    keep_top_k = int(op.attr("keep_top_k", 64) or 64)
    use_gaussian = op.attr("use_gaussian", False)
    sigma = op.attr("gaussian_sigma", 2.0)
    normalized = op.attr("normalized", True)
    m = scores.shape[2]
    k = min(nms_top_k, m) if nms_top_k > 0 else m

    def per_class(boxes, sc):
        s_top, idx = _top_k(sc, k)
        bx = _take(boxes[:, None], idx)
        valid = s_top > score_thr
        iou = _iou_matrix(bx, bx, normalized)
        tri = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=sc.device), -1)
        iou_l = torch.where(tri, iou, _scalar(0.0, iou))
        iou_max = iou_l.max(dim=-1).values
        if use_gaussian:
            decay = torch.exp((torch.square(iou_max)[..., None, :]
                               - torch.square(iou_l)) * sigma)
        else:
            decay = (1.0 - iou_l) / torch.clamp(
                1.0 - iou_max[..., None, :], min=1e-10)
        decay = torch.where(tri, decay, _scalar(1.0, decay))
        min_decay = decay.min(dim=-1).values
        zero = _scalar(0.0, s_top)
        ds = torch.where(valid, s_top * min_decay, zero)
        ds = torch.where(ds > post_thr, ds, zero)
        return ds, bx, idx

    det, counts, index = _multiclass_scaffold(bboxes, scores, bg,
                                              keep_top_k, per_class)
    outs = {"Out": [det]}
    if "Index" in op.outputs:
        outs["Index"] = [index]
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [counts]
    return outs


def _encode_plus1(boxes, gts):
    """Center-size deltas of gts against boxes, +1 pixel widths."""
    aw = boxes[..., 2] - boxes[..., 0] + 1.0
    ah = boxes[..., 3] - boxes[..., 1] + 1.0
    acx = boxes[..., 0] + aw * 0.5
    acy = boxes[..., 1] + ah * 0.5
    gw = gts[..., 2] - gts[..., 0] + 1.0
    gh = gts[..., 3] - gts[..., 1] + 1.0
    gcx = gts[..., 0] + gw * 0.5
    gcy = gts[..., 1] + gh * 0.5
    return aw, ah, acx, acy, gw, gh, gcx, gcy


@register_op("generate_proposals")
@register_op("generate_proposals_v2")
def _generate_proposals(ctx, op, ins):
    """RPN proposals: decode the pre_nms_topN best anchors' deltas, clip
    to the image, drop boxes under min_size, greedy-NMS, keep the
    post_nms_topN best.  RpnRois (B, post, 4) zero-padded, RpnRoiProbs
    (B, post, 1), RpnRoisNum / RoisNum (B,)."""
    scores = first(ins, "Scores")       # (B, A, H, W)
    deltas = first(ins, "BboxDeltas")   # (B, 4A, H, W)
    im_shape = first(ins, "ImShape", None)
    if im_shape is None:
        im_shape = first(ins, "ImInfo")
    anchors = first(ins, "Anchors")     # (H, W, A, 4)
    variances = first(ins, "Variances", None)
    pre_n = int(op.attr("pre_nms_topN", 6000))
    post_n = int(op.attr("post_nms_topN", 1000))
    nms_thresh = op.attr("nms_thresh", 0.5)
    min_size = op.attr("min_size", 0.1)
    b, a_dim, h, w = scores.shape
    m = a_dim * h * w
    anc = anchors.reshape(-1, 4)
    var = variances.reshape(-1, 4) if variances is not None \
        else torch.ones_like(anc)
    pre_k = min(pre_n, m) if pre_n > 0 else m
    post_k = min(post_n, pre_k) if post_n > 0 else pre_k
    v1 = op.type == "generate_proposals"
    eff_min_size = max(min_size, 1.0)
    imr = im_shape.to(scores.dtype)
    s_flat = scores.permute(0, 2, 3, 1).reshape(b, -1)
    d = deltas.reshape(b, a_dim, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(b, -1, 4)
    s_top, idx = _top_k(s_flat, pre_k)
    anc_t, var_t, d_t = _take(anc, idx), _take(var, idx), _take(d, idx)
    aw = anc_t[..., 2] - anc_t[..., 0] + 1.0
    ah = anc_t[..., 3] - anc_t[..., 1] + 1.0
    acx = anc_t[..., 0] + aw * 0.5
    acy = anc_t[..., 1] + ah * 0.5
    cx = var_t[..., 0] * d_t[..., 0] * aw + acx
    cy = var_t[..., 1] * d_t[..., 1] * ah + acy
    clip_v = math.log(1000.0 / 16.0)
    bw = torch.exp(torch.clamp(var_t[..., 2] * d_t[..., 2], max=clip_v)) * aw
    bh = torch.exp(torch.clamp(var_t[..., 3] * d_t[..., 3], max=clip_v)) * ah
    x1 = cx - bw * 0.5
    y1 = cy - bh * 0.5
    x2 = cx + bw * 0.5 - 1.0
    y2 = cy + bh * 0.5 - 1.0
    ih, iw_ = imr[:, 0:1], imr[:, 1:2]
    zero = _scalar(0.0, x1)
    x1 = torch.clamp(x1, zero, iw_ - 1)
    y1 = torch.clamp(y1, zero, ih - 1)
    x2 = torch.clamp(x2, zero, iw_ - 1)
    y2 = torch.clamp(y2, zero, ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    inv_scale = (1.0 / imr[:, 2:3]) if v1 and imr.shape[1] > 2 else 1.0
    keep_size = (((x2 - x1) * inv_scale + 1.0) >= eff_min_size) \
        & (((y2 - y1) * inv_scale + 1.0) >= eff_min_size)
    ninf = _scalar(-math.inf, s_top)
    s_valid = torch.where(keep_size, s_top, ninf)
    keep = _nms_keep(boxes, s_valid, nms_thresh, -math.inf, False)
    s_kept = torch.where(keep & keep_size, s_top, ninf)
    s_fin, sel = _top_k(s_kept, post_k)
    ok = torch.isfinite(s_fin)
    rois = torch.where(ok[..., None], _take(boxes, sel), zero)
    probs = torch.where(ok, s_fin, zero)[..., None]
    counts = ok.sum(-1).to(torch.int32)
    outs = {"RpnRois": [rois], "RpnRoiProbs": [probs]}
    if "RpnRoisNum" in op.outputs:
        outs["RpnRoisNum"] = [counts]
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [counts]
    return outs


def _sce(logit, t):
    return (torch.clamp(logit, min=0.0) - logit * t
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _iou_cxcywh(b1, b2):
    l = torch.maximum(b1[..., 0] - b1[..., 2] / 2, b2[..., 0] - b2[..., 2] / 2)
    r = torch.minimum(b1[..., 0] + b1[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2)
    t = torch.maximum(b1[..., 1] - b1[..., 3] / 2, b2[..., 1] - b2[..., 3] / 2)
    bm = torch.minimum(b1[..., 1] + b1[..., 3] / 2,
                       b2[..., 1] + b2[..., 3] / 2)
    inter = torch.clamp(r - l, min=0.0) * torch.clamp(bm - t, min=0.0)
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / torch.clamp(union, min=1e-10)


@register_op("yolov3_loss")
def _yolov3_loss(ctx, op, ins):
    """YOLOv3's training loss, all images at once, in float32 as the
    reference computes it: predictions whose best IoU against the gts
    passes ignore_thresh leave the negative objectness loss; each gt
    matches its best anchor by wh-IoU and, where that anchor is one of
    this scale's, adds location (sce for x/y, L1 for w/h, scaled by
    2 - w*h), class and positive-objectness losses at its cell.  The
    reference's grid_size = h for both axes is kept.  Loss (N,),
    ObjectnessMask (N, mask, H, W), GTMatchMask (N, G)."""
    x = first(ins, "X")
    gt_box = first(ins, "GTBox").to(torch.float32)    # (N, G, 4) cxcywh
    gt_label = first(ins, "GTLabel").to(torch.int32)  # (N, G)
    gt_score = first(ins, "GTScore", None)
    anchors = [float(a) for a in op.attr("anchors", [])]
    mask = [int(m) for m in op.attr("anchor_mask", [])]
    class_num = int(op.attr("class_num", 1))
    ignore_thresh = op.attr("ignore_thresh", 0.7)
    downsample = int(op.attr("downsample_ratio", 32))
    use_smooth = op.attr("use_label_smooth", True)
    scale_xy = op.attr("scale_x_y", 1.0)
    bias_xy = -0.5 * (scale_xy - 1.0)
    n, _, h, w = x.shape
    a = len(mask)
    g = gt_box.shape[1]
    dev = x.device
    f32 = torch.float32
    input_size = downsample * h
    an_w = _attr_tensor(anchors[0::2], f32, dev)
    an_h = _attr_tensor(anchors[1::2], f32, dev)
    scores = (torch.ones((n, g), dtype=f32, device=dev) if gt_score is None
              else gt_score.to(f32).reshape(n, g))
    if use_smooth:
        sm = min(1.0 / class_num, 1.0 / 40)
        pos_t, neg_t = 1.0 - sm, sm
    else:
        pos_t, neg_t = 1.0, 0.0
    xr = x.reshape(n, a, 5 + class_num, h, w).to(f32)
    gts = gt_box
    valid = (gts[..., 2] > 0) & (gts[..., 3] > 0)             # (N, G)
    gx = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    gy = torch.arange(h, dtype=f32, device=dev)[None, :, None]
    mask_arr = _attr_tensor(mask, torch.long, dev)
    m_w = an_w[mask_arr].reshape(a, 1, 1)
    m_h = an_h[mask_arr].reshape(a, 1, 1)
    pcx = (gx + torch.sigmoid(xr[:, :, 0]) * scale_xy + bias_xy) / h
    pcy = (gy + torch.sigmoid(xr[:, :, 1]) * scale_xy + bias_xy) / h
    pw = torch.exp(xr[:, :, 2]) * m_w / input_size
    ph = torch.exp(xr[:, :, 3]) * m_h / input_size
    pred = torch.stack([pcx, pcy, pw, ph], dim=-1)        # (N, A, H, W, 4)
    ious = _iou_cxcywh(pred[..., None, :], gts[:, None, None, None])
    ious = torch.where(valid[:, None, None, None, :], ious,
                       _scalar(0.0, ious))
    ignored = ious.max(dim=-1).values > ignore_thresh      # (N, A, H, W)
    anc = torch.stack([torch.zeros_like(an_w), torch.zeros_like(an_h),
                       an_w / input_size, an_h / input_size], -1)
    gt_shift = torch.cat([torch.zeros_like(gts[..., :2]), gts[..., 2:]], -1)
    an_iou = _iou_cxcywh(gt_shift[..., None, :], anc)      # (N, G, A_all)
    best_n = torch.argmax(an_iou, dim=-1)
    in_mask = best_n[..., None] == mask_arr                # (N, G, A)
    mask_idx = torch.where(in_mask.any(-1),
                           torch.argmax(in_mask.to(torch.int32), -1),
                           torch.full((), -1, device=dev))
    matched = valid & (mask_idx >= 0)
    gi = torch.clamp((gts[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gts[..., 1] * h).to(torch.int32), 0, h - 1).long()
    ni = torch.arange(n, device=dev)[:, None]
    cell = xr[ni, torch.clamp(mask_idx, min=0), :, gj, gi]  # (N, G, 5+C)
    tx = gts[..., 0] * h - gi
    ty = gts[..., 1] * h - gj
    tw = torch.log(torch.clamp(
        gts[..., 2] * input_size / torch.clamp(an_w[best_n], min=1e-10),
        min=1e-10))
    th = torch.log(torch.clamp(
        gts[..., 3] * input_size / torch.clamp(an_h[best_n], min=1e-10),
        min=1e-10))
    sc_w = (2.0 - gts[..., 2] * gts[..., 3]) * scores
    loc = (_sce(cell[..., 0], tx) + _sce(cell[..., 1], ty)
           + torch.abs(cell[..., 2] - tw)
           + torch.abs(cell[..., 3] - th)) * sc_w
    classes = torch.arange(class_num, device=dev)
    cls_t = torch.where(gt_label[..., None] == classes,
                        torch.full((), pos_t, dtype=f32, device=dev),
                        torch.full((), neg_t, dtype=f32, device=dev))
    cls = _sce(cell[..., 5:], cls_t).sum(-1) * scores
    zero = torch.zeros((), dtype=f32, device=dev)
    per_gt = torch.where(matched, loc + cls, zero)
    # unmatched gts write to anchor slot `a`, cut off after (the
    # reference's out-of-bounds scatter drops them)
    obj_pos = torch.zeros((n, a + 1, h, w), dtype=f32, device=dev)
    obj_pos[ni, torch.where(matched, mask_idx, torch.full((), a,
                                                          device=dev)),
            gj, gi] = scores
    obj_pos = obj_pos[:, :a]
    obj_logit = xr[:, :, 4]
    pos_loss = torch.where(obj_pos > 1e-5, _sce(obj_logit, 1.0) * obj_pos,
                           zero)
    neg_loss = torch.where((obj_pos <= 1e-5) & ~ignored,
                           _sce(obj_logit, 0.0), zero)
    obj_mask = torch.where(ignored & (obj_pos <= 1e-5),
                           torch.full((), -1.0, device=dev), obj_pos)
    loss = per_gt.sum(-1) + pos_loss.sum((1, 2, 3)) + neg_loss.sum((1, 2, 3))
    match_out = torch.where(valid & matched, mask_idx,
                            torch.full((), -1, device=dev))
    return {"Loss": [loss], "ObjectnessMask": [obj_mask],
            "GTMatchMask": [match_out.to(torch.int32)]}


# -- ROI pools, FPN routing, Cascade decode (detection_ops.py:988-1158) -----

@register_op("roi_pool")
def _roi_pool(ctx, op, ins):
    """Quantized max pooling: the integer bin bounds become membership
    masks, so each bin's max is one masked reduction; empty bins give
    0."""
    x = first(ins, "X")         # (B, C, H, W)
    rois = first(ins, "ROIs")   # (R, 4)
    rois_num = first(ins, "RoisNum", None)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    sscale = op.attr("spatial_scale", 1.0)
    _, _, hh, ww = x.shape
    r = rois.shape[0]
    dev = x.device
    bidx = _rois_batch_index(rois_num, r, dev)

    def c_round(v):  # C round(): half away from zero
        return (torch.sign(v) * torch.floor(torch.abs(v) + 0.5)).to(
            torch.int32)

    x0, y0, x1, y1 = (c_round(rois[:, i] * sscale) for i in range(4))
    rh = torch.clamp(y1 - y0 + 1, min=1).to(torch.float32)
    rw = torch.clamp(x1 - x0 + 1, min=1).to(torch.float32)
    binh, binw = rh / ph, rw / pw
    p = torch.arange(ph, dtype=torch.float32, device=dev)
    q = torch.arange(pw, dtype=torch.float32, device=dev)
    hs = torch.clamp(torch.floor(p * binh[:, None]).to(torch.int32)
                     + y0[:, None], 0, hh)
    he = torch.clamp(torch.ceil((p + 1) * binh[:, None]).to(torch.int32)
                     + y0[:, None], 0, hh)
    ws = torch.clamp(torch.floor(q * binw[:, None]).to(torch.int32)
                     + x0[:, None], 0, ww)
    we = torch.clamp(torch.ceil((q + 1) * binw[:, None]).to(torch.int32)
                     + x0[:, None], 0, ww)
    rows = torch.arange(hh, dtype=torch.int32, device=dev)
    cols = torch.arange(ww, dtype=torch.int32, device=dev)
    mh = (rows >= hs[..., None]) & (rows < he[..., None])  # (R, P, H)
    mw = (cols >= ws[..., None]) & (cols < we[..., None])  # (R, Q, W)
    mask = mh[:, :, None, :, None] & mw[:, None, :, None, :]
    img = x[bidx]                                          # (R, C, H, W)
    vals = torch.where(mask[:, None], img[:, :, None, None],
                       _scalar(-math.inf, img))
    out = torch.amax(vals, dim=(4, 5))
    out = torch.where(torch.isfinite(out), out, _scalar(0.0, out))
    return {"Out": [out.to(x.dtype)]}


@register_op("distribute_fpn_proposals")
def _distribute_fpn_proposals(ctx, op, ins):
    """Route each roi to level floor(log2(sqrt(area) / refer_scale) +
    refer_level); each level's output keeps (R, 4) with its rois packed
    first, MultiLevelRoIsNum the counts, RestoreIndex the place of each
    roi in the levels' concatenation."""
    rois = first(ins, "FpnRois")  # (R, 4)
    rois_num = first(ins, "RoisNum", None)
    min_level = int(op.attr("min_level", 2))
    max_level = int(op.attr("max_level", 5))
    refer_level = int(op.attr("refer_level", 4))
    refer_scale = float(op.attr("refer_scale", 224))
    r = rois.shape[0]
    dev = rois.device
    ar = torch.arange(r, dtype=torch.int32, device=dev)
    if rois_num is not None:
        n_valid = rois_num.reshape(-1).to(torch.int32).sum()
        valid_roi = ar < n_valid
    else:
        valid_roi = torch.ones((r,), dtype=torch.bool, device=dev)
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    scale = torch.sqrt(torch.clamp(w * h, min=1e-10))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl.to(torch.int32), min_level, max_level)
    lvl = torch.where(valid_roi, lvl,
                      torch.full((), max_level + 1, dtype=torch.int32,
                                 device=dev))
    outs = {"MultiFpnRois": [], "MultiLevelRoIsNum": []}
    order_all = []
    for level in range(min_level, max_level + 1):
        sel = lvl == level
        order = torch.argsort((~sel).to(torch.int32), stable=True)
        cnt = sel.sum().to(torch.int32)
        keep = ar < cnt
        outs["MultiFpnRois"].append(torch.where(
            keep[:, None], rois[order], _scalar(0.0, rois)))
        outs["MultiLevelRoIsNum"].append(cnt.reshape(1))
        order_all.append(torch.where(keep, order.to(torch.int32),
                                     torch.full((), r, dtype=torch.int32,
                                                device=dev)))
    concat_order = torch.cat(order_all)
    valid = concat_order < r
    rank = torch.cumsum(valid.to(torch.int32), 0) - 1
    restore = torch.zeros((r + 1,), dtype=torch.int32, device=dev)
    restore[concat_order.long()] = torch.where(
        valid, rank.to(torch.int32), torch.zeros((), dtype=torch.int32,
                                                 device=dev))
    outs["RestoreIndex"] = [restore[:r].reshape(r, 1)]
    return outs


@register_op("collect_fpn_proposals")
def _collect_fpn_proposals(ctx, op, ins):
    """Merge the levels' proposals and keep the post_nms_topN best by
    score."""
    rois_list = [v.reshape(-1, 4)
                 for v in ins.get("MultiLevelRois", []) if v is not None]
    scores_list = [v for v in ins.get("MultiLevelScores", [])
                   if v is not None]
    post_n = int(op.attr("post_nms_topN", 1000))
    rois = torch.cat(rois_list, 0)
    scores = torch.cat([s.reshape(-1) for s in scores_list])
    if rois.shape[0] != scores.shape[0]:
        raise ValueError(
            "collect_fpn_proposals: rois/scores row counts disagree "
            f"({rois.shape[0]} vs {scores.shape[0]})")
    k = min(post_n, scores.shape[0])
    s_top, idx = _top_k(scores, k)
    outs = {"FpnRois": [rois[idx]]}
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [(s_top > 0).sum().to(torch.int32).reshape(1)]
    return outs


@register_op("box_decoder_and_assign")
def _box_decoder_and_assign(ctx, op, ins):
    """Cascade R-CNN: decode each class's deltas against each prior (one
    shared variance 4-vector), then give each box the decode of its best
    foreground class."""
    prior = first(ins, "PriorBox")        # (N, 4)
    pvar = first(ins, "PriorBoxVar", None)
    target = first(ins, "TargetBox")      # (N, C*4)
    score = first(ins, "BoxScore")        # (N, C)
    clip = op.attr("box_clip", 4.135)
    n = prior.shape[0]
    c = score.shape[1]
    d = target.reshape(n, c, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    v = pvar.reshape(-1)[:4] if pvar is not None \
        else torch.ones((4,), dtype=prior.dtype, device=prior.device)
    dcx = v[0] * d[..., 0] * pw[:, None] + pcx[:, None]
    dcy = v[1] * d[..., 1] * ph[:, None] + pcy[:, None]
    dw = torch.exp(torch.clamp(v[2] * d[..., 2], max=clip)) * pw[:, None]
    dh = torch.exp(torch.clamp(v[3] * d[..., 3], max=clip)) * ph[:, None]
    decoded = torch.stack([dcx - dw / 2, dcy - dh / 2,
                           dcx + dw / 2 - 1.0, dcy + dh / 2 - 1.0], dim=-1)
    if c > 1:
        best = torch.argmax(score[:, 1:], dim=1) + 1
        assigned = _take(decoded, best[:, None])[:, 0]
    else:
        assigned = prior
    return {"DecodeBox": [decoded.reshape(n, c * 4)],
            "OutputAssignBox": [assigned]}


# -- anchor targets and RetinaNet decoding (detection_ops.py:1161-1320) -----

@register_op("rpn_target_assign")
def _rpn_target_assign(ctx, op, ins):
    """Full-length anchor targets with 0/1 weight masks: positives are
    anchors at IoU >= rpn_positive_overlap and each gt's best anchor,
    negatives under rpn_negative_overlap; each set subsampled at random
    (the op's generator) to rpn_batch_size_per_im * rpn_fg_fraction
    positives and the rest negatives.  ScoreTarget (B, A, 1) in {-1, 0,
    1}, LocationTarget (B, A, 4), LocationWeight, ScoreWeight (B, A,
    1)."""
    anchors = first(ins, "Anchor").reshape(-1, 4)     # (A, 4)
    gt = first(ins, "GtBoxes")                        # (B, G, 4)
    if gt.dim() == 2:
        gt = gt[None]
    rpn_batch = int(op.attr("rpn_batch_size_per_im", 256))
    fg_frac = op.attr("rpn_fg_fraction", 0.5)
    pos_thr = op.attr("rpn_positive_overlap", 0.7)
    neg_thr = op.attr("rpn_negative_overlap", 0.3)
    b = gt.shape[0]
    a = anchors.shape[0]
    dev = gt.device
    n_fg = int(rpn_batch * fg_frac)
    gen = ctx.generator(op)
    valid_gt = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])
    iou = _iou_matrix(anchors, gt, normalized=False)          # (B, A, G)
    iou = torch.where(valid_gt[:, None, :], iou, _scalar(0.0, iou))
    best_iou, _ = iou.max(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    best_anchor = torch.argmax(iou, dim=1)                    # (B, G)
    pos = torch.zeros((b, a + 1), dtype=torch.bool, device=dev)
    pos[torch.arange(b, device=dev)[:, None],
        torch.where(valid_gt, best_anchor,
                    torch.full((), a, device=dev))] = True
    pos = pos[:, :a] | (best_iou >= pos_thr)
    neg = best_iou < neg_thr
    u = torch.rand((2, b, a), generator=gen, device=dev)
    two = torch.full((), 2.0, device=dev)
    pos_keep = pos & (_rank(torch.where(pos, u[0], two)) < n_fg)
    n_neg = rpn_batch - pos_keep.sum(1)
    cand = neg & ~pos
    neg_keep = cand & (_rank(torch.where(cand, u[1], two)) < n_neg[:, None])
    score_t = torch.where(pos_keep, 1, torch.where(neg_keep, 0, -1)).to(
        torch.int32)
    aw, ah, acx, acy, gw, gh, gcx, gcy = _encode_plus1(
        anchors, _take(gt, best_gt))
    loc_t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                         torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    return {"ScoreTarget": [score_t[..., None]], "LocationTarget": [loc_t],
            "LocationWeight": [pos_keep.to(torch.float32)[..., None]],
            "ScoreWeight": [(pos_keep | neg_keep).to(torch.float32)[
                ..., None]]}


@register_op("retinanet_detection_output")
def _retinanet_detection_output(ctx, op, ins):
    """Per FPN level the nms_top_k best (anchor, class) scores above
    score_threshold, their anchors' deltas decoded and clipped to the
    scale-corrected image; class-wise greedy NMS over the merged levels
    (all classes and images at once), the global keep_top_k.  Out (B,
    keep_top_k, 6) padded with label -1, RoisNum (B,)."""
    bboxes_list = [v for v in ins.get("BBoxes", []) if v is not None]
    scores_list = [v for v in ins.get("Scores", []) if v is not None]
    anchors_list = [v for v in ins.get("Anchors", []) if v is not None]
    im_info = first(ins, "ImInfo")      # (B, 3) h, w, scale
    score_thr = op.attr("score_threshold", 0.05)
    nms_top_k = int(op.attr("nms_top_k", 1000))
    keep_top_k = int(op.attr("keep_top_k", 100))
    nms_thr = op.attr("nms_threshold", 0.3)
    c = scores_list[0].shape[-1]
    batched = scores_list[0].dim() == 3
    scores_list = [s if batched else s[None] for s in scores_list]
    bboxes_list = [d if d.dim() == 3 else d[None] for d in bboxes_list]
    b = scores_list[0].shape[0]
    imr = im_info[:b]
    ih = torch.round(imr[:, 0] / imr[:, 2])[:, None]
    iw = torch.round(imr[:, 1] / imr[:, 2])[:, None]
    cand_s, cand_b, cand_c = [], [], []
    for sc, dl, an in zip(scores_list, bboxes_list, anchors_list):
        m = sc.shape[1]
        k = min(nms_top_k, m * c)
        s_top, idx = _top_k(sc.reshape(b, -1), k)
        a_idx = idx // c
        deltas = _take(dl, a_idx)
        anc = _take(an, a_idx)
        aw = anc[..., 2] - anc[..., 0] + 1.0
        ah = anc[..., 3] - anc[..., 1] + 1.0
        acx = anc[..., 0] + aw * 0.5
        acy = anc[..., 1] + ah * 0.5
        cx = deltas[..., 0] * aw + acx
        cy = deltas[..., 1] * ah + acy
        w = torch.exp(torch.clamp(deltas[..., 2], max=10.0)) * aw
        h = torch.exp(torch.clamp(deltas[..., 3], max=10.0)) * ah
        zero = _scalar(0.0, cx)
        cand_b.append(torch.stack([
            torch.clamp(cx - w / 2, zero, iw - 1),
            torch.clamp(cy - h / 2, zero, ih - 1),
            torch.clamp(cx + w / 2 - 1, zero, iw - 1),
            torch.clamp(cy + h / 2 - 1, zero, ih - 1)], dim=-1))
        cand_s.append(torch.where(s_top > score_thr, s_top,
                                  _scalar(0.0, s_top)))
        cand_c.append((idx % c).to(torch.int32))
    s_all = torch.cat(cand_s, 1)        # (B, N)
    b_all = torch.cat(cand_b, 1)        # (B, N, 4)
    c_all = torch.cat(cand_c, 1)        # (B, N)
    classes = torch.arange(c, dtype=torch.int32, device=s_all.device)
    s_cls = torch.where(c_all[:, None, :] == classes[:, None],
                        s_all[:, None, :], _scalar(0.0, s_all))  # (B, C, N)
    order = torch.argsort(-s_cls, dim=-1, stable=True)
    s_sorted = torch.gather(s_cls, -1, order)
    keep = _nms_keep(_take(b_all[:, None], order), s_sorted, nms_thr, 0.0,
                     False)
    kept = torch.zeros_like(s_cls).scatter_(
        -1, order, torch.where(keep, s_sorted, _scalar(0.0, s_sorted)))
    s_final = kept.max(dim=1).values
    n = s_final.shape[1]
    kk = min(keep_top_k, n) if keep_top_k > 0 else n
    s_out, sel = _top_k(s_final, kk)
    lab = torch.where(s_out > 0, torch.gather(c_all, 1, sel).to(s_out.dtype),
                      _scalar(-1.0, s_out))
    det = torch.cat([lab[..., None], s_out[..., None], _take(b_all, sel)],
                    dim=-1)
    outs = {"Out": [det]}
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [(s_out > 0).sum(1).to(torch.int32)]
    return outs


@register_op("generate_proposal_labels")
def _generate_proposal_labels(ctx, op, ins):
    """Faster R-CNN's second-stage sampling: the gts join the candidates;
    candidates at max IoU >= fg_thresh are foreground (subsampled at
    random to batch_size_per_im * fg_fraction), those in [bg_thresh_lo,
    bg_thresh_hi) fill the rest as background; foreground rows get
    center-size targets against their gt.  Every output has
    batch_size_per_im rows an image (LabelsInt32 -1 on the padding),
    RoisNum (B,)."""
    rois = first(ins, "RpnRois")
    gt_classes = first(ins, "GtClasses")
    gt_boxes = first(ins, "GtBoxes")
    if rois.dim() == 2:
        rois = rois[None]
    if gt_boxes.dim() == 2:
        gt_boxes = gt_boxes[None]
        gt_classes = gt_classes[None]
    spi = int(op.attr("batch_size_per_im", 256))
    fg_fraction = op.attr("fg_fraction", 0.25)
    fg_thresh = op.attr("fg_thresh", 0.5)
    bg_hi = op.attr("bg_thresh_hi", 0.5)
    bg_lo = op.attr("bg_thresh_lo", 0.0)
    class_num = int(op.attr("class_nums", op.attr("class_num", 81)))
    weights = [float(w) for w in op.attr("bbox_reg_weights",
                                         [0.1, 0.1, 0.2, 0.2])]
    b = rois.shape[0]
    dev = rois.device
    n_fg = int(spi * fg_fraction)
    gen = ctx.generator(op)
    gtb = gt_boxes
    valid_gt = (gtb[..., 2] > gtb[..., 0]) & (gtb[..., 3] > gtb[..., 1])
    cand = torch.cat([rois, gtb.to(rois.dtype)], 1)           # (B, N, 4)
    dt = cand.dtype
    n = cand.shape[1]
    valid_cand = (cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
    iou = _iou_matrix(cand, gtb, normalized=False)
    iou = torch.where(valid_gt[:, None, :], iou, _scalar(0.0, iou))
    max_ov, _ = iou.max(dim=2)
    arg_gt = torch.argmax(iou, dim=2)
    is_fg = valid_cand & (max_ov >= fg_thresh)
    is_bg = valid_cand & ~is_fg & (max_ov >= bg_lo) & (max_ov < bg_hi)
    u = torch.rand((2, b, n), generator=gen, device=dev)
    two = torch.full((), 2.0, device=dev)
    r_fg = torch.where(is_fg, u[0], two)
    fg_keep = is_fg & (_rank(r_fg) < n_fg)
    n_fg_real = fg_keep.sum(1)
    r_bg = torch.where(is_bg, u[1], two)
    bg_keep = is_bg & (_rank(r_bg) < (spi - n_fg_real)[:, None])
    spi_t = torch.full((), spi, device=dev)
    sel_rank = torch.where(
        fg_keep, _rank(torch.where(fg_keep, r_fg, two)),
        torch.where(bg_keep,
                    n_fg_real[:, None] + _rank(torch.where(bg_keep, r_bg,
                                                           two)),
                    spi_t))
    slot = torch.where(fg_keep | bg_keep, sel_rank, spi_t)
    bi = torch.arange(b, device=dev)[:, None]
    out_rois = torch.zeros((b, spi + 1, 4), dtype=dt, device=dev)
    out_rois[bi, slot] = cand
    lab = torch.where(fg_keep, torch.gather(gt_classes.to(torch.int32), 1,
                                            arg_gt),
                      torch.zeros((), dtype=torch.int32, device=dev))
    out_lab = torch.full((b, spi + 1), -1, dtype=torch.int32, device=dev)
    out_lab[bi, slot] = lab
    cw, chh, ccx, ccy, gw, gh, gcx, gcy = _encode_plus1(
        cand, _take(gtb.to(dt), arg_gt))
    tgt = torch.stack([(gcx - ccx) / cw / weights[0],
                       (gcy - ccy) / chh / weights[1],
                       torch.log(gw / cw) / weights[2],
                       torch.log(gh / chh) / weights[3]], dim=-1)
    full_tgt = torch.zeros((b, spi + 1, 4), dtype=dt, device=dev)
    full_tgt[bi, slot] = torch.where(fg_keep[..., None], tgt,
                                     _scalar(0.0, tgt))
    out_rois, out_lab, full_tgt = (out_rois[:, :spi], out_lab[:, :spi],
                                   full_tgt[:, :spi])
    cls_slot = torch.clamp(out_lab, 0, class_num - 1).long()
    si = torch.arange(spi, device=dev)[None, :]
    tgt_c = torch.zeros((b, spi, class_num, 4), dtype=dt, device=dev)
    tgt_c[bi, si, cls_slot] = full_tgt
    inside = torch.zeros((b, spi, class_num, 4), dtype=dt, device=dev)
    inside[bi, si, cls_slot] = (out_lab > 0).to(dt)[..., None].expand(
        b, spi, 4)
    count = (n_fg_real + bg_keep.sum(1)).to(torch.int32)
    inw = inside.reshape(b, spi, -1)
    outs = {"Rois": [out_rois], "LabelsInt32": [out_lab],
            "BboxTargets": [tgt_c.reshape(b, spi, -1)],
            "BboxInsideWeights": [inw], "BboxOutsideWeights": [inw]}
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [count]
    return outs


# -- locality-aware NMS (detection_ops.py:1433-1535) ------------------------------

def _locality_merge(boxes, scores, nms_thr, normalized, score_thr=0.0,
                    pair_iou=None):
    """EAST's locality-aware prepass over all (image, class) rows at
    once: walk the boxes in input order; while the next box overlaps the
    current merge head beyond nms_thr, fold it in (score-weighted
    coordinates, summed scores), else finalize the head and start a new
    one.  score_threshold applies to the merged heads only.  boxes
    (..., n, D), scores (..., n) -> same-length arrays, heads packed
    first, zero scores after."""
    lead, n, dim = boxes.shape[:-2], boxes.shape[-2], boxes.shape[-1]
    dev, dt = boxes.device, boxes.dtype
    f32 = torch.float32
    head_b = torch.zeros(lead + (dim,), dtype=dt, device=dev)
    head_s = torch.full(lead, -1.0, dtype=f32, device=dev)
    # slot n takes the writes that do not happen
    out_b = torch.zeros(lead + (n + 1, dim), dtype=dt, device=dev)
    out_s = torch.zeros(lead + (n + 1,), dtype=f32, device=dev)
    cnt = torch.zeros(lead, dtype=torch.long, device=dev)
    dump = torch.full((), n, dtype=torch.long, device=dev)

    def put(out_b, out_s, when):
        at = torch.where(when, cnt, dump)[..., None]
        return (out_b.scatter(-2, at[..., None].expand(lead + (1, dim)),
                              head_b[..., None, :]),
                out_s.scatter(-1, at, head_s[..., None]))

    for i in range(n):
        b, s = boxes[..., i, :], scores[..., i].to(f32)
        has_head = head_s >= 0
        if pair_iou is None:
            iou = _iou_matrix(b[..., None, :], head_b[..., None, :],
                              normalized)[..., 0, 0]
        else:
            iou = pair_iou(b, head_b)
        do_merge = has_head & (iou > nms_thr)
        hs = torch.clamp(head_s, min=0.0)
        merged_b = (b * s[..., None] + head_b * hs[..., None]) \
            / torch.clamp(s + hs, min=1e-12)[..., None]
        finalize = has_head & ~do_merge
        out_b, out_s = put(out_b, out_s, finalize)
        cnt = cnt + finalize.to(torch.long)
        head_b = torch.where(do_merge[..., None], merged_b.to(dt), b)
        head_s = torch.where(do_merge, head_s + s, s)
    out_b, out_s = put(out_b, out_s, head_s >= 0)
    out_b, out_s = out_b[..., :n, :], out_s[..., :n]
    zero = torch.zeros((), dtype=f32, device=dev)
    return out_b, torch.where(out_s > score_thr, out_s, zero)


@register_op("locality_aware_nms")
def _locality_aware_nms(ctx, op, ins):
    """EAST text detection: the locality-aware merge, then per-class
    greedy NMS (polygon IoU for 8..32-coordinate quads) and the global
    keep_top_k, in multiclass_nms's dense contract with RoisNum."""
    bboxes = first(ins, "BBoxes")   # (B, M, 4) or (B, M, 8..32)
    scores = first(ins, "Scores")   # (B, C, M)
    box_dim = bboxes.shape[-1]
    is_poly = box_dim != 4
    bg = op.attr("background_label", -1)
    score_thr = op.attr("score_threshold", 0.0)
    nms_top_k = int(op.attr("nms_top_k", 64) or 64)
    iou_thr = op.attr("nms_threshold", 0.3)
    keep_top_k = int(op.attr("keep_top_k", 64) or 64)
    normalized = op.attr("normalized", True)
    m = scores.shape[2]
    k = min(nms_top_k, m) if nms_top_k > 0 else m

    def pair_iou(b1, b2):
        return poly_iou(b1.reshape(b1.shape[:-1] + (-1, 2)),
                        b2.reshape(b2.shape[:-1] + (-1, 2)))

    def per_class(boxes, sc):
        f = sc.shape[1]
        mb, ms = _locality_merge(
            boxes[:, None].expand(-1, f, -1, -1), sc, iou_thr, normalized,
            score_thr=score_thr, pair_iou=pair_iou if is_poly else None)
        s_top, idx = _top_k(ms, k)
        b_top = _take(mb, idx)
        if is_poly:
            keep = _nms_keep_poly(b_top, s_top, iou_thr, score_thr)
        else:
            keep = _nms_keep(b_top, s_top, iou_thr, score_thr, normalized)
        return torch.where(keep, s_top, _scalar(-1.0, s_top)), b_top, idx

    det, counts, _ = _multiclass_scaffold(bboxes, scores, bg, keep_top_k,
                                          per_class, box_dim=box_dim)
    outs = {"Out": [det]}
    if "Index" in op.outputs:
        raise NotImplementedError(
            "locality_aware_nms: the Index output has no meaningful "
            "source-row mapping once boxes merge; consume Out/RoisNum")
    if "RoisNum" in op.outputs:
        outs["RoisNum"] = [counts]
    return outs


def _nms_keep_poly(boxes, scores, iou_thr, score_thr):
    """Greedy NMS with polygon IoU, boxes (..., k, 2V) flattened quads."""
    k = boxes.shape[-2]
    pts = boxes.reshape(boxes.shape[:-1] + (-1, 2))
    iou = poly_iou(pts[..., :, None, :, :], pts[..., None, :, :, :])
    return _greedy_keep(iou > iou_thr, scores > score_thr, k)


# -- ROI pools (detection_ops.py:1538-1638) -----------------------------------------

@register_op("psroi_pool")
def _psroi_pool(ctx, op, ins):
    """Position-sensitive ROI average pooling: output channel c at bin
    (ph, pw) averages input channel (c * PH + ph) * PW + pw over the bin;
    roi corners round as the reference's (start round(x) * scale, end
    (round(x2) + 1) * scale)."""
    x = first(ins, "X")                 # (N, C_in, H, W)
    rois = first(ins, "ROIs").reshape(-1, 4)
    rois_num = first(ins, "RoisNum", None)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    oc = int(op.attr("output_channels"))
    scale = op.attr("spatial_scale", 1.0)
    _, _, h, w = x.shape
    r = rois.shape[0]
    dev, dt = x.device, x.dtype
    bids = _rois_batch_index(rois_num, r, dev)
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = (torch.round(rois[:, 2]) + 1.0) * scale
    y2 = (torch.round(rois[:, 3]) + 1.0) * scale
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    bh, bw = (rh / ph)[:, None], (rw / pw)[:, None]
    ar_h = torch.arange(ph, device=dev)
    ar_w = torch.arange(pw, device=dev)
    hs = torch.clamp(torch.floor(y1[:, None] + ar_h * bh), 0, h)
    he = torch.clamp(torch.ceil(y1[:, None] + (ar_h + 1) * bh), 0, h)
    ws_ = torch.clamp(torch.floor(x1[:, None] + ar_w * bw), 0, w)
    we = torch.clamp(torch.ceil(x1[:, None] + (ar_w + 1) * bw), 0, w)
    ymask = (ys >= hs[..., None]) & (ys < he[..., None])      # (R, PH, H)
    xmask = (xs >= ws_[..., None]) & (xs < we[..., None])     # (R, PW, W)
    g = x[bids].reshape(r, oc, ph, pw, h, w)
    msk = ymask[:, None, :, None, :, None] & xmask[:, None, None, :, None, :]
    s = (g * msk).sum(dim=(4, 5))
    dh, dw = he - hs, we - ws_
    area = torch.clamp(dh[:, :, None] * dw[:, None, :], min=1.0)
    empty = (dh[:, :, None] <= 0) | (dw[:, None, :] <= 0)
    out = torch.where(empty[:, None], _scalar(0.0, s), s / area[:, None])
    return {"Out": [out]}


def _tri_integral(a, b, c):
    """The integral over [a, b] of max(0, 1 - |y - c|) dy, in closed
    form."""
    def big_f(u):
        u = torch.clamp(u, -1.0, 1.0)
        neg = 0.5 * torch.square(u + 1.0)
        pos = 0.5 + u - 0.5 * torch.square(u)
        return torch.where(u <= 0, neg, pos)
    return torch.clamp(big_f(b - c) - big_f(a - c), min=0.0)


@register_op("prroi_pool")
def _prroi_pool(ctx, op, ins):
    """Precise RoI pooling: the exact integral of the bilinearly
    interpolated map over each bin over the bin's area, as two small
    products a bin (separable triangle-kernel weights)."""
    x = first(ins, "X")
    rois = first(ins, "ROIs").reshape(-1, 4)
    rois_num = first(ins, "BatchRoINums", None)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    scale = op.attr("spatial_scale", 1.0)
    _, _, h, w = x.shape
    r = rois.shape[0]
    dev, dt = x.device, x.dtype
    bids = _rois_batch_index(rois_num, r, dev)
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    rw = torch.clamp(x2 - x1, min=0.0)
    rh = torch.clamp(y2 - y1, min=0.0)
    bh, bw = rh / ph, rw / pw
    win = bh * bw
    ph_i = torch.arange(ph, dtype=dt, device=dev)
    pw_i = torch.arange(pw, dtype=dt, device=dev)
    y1e, bhe = y1[:, None, None], bh[:, None, None]
    x1e, bwe = x1[:, None, None], bw[:, None, None]
    wy = _tri_integral(y1e + ph_i[:, None] * bhe,
                       y1e + (ph_i[:, None] + 1) * bhe, ys[None])
    wx = _tri_integral(x1e + pw_i[:, None] * bwe,
                       x1e + (pw_i[:, None] + 1) * bwe, xs[None])
    s = torch.einsum("rph,rchw,rqw->rcpq", wy, x[bids], wx)
    win = win[:, None, None, None]
    return {"Out": [torch.where(win > 0, s / torch.clamp(win, min=1e-12),
                                _scalar(0.0, s))]}


@register_op("retinanet_target_assign")
def _retinanet_target_assign(ctx, op, ins):
    """rpn_target_assign without subsampling: every anchor at max IoU >=
    positive_overlap (and each gt's best anchors) is foreground with the
    gt's class, every anchor under negative_overlap is background (0),
    the rest ignored (-1).  ForegroundNumber (B, 1) = fg count + 1."""
    anchors = first(ins, "Anchor").reshape(-1, 4)
    gt = first(ins, "GtBoxes")
    gt_labels = first(ins, "GtLabels").to(torch.int32)
    if gt.dim() == 2:
        gt = gt[None]
        gt_labels = gt_labels.reshape(1, -1)
    b, g, _ = gt.shape
    gt_labels = gt_labels.reshape(b, g)
    pos_thr = op.attr("positive_overlap", 0.5)
    neg_thr = op.attr("negative_overlap", 0.4)
    valid_gt = (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1])
    crowd = first(ins, "IsCrowd", None)
    if crowd is not None:
        valid_gt = valid_gt & (crowd.reshape(b, g).to(torch.int32) == 0)
    iou = _iou_matrix(anchors, gt, normalized=False)          # (B, A, G)
    iou = torch.where(valid_gt[:, None, :], iou, _scalar(-1.0, iou))
    best_iou, _ = iou.max(dim=2)
    best_gt = torch.argmax(iou, dim=2)
    gt_best, _ = iou.max(dim=1)                               # (B, G)
    is_gt_best = (iou == gt_best[:, None, :]) & valid_gt[:, None, :] \
        & (gt_best[:, None, :] > 0)
    fg = (best_iou >= pos_thr) | is_gt_best.any(2)
    bg = ~fg & (best_iou < neg_thr) & (best_iou >= 0)
    score = torch.where(fg, torch.gather(gt_labels, 1, best_gt),
                        torch.where(bg, 0, -1)).to(torch.int32)
    aw, ah, acx, acy, gw, gh, gcx, gcy = _encode_plus1(
        anchors, _take(gt, best_gt))
    tgt = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                       torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    return {"ScoreTarget": [score[..., None]],
            "LocationTarget": [torch.where(fg[..., None], tgt,
                                           _scalar(0.0, tgt))],
            "LocationWeight": [fg.to(torch.float32)[..., None]],
            "ScoreWeight": [(fg | bg).to(torch.float32)[..., None]],
            "ForegroundNumber": [(fg.sum(1) + 1).to(torch.int32)
                                 .reshape(b, 1)]}


# -- polygon geometry (detection_ops.py:1711-1832), batched over leading dims -----

def _poly_area(poly, nv=None):
    """Shoelace area of (..., V, 2) polygons; with `nv` (...,) only the
    first nv vertices count."""
    v = poly.shape[-2]
    idx = torch.arange(v, device=poly.device)
    x, y = poly[..., 0], poly[..., 1]
    if nv is None:
        nxt = ((idx + 1) % v).expand(x.shape)
    else:
        nxt = torch.where(idx + 1 >= nv[..., None], 0, idx + 1)
        nxt = nxt.expand(x.shape)
    xn = torch.gather(x, -1, nxt)
    yn = torch.gather(y, -1, nxt)
    cross = x * yn - xn * y
    if nv is not None:
        cross = torch.where(idx < nv[..., None], cross, _scalar(0.0, cross))
    return 0.5 * torch.abs(cross.sum(-1))


def _convex_clip(subject, clip, max_out=None):
    """Sutherland-Hodgman clip of `subject` (..., S, 2) against the
    convex `clip` (..., C, 2): (points (..., cap, 2), count (...,)),
    cap = S + C, one edge a round."""
    lead = torch.broadcast_shapes(subject.shape[:-2], clip.shape[:-2])
    subject = subject.expand(lead + subject.shape[-2:])
    clip = clip.expand(lead + clip.shape[-2:])
    s, c = subject.shape[-2], clip.shape[-2]
    cap = max_out or (s + c)
    dev, dt = subject.device, subject.dtype
    sign = torch.sign((clip[..., 0] * torch.roll(clip[..., 1], -1, -1)
                       - torch.roll(clip[..., 0], -1, -1) * clip[..., 1])
                      .sum(-1) + 1e-30)
    pts = torch.zeros(lead + (cap, 2), dtype=dt, device=dev)
    pts[..., :s, :] = subject
    cnt = torch.full(lead, s, dtype=torch.long, device=dev)
    idxs = torch.arange(cap, device=dev)
    for i in range(c):
        a = clip[..., i, :]
        edge = (clip[..., (i + 1) % c, :] - a) * sign[..., None]
        e0, e1 = edge[..., 0:1], edge[..., 1:2]
        a0, a1 = a[..., 0:1], a[..., 1:2]

        def inside(p):
            return e0 * (p[..., 1] - a1) - e1 * (p[..., 0] - a0) >= 0

        live = idxs < cnt[..., None]
        nxt_i = torch.where(idxs + 1 >= cnt[..., None], 0, idxs + 1)
        nxt = torch.gather(pts, -2, nxt_i[..., None].expand(
            lead + (cap, 2)))
        cur_in = inside(pts) & live
        nxt_in = inside(nxt) & live
        d = nxt - pts
        denom = e0 * d[..., 1] - e1 * d[..., 0]
        t = (e1 * (pts[..., 0] - a0) - e0 * (pts[..., 1] - a1)) \
            / torch.where(torch.abs(denom) < 1e-12,
                          _scalar(1e-12, denom), denom)
        inter = pts + torch.clamp(t, 0.0, 1.0)[..., None] * d
        emit1 = cur_in & live
        emit2 = (cur_in != nxt_in) & live
        i1, i2 = emit1.to(torch.long), emit2.to(torch.long)
        n1 = torch.cumsum(i1, -1) - i1
        n2 = torch.cumsum(i2, -1) - i2
        pos1 = torch.where(emit1, n1 + n2, cap)
        pos2 = torch.where(emit2, n1 + i1 + n2, cap)
        new = torch.zeros(lead + (cap + 1, 2), dtype=dt, device=dev)
        new = new.scatter(-2, torch.clamp(pos1, max=cap)[..., None].expand(
            lead + (cap, 2)), pts)
        new = new.scatter(-2, torch.clamp(pos2, max=cap)[..., None].expand(
            lead + (cap, 2)), inter)
        pts = new[..., :cap, :]
        cnt = i1.sum(-1) + i2.sum(-1)
    return pts, cnt


def poly_iou(p1, p2):
    """IoU of convex polygons (..., V1, 2) and (..., V2, 2) by the area
    of their clip; 0 where either area or the intersection is 0."""
    a1 = _poly_area(p1)
    a2 = _poly_area(p2)
    inter_pts, inter_cnt = _convex_clip(p1, p2)
    ai = _poly_area(inter_pts, nv=inter_cnt)
    iou = ai / torch.clamp(a1 + a2 - ai, min=1e-10)
    return torch.where((a1 <= 0) | (a2 <= 0) | (ai <= 0),
                       _scalar(0.0, iou), iou)


def _poly_raster(polys, box, resolution, valid_poly):
    """The union of polygons (..., P, V, 2) on a resolution^2 grid over
    `box` (..., 4): an even-odd crossing test at the pixel centres (the
    reference's redesign of COCO's RLE rasteriser)."""
    m = resolution
    dev, dt = polys.device, polys.dtype
    w = torch.clamp(box[..., 2] - box[..., 0], min=1.0)[..., None, None]
    h = torch.clamp(box[..., 3] - box[..., 1], min=1.0)[..., None, None]
    cx = torch.arange(m, device=dev).to(dt) + 0.5
    cy = torch.arange(m, device=dev).to(dt) + 0.5
    px = (polys[..., 0] - box[..., 0, None, None]) * m / w    # (..., P, V)
    py = (polys[..., 1] - box[..., 1, None, None]) * m / h
    x2 = torch.roll(px, -1, -1)
    y2 = torch.roll(py, -1, -1)
    x1, y1 = px[..., None], py[..., None]
    x2, y2 = x2[..., None], y2[..., None]
    spans = (y1 > cy) != (y2 > cy)                             # (..., P, V, M)
    dy = y2 - y1
    xint = x1 + (cy - y1) / torch.where(torch.abs(dy) < 1e-12,
                                        _scalar(1e-12, dy), dy) * (x2 - x1)
    left = spans[..., None] & (xint[..., None] > cx)           # (.., P, V, M, M)
    cross = left.sum(-3)                                       # (..., P, M, M)
    inside = (cross % 2 == 1) & valid_poly[..., None, None]
    return inside.any(-3)


@register_op("generate_mask_labels")
def _generate_mask_labels(ctx, op, ins):
    """Mask R-CNN's mask targets: each foreground roi takes the polygons
    of the gt whose box it overlaps best, rasterised to resolution^2 in
    the roi, as a per-class -1/0/1 target.  Dense form: GtSegms (B, G,
    P, V, 2), GtSegmsVerts (B, G, P) vertex counts, Rois (B, R, 4),
    LabelsInt32 (B, R) -> MaskRois (B, R, 4), RoiHasMaskInt32 (B, R),
    MaskInt32 (B, R, num_classes * res^2)."""
    im_info = first(ins, "ImInfo")
    gt_classes = first(ins, "GtClasses").to(torch.int32)
    is_crowd = first(ins, "IsCrowd").to(torch.int32)
    segms = first(ins, "GtSegms")
    verts = first(ins, "GtSegmsVerts", None)
    rois = first(ins, "Rois")
    labels = first(ins, "LabelsInt32").to(torch.int32)
    num_classes = int(op.attr("num_classes"))
    res = int(op.attr("resolution"))
    if rois.dim() == 2:
        rois = rois[None]
        labels = labels.reshape(1, -1)
        gt_classes = gt_classes.reshape(1, -1)
        is_crowd = is_crowd.reshape(1, -1)
        segms = segms[None] if segms.dim() == 4 else segms
    b, r, _ = rois.shape
    g, p, v = segms.shape[1], segms.shape[2], segms.shape[3]
    dev = rois.device
    if verts is None:
        verts = torch.full((b, g, p), v, dtype=torch.int32, device=dev)
    verts = verts.to(torch.int32).reshape(b, g, p)
    vidx = torch.arange(v, device=dev)
    valid_gt = (gt_classes > 0) & (is_crowd == 0) & (verts > 0).any(2)
    valid_poly = verts > 0                                     # (B, G, P)
    vert_ok = vidx < verts[..., None]                          # (B, G, P, V)
    big = 1e30
    xs = segms[..., 0]
    ys = segms[..., 1]
    lo, hi = _scalar(big, xs), _scalar(-big, xs)
    x0 = torch.where(vert_ok, xs, lo).amin(dim=(2, 3))
    y0 = torch.where(vert_ok, ys, lo).amin(dim=(2, 3))
    x1 = torch.where(vert_ok, xs, hi).amax(dim=(2, 3))
    y1 = torch.where(vert_ok, ys, hi).amax(dim=(2, 3))
    gt_boxes = torch.stack([x0, y0, x1, y1], dim=-1)          # (B, G, 4)
    fg = labels > 0
    scale = im_info[:, 2].reshape(b, 1, 1)
    roi_img = rois / scale
    iou = _iou_matrix(roi_img, gt_boxes.to(roi_img.dtype), normalized=False)
    iou = torch.where(valid_gt[:, None, :], iou, _scalar(-1.0, iou))
    best_gt = torch.argmax(iou, dim=2)                         # (B, R)
    bi = torch.arange(b, device=dev)[:, None]
    mask = _poly_raster(segms[bi, best_gt], roi_img.to(segms.dtype), res,
                        valid_poly[bi, best_gt])               # (B, R, M, M)
    flat = mask.reshape(b, r, -1).to(torch.int32)
    minus = torch.full((), -1, dtype=torch.int32, device=dev)
    tgt = torch.full((b, r, num_classes, res * res), -1, dtype=torch.int32,
                     device=dev)
    cls = torch.clamp(labels, 0, num_classes - 1).long()
    tgt[bi, torch.arange(r, device=dev)[None, :], cls] = torch.where(
        fg[..., None], flat, minus)
    masks = torch.where(fg[..., None], tgt.reshape(b, r, -1), minus)
    return {"MaskRois": [torch.where(fg[..., None], rois,
                                     _scalar(0.0, rois))],
            "RoiHasMaskInt32": [fg.to(torch.int32)], "MaskInt32": [masks]}
