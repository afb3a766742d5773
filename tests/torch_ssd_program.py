"""MobileNet-SSD on Pascal VOC, as PaddleCV's `ssd` example builds it
(PaddlePaddle/models, PaddleCV/ssd: mobilenet_ssd.py and train.py,
`--dataset pascalvoc`): a MobileNet V1 backbone at scale 1.0 in 1.x
conv2d + batch_norm layers (the depthwise convolutions as grouped ones),
four extra blocks after the 1024-wide stage (1x1 to 256 then 3x3/2 to
512; 128 -> 256; 128 -> 256; 64 -> 128), `multi_box_head` over the six
maps (19^2, 10^2, 5^2, 3^2, 2^2, 1^2 at 300^2) with min_sizes [60, 105,
150, 195, 240, 285], max_sizes [[], 150, 195, 240, 285, 300], aspect
ratios [[2], [2, 3] x 5], flip, offset 0.5: 1917 priors; Paddle's
ssd_loss (per_prediction matching at 0.5, max_negative mining at 3:1
under overlap 0.5, center-size location targets, smooth L1), summed;
RMSProp at lr 0.001 over piecewise_decay (VOC's 19200 images at B=64:
boundaries at epochs 40/60/80/100, values 1, 0.5, 0.25, 0.1, 0.01 of
it) with L2Decay(5e-5); decoding through detection_output at
nms_threshold 0.45, nms_top_k 400, keep_top_k 200.

`build` takes either package's `fluid`, so the same code gives the same
Program in both.  `FULL` is the published configuration (B=64, 21
classes: VOC's 20 and the background).  `SMALL` is it cut for the CPU:
scale 0.25, one of the five 512-wide blocks, 160^2 images (maps of 10,
5, 3, 2, 1 and 1: 540 priors), 5 classes, B=16, the prior sizes scaled
with the image.  Its last two maps are 1x1 as the full width's last one
is, and their three batch norms see B values a channel: at 64^2 seven
of them chain, each multiplying the float32 rounding that comes in, and
at B=2 a 1x1 map's batch-norm input gradient is 0 but for rounding,
which RMSProp scales up to a full step.

Where it departs from the published example (PERF.md says why):
- Paddle's fluid.layers.ssd_loss is a compat guard in both packages (its
  note: the loss composes target_assign + box_coder + softmax /
  smooth_l1), so `ssd_loss` below composes it from the layers and
  mine_hard_examples.  The dense target_assign ignores NegIndices, so
  the confidence weight is the positives' mask plus the mined
  negatives'; the location targets are box_coder's encode of every gt
  against every prior, gathered per (image, prior) by target_assign
  over the gts (a batch of B * M rows).
- Ground truth is dense: gt_box (B, 16, 4) normalised corner boxes with
  zero-area rows as padding, gt_label (B, 16, 1); images and boxes are
  drawn from a seed (no VOC in the repository), each image's noise at a
  contrast and brightness of its own.
- With `quant`, fluid.contrib.slim's pass rewrites the program before
  the optimizer appends the backward, as PaddleSlim's QAT flow does.
"""

import numpy as np

CLASSES_VOC = 21
MAX_GT = 16
_SIZES = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
_MAXES = [[], 150.0, 195.0, 240.0, 285.0, 300.0]

FULL = dict(image=300, scale=1.0, classes=CLASSES_VOC, batch=64,
            gt=MAX_GT, mid_blocks=5, min_sizes=_SIZES, max_sizes=_MAXES,
            nms_top_k=400, keep_top_k=200, lr=0.001, steps_per_epoch=300)
SMALL = dict(FULL, image=160, scale=0.25, classes=5, batch=16, gt=4,
             mid_blocks=1, min_sizes=[s * 160 / 300 for s in _SIZES],
             max_sizes=[[]] + [s * 160 / 300 for s in _MAXES[1:]],
             nms_top_k=20, keep_top_k=10)

ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                 [2.0, 3.0]]
NMS_THRESHOLD = 0.45
OVERLAP, NEG_POS_RATIO, NEG_OVERLAP = 0.5, 3.0, 0.5
LR_EPOCHS = [40, 60, 80, 100]
LR_DECAY = [1, 0.5, 0.25, 0.1, 0.01]
L2 = 5e-5


def _conv_bn(fluid, x, filter_size, num_filters, stride, padding,
             groups=1, act="relu"):
    attr = fluid.ParamAttr(learning_rate=0.1,
                           initializer=fluid.initializer.MSRA())
    conv = fluid.layers.conv2d(x, num_filters, filter_size, stride=stride,
                               padding=padding, groups=groups, act=None,
                               use_cudnn=groups == 1, param_attr=attr,
                               bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act)


def _depthwise_separable(fluid, x, f1, f2, groups, stride, scale):
    dw = _conv_bn(fluid, x, 3, int(f1 * scale), stride, 1,
                  groups=int(groups * scale))
    return _conv_bn(fluid, dw, 1, int(f2 * scale), 1, 0)


def _extra_block(fluid, x, f1, f2, stride, scale):
    pw = _conv_bn(fluid, x, 1, int(f1 * scale), 1, 0)
    return _conv_bn(fluid, pw, 3, int(f2 * scale), stride, 1)


def mobilenet_ssd(fluid, image, cfg):
    """The backbone, the extra blocks and the heads: (locs (B, M, 4),
    confs (B, M, C), priors (M, 4), variances (M, 4))."""
    s = cfg["scale"]
    x = _conv_bn(fluid, image, 3, int(32 * s), 2, 1)
    for f1, f2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = _depthwise_separable(fluid, x, f1, f2, f1, stride, s)
    for _ in range(cfg["mid_blocks"]):
        x = _depthwise_separable(fluid, x, 512, 512, 512, 1, s)
    module11 = x
    x = _depthwise_separable(fluid, x, 512, 1024, 512, 2, s)
    module13 = _depthwise_separable(fluid, x, 1024, 1024, 1024, 1, s)
    module14 = _extra_block(fluid, module13, 256, 512, 2, s)
    module15 = _extra_block(fluid, module14, 128, 256, 2, s)
    module16 = _extra_block(fluid, module15, 128, 256, 2, s)
    module17 = _extra_block(fluid, module16, 64, 128, 2, s)
    return fluid.layers.multi_box_head(
        inputs=[module11, module13, module14, module15, module16, module17],
        image=image, num_classes=cfg["classes"], min_ratio=20, max_ratio=90,
        min_sizes=cfg["min_sizes"], max_sizes=cfg["max_sizes"],
        aspect_ratios=ASPECT_RATIOS, base_size=cfg["image"], offset=0.5,
        flip=True)


def ssd_loss(fluid, locs, confs, gt_box, gt_label, box, box_var, cfg,
             conf_loss_weight=1.0, loc_loss_weight=1.0):
    """Paddle's ssd_loss (layers/detection.py) over the dense rules: (B,
    1) losses normalised by the count of matched priors."""
    L = fluid.layers
    g, m = cfg["gt"], num_priors(cfg)
    # 1. match every prior to a gt
    iou = L.reshape(L.iou_similarity(L.reshape(gt_box, [-1, 4]), box),
                    [-1, g, m])
    match, match_dist = L.bipartite_match(iou, "per_prediction", OVERLAP)
    # 2. the confidence loss that mining ranks by
    label, _ = L.target_assign(gt_label, match, mismatch_value=0)
    mined_loss = L.reshape(L.softmax_with_cross_entropy(confs, label),
                           [-1, m])
    mined_loss.stop_gradient = True
    # 3. hard negatives: the highest losses, 3 for each positive
    helper = fluid.layer_helper.LayerHelper("mine_hard_examples")
    neg = helper.create_variable_for_type_inference(dtype="int32")
    updated = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        "mine_hard_examples",
        inputs={"ClsLoss": [mined_loss], "MatchIndices": [match],
                "MatchDist": [match_dist]},
        outputs={"NegIndices": [neg], "UpdatedMatchIndices": [updated]},
        attrs={"neg_pos_ratio": NEG_POS_RATIO,
               "neg_dist_threshold": NEG_OVERLAP,
               "mining_type": "max_negative", "sample_size": 0},
        infer_shape=False)
    # 4. the targets: labels, and each gt encoded against every prior
    # gathered by (image, prior)
    target_label, loc_weight = L.target_assign(gt_label, updated,
                                               mismatch_value=0)
    encoded = L.box_coder(box, box_var, L.reshape(gt_box, [-1, 4]),
                          code_type="encode_center_size")
    encoded = L.reshape(L.transpose(L.reshape(encoded, [-1, g, m, 4]),
                                    [0, 2, 1, 3]), [-1, g, 4])
    target_bbox, _ = L.target_assign(encoded, L.reshape(updated, [-1, 1]),
                                     mismatch_value=0)
    conf_weight = loc_weight + L.cast(L.reshape(neg, [-1, m, 1]), "float32")
    # 5. the losses
    conf = L.softmax_with_cross_entropy(confs, target_label) * conf_weight
    loc = L.smooth_l1(L.reshape(locs, [-1, 4]),
                      L.reshape(target_bbox, [-1, 4]))
    loc = loc * L.reshape(loc_weight, [-1, 1])
    loss = conf_loss_weight * L.reshape(conf, [-1, m]) \
        + loc_loss_weight * L.reshape(loc, [-1, m])
    loss = L.reduce_sum(loss, dim=1, keep_dim=True)
    return loss / L.reduce_sum(loc_weight)


def optimizer(fluid, cfg):
    bounds = [cfg["steps_per_epoch"] * e for e in LR_EPOCHS]
    values = [cfg["lr"] * d for d in LR_DECAY]
    return fluid.optimizer.RMSProp(
        learning_rate=fluid.layers.piecewise_decay(bounds, values),
        regularization=fluid.regularizer.L2Decay(L2))


def build(fluid, cfg, train=True, quant=False):
    """(main, startup, {name: var}) under a fresh unique-name scope, so
    the train and the decode programs name the parameters alike.  The
    train program fetches "loss"; the decode program "nmsed" (B,
    keep_top_k, 6) and "count" (B,).  With `quant`, quantization-aware
    training: fluid.contrib.slim's QuantizationTransformPass (8-bit
    weights by abs_max, activations by the moving average) rewrites the
    program before the optimizer appends the backward, so the inserted
    quant-dequant ops are differentiated (their straight-through
    gradient)."""
    main, startup = fluid.Program(), fluid.Program()
    hw = cfg["image"]
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.data("image", [-1, 3, hw, hw], "float32")
        locs, confs, box, box_var = mobilenet_ssd(fluid, image, cfg)
        out = {"locs": locs, "confs": confs, "box": box, "var": box_var}
        if train:
            gt_box = fluid.data("gt_box", [-1, cfg["gt"], 4], "float32")
            gt_label = fluid.data("gt_label", [-1, cfg["gt"], 1], "int32")
            loss = fluid.layers.reduce_sum(ssd_loss(
                fluid, locs, confs, gt_box, gt_label, box, box_var, cfg))
            if quant:
                fluid.contrib.slim.QuantizationTransformPass().apply(
                    main, startup)
            optimizer(fluid, cfg).minimize(loss)
            out["loss"] = loss
        else:
            nmsed, count = fluid.layers.detection_output(
                locs, confs, box, box_var, nms_threshold=NMS_THRESHOLD,
                nms_top_k=cfg["nms_top_k"], keep_top_k=cfg["keep_top_k"])
            out.update(nmsed=nmsed, count=count)
    return main, startup, out


def head_program(fluid, cfg):
    """detection_output alone, over fed head outputs and priors (the
    decode half on inputs both Executors share): (main, startup, out,
    count)."""
    m = num_priors(cfg)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loc = fluid.data("loc", [-1, m, 4], "float32")
        conf = fluid.data("conf", [-1, m, cfg["classes"]], "float32")
        box = fluid.data("box", [m, 4], "float32")
        var = fluid.data("var", [m, 4], "float32")
        out, count = fluid.layers.detection_output(
            loc, conf, box, var, nms_threshold=NMS_THRESHOLD,
            nms_top_k=cfg["nms_top_k"], keep_top_k=cfg["keep_top_k"])
    return main, startup, out, count


def num_priors(cfg):
    """The prior count from the map sizes alone: 3 a cell on the first
    map (aspect 1, 2, 1/2; no max size), 6 on the others (1, 2, 1/2, 3,
    1/3 and the max size's square)."""
    side = cfg["image"]
    sides = []
    side = (side + 2 - 3) // 2 + 1            # the stem, stride 2
    for stride in (1, 2, 1, 2, 1, 2):
        side = (side + 2 - 3) // stride + 1
    sides.append(side)                        # module11
    side = (side + 2 - 3) // 2 + 1
    sides.append(side)                        # module13
    for _ in range(4):
        side = (side + 2 - 3) // 2 + 1
        sides.append(side)
    return sum(s * s * (3 if i == 0 else 6) for i, s in enumerate(sides))


def batch(cfg, seed=0):
    """Seeded images (uniform noise at a contrast and brightness of its
    own an image and channel) and 1-6 gt boxes an image (at most `gt`;
    normalised corners, sides 0.1-0.6), the rest zero-area padding;
    labels 1 to classes - 1, 0 on the padding."""
    rng = np.random.RandomState(seed)
    b, g, hw = cfg["batch"], cfg["gt"], cfg["image"]
    # a contrast and a brightness an image and channel: without them the
    # images' global statistics agree, and the batch norms of the 1x1
    # maps (whose field is the whole image) divide by a near-zero spread
    image = (rng.uniform(-1, 1, (b, 3, hw, hw))
             * rng.uniform(0.2, 1.0, (b, 3, 1, 1))
             + rng.uniform(-0.5, 0.5, (b, 3, 1, 1))).astype("float32")
    gt_box = np.zeros((b, g, 4), "float32")
    gt_label = np.zeros((b, g, 1), "int32")
    for i in range(b):
        n = rng.randint(1, min(6, g) + 1)
        wh = rng.uniform(0.1, 0.6, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (1 - wh)
        gt_box[i, :n] = np.concatenate([xy, xy + wh], 1)
        gt_label[i, :n, 0] = rng.randint(1, cfg["classes"], n)
    return {"image": image, "gt_box": gt_box, "gt_label": gt_label}
