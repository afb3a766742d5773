"""The detection surface of the port against paddle_tpu's on the CPU.

- fluid.layers' detection layers (the twelve of layers/detection.py),
  `multi_box_head` and the seven detection compat wrappers: one program
  that calls each gives the reference's Program JSON in the port, and
  its forward outputs agree in both Executors (F32; labels, counts and
  indices exactly).  static.nn's multi_box_head is fluid.layers'.
- nn.functional's detection tail: each function on the same seeded
  inputs in both packages' eager mode, outputs within F32 (integers
  exactly) and, where the rule is differentiable, the gradients of the
  inputs under the same cotangents.  rpn_target_assign and
  retinanet_target_assign read index slots the dense rules do not give
  and raise KeyError in both.
- The names fluid.layers and nn.functional re-export are the port's own
  layers, as the reference's are its.

Tolerances.  F32 (rtol 2e-5, atol 2e-6): a few float32 operations whose
only difference is the order of their sums.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.fluid as JF
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import flags as jax_flags

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF

from torch_det_cases import (_ANCH, _GT_PIX, _ROIS, CASES, _anchors,
                             _boxes, _segms)

F32 = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _f32(a):
    return np.asarray(a, np.float32) if np.issubdtype(
        np.asarray(a).dtype, np.floating) else np.asarray(a)


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


# -- the layers in one program ---------------------------------------------------

def _layers_program(fluid):
    """Every detection layer of fluid.layers, multi_box_head and the
    seven compat wrappers, on data inputs.  Returns (main, startup,
    {name: output var}, feed)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    out = {}
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feat = fluid.data("feat", [2, 4, 3, 3], "float32")
        feat2 = fluid.data("feat2", [2, 4, 2, 2], "float32")
        img = fluid.data("img", [2, 3, 24, 24], "float32")
        boxes = fluid.data("boxes", [6, 4], "float32")
        deltas = fluid.data("deltas", [2, 6, 4], "float32")
        logits = fluid.data("logits", [2, 6, 3], "float32")
        rois = fluid.data("rois", [3, 4], "float32")
        gtb = fluid.data("gtb", [2, 3, 4], "float32")
        gtl = fluid.data("gtl", [2, 3], "int32")
        label = fluid.data("label", [5, 1], "int32")
        x5 = fluid.data("x5", [5, 3], "float32")
        fg = fluid.data("fg", [1], "int32")
        yolo_x = fluid.data("yolo_x", [2, 16, 3, 3], "float32")
        imsize = fluid.data("imsize", [2, 2], "int32")
        iminfo = fluid.data("iminfo", [2, 3], "float32")
        px = fluid.data("px", [2, 8, 6, 6], "float32")
        match = fluid.data("match", [2, 5], "int32")
        tx = fluid.data("tx", [2, 3, 4], "float32")
        pvar = fluid.data("pvar", [4], "float32")
        bda_t = fluid.data("bda_t", [6, 12], "float32")
        bscore = fluid.data("bscore", [6, 3], "float32")
        out["prior"], out["prior_var"] = L.prior_box(
            feat, img, [4.0], [8.0], [2.0], flip=True, clip=True)
        out["anchors"], _ = L.anchor_generator(feat, [32.0, 64.0],
                                               [0.5, 1.0, 2.0])
        out["enc"] = L.box_coder(boxes, [0.1, 0.1, 0.2, 0.2],
                                 L.reshape(deltas, [-1, 4]),
                                 box_normalized=False)
        out["iou"] = L.iou_similarity(boxes, L.reshape(gtb, [-1, 4]))
        out["clip"] = L.box_clip(deltas, iminfo)
        out["match"], out["match_dist"] = L.bipartite_match(
            L.reshape(L.iou_similarity(L.reshape(gtb, [-1, 4]), boxes),
                      [2, 3, 6]), "per_prediction", 0.3)
        out["nms"], out["nms_num"] = L.multiclass_nms(
            deltas, L.transpose(L.softmax(logits), [0, 2, 1]),
            score_threshold=0.2, nms_top_k=4, keep_top_k=5)
        out["yolo_boxes"], out["yolo_scores"] = L.yolo_box(
            yolo_x, imsize, [10, 13, 16, 30], 3, 0.3, 8)
        out["focal"] = L.sigmoid_focal_loss(x5, label, fg)
        out["roi_align"] = L.roi_align(px, rois, 2, 2, 0.5, 2)
        out["det"], out["det_num"] = L.detection_output(
            L.scale(deltas, 0.1), logits, L.reshape(boxes, [6, 4]) * 0.05,
            L.reshape(boxes, [6, 4]) * 0.0 + 0.1, nms_top_k=4, keep_top_k=3)
        out["yolo_loss"] = L.yolov3_loss(
            yolo_x, gtb * 0.1 + 0.3, gtl, [10, 13, 16, 30, 33, 23], [1, 2],
            3, 0.5, 8)
        out["locs"], out["confs"], out["mbox"], out["mvar"] = \
            L.multi_box_head([feat, feat2], img, 24, 3,
                             [[2.0], [2.0, 3.0]], min_sizes=[6.0, 12.0],
                             max_sizes=[[], 18.0])
        out["pbt"] = L.polygon_box_transform(px)
        out["prroi"] = L.prroi_pool(px, rois, pooled_height=2,
                                    pooled_width=2)
        out["bda"], out["bda_assign"] = L.box_decoder_and_assign(
            boxes, pvar, bda_t, L.softmax(bscore), box_clip=4.135)
        out["ta"], out["ta_w"] = L.target_assign(tx, match, mismatch_value=0)
        out["roi_pool"], _ = L.roi_pool(px, rois, pooled_height=2,
                                        pooled_width=2)
        out["psroi"] = L.psroi_pool(px, rois, output_channels=2,
                                    pooled_height=2, pooled_width=2)
        out["retina"] = L.retinanet_detection_output(
            [deltas], [L.softmax(logits)], [boxes], iminfo, nms_top_k=5,
            keep_top_k=4)
    rng = np.random.RandomState(0)
    feed = {"feat": _f(2, 4, 3, 3), "feat2": _f(2, 4, 2, 2, seed=1),
            "img": _f(2, 3, 24, 24, seed=2),
            "boxes": _f32(_boxes(6, scale=16)),
            "deltas": _f32(_boxes(2, 6, seed=3)),
            "logits": _f(2, 6, 3, seed=4), "rois": _f32(_ROIS),
            "gtb": _f32(_boxes(2, 3, seed=5)),
            "gtl": rng.randint(0, 3, (2, 3)).astype(np.int32),
            "label": rng.randint(0, 4, (5, 1)).astype(np.int32),
            "x5": _f(5, 3, seed=6), "fg": np.array([3], np.int32),
            "yolo_x": _f(2, 16, 3, 3, seed=7),
            "imsize": np.array([[24, 32], [30, 20]], np.int32),
            "iminfo": np.array([[16., 16., 1.], [20., 14., 2.]], np.float32),
            "px": _f(2, 8, 6, 6, seed=8),
            "match": np.array([[0, -1, 2, 1, -1], [-1, 1, -1, -1, 0]],
                              np.int32),
            "tx": _f(2, 3, 4, seed=9),
            "pvar": np.array([0.1, 0.1, 0.2, 0.2], np.float32),
            "bda_t": _f(6, 12, seed=10, scale=0.5),
            "bscore": _f(6, 3, seed=11)}
    return main, startup, out, feed


def test_detection_layers_build_and_run_as_the_reference():
    jm, js, jo, feed = _layers_program(JF)
    tm, ts, to, _ = _layers_program(TF)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    assert {op.type for op in tm.global_block().ops} >= {
        "prior_box", "anchor_generator", "box_coder", "iou_similarity",
        "box_clip", "bipartite_match", "multiclass_nms3", "yolo_box",
        "sigmoid_focal_loss", "roi_align", "yolov3_loss", "conv2d",
        "polygon_box_transform", "prroi_pool", "box_decoder_and_assign",
        "target_assign", "roi_pool", "psroi_pool",
        "retinanet_detection_output"}
    names = sorted(jo)
    fetch = [jo[n].name for n in names]
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(ts, scope=tscope)
    from paddle_tpu_torch.convert import load_jax_scope
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    for n, w, g in zip(names, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=n, **F32)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


def test_static_nn_multi_box_head_is_fluid_layers():
    assert T.static.nn.multi_box_head is T.fluid.layers.multi_box_head
    assert "multi_box_head" in T.static.nn.__all__


@pytest.mark.parametrize("name", [
    "anchor_generator", "bipartite_match", "box_clip", "box_coder",
    "detection_output", "multiclass_nms", "prior_box", "roi_align",
    "sigmoid_focal_loss", "yolo_box", "yolov3_loss"])
def test_functional_reexports_the_detection_layers(name):
    assert getattr(T.nn.functional, name) is getattr(T.fluid.layers, name)
    assert getattr(J.nn.functional, name) is getattr(J.fluid.layers, name)


# -- nn.functional's detection tail, eagerly ----------------------------------------

def _to_ref(a):
    if isinstance(a, list):
        return [_to_ref(v) for v in a]
    return J.to_tensor(a) if isinstance(a, np.ndarray) else a


def _to_port(a):
    if isinstance(a, list):
        return [_to_port(v) for v in a]
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


_PIX = _f32(_boxes(2, 4, seed=1, scale=16))
FUNCTIONAL = {
    "roi_pool": ((_f(2, 3, 6, 6), _f32(_ROIS)), {"output_size": 2}, (0,)),
    "prroi_pool": ((_f(2, 3, 6, 6), _f32(_ROIS)),
                   {"pooled_height": 2, "pooled_width": 3}, (0,)),
    "psroi_pool": ((_f(2, 8, 6, 6), _f32(_ROIS)),
                   {"output_channels": 2, "pooled_height": 2,
                    "pooled_width": 2}, (0,)),
    "polygon_box_transform": ((_f(1, 8, 3, 4),), {}, (0,)),
    "generate_proposals": (tuple(_f32(a) for a in (
        CASES["generate_proposals"][1]["Scores"][0],
        CASES["generate_proposals"][1]["BboxDeltas"][0],
        CASES["generate_proposals"][1]["ImInfo"][0],
        CASES["generate_proposals"][1]["Anchors"][0],
        CASES["generate_proposals"][1]["Variances"][0])),
        {"pre_nms_top_n": 12, "post_nms_top_n": 6, "min_size": 2.0,
         "return_rois_num": True}, ()),
    "distribute_fpn_proposals": ((_f32(
        CASES["distribute_fpn_proposals"][1]["FpnRois"][0]), 2, 5, 4, 224),
        {}, ()),
    "collect_fpn_proposals": (([_f32(_boxes(3, scale=20)),
                                _f32(_boxes(2, seed=1, scale=20))],
                               [_f(3, 1), _f(2, 1, seed=1)], 2, 3, 4), {},
                              ()),
    "density_prior_box": ((np.zeros((1, 2, 3, 3), np.float32),
                           np.zeros((1, 3, 24, 24), np.float32)),
                          {"densities": [2, 1], "fixed_sizes": [8.0, 12.0],
                           "fixed_ratios": [1.0, 2.0], "clip": True}, ()),
    "box_decoder_and_assign": ((
        _f32(_anchors(4, seed=1)), np.array([0.1, 0.1, 0.2, 0.2], np.float32),
        _f(4, 12, seed=2, scale=0.5), _f32(np.abs(_f(4, 3, seed=3))), 4.135),
        {}, (0, 2)),
    "retinanet_detection_output": (tuple(
        [_f32(a) for a in CASES["retinanet_detection_output"][1][s]]
        for s in ("BBoxes", "Scores", "Anchors")) + (_f32(
            CASES["retinanet_detection_output"][1]["ImInfo"][0]),),
        {"nms_top_k": 5, "keep_top_k": 6}, ()),
    "target_assign": ((_f(2, 3, 4), np.array(
        [[0, -1, 2, 1, -1], [-1, 1, -1, -1, 0]], np.int32)), {}, (0,)),
    "generate_proposal_labels": (tuple(_f32(CASES[
        "generate_proposal_labels"][1][s][0]) for s in (
            "RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo")),
        {"batch_size_per_im": 6, "fg_fraction": 0.5, "fg_thresh": 0.5,
         "bg_thresh_lo": 0.1, "class_nums": 3}, ()),
    "generate_mask_labels": ((
        np.array([[20., 20., 2.]], np.float32),
        np.array([[1, 2]], np.int32), np.array([[0, 0]], np.int32),
        _f32(_segms()), np.array([[[2., 2., 12., 10.], [16., 4., 26., 18.],
                                   [0., 0., 4., 4.]]], np.float32),
        np.array([[1, 2, 0]], np.int32), 3, 4), {}, ()),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_detection_tail_matches_the_reference(name):
    args, kwargs, grad = FUNCTIONAL[name]
    with Jdy.guard():
        jargs = [_to_ref(a) for a in args]
        for i in grad:
            jargs[i].stop_gradient = False
        jouts = _flat(getattr(J.nn.functional, name)(*jargs, **kwargs))
        want = [np.asarray(o.numpy()) for o in jouts]
        floats = [k for k, w in enumerate(want)
                  if np.issubdtype(w.dtype, np.floating)]
        cts = [np.random.RandomState(7 + k).randn(*want[k].shape).astype(
            want[k].dtype) for k in floats]
        if grad:
            J.add_n([J.sum(J.multiply(jouts[k], J.to_tensor(c)))
                     for k, c in zip(floats, cts)]).backward()
            jgrads = [np.asarray(jargs[i].grad.numpy()) for i in grad]
    targs = [_to_port(a) for a in args]
    for i in grad:
        targs[i].requires_grad_(True)
    touts = _flat(getattr(T.nn.functional, name)(*targs, **kwargs))
    assert len(touts) == len(want)
    for k, (t, w) in enumerate(zip(touts, want)):
        g = t.detach().numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=f"out {k}", **F32)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"out {k}")
    if grad:
        sum((touts[k] * torch.from_numpy(c)).sum()
            for k, c in zip(floats, cts)).backward()
        for i, w in zip(grad, jgrads):
            np.testing.assert_allclose(targs[i].grad.numpy(), w,
                                       err_msg=f"grad {i}", **F32)


@pytest.mark.parametrize("name,args", [
    ("rpn_target_assign", (None, None, _ANCH, None, _GT_PIX,
                           np.zeros((2, 3), np.int32),
                           np.array([[16., 16., 1.]] * 2))),
    ("retinanet_target_assign", (None, None, _ANCH, None, _GT_PIX,
                                 np.array([[3, 1, 0], [2, 0, 0]], np.int32),
                                 np.zeros((2, 3), np.int32),
                                 np.array([[16., 16., 1.]] * 2)))])
def test_target_assign_functionals_raise_in_both(name, args):
    """Paddle's signatures return the sampled anchors' index lists; the
    dense rules give per-anchor targets and masks: both read a slot that
    is not there (ROADMAP queue 3)."""
    args = [_f32(a) if isinstance(a, np.ndarray) else a for a in args]
    with Jdy.guard():
        with pytest.raises(KeyError):
            getattr(J.nn.functional, name)(*[_to_ref(a) for a in args])
    with pytest.raises(KeyError):
        getattr(T.nn.functional, name)(*[_to_port(a) for a in args])
