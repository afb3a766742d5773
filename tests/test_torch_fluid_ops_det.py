"""The op rules of the detection and quantize buckets against the
reference's, in the two-registry harness of test_torch_fluid_ops.py: the
same numpy inputs through each package's rule, forward outputs and, for
the differentiable rules, the port's generic autograd gradient against
`jax.vjp` of the reference's rule, in float32 and float64.  Then what
the harness cannot hold: every output slot of the multi-output rules
(the harness compares each slot's first tensor of the slots the
reference gives an op that declares none), the rankings on inputs with
ties (`lax.top_k` and the stable `jnp.argsort` put the lower index
first), the subsampling rules by what their draws cannot change, the
quantizers on values that sit exactly on .5 steps (both round half to
even), the straight-through gradient of each quant rule, and the
reference's raises.

Tolerances: the harness's F32 (rtol 2e-5, atol 2e-6) and F64 (rtol
1e-11, atol 1e-12), one op whose only difference is the order of its
sums; labels, counts, indices and masks exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_fluid_ops as H
from test_torch_fluid_ops import JFW, JREG, TFW, _cast, _names, _port
from torch_det_cases import (CASES, _NMS, _QSTATE, _QX,
                             _anchors, _boxes, _f, _rng)

from paddle_tpu_torch.ops import detection_ops as TD
from paddle_tpu_torch.ops import registry as TREG


def _jitted(op_type, ins, attrs, outputs=()):
    """The reference's rule of `op_type` under one jax.jit (the
    reference's Executor compiles its rules the same way; one compile is
    far quicker than eager dispatch op by op): f(list of the input
    arrays in slot order) -> {slot: [arrays]}."""
    op = JFW.Operator(JFW.Program().global_block(), 0, op_type,
                      _names({s: len(v) for s, v in ins.items()}),
                      {s: [f"{s}_0"] for s in outputs}, dict(attrs))
    fn = JREG._FORWARD[op_type]
    slots = [(s, len(v)) for s, v in ins.items()]

    def f(vals):
        it = iter(vals)
        return fn(JREG.LowerCtx(jax.random.PRNGKey(0)), op,
                  {s: [next(it) for _ in range(n)] for s, n in slots})

    return jax.jit(f)


def _reference(op_type, ins, attrs, ct_slots, cts):
    """test_torch_fluid_ops._reference with the rule and its vjp jitted."""
    f = _jitted(op_type, ins, attrs)
    flat = [jnp.asarray(a) for v in ins.values() for a in v]
    outs = f(flat)
    paths = [(s, i) for s, v in ins.items() for i, a in enumerate(v)
             if np.issubdtype(np.asarray(a).dtype, np.floating)]
    pos = {p: k for k, p in enumerate((s, i) for s, v in ins.items()
                                      for i in range(len(v)))}
    grads = {}
    if callable(cts):
        cts = cts({s: [np.asarray(a) for a in v] for s, v in outs.items()})
    if ct_slots and paths:
        @jax.jit
        def vjp(dvals, ct):
            def g(dv):
                merged = list(flat)
                for p, d in zip(paths, dv):
                    merged[pos[p]] = d
                o = f(merged)
                return [o[s][0] for s in ct_slots]
            return jax.vjp(g, dvals)[1](ct)[0]

        dvals = vjp([flat[pos[p]] for p in paths],
                    [jnp.asarray(c) for c in cts])
        grads = {p: np.asarray(d) for p, d in zip(paths, dvals)}
    return ({s: [np.asarray(a) for a in v] for s, v in outs.items()},
            grads)


def _check(name, dtype):
    """test_torch_fluid_ops._check over this file's CASES, the
    reference jitted: outputs and input gradients under the seeded
    cotangents, float outputs in their dtype, the rest exactly."""
    op_type, ins, attrs, ct_slots = CASES[name]
    ins = {s: _cast(v, dtype) for s, v in ins.items()}
    tol = H.F64 if dtype == "float64" else H.F32
    drawn = []

    def draw(outs):
        rng = _rng(7)
        drawn.extend(np.asarray(rng.randn(*outs[s][0].shape),
                                dtype=outs[s][0].dtype) for s in ct_slots)
        return drawn

    with jax.enable_x64(dtype == "float64"):
        want, want_grads = _reference(op_type, ins, attrs, ct_slots, draw)
    got, got_grads = _port(op_type, ins, attrs, list(want), ct_slots, drawn)
    for slot, vals in want.items():
        w, g = vals[0], got[slot][0]
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, err_msg=slot, **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=slot)
    assert set(got_grads) == set(want_grads)
    for path, w in want_grads.items():
        np.testing.assert_allclose(got_grads[path], w, err_msg=str(path),
                                   **tol)


def _both(op_type, ins, attrs, outputs, seed=0):
    """Every output of the reference's rule (jitted) and the port's, the
    op declaring `outputs`; float inputs as float32, the port's
    generator seeded by `seed`."""
    ins = {s: _cast(v, "float32") for s, v in ins.items()}
    want = _jitted(op_type, ins, attrs, outputs)(
        [jnp.asarray(a) for v in ins.values() for a in v])
    top = TFW.Operator(TFW.Program().global_block(), 0, op_type,
                       _names({s: len(v) for s, v in ins.items()}),
                       {s: [f"{s}_0"] for s in outputs}, dict(attrs))
    got = TREG.forward_rule(op_type)(
        TREG.LowerCtx(seed, device="cpu"), top,
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()})
    return want, got


# rules the reference computes in float32 whatever its input (yolov3_loss
# casts its input; the locality-aware merge carries its scores in float32,
# and jax's scan refuses a float64 sum there)
FLOAT64_OK = set(CASES) - {"locality_aware_nms", "locality_aware_nms_quads",
                           "yolov3_loss", "yolov3_loss_no_smooth"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_matches_the_reference_float32(name):
    _check(name, "float32")


@pytest.mark.parametrize("name", sorted(FLOAT64_OK))
def test_rule_matches_the_reference_float64(name):
    _check(name, "float64")


def test_every_new_rule_is_held():
    """Each rule of the two buckets has a case above, every op type of
    the reference's two modules is registered in the port (44), and
    nothing else of the port is in those modules."""
    from paddle_tpu.ops import detection_ops as JD
    from paddle_tpu.ops import quantize_ops as JQ
    from paddle_tpu_torch.ops import quantize_ops as TQ

    ref = {n for n in JREG.registered_ops()
           if JREG._FORWARD[n].__module__ in (JD.__name__, JQ.__name__)}
    mine = {n for n in TREG.registered_ops()
            if TREG.forward_rule(n).__module__ in (TD.__name__,
                                                   TQ.__name__)}
    assert len(ref) == 44 and mine == ref
    assert {c[0] for c in CASES.values()} == ref


# -- every output slot -------------------------------------------------------------

_ALL_SLOTS = {
    "multiclass_nms": ["Out", "Index", "NmsRoisNum"],
    "multiclass_nms2": ["Out", "Index", "NmsRoisNum"],
    "multiclass_nms3_pixels": ["Out", "Index", "NmsRoisNum"],
    "matrix_nms": ["Out", "Index", "RoisNum"],
    "matrix_nms_gaussian": ["Out", "Index", "RoisNum"],
    "locality_aware_nms": ["Out", "RoisNum"],
    "locality_aware_nms_quads": ["Out", "RoisNum"],
    "generate_proposals": ["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
    "generate_proposals_v2": ["RpnRois", "RpnRoiProbs", "RoisNum"],
    "retinanet_detection_output": ["Out", "RoisNum"],
    "generate_proposal_labels": ["Rois", "LabelsInt32", "BboxTargets",
                                 "BboxInsideWeights", "RoisNum"],
    "distribute_fpn_proposals": ["MultiFpnRois", "MultiLevelRoIsNum",
                                 "RestoreIndex"],
    "collect_fpn_proposals": ["FpnRois", "RoisNum"],
    "fake_quantize_range_abs_max": ["Out", "OutScale", "OutScales"],
    "moving_average_abs_max_scale": ["Out", "OutScale", "OutState",
                                     "OutAccum"],
}


def _equal_slots(want, got, tol=None):
    for slot, ws in want.items():
        assert len(got[slot]) == len(ws), slot
        for w, g in zip(ws, got[slot]):
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)


@pytest.mark.parametrize("name", sorted(_ALL_SLOTS))
def test_multi_output_rules_give_every_output(name):
    """With every output slot declared, every tensor of every slot (the
    NMS rules' counts and source indices, the FPN levels' lists)."""
    op_type, ins, attrs, _ = CASES[name]
    want, got = _both(op_type, ins, attrs, _ALL_SLOTS[name])
    assert set(got) == set(want)
    _equal_slots(want, got)


# -- ties ------------------------------------------------------------------------

def test_top_k_and_rank_break_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf]])
    v, i = TD._top_k(x, 6)
    assert i.tolist() == [[1, 2, 4, 0, 3, 5]]
    assert TD._rank(x).tolist() == [[2, 3, 4, 0, 5, 1]]


_TIES = {
    # equal losses: the lower prior index is the harder negative
    "mine_hard_examples": ("mine_hard_examples", {
        "ClsLoss": [np.array([[0.5, 0.5, 0.5, 0.2, 0.5, 0.5, 0.5, 0.5]])],
        "MatchIndices": [np.array([[-1, 0, -1, -1, -1, -1, 1, -1]],
                                  np.int32)],
        "MatchDist": [np.zeros((1, 8))]},
        {"neg_pos_ratio": 1.5}, ["NegIndices", "UpdatedMatchIndices"]),
    # every score equal and every box the same: the first box of each
    # class stands, the classes in order
    "multiclass_nms3": ("multiclass_nms3", {
        "BBoxes": [np.tile([[0.1, 0.1, 0.4, 0.5]], (1, 5, 1))],
        "Scores": [np.full((1, 3, 5), 0.5)]},
        dict(_NMS, keep_top_k=4, nms_top_k=5),
        ["Out", "Index", "NmsRoisNum"]),
    # equal scores, boxes apart: all kept, in index order
    "multiclass_nms3_apart": ("multiclass_nms3", {
        "BBoxes": [_boxes(1, 5, seed=3) * np.array([1, 1, 0.3, 0.3])],
        "Scores": [np.full((1, 2, 5), 0.25)]},
        dict(_NMS, keep_top_k=6, nms_top_k=5),
        ["Out", "Index", "NmsRoisNum"]),
    "matrix_nms": ("matrix_nms", {
        "BBoxes": [np.tile([[0.1, 0.1, 0.4, 0.5]], (1, 4, 1))],
        "Scores": [np.full((1, 2, 4), 0.5)]},
        dict(_NMS, keep_top_k=3), ["Out", "Index", "RoisNum"]),
    # every candidate scores alike
    "retinanet_detection_output": ("retinanet_detection_output", {
        "BBoxes": [np.zeros((1, 4, 4))], "Scores": [np.full((1, 4, 2), 0.5)],
        "Anchors": [_anchors(4, seed=2)],
        "ImInfo": [np.array([[16., 16., 1.]])]},
        {"nms_top_k": 6, "keep_top_k": 5, "nms_threshold": 0.3},
        ["Out", "RoisNum"]),
    # equal scores over the anchors, then equal IoUs of two anchors
    "generate_proposals": ("generate_proposals_v2", {
        "Scores": [np.zeros((1, 2, 2, 2))],
        "BboxDeltas": [np.zeros((1, 8, 2, 2))],
        "ImShape": [np.array([[40., 40.]])],
        "Anchors": [np.tile(_anchors(2, seed=4, scale=30), (2, 2, 1, 1))],
        "Variances": [np.ones((2, 2, 2, 4))]},
        {"pre_nms_topN": 6, "post_nms_topN": 4, "nms_thresh": 0.7},
        ["RpnRois", "RpnRoiProbs", "RoisNum"]),
    # two anchors equally good for a gt: the first takes it
    "rpn_target_assign": ("rpn_target_assign", {
        "Anchor": [np.array([[0., 0., 4., 4.], [0., 0., 4., 4.],
                             [10., 10., 14., 14.]])],
        "GtBoxes": [np.array([[[0., 0., 4., 4.]]])]},
        {"rpn_batch_size_per_im": 16, "rpn_positive_overlap": 1.5},
        ["ScoreTarget", "LocationTarget", "LocationWeight",
         "ScoreWeight"]),
    "bipartite_match": ("bipartite_match", {
        "DistMat": [np.array([[[0.5, 0.5, 0.2], [0.5, 0.5, 0.5]]])]},
        {"match_type": "per_prediction", "dist_threshold": 0.4},
        ["ColToRowMatchIndices", "ColToRowMatchDist"]),
    "collect_fpn_proposals": ("collect_fpn_proposals", {
        "MultiLevelRois": [_boxes(3), _boxes(2, seed=1)],
        "MultiLevelScores": [np.full((3, 1), 0.5), np.full((2, 1), 0.5)]},
        {"post_nms_topN": 3}, ["FpnRois", "RoisNum"]),
}


@pytest.mark.parametrize("name", sorted(_TIES))
def test_rules_rank_ties_as_the_reference(name):
    op_type, ins, attrs, slots = _TIES[name]
    want, got = _both(op_type, ins, attrs, slots)
    _equal_slots(want, got)


def test_generate_proposal_labels_ties_pack_as_the_reference():
    """Candidates of equal overlap: the packing of the sampled rows is
    by the draws, so the rows are held as a set, and the counts and the
    labels' multiset exactly."""
    rois = np.array([[[1., 1., 4., 4.], [1., 1., 4., 4.], [9., 9., 12., 12.],
                      [9., 9., 12., 12.]]])
    ins = {"RpnRois": [rois], "GtClasses": [np.array([[2]], np.int32)],
           "IsCrowd": [np.zeros((1, 1), np.int32)],
           "GtBoxes": [np.array([[[1., 1., 4., 4.]]])],
           "ImInfo": [np.array([[20., 20., 1.]])]}
    attrs = {"batch_size_per_im": 8, "fg_fraction": 0.5, "bg_thresh_lo": 0.0,
             "class_nums": 3}
    want, got = _both("generate_proposal_labels", ins, attrs,
                      ["Rois", "LabelsInt32", "RoisNum"])
    assert got["RoisNum"][0].tolist() == np.asarray(
        want["RoisNum"][0]).tolist()
    w_rows = {tuple(r) + (int(l),) for r, l in zip(
        np.asarray(want["Rois"][0])[0], np.asarray(want["LabelsInt32"][0])[0])}
    g_rows = {tuple(r) + (int(l),) for r, l in zip(
        got["Rois"][0].numpy()[0], got["LabelsInt32"][0].numpy()[0])}
    assert g_rows == w_rows


# -- the subsampling rules: what the draws cannot change ---------------------------

def test_rpn_target_assign_subsamples_to_its_sizes():
    """40 positives for 8 slots and 50 negatives for the other 8: the
    draws pick which, the counts and the masks' consistency are the
    rule's; the same seed draws the same."""
    anchors = np.concatenate([np.tile([[0., 0., 10., 10.]], (40, 1)),
                              np.tile([[50., 50., 60., 60.]], (50, 1))])
    ins = {"Anchor": [anchors], "GtBoxes": [np.array([[[0., 0., 10., 10.]]])]}
    attrs = {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.5}
    slots = ["ScoreTarget", "LocationTarget", "LocationWeight", "ScoreWeight"]
    want, got = _both("rpn_target_assign", ins, attrs, slots)
    again = _both("rpn_target_assign", ins, attrs, slots)[1]
    other = _both("rpn_target_assign", ins, attrs, slots, seed=3)[1]
    st = got["ScoreTarget"][0].numpy()[0, :, 0]
    ws = np.asarray(want["ScoreTarget"][0])[0, :, 0]
    for s in (st, ws):
        assert (s[:40] == 1).sum() == 8 and (s[:40] == 0).sum() == 0
        assert (s[40:] == 0).sum() == 8 and (s[40:] == 1).sum() == 0
    np.testing.assert_array_equal(got["LocationWeight"][0].numpy()[0, :, 0],
                                  st == 1)
    np.testing.assert_array_equal(got["ScoreWeight"][0].numpy()[0, :, 0],
                                  st >= 0)
    np.testing.assert_array_equal(again["ScoreTarget"][0].numpy()[0, :, 0],
                                  st)
    assert not np.array_equal(other["ScoreTarget"][0].numpy()[0, :, 0], st)


def test_generate_proposal_labels_subsamples_to_its_sizes():
    """Many foreground and background candidates for a few slots: the
    foreground rows first (their label, targets and inside weights),
    then the background (label 0), the counts as the reference's."""
    rng = _rng(0)
    near = np.array([1., 1., 9., 9.]) + rng.rand(12, 4) * 0.3
    far = np.array([20., 20., 26., 26.]) + rng.rand(12, 4)
    rois = np.concatenate([near, far])[None]
    ins = {"RpnRois": [rois], "GtClasses": [np.array([[2]], np.int32)],
           "IsCrowd": [np.zeros((1, 1), np.int32)],
           "GtBoxes": [np.array([[[1., 1., 9., 9.]]])],
           "ImInfo": [np.array([[40., 40., 1.]])]}
    attrs = {"batch_size_per_im": 8, "fg_fraction": 0.25, "class_nums": 3}
    slots = ["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "RoisNum"]
    want, got = _both("generate_proposal_labels", ins, attrs, slots)
    assert got["RoisNum"][0].tolist() == [8] == np.asarray(
        want["RoisNum"][0]).tolist()
    for lab in (got["LabelsInt32"][0].numpy()[0],
                np.asarray(want["LabelsInt32"][0])[0]):
        assert lab.tolist() == [2, 2, 0, 0, 0, 0, 0, 0]
    inside = got["BboxInsideWeights"][0].numpy()[0].reshape(8, 3, 4)
    assert (inside[:2, 2] == 1).all() and inside.sum() == 8
    assert (got["Rois"][0].numpy()[0, 2:, 0] >= 20).all()


# -- quantizers: .5 steps, the straight-through gradient -------------------------

_HALF = np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, -2.5, 3.5, 127.0]])


@pytest.mark.parametrize("op_type", [
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max"])
def test_quantizers_round_half_to_even(op_type):
    """max|x| = 127 makes bin_cnt / s exactly 1: the values on .5 steps
    round to even in both packages."""
    x = np.concatenate([_HALF, _HALF[::-1]])
    attrs = {"quant_axis": 1} if "channel" in op_type else {}
    want, got = _both(op_type, {"X": [x.T if "channel" in op_type
                                      else x]}, attrs, ["Out", "OutScale"])
    _equal_slots(want, got)
    if op_type == "fake_quantize_abs_max":
        assert got["Out"][0].numpy()[0].tolist() == [0, 2, 2, -0.0]


@pytest.mark.parametrize("op_type", [
    "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max"])
def test_quant_dequant_passes_the_cotangent_straight_through(op_type):
    """d Out / d X is the identity (the straight-through estimator), the
    observer inputs get none; the quantize-only forms give zero."""
    ins = {"X": [_QX]}
    if "moving" in op_type:
        ins.update(_QSTATE)
    ct = _f(3, 4, seed=9)
    outs, grads = _port(op_type, ins, {}, ["Out"], ["Out"], [ct])
    np.testing.assert_array_equal(grads[("X", 0)], ct)
    for (slot, _), g in grads.items():
        if slot != "X":
            assert not g.any(), slot
    _, zero = _port("fake_quantize_abs_max", {"X": [_QX]}, {}, ["Out"],
                    ["Out"], [ct])
    assert not zero[("X", 0)].any()


def test_moving_average_observer_state_is_new_tensors():
    """The observer's outputs are new tensors; its inputs keep their
    values."""
    state = {k: [torch.tensor(v[0])] for k, v in _QSTATE.items()}
    before = {k: v[0].clone() for k, v in state.items()}
    rule = TREG.forward_rule("fake_quantize_dequantize_moving_average_abs_max")
    from paddle_tpu_torch.tensor import _EagerOp
    outs = rule(TREG.LowerCtx(device="cpu"),
                _EagerOp("fake_quantize_dequantize_moving_average_abs_max",
                         {}, ["Out"]),
                dict(state, X=[torch.from_numpy(_QX)]))
    for k, v in state.items():
        assert torch.equal(v[0], before[k]), k
    assert outs["OutAccum"][0] is not state["InAccum"][0]
    np.testing.assert_allclose(outs["OutState"][0].numpy(), [0.9 * 1.5 + 1])


# -- the reference's raises --------------------------------------------------------

@pytest.mark.parametrize("op_type,ins,attrs,outputs,exc,match", [
    ("mine_hard_examples", {"ClsLoss": [np.zeros((1, 3))],
                            "MatchIndices": [np.zeros((1, 3), np.int32)],
                            "MatchDist": [np.zeros((1, 3))]},
     {"mining_type": "hard_example"}, ["NegIndices"], NotImplementedError,
     "only max_negative"),
    ("box_coder", {"PriorBox": [_boxes(3)], "TargetBox": [_boxes(3)]},
     {"code_type": "decode_center_size"}, ["OutputBox"], ValueError,
     "rank-3 TargetBox"),
    ("collect_fpn_proposals", {"MultiLevelRois": [_boxes(3)],
                               "MultiLevelScores": [np.zeros((2, 1))]},
     {}, ["FpnRois"], ValueError, "disagree"),
    ("locality_aware_nms", {"BBoxes": [_boxes(1, 3)],
                            "Scores": [np.ones((1, 1, 3))]},
     {}, ["Out", "Index"], NotImplementedError, "Index output"),
])
def test_rules_raise_where_the_reference_raises(op_type, ins, attrs, outputs,
                                                exc, match):
    with pytest.raises(exc, match=match):
        _jitted(op_type, ins, attrs, outputs)(
            [jnp.asarray(a) for v in ins.values() for a in v])
    top = TFW.Operator(TFW.Program().global_block(), 0, op_type,
                       _names({s: len(v) for s, v in ins.items()}),
                       {s: [f"{s}_0"] for s in outputs}, dict(attrs))
    with pytest.raises(exc, match=match):
        TREG.forward_rule(op_type)(
            TREG.LowerCtx(0, device="cpu"), top,
            {s: [torch.from_numpy(np.array(a)) for a in v]
             for s, v in ins.items()})


# -- the priors are built once a device ------------------------------------------------

def test_priors_are_built_once_and_kept():
    """A second run of the same prior_box op gives the same tensor object
    (no new host-to-device copy); other attrs or shapes build anew."""
    op_type, ins, attrs, _ = CASES["prior_box"]
    outs = [_both(op_type, ins, attrs, ["Boxes", "Variances"])[1]
            for _ in range(2)]
    assert outs[0]["Boxes"][0] is outs[1]["Boxes"][0]
    other = _both(op_type, ins, dict(attrs, offset=0.25),
                  ["Boxes", "Variances"])[1]
    assert other["Boxes"][0] is not outs[0]["Boxes"][0]
