"""The op rules of the sequence bucket and the control-flow bucket's
single-op rules (select_input, assert, print) against
the reference's, in the two-registry harness of test_torch_fluid_ops.py:
the same numpy inputs through each package's rule, forward outputs and
the port's generic autograd gradient against `jax.vjp` of the
reference's rule, in float32 and float64.  The sub-block and tensor-
array rules run in programs (test_torch_control_flow.py).  Then the
forms the harness cannot hold: select_output (it reads its declared
outputs), the rules' raises and an oracle for sequence_erase.

Tolerances: the harness's F32 (rtol 2e-5, atol 2e-6) and F64 (rtol
1e-11, atol 1e-12), one op whose only difference is the summation
order; integer outputs exactly.
"""

import numpy as np
import pytest

from test_torch_fluid_ops import _both_rules, _check, _f, _port, _reference

_LEN = np.array([5, 2, 0], np.int64)
_IDS = np.array([[3, 2, 5, 2, 7, 1], [2, 2, 4, 5, 0, 6],
                 [5, 1, 2, 3, 4, 2]], np.int64)

# name -> (op type, {slot: [numpy]}, attrs, output slots that get
# cotangents (empty: forward only))
CASES = {
    "sequence_mask": ("sequence_mask", {"X": [np.array([3, 1, 0, 4])]},
                      {"maxlen": 5, "out_dtype": "float32"}, []),
    "sequence_mask_2d_tensor_maxlen": (
        "sequence_mask", {"X": [np.array([[3, 1], [0, 6]])],
                          "MaxLenTensor": [np.array(6)]},
        {"maxlen": -1, "out_dtype": "int64"}, []),
    "sequence_softmax": ("sequence_softmax", {"X": [_f(3, 5)],
                                              "Length": [_LEN]}, {},
                         ["Out"]),
    "sequence_softmax_3d_full": ("sequence_softmax", {"X": [_f(3, 5, 2)]},
                                 {}, ["Out"]),
    "sequence_reverse": ("sequence_reverse", {"X": [_f(3, 5, 2)],
                                              "Length": [_LEN]}, {}, ["Y"]),
    "sequence_expand_as": ("sequence_expand_as", {
        "X": [_f(3, 4)], "Y": [_f(3, 5, 4, seed=1)], "Length": [_LEN]}, {},
        ["Out"]),
    "sequence_expand": ("sequence_expand", {
        "X": [_f(3, 1, 4)], "Y": [_f(3, 5, 4, seed=1)]}, {"ref_level": -1},
        ["Out"]),
    "sequence_pad_longer": ("sequence_pad", {
        "X": [_f(3, 5, 4)], "Length": [_LEN], "PadValue": [np.array([0.5])]},
        {"padded_length": 7}, ["Out"]),
    "sequence_pad_cut": ("sequence_pad", {
        "X": [_f(3, 5, 4)], "Length": [np.array([2, 4, 1])],
        "PadValue": [np.array([-1.0])]}, {"padded_length": 3}, ["Out"]),
    "sequence_pad_default": ("sequence_pad", {
        "X": [_f(3, 5)], "Length": [_LEN], "PadValue": [np.array([2.0])]},
        {"padded_length": -1}, ["Out"]),
    "sequence_unpad": ("sequence_unpad", {"X": [_f(3, 5, 4)],
                                          "Length": [_LEN]}, {}, ["Out"]),
    "sequence_concat": ("sequence_concat", {
        "X": [_f(3, 4, 2), _f(3, 3, 2, seed=1)],
        "Length": [np.array([4, 1, 0]), np.array([2, 3, 1])]}, {}, ["Out"]),
    "sequence_concat_full": ("sequence_concat", {
        "X": [_f(2, 2, 3), _f(2, 3, 3, seed=1)]}, {}, ["Out"]),
    "sequence_erase": ("sequence_erase", {"X": [_IDS],
                                          "Length": [np.array([6, 4, 5])]},
                       {"tokens": [2, 5]}, []),
    "sequence_slice": ("sequence_slice", {
        "X": [_f(3, 5, 2)], "Offset": [np.array([[1], [0], [2]])],
        "Length": [np.array([[2], [2], [3]])]}, {}, ["Out"]),
    "sequence_enumerate": ("sequence_enumerate", {
        "X": [_IDS[:, :5]], "Length": [_LEN]},
        {"win_size": 3, "pad_value": 0}, []),
    "sequence_enumerate_full": ("sequence_enumerate", {"X": [_IDS]},
                                {"win_size": 2, "pad_value": 9}, []),
    "im2sequence": ("im2sequence", {"X": [_f(2, 3, 5, 6)]},
                    {"kernels": [2, 3], "strides": [1, 2],
                     "paddings": [0, 1, 1, 0]}, ["Out"]),
    "sequence_reshape": ("sequence_reshape", {"X": [_f(3, 4, 6)]},
                         {"new_dim": 8}, ["Out"]),
    "sequence_scatter": ("sequence_scatter", {
        "X": [_f(3, 6)], "Ids": [np.array([[0, 2, 2, -1], [5, 7, 1, 0],
                                            [3, 3, 3, 3]])],
        "Updates": [_f(3, 4, seed=1)]}, {}, ["Out"]),
    "lod_reset": ("lod_reset", {"X": [_f(3, 4)]}, {"target_lod": [0, 1, 3]},
                  ["Out"]),
    "select_input": ("select_input", {
        "X": [_f(2, 3), _f(2, 3, seed=1), _f(2, 3, seed=2)],
        "Mask": [np.array([2], np.int32)]}, {}, ["Out"]),
    "select_input_first": ("select_input", {
        "X": [_f(2, 3), _f(2, 3, seed=1)], "Mask": [np.array([0], np.int32)]},
        {}, ["Out"]),
    "assert": ("assert", {"Cond": [np.array([True])]}, {}, []),
    "print": ("print", {"In": [_f(2, 3)]}, {"message": "x"}, ["Out"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rule_matches_the_reference(name, dtype):
    _check(name, dtype, CASES)


def test_select_output_gives_x_to_each_output():
    """select_output reads its declared outputs (the harness's one-op
    block declares none, so it is held here with them declared)."""
    x = _f(2, 3)
    want, got = _both_rules("select_output", {
        "X": [x], "Mask": [np.array([1], np.int32)]}, {}, ["Out"])
    assert len(got["Out"]) == len(want["Out"]) == 1
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))


def test_sequence_mask_needs_a_maxlen_in_both():
    """Without a static maxlen both rules raise (the reference's static
    shape contract)."""
    with pytest.raises(ValueError, match="static maxlen"):
        _reference("sequence_mask", {"X": [np.array([1, 2])]},
                   {"maxlen": -1}, [], [])
    with pytest.raises(ValueError, match="static maxlen"):
        _port("sequence_mask", {"X": [np.array([1, 2])]}, {"maxlen": -1},
              ["Y"], [], [])


def test_im2sequence_real_image_sizes_raise_in_both():
    ins = {"X": [_f(1, 2, 4, 4)], "Y": [np.array([[4, 4]])]}
    for run in (lambda: _reference("im2sequence", ins, {}, [], []),
                lambda: _port("im2sequence", ins, {}, ["Out"], [], [])):
        with pytest.raises(NotImplementedError, match="ImgRealSize"):
            run()


def test_sequence_erase_front_packs_the_survivors():
    """The harness's erase case by a numpy oracle: each row's tokens not
    in `tokens` within its length, in order, then zeros."""
    got, _ = _port("sequence_erase", {"X": [_IDS],
                                      "Length": [np.array([6, 4, 5])]},
                   {"tokens": [2, 5]}, ["Out", "OutLength"], [], [])
    want, lens = [], []
    for row, n in zip(_IDS, (6, 4, 5)):
        keep = [v for v in row[:n] if v not in (2, 5)]
        want.append(keep + [0] * (6 - len(keep)))
        lens.append(len(keep))
    np.testing.assert_array_equal(got["Out"][0], np.array(want))
    assert got["OutLength"][0].tolist() == lens == [3, 1, 3]
