"""The op rules of the optimizer, random and misc buckets (and the
collective bucket's c_allreduce_sum) against the reference's, in the
two-registry harness of test_torch_fluid_ops.py: the same numpy inputs
through each package's rule, forward outputs (and, for the misc bucket's
differentiable rules, the port's generic autograd gradient against
`jax.vjp` of the reference's rule) in float32 and float64.  Then what the
harness cannot hold: the drawing rules by their statistics and by their
outputs' shapes and dtypes beside the reference's (their bits are
torch's), py_func by what it calls (the io rules in
test_torch_fluid_misc.py), and dgc's warm-up and ties.
recompute_segment_grad runs in the programs of
test_torch_fluid_optimizer.py (`PROGRAM_RULES`).

Tolerances: the harness's F32 (rtol 2e-5, atol 2e-6) and F64 (rtol
1e-11, atol 1e-12), one op whose only difference is the order of its
sums; integer and boolean outputs exactly.  A statistic of n draws lies
within 5 of its standard errors (a false alarm about once in 10^6 a
check); a chi-square of k cells below its 1 - 1e-6 quantile.
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_fluid_ops import (JFW, JREG, _check, _f, _ids, _names,
                                  _port, _probs)

PROGRAM_RULES = {"recompute_segment_grad"}


def _pos(*shape, seed=0):
    return np.abs(_f(*shape, seed=seed)) + 0.1


def _lr(v=0.1):
    return np.array([v])


def _opt(op, extra, attrs=None, p=None, g=None):
    """An update rule's case: Param, Grad and LearningRate, plus
    `extra` slots."""
    ins = {"Param": [_f(3, 4) if p is None else p],
           "Grad": [_f(3, 4, seed=1) if g is None else g],
           "LearningRate": [_lr()]}
    ins.update({k: [v] for k, v in extra.items()})
    return (op, ins, attrs or {}, [])


def _pows(b1=0.9 ** 3, b2=0.999 ** 3):
    return {"Beta1Pow": np.array([b1]), "Beta2Pow": np.array([b2])}


_ADAM = dict(Moment1=_f(3, 4, seed=2) * 0.1, Moment2=_pos(3, 4, seed=3),
             **_pows())
_STAT = np.arange(11, dtype=np.float64) % 3

# name -> (op type, {slot: [numpy]}, attrs, output slots that get
# cotangents (empty: forward only))
CASES = {
    # -- optimizer bucket ------------------------------------------------------
    "adamw": _opt("adamw", _ADAM, {"coeff": 0.05, "lr_ratio": 0.5,
                                   "beta1": 0.8, "epsilon": 1e-6}),
    "adamw_no_decay": _opt("adamw", _ADAM, {"with_decay": False}),
    "adagrad": _opt("adagrad", {"Moment": _pos(3, 4, seed=2)},
                    {"epsilon": 1e-5}),
    "rmsprop": _opt("rmsprop", {"MeanSquare": _pos(3, 4, seed=2),
                                "Moment": _f(3, 4, seed=3)},
                    {"decay": 0.9, "momentum": 0.5}),
    "rmsprop_centered": _opt("rmsprop", {
        "MeanSquare": _pos(3, 4, seed=2) + 2, "Moment": _f(3, 4, seed=3),
        "MeanGrad": _f(3, 4, seed=4) * 0.1},
        {"decay": 0.9, "centered": True, "epsilon": 1e-4}),
    "adadelta": ("adadelta", {"Param": [_f(3, 4)], "Grad": [_f(3, 4, seed=1)],
                              "AvgSquaredGrad": [_pos(3, 4, seed=2)],
                              "AvgSquaredUpdate": [_pos(3, 4, seed=3)]},
                 {"rho": 0.9, "epsilon": 1e-5}, []),
    "adamax": _opt("adamax", {"Moment": _f(3, 4, seed=2),
                              "InfNorm": _pos(3, 4, seed=3),
                              "Beta1Pow": np.array([0.9 ** 2])},
                   {"beta2": 0.99}),
    "lamb": _opt("lamb", _ADAM, {"weight_decay": 0.02}),
    "lamb_zero_param": _opt("lamb", _ADAM, p=np.zeros((3, 4))),
    "lars_momentum": _opt("lars_momentum", {"Velocity": _f(3, 4, seed=2)},
                          {"mu": 0.9, "lars_coeff": 0.01,
                           "lars_weight_decay": 0.001, "epsilon": 1e-7}),
    "lars_momentum_zero_grad": _opt(
        "lars_momentum", {"Velocity": _f(3, 4, seed=2)}, {},
        g=np.zeros((3, 4))),
    "dpsgd_sigma0": _opt("dpsgd", {}, {"clip": 1.5, "batch_size": 4.0,
                                       "sigma": 0.0}),
    "check_finite_and_unscale": ("check_finite_and_unscale", {
        "X": [_f(3, 4) * 1e3, _f(5, seed=1)], "Scale": [np.array([64.0])]},
        {}, []),
    "check_finite_and_unscale_inf": ("check_finite_and_unscale", {
        "X": [_f(3, 4), np.array([1.0, np.inf, 2.0])],
        "Scale": [np.array([8.0])]}, {}, []),
    "update_loss_scaling_good": ("update_loss_scaling", {
        "X": [_f(3, 4)], "FoundInfinite": [np.array([False])],
        "PrevLossScaling": [np.array([1024.0])],
        "InGoodSteps": [np.array([2], np.int32)],
        "InBadSteps": [np.array([1], np.int32)]},
        {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2}, []),
    "update_loss_scaling_bad": ("update_loss_scaling", {
        "X": [_f(3, 4)], "FoundInfinite": [np.array([True])],
        "PrevLossScaling": [np.array([1.5])],
        "InGoodSteps": [np.array([5], np.int32)],
        "InBadSteps": [np.array([1], np.int32)]},
        {"decr_every_n_nan_or_inf": 2, "decr_ratio": 0.5}, []),
    "dgc": ("dgc", {"U": [_f(4, 5, seed=2)], "V": [_f(4, 5, seed=3)],
                    "Grad": [_f(4, 5, seed=1)]},
            {"m": 0.8, "ratio": 0.75}, []),
    "dgc_warmup": ("dgc", {"U": [_f(4, 5, seed=2)], "V": [_f(4, 5, seed=3)],
                           "Grad": [_f(4, 5, seed=1)],
                           "CurrentStep": [np.array([3.0])]},
                   {"m": 0.9, "ratio_list": [0.5, 0.75, 0.9],
                    "rampup_step": 6}, []),
    "decayed_adagrad": _opt("decayed_adagrad", {"Moment": _pos(3, 4, seed=2)},
                            {"decay": 0.9}),
    "proximal_gd": _opt("proximal_gd", {}, {"l1": 0.5, "l2": 0.1}),
    "proximal_adagrad": _opt("proximal_adagrad",
                             {"Moment": _pos(3, 4, seed=2)},
                             {"l1": 0.05, "l2": 0.1}),
    "ftrl": _opt("ftrl", {"SquaredAccumulator": _pos(3, 4, seed=2),
                          "LinearAccumulator": _f(3, 4, seed=3)},
                 {"l1": 0.1, "l2": 0.2}),
    "ftrl_lr_power": _opt("ftrl", {"SquaredAccumulator": _pos(3, 4, seed=2),
                                   "LinearAccumulator": _f(3, 4, seed=3)},
                          {"l1": 0.1, "l2": 0.2, "lr_power": -0.3}),
    # -- random bucket's deterministic rule --------------------------------------
    "shuffle_channel": ("shuffle_channel", {"X": [_f(2, 6, 3, 2)]},
                        {"group": 3}, ["Out"]),
    # -- misc bucket ------------------------------------------------------
    "auc": ("auc", {"Predict": [_probs(9, 2)],
                    "Label": [_ids((9, 1), 2, seed=1)],
                    "StatPos": [_STAT], "StatNeg": [_STAT[::-1].copy()]},
            {"num_thresholds": 10}, []),
    "add_position_encoding": ("add_position_encoding", {"X": [_f(2, 5, 6)]},
                              {"alpha": 0.7, "beta": 1.5}, ["Out"]),
    "allclose": ("allclose", {"Input": [_f(3, 4)],
                              "Other": [_f(3, 4) + 1e-6],
                              "Rtol": [np.array([1e-5])],
                              "Atol": [np.array([1e-8])]}, {}, []),
    "allclose_far_nan": ("allclose", {
        "Input": [np.array([1.0, np.nan])], "Other": [np.array([1.1, np.nan])]},
        {"rtol": 0.2, "atol": 0.0, "equal_nan": True}, []),
    "conv_shift": ("conv_shift", {"X": [_f(2, 7)], "Y": [_f(2, 3, seed=1)]},
                   {}, ["Out"]),
    "cvm": ("cvm", {"X": [_pos(4, 5)], "CVM": [_pos(4, 2, seed=1)]},
            {"use_cvm": True}, ["Y"]),
    "cvm_off": ("cvm", {"X": [_pos(4, 5)], "CVM": [_pos(4, 2, seed=1)]},
                {"use_cvm": False}, ["Y"]),
    "diag": ("diag", {"Diagonal": [_f(4)]}, {}, ["Out"]),
    "diag_embed": ("diag_embed", {"Input": [_f(2, 3)]},
                   {"offset": 1, "dim1": 0, "dim2": 2}, ["Out"]),
    "diag_embed_neg": ("diag_embed", {"Input": [_f(2, 3, 4)]},
                       {"offset": -2, "dim1": -1, "dim2": 1}, ["Out"]),
    "empty": ("empty", {}, {"shape": [2, 3], "dtype": "float32"}, []),
    "fc": ("fc", {"Input": [_f(2, 3, 4)], "W": [_f(12, 5, seed=1)],
                  "Bias": [_f(5, seed=2)]},
           {"in_num_col_dims": 1, "activation_type": "relu"}, ["Out"]),
    "fc_col2": ("fc", {"Input": [_f(2, 3, 4)], "W": [_f(4, 5, seed=1)]},
                {"in_num_col_dims": 2}, ["Out"]),
    "fill": ("fill", {}, {"shape": [2, 2], "dtype": "int64",
                          "value": [1, -2, 3, 7]}, []),
    "fill_zeros_like2": ("fill_zeros_like2", {"X": [_f(2, 3)]},
                         {"dtype": "float32"}, []),
    "grad_add": ("grad_add", {"X": [_f(2, 3)], "Y": [_f(2, 3, seed=1)]}, {},
                 ["Out"]),
    "is_empty": ("is_empty", {"X": [np.zeros((0, 3))]}, {}, []),
    "is_empty_not": ("is_empty", {"X": [_f(2, 3)]}, {}, []),
    "l1_norm": ("l1_norm", {"X": [_f(3, 4)]}, {}, ["Out"]),
    "mean_iou": ("mean_iou", {"Predictions": [_ids((3, 4), 5)],
                              "Labels": [_ids((3, 4), 5, seed=1)]},
                 {"num_classes": 6}, []),
    "mean_iou_running": ("mean_iou", {
        "Predictions": [_ids((8,), 3)], "Labels": [_ids((8,), 3, seed=1)],
        "InWrongs": [np.array([1, 0, 2], np.int32)],
        "InCorrects": [np.array([0, 3, 1], np.int32)],
        "InMeanIou": [np.array([0.25])]}, {"num_classes": 3}, []),
    "minus": ("minus", {"X": [_f(2, 3)], "Y": [_f(2, 3, seed=1)]}, {},
              ["Out"]),
    "modified_huber_loss": ("modified_huber_loss", {
        "X": [_f(8, 1) * 2], "Y": [_ids((8, 1), 2, seed=1).astype(float)]},
        {}, ["Out"]),
    "seed_fixed": ("seed", {}, {"seed": 1234}, []),
    "shard_index": ("shard_index", {"X": [np.array([[0], [6], [7], [13],
                                                    [19]], np.int64)]},
                    {"index_num": 20, "nshards": 3, "shard_id": 1,
                     "ignore_value": -1}, []),
    "squared_l2_distance": ("squared_l2_distance", {
        "X": [_f(3, 2, 2)], "Y": [_f(1, 4, seed=1)]}, {}, ["Out"]),
    "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss", {
        "X": [_f(6, 1) * 3],
        "Label": [np.array([[-2.0], [-0.5], [0.3], [1.7], [0.0], [1.0]])]},
        {}, ["Y"]),
    "partial_concat": ("partial_concat", {"X": [_f(2, 5), _f(2, 5, seed=1)]},
                       {"start_index": -3, "length": 2}, ["Out"]),
    "partial_sum": ("partial_sum", {"X": [_f(2, 5), _f(2, 5, seed=1),
                                          _f(2, 5, seed=2)]},
                    {"start_index": 1, "length": -1}, ["Out"]),
    "fsp": ("fsp", {"X": [_f(2, 3, 4, 4)], "Y": [_f(2, 5, 4, 4, seed=1)]}, {},
            ["Out"]),
    "average_accumulates": ("average_accumulates", {
        "param": [_f(3, 4)], "in_sum_1": [_f(3, 4, seed=1)],
        "in_sum_2": [_f(3, 4, seed=2)], "in_sum_3": [_f(3, 4, seed=3)],
        "in_num_accumulates": [np.array([2], np.int64)],
        "in_old_num_accumulates": [np.array([4], np.int64)],
        "in_num_updates": [np.array([9], np.int64)]},
        {"average_window": 0.5, "min_average_window": 3,
         "max_average_window": 10}, []),
    "average_accumulates_batch": ("average_accumulates", {
        "param": [_f(3, 4)], "in_sum_1": [_f(3, 4, seed=1)],
        "in_sum_2": [_f(3, 4, seed=2)], "in_sum_3": [_f(3, 4, seed=3)],
        "in_num_accumulates": [np.array([0], np.int64)],
        "in_old_num_accumulates": [np.array([4], np.int64)],
        "in_num_updates": [np.array([16383], np.int64)]},
        {"average_window": 0.15}, []),
    # -- collective bucket: one process ----------------------------------------
    "c_allreduce_sum": ("c_allreduce_sum", {"X": [_f(3, 4)]},
                        {"ring_id": 0}, []),
}
# the other rules of the collective bucket with an X and an Out: with no
# group each is the identity, as the reference's is outside a mesh
# (test_torch_collective.py holds them over four ranks)
CASES.update({t: (t, {"X": [_pos(3, 4) if t == "c_allreduce_prod"
                            else _f(3, 4)]}, {"ring_id": 0}, [])
              for t in ("c_allreduce_max", "c_allreduce_min",
                        "c_allreduce_prod", "mp_allreduce_sum",
                        "c_reduce_sum", "c_broadcast", "c_allgather",
                        "c_reducescatter", "c_concat", "c_split",
                        "c_identity", "alltoall", "barrier",
                        "c_sync_calc_stream", "c_sync_comm_stream")})

# rules the reference computes in float32 whatever its input (auc's and
# mean_iou's counts) or only defines for integers, and those whose
# inputs carry a dtype of their own
FLOAT64_OK = set(CASES) - {"empty", "fill", "seed_fixed", "shard_index",
                           "is_empty", "is_empty_not"}

# drawn by the op's generator: held below by statistics
RANDOM = {"uniform_random_batch_size_like", "truncated_gaussian_random",
          "randint", "randperm", "bernoulli", "multinomial", "sampling_id",
          "seed", "random_crop", "gaussian_random_batch_size_like"}
# held by what they call, read and write: py_func below, the io rules in
# test_torch_fluid_misc.py
HELD_BELOW = {"py_func", "save", "save_combine", "load", "load_combine"}
# the collective rules with no X -> Out form, held in
# test_torch_collective.py (in one process and over four ranks)
HELD_BELOW |= {"c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
               "c_wait_calc_stream", "c_wait_comm_stream", "send_v2",
               "recv_v2"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_matches_the_reference_float32(name):
    _check(name, "float32", CASES)


@pytest.mark.parametrize("name", sorted(FLOAT64_OK))
def test_rule_matches_the_reference_float64(name):
    _check(name, "float64", CASES)


@pytest.mark.parametrize("name", ["check_finite_and_unscale_inf",
                                  "update_loss_scaling_bad"])
def test_amp_rules_give_every_output(name):
    """The harness compares each slot's first tensor: every Out, and the
    found flag's (1,) bool, match the reference's."""
    op_type, ins, attrs, _ = CASES[name]
    out_slots = {"check_finite_and_unscale": ["Out", "FoundInfinite"],
                 "update_loss_scaling": ["Out", "LossScaling",
                                         "OutGoodSteps", "OutBadSteps"]}
    want, got = _both(op_type, ins, attrs, out_slots[op_type])
    for slot, ws in want.items():
        assert len(got[slot]) == len(ws)
        for w, g in zip(ws, got[slot]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=0, err_msg=slot)
    if op_type == "check_finite_and_unscale":
        assert got["FoundInfinite"][0].dtype == torch.bool
        assert got["FoundInfinite"][0].shape == (1,)


def _both(op_type, ins, attrs, outputs, seed=0):
    """Every output of the reference's rule and the port's (float
    inputs as float32); the port's generator seeded by `seed`."""
    from test_torch_fluid_ops import TFW, TREG, _cast
    import jax.numpy as jnp

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
        TREG.LowerCtx(seed, device="cpu"), top,
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()})
    return want, got


def test_dgc_keeps_every_tie_at_its_threshold():
    """|v| = 1 for six of eight elements: keeping the top 2 by value
    keeps all six tied ones, in both packages."""
    v = np.array([[1.0, -1.0, 0.5, 1.0], [-1.0, 1.0, 0.25, 1.0]])
    ins = {"U": [np.zeros((2, 4))], "V": [v], "Grad": [np.zeros((2, 4))]}
    want, got = _both("dgc", ins, {"m": 0.9, "ratio": 0.75},
                      ["U_out", "V_out", "EncodeGrad"])
    enc = got["EncodeGrad"][0].numpy()
    np.testing.assert_array_equal(enc, np.asarray(want["EncodeGrad"][0]))
    assert np.count_nonzero(enc) == 6


@pytest.mark.parametrize("step,ratio", [(0.0, 0.5), (2.0, 0.75),
                                        (4.0, 0.9), (50.0, 0.9)])
def test_dgc_warmup_picks_its_ratio_by_the_step(step, ratio):
    """ratio_list [0.5, 0.75, 0.9] over rampup_step 6: two steps a
    ratio, the last one after; k = round(20 (1 - ratio)) kept."""
    v = _f(4, 5, seed=3)
    ins = {"U": [np.zeros((4, 5))], "V": [v], "Grad": [np.zeros((4, 5))],
           "CurrentStep": [np.array([step])]}
    want, got = _both("dgc", ins, {"m": 0.9, "ratio_list": [0.5, 0.75, 0.9],
                                   "rampup_step": 6}, ["EncodeGrad"])
    enc = got["EncodeGrad"][0].numpy()
    np.testing.assert_array_equal(enc, np.asarray(want["EncodeGrad"][0]))
    assert np.count_nonzero(enc) == max(1, round(20 * (1 - ratio)))


def test_update_loss_scaling_grows_and_keeps_its_floor():
    """incr_every_n_steps good steps double the scale and restart the
    count; a shrink never takes the scale below 1."""
    base = {"X": [_f(2, 2)], "InBadSteps": [np.array([0], np.int32)]}
    for prev, good, found, want_scale, want_good in (
            (8.0, 2, False, 16.0, 0), (1.5, 0, True, 1.0, 0)):
        ins = dict(base, FoundInfinite=[np.array([found])],
                   PrevLossScaling=[np.array([prev])],
                   InGoodSteps=[np.array([good], np.int32)],
                   InBadSteps=[np.array([1], np.int32)])
        want, got = _both("update_loss_scaling", ins,
                          {"incr_every_n_steps": 3,
                           "decr_every_n_nan_or_inf": 2},
                          ["Out", "LossScaling", "OutGoodSteps",
                           "OutBadSteps"])
        assert float(got["LossScaling"][0]) == want_scale == \
            float(np.asarray(want["LossScaling"][0])[0])
        assert int(got["OutGoodSteps"][0]) == want_good


@pytest.mark.parametrize("op_type,attrs", [
    ("c_allreduce_sum", {}),
    ("scale", {"scale": 0.5, "divide_by_axis_size": "data"})])
def test_a_collective_keeps_its_bits_under_a_group_of_one(op_type, attrs):
    """In one process c_allreduce_sum is the identity and the scale's
    divide_by_axis_size divides by 1 (the reference's rules outside a
    mesh); under a live gloo group of one the all-reduce runs on its one
    rank and the scale divides by the group's size, 1: the bits stay
    (test_torch_collective.py holds four ranks)."""
    import paddle_tpu_torch.distributed as dist
    from test_torch_fluid_ops import TFW, TREG

    x = torch.from_numpy(_f(3, 4))
    op = TFW.Operator(TFW.Program().global_block(), 0, op_type,
                      {"X": ["X_0"]}, {"Out": ["Out_0"]}, dict(attrs))

    def run():
        return TREG.forward_rule(op_type)(
            TREG.LowerCtx(0, device="cpu"), op, {"X": [x]})["Out"][0]

    want = x * attrs.get("scale", 1.0)
    torch.testing.assert_close(run(), want, rtol=0, atol=0)
    env = dist.init_parallel_env(backend="gloo", device="cpu", rank=0,
                                 world_size=1)
    try:
        assert (env.rank, env.world_size) == (0, 1)
        torch.testing.assert_close(run(), want, rtol=0, atol=0)
    finally:
        dist.destroy_parallel_env()


# -- the drawing rules -----------------------------------------------------------

def _draw(op_type, ins, attrs, outputs, seed=0):
    """The port's outputs and the reference's, same shapes asked."""
    want, got = _both(op_type, ins, attrs, outputs, seed=seed)
    for slot in outputs:
        w, g = np.asarray(want[slot][0]), got[slot][0]
        assert tuple(g.shape) == w.shape, slot
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == torch.float32, slot
    return {s: v[0].numpy() for s, v in got.items()}


def _mean_within(x, mean, std):
    n = x.size
    assert abs(x.mean() - mean) < 5 * std / n ** 0.5, (x.mean(), mean)
    assert abs(x.std() - std) < 5 * std / (2 * n) ** 0.5, (x.std(), std)


def _chi2_ok(counts, probs):
    """Pearson's statistic of `counts` against `probs` below the 1 -
    1e-6 quantile of its chi-square (Wilson-Hilferty)."""
    n = counts.sum()
    exp = n * probs
    stat = float(((counts - exp) ** 2 / exp).sum())
    k = len(counts) - 1
    z = 4.753  # the normal's 1 - 1e-6 quantile
    limit = k * (1 - 2 / (9 * k) + z * (2 / (9 * k)) ** 0.5) ** 3
    assert stat < limit, (stat, limit)


def test_uniform_random_batch_size_like_takes_its_batch_and_range():
    got = _draw("uniform_random_batch_size_like", {"Input": [_f(300, 2)]},
                {"shape": [-1, 700], "min": -2.0, "max": 4.0,
                 "input_dim_idx": 0, "output_dim_idx": 0}, ["Out"])["Out"]
    assert got.shape == (300, 700)
    assert got.min() >= -2.0 and got.max() <= 4.0
    _mean_within(got.astype(np.float64), 1.0, 6.0 / 12 ** 0.5)


def test_gaussian_random_batch_size_like_moments():
    got = _draw("gaussian_random_batch_size_like", {"Input": [_f(3, 400)]},
                {"shape": [600, -1], "mean": 0.5, "std": 2.0,
                 "input_dim_idx": 1, "output_dim_idx": 1}, ["Out"])["Out"]
    assert got.shape == (600, 400)
    _mean_within(got.astype(np.float64), 0.5, 2.0)


def test_truncated_gaussian_random_moments_and_bounds():
    """N(0, 1) truncated to [-2, 2] (the reference's bounds), then std
    3 and mean -1: every value within 2 std of the mean, the truncated
    moments (std 0.87962566...)."""
    from math import erf, exp, pi, sqrt

    got = _draw("truncated_gaussian_random", {},
                {"shape": [500, 400], "mean": -1.0, "std": 3.0,
                 "dtype": "float32"}, ["Out"])["Out"].astype(np.float64)
    assert got.min() >= -7.0 and got.max() <= 5.0
    phi2 = exp(-2.0) / sqrt(2 * pi)
    mass = erf(2 / sqrt(2))
    std = 3.0 * sqrt(1 - 4 * phi2 / mass)
    _mean_within(got, -1.0, std)


def test_randint_stays_in_its_range_uniformly():
    got = _draw("randint", {}, {"shape": [200000], "low": -3, "high": 5,
                                "dtype": "int64"}, ["Out"])["Out"]
    assert got.dtype == np.int64 and got.min() >= -3 and got.max() <= 4
    _chi2_ok(np.bincount(got + 3, minlength=8), np.full(8, 1 / 8))


def test_randperm_is_a_permutation_and_moves_with_the_seed():
    a = _draw("randperm", {}, {"n": 1000}, ["Out"], seed=1)["Out"]
    b = _draw("randperm", {}, {"n": 1000}, ["Out"], seed=2)["Out"]
    assert sorted(a.tolist()) == list(range(1000)) == sorted(b.tolist())
    assert not np.array_equal(a, b)


def test_bernoulli_means_follow_x():
    p = np.array([0.05, 0.3, 0.5, 0.9])
    x = np.tile(p, (50000, 1))
    got = _draw("bernoulli", {"X": [x]}, {}, ["Out"])["Out"]
    assert set(np.unique(got).tolist()) <= {0.0, 1.0}
    n = x.shape[0]
    for j, pj in enumerate(p):
        assert abs(got[:, j].mean() - pj) < 5 * (pj * (1 - pj) / n) ** 0.5


@pytest.mark.parametrize("replacement", [True, False])
def test_multinomial_frequencies(replacement):
    """With replacement: every draw's category by a chi-square against
    the row's weights (which need not sum to 1).  Without: k distinct
    ids a row, the first draw's category by the same test."""
    w = np.array([1.0, 2.0, 3.0, 4.0, 0.5])
    rows = 40000
    x = np.tile(w, (rows, 1))
    k = 3
    got = _draw("multinomial", {"X": [x]},
                {"num_samples": k, "replacement": replacement},
                ["Out"])["Out"]
    assert got.shape == (rows, k) and got.dtype == np.int64
    if replacement:
        _chi2_ok(np.bincount(got.reshape(-1), minlength=5), w / w.sum())
    else:
        assert all(len(set(r)) == k for r in got[:200].tolist())
        _chi2_ok(np.bincount(got[:, 0], minlength=5), w / w.sum())


def test_sampling_id_draws_each_row_by_its_probabilities():
    p = np.array([0.1, 0.6, 0.3])
    got = _draw("sampling_id", {"X": [np.tile(p, (60000, 1))]}, {},
                ["Out"])["Out"]
    assert got.dtype == np.int64
    _chi2_ok(np.bincount(got, minlength=3), p)


def test_seed_zero_draws_an_int32_in_its_range():
    outs = [_draw("seed", {}, {"seed": 0}, ["Out"], seed=s)["Out"]
            for s in (1, 2)]
    for o in outs:
        assert o.shape == (1,) and o.dtype == np.int32
        assert 1 <= int(o[0]) < 2 ** 31 - 1
    assert outs[0][0] != outs[1][0]


def test_random_crop_cuts_a_window_and_passes_its_seed():
    x = np.arange(2 * 6 * 7, dtype=np.float64).reshape(2, 6, 7)
    got = _draw("random_crop", {"X": [x], "Seed": [np.array([5])]},
                {"shape": [3, 4]}, ["Out", "SeedOut"])
    out = got["Out"]
    r0, c0 = int(out[0, 0, 0]) // 7, int(out[0, 0, 0]) % 7
    np.testing.assert_array_equal(out, x[:, r0:r0 + 3, c0:c0 + 4])
    assert got["SeedOut"].tolist() == [5]


# -- py_func and the io rules ------------------------------------------------------

def test_py_func_calls_its_function_on_host_copies(tmp_path):
    """The rule hands the function numpy copies and gives back tensors
    of the declared shapes and dtypes; the reference's pure_callback
    contract."""
    from paddle_tpu_torch.fluid import framework as TFW
    from paddle_tpu_torch.ops import misc_ops, registry

    seen = []

    def fn(a, b):
        seen.append((type(a), a.dtype, b.shape))
        return [a * 2 + b.sum(), np.arange(3)]

    fid = misc_ops.register_py_func(fn)
    prog = TFW.Program()
    blk = prog.global_block()
    blk.create_var(name="o0", shape=[2, 2], dtype="float32")
    blk.create_var(name="o1", shape=[3], dtype="int64")
    op = TFW.Operator(blk, 0, "py_func", {"X": ["a", "b"]},
                      {"Out": ["o0", "o1"]}, {"forward_callable_id": fid})
    a = torch.ones(2, 2)
    b = torch.arange(4.0)
    ctx = registry.LowerCtx(0, device="cpu")
    outs = registry.forward_rule("py_func")(ctx, op, {"X": [a, b]})["Out"]
    assert seen == [(np.ndarray, np.float32, (4,))]
    np.testing.assert_array_equal(outs[0].numpy(), np.full((2, 2), 8.0))
    assert outs[0].dtype == torch.float32 and outs[1].dtype == torch.int64
    assert outs[1].tolist() == [0, 1, 2] and ctx.host_reads == 2


def test_every_new_rule_is_held():
    """Each rule this file is for has a case, a statistical test or a
    test of its host effects."""
    from paddle_tpu_torch.ops import (collective_ops, misc_ops,
                                      optimizer_ops, random_ops, registry)

    mods = {m.__name__ for m in (collective_ops, misc_ops, optimizer_ops,
                                 random_ops)}
    mine = {n for n in registry.registered_ops()
            if registry.forward_rule(n).__module__ in mods}
    held = {c[0] for c in CASES.values()} | RANDOM | HELD_BELOW
    # the three buckets' rules ported before (test_torch_fluid_ops.py and
    # test_torch_fluid_ops_nn.py hold them)
    before = {"sgd", "momentum", "adam", "gaussian_random", "uniform_random",
              "bilinear_tensor_product"}
    assert mine - before == held


def test_dpsgd_noise_has_its_scale():
    """With a zero gradient and parameter at lr 1 the update is -noise /
    batch_size, noise ~ N(0, (sigma clip)^2): its moments."""
    n = 200000
    got = _draw("dpsgd", {"Param": [np.zeros(n)], "Grad": [np.zeros(n)],
                          "LearningRate": [np.array([1.0])]},
                {"clip": 1.5, "batch_size": 4.0, "sigma": 2.0},
                ["ParamOut"])["ParamOut"].astype(np.float64)
    _mean_within(got, 0.0, 2.0 * 1.5 / 4.0)
