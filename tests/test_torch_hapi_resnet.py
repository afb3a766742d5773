"""hapi.Model on a cut resnet18 (10 classes, 3 x 32 x 32 images, B=4)
in the port against paddle_tpu on the CPU: `fit` (Momentum over a
PiecewiseDecay with coupled L2, shuffle, an eval set, EarlyStopping,
ModelCheckpoint and LRScheduler), `evaluate` and `predict`, under the
static-mode adapter (8 images: 2 steps) and the dygraph adapter (4
images: 1 step; paddle_tpu's eager resnet18 takes ~9 s a step here), at
O0 and O1.  The runner is tests/test_torch_hapi.py's.

Tolerances.  At 32 x 32 layer4 works on 1 x 1 maps, so its batch norm
normalises 4 values a channel and float32 results move with the
summation order (tests/test_torch_resnet.py); a ReLU kink flip moves a
gradient term whole.  The first loss (the same weights): TOL32 (1e-4).
The second: within MOVE (5 %) of its distance from the first (measured
2.2 %; paddle_tpu's own two adapters differ by 3.1 % of it).  The
parameters after the fit: within SPREAD (atol 1e-2): the port ends up to
7.7e-3 from paddle_tpu's static-mode run in a weight
(layer2.0.conv2.weight), and paddle_tpu's own two adapters end up to
7.7e-3 from each other there too.  evaluate's loss and predict's logits
(eval mode: running statistics that two steps barely moved, so logits
of ~100): within MOVE of the largest logit (measured 3.7 %; paddle_tpu's
two adapters differ by 3.6 %).

At O1 the port is held to paddle_tpu's float32 run: the first loss within
BF16_FIRST (10 %) of it, everything finite.  A bf16 forward of the same
weights moves the first loss by 0.5 % over 8 images (static-mode) and
by 4.0 % over 4 (dygraph: batch norm over 4 values a channel in layer4
magnifies bf16's rounding of the convolutions).  paddle_tpu's
own O1 is not a reference here: its batch_norm lowering takes the batch
variance as E[x^2] - E[x]^2 in the input's dtype, which in bfloat16 is
off by 3.3 % in the first loss and goes negative in a running variance,
so its evaluate returns NaN (ROADMAP queue 3 item 9); the port's batch
norm accumulates in float32.  Nor can the float32 fit hold the O1
update at this size, so each adapter's O1 steps are held to a plain
bf16 step written out in tests/torch_plain_steps.py
(test_o1_steps_match_a_plain_bf16_step).
"""

import numpy as np
import pytest
import torch

from test_torch_hapi import run_fit
from torch_plain_steps import resnet18_o1_steps

from paddle_tpu.vision import models as JM

from paddle_tpu_torch.vision import models as TM

TOL32 = dict(rtol=1e-4, atol=1e-4)
SPREAD = dict(atol=1e-2, rtol=0)
MOVE = 5e-2
BF16_FIRST = 0.1
PLAIN_O1 = 1e-5
SHAPE = (3, 32, 32)
IMAGES = {"static": 8, "dygraph": 4}


@pytest.fixture(autouse=True)
def _leave_global_rngs():
    """Leave numpy's and torch's global generators as each test found
    them: other files' tests in this process draw from them."""
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _resnet18(side):
    return JM.resnet18(num_classes=10) if side == "j" else \
        TM.resnet18(num_classes=10, device="cpu")


def _momentum(P, net):
    return P.optimizer.Momentum(
        P.optimizer.lr.PiecewiseDecay([1], [0.01, 0.005]), 0.9,
        parameters=net.parameters(), weight_decay=1e-4)


@pytest.fixture(scope="module", params=["static", "dygraph"])
def runs(request, tmp_path_factory):
    """{(side, amp): run} for one adapter: paddle_tpu at O0, the port at
    O0 and O1, from the same weights."""
    adapter = request.param
    tmp = tmp_path_factory.mktemp(f"resnet18_{adapter}")
    n = IMAGES[adapter]
    j = run_fit("j", _resnet18, _momentum, adapter, None, SHAPE, n, 4,
                tmp / "j0")
    out = {("j", None): j}
    for amp in (None, "O1"):
        out[("t", amp)] = run_fit("t", _resnet18, _momentum, adapter, amp,
                                  SHAPE, n, 4, tmp / f"t{amp}", j["state"])
    return adapter, out


def test_f32_fit_matches(runs):
    adapter, r = runs
    j, t = r[("j", None)], r[("t", None)]
    want, got = np.array(j["losses"]), np.array(t["losses"])
    assert len(got) == len(want) == IMAGES[adapter] // 4
    limit = TOL32["atol"] + TOL32["rtol"] * np.abs(want) \
        + MOVE * np.abs(want - want[0])
    assert (np.abs(got - want) <= limit).all(), (got, want)
    for k, w in j["after"].items():
        np.testing.assert_allclose(t["after"][k], w, **SPREAD, err_msg=k)
    assert t["lr"] == j["lr"] and len(t["hist"]) == len(j["hist"]) == 1


def test_f32_evaluate_and_predict_match(runs):
    _, r = runs
    j, t = r[("j", None)], r[("t", None)]
    scale = np.abs(j["pred"]).max()
    assert np.abs(t["pred"] - j["pred"]).max() <= MOVE * scale
    np.testing.assert_allclose(t["ev"]["loss"], j["ev"]["loss"], rtol=MOVE)
    assert set(t["ev"]) == set(j["ev"]) == {"acc_top1", "acc_top2", "loss"}
    for k in ("acc_top1", "acc_top2"):
        assert 0.0 <= t["ev"][k] <= 1.0


def test_o1_fit_is_finite_and_near_f32(runs):
    _, r = runs
    j, t = r[("j", None)], r[("t", "O1")]
    assert np.isfinite(t["losses"]).all()
    np.testing.assert_allclose(t["losses"][0], j["losses"][0],
                               rtol=BF16_FIRST)
    assert np.isfinite(t["pred"]).all() and np.isfinite(t["ev"]["loss"])
    assert all(np.isfinite(v).all() for v in t["after"].values())
    moved = [k for k, v in t["after"].items()
             if not np.array_equal(v, t["state"][k])]
    assert len(moved) == len(t["after"])  # parameters and statistics


@pytest.mark.parametrize("adapter", ["static", "dygraph"])
def test_o1_steps_match_a_plain_bf16_step(adapter):
    """Two Model.train_batch calls at O1 against plain_o1 from the same
    weights and batches: each parameter's and running statistic's change
    within PLAIN_O1 (1e-5) in relative L2, the losses within rtol 1e-6.
    Measured: 0 and equal, both adapters (the same operations in the
    same order); the limits leave room for float32 reassociation only.

    The float32 fit cannot hold an O1 update at this size: each tensor's
    change over the port's O1 fit (`runs`) is 0.85-1.30 in relative L2
    from its change over the port's float32 fit in the worst batch norm
    bias (dygraph / static-mode; 0.32 / 0.61 over all tensors), where a
    batch norm update left out reads 1.0.  Here two controls, made by
    editing the port, fail: the gradients left scaled (the unscale
    removed from the adapter and from GradScaler) read a median 4.6e5 /
    6.0e5 and the second loss is off by 5e5; batch norm's parameters
    left out of the update read 1.0 in each of them."""
    got, want, losses, want_losses, errs = resnet18_o1_steps(
        adapter, "cpu", SHAPE)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    bad = {k: e for k, e in errs.items() if e > PLAIN_O1}
    assert not bad, bad
