"""MobileNet-SSD (tests/torch_ssd_program.py) in both packages on the CPU.

- The builder gives the reference's Program JSON in the port, for the
  train and the decode programs of the cut configuration.
- The full width's 1917 priors, from the map sizes alone and from the
  prior_box rule on meta tensors at those maps.
- The cut train program through both Executors, from the reference's
  startup values: 3 steps, each from the reference's state (so the
  steps' differences do not compound): the loss within SSD_LOSS_RTOL,
  the parameters' updates within SSD_UPDATE, the optimizer's moments
  within SSD_MOMENT, the other state within SSD_STATE; the host reads of
  the port's step are 0.
- detection_output on the same head outputs in both Executors: labels,
  source rows and counts exactly, scores and boxes within F32; then the
  cut decode program after the steps, with its counts.

Tolerances.  The cut's last two maps are 1x1 (the full width's last
one is), where three batch norms see 16 values a channel and divide by
their spread, multiplying the float32 rounding that comes in; a
batch-norm scale's gradient is a sum of cancelling terms (measured on
this CPU: up to 19 % apart where its norm is 6e-5, against 0.6 % for a
convolution's).  RMSProp's first step is near lr * 4.5 in size for
every gradient above 1e-3, so an element whose gradient is within
rounding of 0 may step either way (5 of 313625 elements on the first
step here).  So the updates and moments are held as one vector each.
Measured over the 3 steps: loss 5.4e-7, updates 8.3e-3, moments
7.8e-3, other state 1.2e-5.  SSD_LOSS_RTOL (1e-5): the loss of one step
from the same state.  SSD_UPDATE and SSD_MOMENT (5e-2): relative L2 of
all the trainable parameters' updates, and of all RMSProp's mean
squares and steps.  SSD_STATE (1e-4): each batch norm's running
statistics and the learning rate, relative L2.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.ops import registry as TREG

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ssd_program as S  # noqa: E402

SSD_LOSS_RTOL = 1e-5
SSD_UPDATE = 5e-2
SSD_MOMENT = 5e-2
SSD_STATE = 1e-4
F32 = dict(rtol=2e-5, atol=2e-6)
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    """The reference's Executor keeps compiled steps in a cache that
    every pytest worker shares; these runs stay out of it."""
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _state(scope):
    return {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}


def _port_state(scope):
    return {n: scope.get(n).numpy() for n in scope.local_var_names()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-6 * max(want.size, 1) ** 0.5
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), floor)


class Pair:
    """A reference-built program in both Executors, from the values of
    its startup program run by the port's (the reference's scope set to
    them: its Executor would compile the startup program first)."""

    def __init__(self, jmain, jstart):
        self.jmain = jmain
        self.jexe, self.jscope = JF.Executor(), JF.Scope()
        self.tmain = TF.Program.from_dict(jmain.to_dict())
        self.texe, self.tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
        self.texe.run(TF.Program.from_dict(jstart.to_dict()),
                      scope=self.tscope)
        for n, v in _port_state(self.tscope).items():
            self.jscope.set(n, jnp.asarray(v))

    def step(self, feed, fetch, program=None):
        """One run of `program` (the main one by default) in each, the
        port's from the reference's state: (reference outputs, port
        outputs)."""
        load_jax_scope(self.tscope, _state(self.jscope))
        jprog = program or self.jmain
        tprog = self.tmain if program is None \
            else TF.Program.from_dict(program.to_dict())
        want = self.jexe.run(jprog, feed=feed, fetch_list=fetch,
                             scope=self.jscope)
        got = self.texe.run(tprog, feed=feed, fetch_list=fetch,
                            scope=self.tscope)
        return [np.asarray(w) for w in want], [np.asarray(g) for g in got]


def check_steps(pair, feed, fetch, what):
    """STEPS steps, each from the reference's state: the loss (fetch[0]);
    the trainable parameters' updates and RMSProp's moments, each set
    as one vector; every other float state var.  Returns the losses and
    the reference's fetches of the last step."""
    trainable = {p.name for p in pair.jmain.all_parameters() if p.trainable}
    losses = []
    for i in range(STEPS):
        before = _state(pair.jscope)
        want, got = pair.step(feed, fetch)
        losses.append((float(want[0]), float(got[0])))
        np.testing.assert_allclose(got[0], want[0], rtol=SSD_LOSS_RTOL,
                                   err_msg=f"{what} step {i}")
        ref, port = _state(pair.jscope), _port_state(pair.tscope)
        upd, mom = ([], []), ([], [])
        for n, w in ref.items():
            if not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(port[n], w, err_msg=n)
            elif n in trainable:
                upd[0].append((port[n] - before[n]).ravel())
                upd[1].append((w - before[n]).ravel())
            elif n.endswith(("_mean_square_0", "_momentum_0")):
                mom[0].append(port[n].ravel())
                mom[1].append(w.ravel())
            else:
                assert _rel(port[n], w) <= SSD_STATE, (what, i, n)
        err = _rel(np.concatenate(upd[0]), np.concatenate(upd[1]))
        assert err <= SSD_UPDATE, (what, i, "updates", err)
        err = _rel(np.concatenate(mom[0]), np.concatenate(mom[1]))
        assert err <= SSD_MOMENT, (what, i, "moments", err)
    assert np.isfinite(losses).all(), losses
    return losses, want


@pytest.fixture(scope="module")
def small():
    return S.build(JF, S.SMALL), S.build(JF, S.SMALL, train=False)


def test_port_builds_the_reference_programs(small):
    (jm, js, _), (jd, jds, _) = small
    tm, ts, _ = S.build(TF, S.SMALL)
    td, tds, _ = S.build(TF, S.SMALL, train=False)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    assert _json(td) == _json(jd) and _json(tds) == _json(jds)
    types = {op.type for op in tm.global_block().ops}
    assert {"prior_box", "iou_similarity", "bipartite_match", "target_assign",
            "mine_hard_examples", "box_coder", "depthwise_conv2d",
            "rmsprop"} <= types
    assert "multiclass_nms3" in {op.type for op in td.global_block().ops}


def test_full_width_has_1917_priors():
    """From the map sizes (19, 10, 5, 3, 2, 1 at 300^2) and from the
    prior_box rule on meta tensors at those maps with the head's
    attrs."""
    assert S.num_priors(S.FULL) == 1917
    total = 0
    for i, side in enumerate((19, 10, 5, 3, 2, 1)):
        maxes = S.FULL["max_sizes"][i]
        op = TF.framework.Operator(
            TF.Program().global_block(), 0, "prior_box", {}, {}, {
                "min_sizes": [S.FULL["min_sizes"][i]],
                "max_sizes": [maxes] if maxes else [],
                "aspect_ratios": S.ASPECT_RATIOS[i], "flip": True,
                "offset": 0.5})
        out = TREG.forward_rule("prior_box")(
            TREG.LowerCtx(device="meta"), op,
            {"Input": [torch.empty(1, 8, side, side, device="meta")],
             "Image": [torch.empty(1, 3, 300, 300, device="meta")]})
        total += out["Boxes"][0].shape[:3].numel()
    assert total == 1917


@pytest.fixture(scope="module")
def stepped(small):
    """The cut train program's STEPS steps in both Executors
    (check_steps), with the heads' outputs and priors fetched."""
    (jm, js, jo), _ = small
    pair = Pair(jm, js)
    feed = S.batch(S.SMALL)
    reads = profiler.get_int_stats().get("control_flow_host_reads", 0)
    losses, heads = check_steps(
        pair, feed, [jo[k].name for k in ("loss", "locs", "confs", "box",
                                          "var")], "ssd")
    reads = profiler.get_int_stats().get("control_flow_host_reads",
                                         0) - reads
    return pair, losses, heads[1:], reads


def test_cut_program_trains_alike_in_both_executors(stepped):
    """(The steps are held in the fixture.)  The loss falls in both, and
    the port's steps read nothing on the host."""
    _, losses, _, reads = stepped
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]
    assert reads == 0


def test_detection_output_in_both_executors(stepped):
    """The SSD head's decode on the same inputs: the reference's and the
    port's Executors give the same labels, counts and rows."""
    cfg = S.SMALL
    heads = stepped[2]
    jmain, jstart, out, num = S.head_program(JF, cfg)
    tmain, _, _, _ = S.head_program(TF, cfg)
    assert _json(tmain) == _json(jmain)
    hfeed = dict(zip(("loc", "conf", "box", "var"), heads))
    want = JF.Executor().run(jmain, feed=hfeed,
                             fetch_list=[out.name, num.name],
                             scope=JF.Scope())
    got = TF.Executor(TF.CPUPlace()).run(
        tmain, feed=hfeed, fetch_list=[out.name, num.name],
        scope=TF.Scope())
    w, g = np.asarray(want[0]), np.asarray(got[0])
    assert g.shape == w.shape == (cfg["batch"], cfg["keep_top_k"], 6)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(g[..., 0], w[..., 0])
    np.testing.assert_allclose(g[..., 1:], w[..., 1:], **F32)
    counts = np.asarray(got[1])
    rows = np.arange(cfg["keep_top_k"])[None, :] < counts[:, None]
    assert (g[..., 0][rows] >= 1).all() and (g[..., 0][~rows] == -1).all()


def test_cut_decode_program_after_training(small, stepped):
    """The decode program on the trained cut scope in both Executors:
    the counts of detections and each image's labels (as sets: rows of
    near-equal scores may trade places) and scores."""
    _, (jd, _, do) = small
    pair = stepped[0]
    want, got = pair.step({"image": S.batch(S.SMALL)["image"]},
                          [do["nmsed"].name, do["count"].name], program=jd)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[1], want[1])
    for w, g, n in zip(want[0], got[0], got[1]):
        assert sorted(g[:n, 0]) == sorted(w[:n, 0])
        np.testing.assert_allclose(np.sort(g[:n, 1]), np.sort(w[:n, 1]),
                                   rtol=1e-3)
