"""Paddle's book programs in both Executors on the CPU.

- The four programs of tests/test_book_models.py (`BOOK_BUILDERS`:
  word2vec, the recommender, sentiment conv, SRL with a CRF) are built
  by paddle_tpu, serialised (`Program.to_dict()`), and run from the
  reference's startup values in paddle_tpu's Executor and, read back by
  `fluid.Program.from_dict`, in the port's: 5 steps each, every step's
  loss within BOOK_RTOL, each package's loss falling as the book test
  asks; SRL's `crf_decoding` path equal on the live positions after
  them.  The JAX-free mirrors of tests/torch_book_programs.py (which
  `chip_smoke.py` runs on the card) build the same JSON with the port.
- The book's SRL program, `db_lstm` of tests/torch_srl_program.py: the
  port's build gives the reference's JSON at the book's width (depth 8,
  512 wide) and at the cut (depth 2, 32 wide), where the first step's
  loss and the gradients of `crfw`, `emb` and an LSTM `Weight` agree
  within SRL_GRAD, and 3 steps of both Executors agree.
- The learning rate `exponential_decay` feeds the step after 1, 2 and k
  runs in both Executors (the `increment` counter carried across runs).
- `ParamAttr.learning_rate` is ignored by both packages' SGD (ROADMAP
  queue 3): crfw's update is the global learning rate's.

Tolerances.  BOOK_RTOL (1e-5): five independent float32 trajectories of
one program, whose losses differ by the summation order of their
reductions and products, compounded over the steps (the largest
difference measured on this CPU was 2.1e-7).  SRL_GRAD (relative L2
1e-5): one float32 backward through two LSTMs and the CRF's recursion
(measured: 3.2e-7 at most).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.ops import rnn_ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_book_programs as B  # noqa: E402
import torch_srl_program as S  # noqa: E402
from test_book_models import BOOK_BUILDERS  # noqa: E402

BOOK_RTOL = 1e-5
SRL_GRAD = 1e-5
STEPS = 5


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


class Pair:
    """A reference-built (main, startup) run in both Executors, each
    from the reference's startup values."""

    def __init__(self, jmain, jstart):
        self.jmain = jmain
        self.jexe, self.jscope = JF.Executor(), JF.Scope()
        self.jexe.run(jstart, scope=self.jscope)
        self.tmain = TF.Program.from_dict(jmain.to_dict())
        self.texe = TF.Executor(TF.CPUPlace())
        self.tscope = TF.Scope()
        self.texe.run(TF.Program.from_dict(jstart.to_dict()),
                      scope=self.tscope)
        load_jax_scope(self.tscope, {
            n: np.asarray(self.jscope.get(n))
            for n in self.jscope.local_var_names()})

    def run(self, feed, fetch, program=None):
        names = [v if isinstance(v, str) else v.name for v in fetch]
        jprog = program or self.jmain
        tprog = self.tmain if program is None \
            else TF.Program.from_dict(program.to_dict())
        want = self.jexe.run(jprog, feed=feed, fetch_list=names,
                             scope=self.jscope)
        got = self.texe.run(tprog, feed=feed, fetch_list=names,
                            scope=self.tscope)
        return [np.asarray(w) for w in want], [np.asarray(g) for g in got]


def _reference_book(name):
    main, startup = JF.Program(), JF.Program()
    with JF.program_guard(main, startup), JU.guard():
        fetches = BOOK_BUILDERS[name]()
    return main, startup, fetches


@pytest.mark.parametrize("name", sorted(BOOK_BUILDERS))
def test_port_mirrors_build_the_book_programs(name):
    jm, js, _ = _reference_book(name)
    tm, ts, _ = B.build(TF, name)
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)


@pytest.mark.parametrize("name", sorted(BOOK_BUILDERS))
def test_book_program_in_both_executors(name):
    jm, js, fetches = _reference_book(name)
    pair = Pair(jm, js)
    feed = B.feeds(name)
    losses = []
    for _ in range(STEPS):
        want, got = pair.run(feed, fetches[:1])
        losses.append((float(want[0]), float(got[0])))
        np.testing.assert_allclose(got[0], want[0], rtol=BOOK_RTOL)
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1], \
        losses
    if name == "srl_crf":
        infer = jm.clone(for_test=True)
        want, got = pair.run(feed, fetches[1:], program=infer)
        live = np.arange(B.SRL_T)[None, :] < feed["length"][:, None]
        assert got[0].shape == want[0].shape == feed["word"].shape
        np.testing.assert_array_equal(got[0][live], want[0][live])
        assert (got[0][~live] == 0).all()


def _srl(cfg, fluid, unique_name):
    with unique_name.guard():
        return S.build(fluid, cfg)


@pytest.mark.parametrize("cfg_name", ["BOOK", "SMALL"])
def test_db_lstm_builds_the_reference_program(cfg_name):
    """The book's widths too: the chip's program is the reference's."""
    cfg = getattr(S, cfg_name)
    jm, js, _ = _srl(cfg, JF, JU)
    tm, ts, _ = _srl(cfg, TF, TU)
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)
    lstms = [op for op in tm.global_block().ops if op.type == "lstm"]
    assert len(lstms) == cfg["depth"]
    assert [op.attr("is_reverse") for op in lstms] == \
        [i % 2 == 1 for i in range(cfg["depth"])]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                              1e-12)


def test_db_lstm_loss_and_gradients_match_the_reference():
    cfg = S.SMALL
    jm, js, fetch = _srl(cfg, JF, JU)
    pair = Pair(jm, js)
    feed = S.batch(cfg, seed=0)
    weight = next(op.input("Weight")[0] for op in jm.global_block().ops
                  if op.type == "lstm")
    grads = ["crfw@GRAD", "emb@GRAD", weight + "@GRAD"]
    before = _arms()
    want, got = pair.run(feed, [fetch["loss"].name] + grads)
    arms = _arms(before)
    assert arms == {"loop": cfg["depth"], "cudnn": 0}, arms
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, w, g in zip(grads, want[1:], got[1:]):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= SRL_GRAD, (name, _rel(g, w))
    losses = [float(want[0])]
    for _ in range(2):
        want, got = pair.run(feed, [fetch["loss"].name])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        losses.append(float(want[0]))
    assert losses[-1] < losses[0], losses


def _arms(before=None):
    """The lstm rule's arm counts, or their change since `before`."""
    now = dict(rnn_ops.LSTM_ARMS)
    if before is None:
        return now
    return {k: now[k] - before[k] for k in now}


def _decay_program(fluid, unique_name, staircase):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        x = fluid.data("x", [-1, 3], "float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 1))
        lr = fluid.layers.exponential_decay(0.01, decay_steps=2,
                                            decay_rate=0.5,
                                            staircase=staircase)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, lr


@pytest.mark.parametrize("staircase", [True, False])
def test_exponential_decay_reads_the_carried_step(staircase):
    """The step counter is a persistable var an `increment` op at the top
    of the block raises each run: run k reads step k, in both
    Executors."""
    jm, js, lr = _decay_program(JF, JU, staircase)
    tm, ts, _ = _decay_program(TF, TU, staircase)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    assert jm.global_block().ops[0].type == "increment"
    pair = Pair(jm, js)
    feed = {"x": np.ones((2, 3), np.float32)}
    for k in range(1, 6):
        want, got = pair.run(feed, [lr, "@LR_DECAY_COUNTER@"])
        expect = 0.01 * 0.5 ** (k // 2 if staircase else k / 2)
        np.testing.assert_allclose(want[0], [expect], rtol=1e-6)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        assert float(got[1][0]) == float(want[1][0]) == k


def _crfw_step(fluid, unique_name, crf_lr):
    cfg = dict(S.SMALL, crf_lr=crf_lr)
    with unique_name.guard():
        return S.build(fluid, cfg)


def test_param_attr_learning_rate_is_ignored_by_both():
    """ROADMAP queue 3: the reference stores ParamAttr.learning_rate
    (Parameter.optimize_attr) and its SGD reads only the global learning
    rate, so crfw moves by 0.01 * grad whatever its 1e-3 says; the port
    follows.  The update is pinned against crfw - 0.01 * grad."""
    feed = S.batch(S.SMALL, seed=1)
    ups = {}
    for crf_lr in (1e-3, 1.0):
        jm, js, _ = _crfw_step(JF, JU, crf_lr)
        assert jm.global_block().var("crfw").optimize_attr == \
            {"learning_rate": crf_lr}
        pair = Pair(jm, js)
        w0 = np.asarray(pair.jscope.get("crfw")).copy()
        want, got = pair.run(feed, ["crfw@GRAD"])
        w1 = np.asarray(pair.jscope.get("crfw"))
        t1 = pair.tscope.get("crfw").numpy()
        np.testing.assert_allclose(w1, w0 - 0.01 * want[0], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(t1, w0 - 0.01 * got[0], rtol=1e-6,
                                   atol=1e-7)
        ups[crf_lr] = (w1 - w0, t1 - w0)
    np.testing.assert_allclose(ups[1e-3][0], ups[1.0][0], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(ups[1e-3][1], ups[1.0][1], rtol=1e-6,
                               atol=1e-9)


def test_lstm_cudnn_arm_matches_the_loop():
    """The `lstm` rule's fused arm (one torch.lstm, default activations,
    no initial state) against its loop, forward and gradient, both
    directions, on the CPU; the card holds them in chip_smoke's srl
    phase."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 6, 16))
    w = torch.from_numpy(rng.randn(4, 16) * 0.5)
    b = torch.from_numpy(rng.randn(1, 16) * 0.5)
    ct_h = torch.from_numpy(rng.randn(3, 6, 4))
    ct_c = torch.from_numpy(rng.randn(3, 6, 4))
    for reverse in (False, True):
        runs = {}
        for fused in (True, False):
            leaves = [t.clone().requires_grad_() for t in (x, w, b)]
            op = _FakeOp({"is_reverse": reverse})
            old = rnn_ops.LSTM_CUDNN[0]
            rnn_ops.LSTM_CUDNN[0] = fused
            try:
                before = _arms()
                out = rnn_ops._lstm(_Ctx(), op, {
                    "Input": [leaves[0]], "Weight": [leaves[1]],
                    "Bias": [leaves[2]]})
                arms = _arms(before)
            finally:
                rnn_ops.LSTM_CUDNN[0] = old
            assert arms["cudnn" if fused else "loop"] == 1
            hs, cs = out["Hidden"][0], out["Cell"][0]
            runs[fused] = [hs, cs] + list(torch.autograd.grad(
                [hs, cs], leaves, [ct_h, ct_c]))
        for a, b_ in zip(runs[True], runs[False]):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b_.detach().numpy(), rtol=1e-10,
                                       atol=1e-12)


class _FakeOp:
    def __init__(self, attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


class _Ctx:
    abstract = False
