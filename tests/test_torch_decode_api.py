"""The port's 2.x decode API (paddle_tpu_torch.nn.decode:
`BeamSearchDecoder`, `dynamic_decode`) against paddle_tpu.nn.decode on
the CPU.  It mirrors the reference's own cases (tests/test_nn_tail.py's
greedy equivalence on a deterministic toy cell, tests/test_functional_
tail.py's standalone step) and holds the per-step `predicted_ids`,
`parent_ids` and `scores`, the lengths and the final states of a beam
search over a random LSTM cell against the reference's, with keyword
arguments passed through to the cell, time-major outputs, exact ties
(constant logits) and finished beams.

Tolerances.  Ids, parents, lengths and finished masks are exact.
Scores and states: F32 (rtol 1e-5, atol 1e-5), float32 sums of up to 8
clamped log-probabilities, which only the order of float32 operations
separates; the -1e9 of a beam that has not started is held the same
way.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy

import paddle_tpu_torch as T

from test_torch_hapi import fresh_jax_stream

F32 = dict(rtol=1e-5, atol=1e-5)
V, E, H, B = 7, 5, 6, 3


@pytest.fixture(autouse=True)
def _cpu_and_global_rngs():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    T.device._CURRENT[0] = old
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)



class ToyCell(T.nn.RNNCellBase):
    """The reference test's deterministic cell: logits prefer token
    (state + 1) mod V, so the greedy rollout is 1, 2, 3, ..."""

    V = 6

    def forward(self, inputs, states, **kw):
        nxt = (states[:, 0] + 1).long() % self.V
        logits = torch.full((inputs.shape[0], self.V), -10.0)
        logits[torch.arange(inputs.shape[0]), nxt] = 0.0
        return logits, states + 1


def test_beam_search_decoder_greedy_equivalence():
    """tests/test_nn_tail.py:136 on the port."""
    dec = T.nn.BeamSearchDecoder(ToyCell(), start_token=0, end_token=5,
                                 beam_size=3)
    outputs, _ = T.nn.dynamic_decode(dec, inits=torch.zeros(2, 1),
                                     max_step_num=8)
    ids = outputs["predicted_ids"].numpy()
    assert ids.shape[0] == 2 and ids.shape[2] == 3
    np.testing.assert_array_equal(ids[0, :5, 0], [1, 2, 3, 4, 5])
    assert (ids[0, 5:, 0] == 5).all()
    assert np.isfinite(outputs["scores"].numpy()[:, :, 0]).all()


def test_beam_decoder_standalone_step():
    """tests/test_functional_tail.py:293 on the port."""
    dec = T.nn.BeamSearchDecoder(ToyCell(), start_token=0, end_token=5,
                                 beam_size=2)
    inputs, states, finished = dec.initialize(torch.zeros(2, 1))
    outputs, states, inputs, finished = dec.step(0, inputs, states)
    assert list(outputs["predicted_ids"].shape) == [2, 2]
    assert dec.tracks_own_finished and not T.nn.Decoder().tracks_own_finished


def _program(P):
    class Cell(P.nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.lstm = P.nn.LSTMCell(E, H)
            self.out = P.nn.Linear(H, V)
            self.scale = 1.0

        def forward(self, inputs, states, bias=None):
            h, st = self.lstm(inputs, states)
            logits = P.scale(self.out(h), self.scale)
            if bias is not None:
                logits = P.add(logits, bias)
            return logits, st

    return Cell(), P.nn.Embedding(V, E)


def _pair():
    with fresh_jax_stream():
        jc, je = _program(J)
    tc, te = _program(T)
    for j, t in ((jc, tc), (je, te)):
        assert t.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                                 j.state_dict().items()}) == ([], [])
    return (jc, je), (tc, te)


def _decode(P, cell, emb, k, inits, **kw):
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=k, embedding_fn=emb)
    # the cell's own output is the logits: no output_fn
    tiled = {n: dec.tile_beam_merge_with_batch(v) for n, v in
             kw.pop("tile", {}).items()}
    return P.nn.dynamic_decode(dec, inits=inits, **kw, **tiled)


def _states(P, seed=1):
    h = np.random.RandomState(seed).randn(B, H).astype(np.float32)
    c = np.random.RandomState(seed + 1).randn(B, H).astype(np.float32)
    if P is J:
        return (J.to_tensor(h), J.to_tensor(c))
    return (torch.from_numpy(h), torch.from_numpy(c))


def _compare(jout, tout):
    jo, js = jout[0], jout[1]
    to, ts = tout[0], tout[1]
    for key in ("predicted_ids", "parent_ids"):
        np.testing.assert_array_equal(to[key].numpy(), jo[key].numpy(),
                                      err_msg=key)
    np.testing.assert_allclose(to["scores"].detach().numpy(),
                               jo["scores"].numpy(), **F32)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **F32)
    if len(jout) == 3:
        np.testing.assert_array_equal(tout[2].numpy(), jout[2].numpy())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_matches_the_reference(k, time_major):
    (jc, je), (tc, te) = _pair()
    bias = np.random.RandomState(5).randn(B, V).astype(np.float32)
    with Jdy.guard():
        jout = _decode(J, jc, je, k, _states(J), max_step_num=8,
                       output_time_major=time_major, return_length=True,
                       tile={"bias": J.to_tensor(bias)})
    tout = _decode(T, tc, te, k, _states(T), max_step_num=8,
                   output_time_major=time_major, return_length=True,
                   tile={"bias": torch.from_numpy(bias)})
    _compare(jout, tout)
    steps = tout[0]["predicted_ids"].shape[0 if time_major else 1]
    assert 1 <= steps <= 8
    assert tout[2].dtype == torch.int64 and tout[2].shape == (B, k)


def test_ties_and_finished_beams_follow_the_reference():
    """Constant logits tie every candidate: the first step fans out from
    beam 0 to tokens 0..k-1 (the others start at -1e9), later steps take
    the lower flat index among equal totals, the beam that picked the
    end token (1) is finished and then extends only with it at no cost,
    so it leads from the next step on."""
    (jc, je), (tc, te) = _pair()
    jc.scale = tc.scale = 0.0
    with Jdy.guard():
        jout = _decode(J, jc, je, 3, _states(J), max_step_num=5,
                       return_length=True)
    tout = _decode(T, tc, te, 3, _states(T), max_step_num=5,
                   return_length=True)
    _compare(jout, tout)
    ids = tout[0]["predicted_ids"].numpy()
    parents = tout[0]["parent_ids"].numpy()
    scores = tout[0]["scores"].detach().numpy()
    np.testing.assert_array_equal(ids[:, 0], [[0, 1, 2]] * B)
    np.testing.assert_array_equal(parents[:, 0], [[0, 0, 0]] * B)
    # step 2: the finished beam (1) first, at its unchanged score
    np.testing.assert_array_equal(ids[:, 1, 0], [1] * B)
    np.testing.assert_array_equal(parents[:, 1, 0], [1] * B)
    np.testing.assert_allclose(scores[:, 1, 0], scores[:, 0, 1], **F32)
    np.testing.assert_allclose(scores[:, 0], np.log(1 / V), **F32)
    # the finished beam's length is the step it finished at
    assert (tout[2].numpy()[:, 0] == 2).all()


def test_an_unlikely_token_scores_the_clamped_log_probability():
    """log(max(softmax, 1e-20)), not log_softmax: a token whose
    probability underflows scores log(1e-20)."""
    dec = T.nn.BeamSearchDecoder(ToyCell(), 0, 1, beam_size=2)
    dec.initialize(torch.zeros(1, 1))
    logits = torch.tensor([[0.0, -100.0, -200.0, 5.0],
                           [0.0, 0.0, 0.0, 0.0]])
    fin = torch.zeros(1, 2, dtype=torch.bool)
    lp = torch.tensor([[0.0, -3.0]])
    top, parent, token, _, _ = dec._beam_step(logits, lp, fin)
    assert token.tolist() == [[3, 0]] and parent.tolist() == [[0, 1]]
    dec2 = T.nn.BeamSearchDecoder(ToyCell(), 0, 1, beam_size=4)
    top, parent, token, _, _ = dec2._beam_step(
        torch.tensor([[0.0, -100.0, -200.0, 50.0]] * 4),
        torch.tensor([[0.0, -1e9, -1e9, -1e9]]),
        torch.zeros(1, 4, dtype=torch.bool))
    assert token.tolist() == [[3, 0, 1, 2]]
    np.testing.assert_allclose(top[0, 2:].numpy(),
                               [np.log(1e-20)] * 2, rtol=1e-6)


def test_states_follow_their_parents():
    """Each state row is the parent beam's row after the step."""
    dec = T.nn.BeamSearchDecoder(ToyCell(), 0, 5, beam_size=3)
    inputs, states, _ = dec.initialize(torch.arange(2.0)[:, None])
    outs, new_states, _, _ = dec.step(0, inputs, states)
    gather = (torch.arange(2)[:, None] * 3 + outs["parent_ids"]).reshape(-1)
    np.testing.assert_array_equal(new_states.numpy(),
                                  (states + 1)[gather].numpy())
