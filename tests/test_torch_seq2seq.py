"""Paddle 2.x's seq2seq with attention (tests/torch_seq2seq_program.py,
one program over both packages' 2.x API) at vocab 50, hidden 16, 2
layers, B=4, T=7, on the CPU: the same weights (uniform +-0.1 from one
numpy stream) and data in paddle_tpu and the port.  Logits, the masked
loss and every gradient match; three hapi `Model.fit` steps under Adam
with the global-norm clip engaged (at 0.05) match the reference's static-mode
adapter (the port under both its adapters); beam search at width 3
gives the reference's ids, parents and scores; beam 1 is the greedy
loop; and every beam, followed back through its parents, scores what a
teacher-forced pass of its tokens scores.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): one float32 forward of 7
decoder steps.  GRAD (rtol 1e-4, atol 1e-6): gradients through the 7
steps of the attention cell and the 2-layer LSTM, whose float32 sums
the packages order differently.  FIT (rtol 1e-4, atol 1e-5): the
parameters after three Adam steps (each element moves by about the
learning rate, 1e-3, whatever its gradient's size).  SCORE (rtol 1e-5,
atol 1e-5): sums of 7 clamped log-probabilities.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy

import paddle_tpu_torch as T
from paddle_tpu_torch.fluid import dygraph as Tdy

import torch_seq2seq_program as S

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
FIT = dict(rtol=1e-4, atol=1e-5)
SCORE = dict(rtol=1e-5, atol=1e-5)
CFG = S.TINY
# the global-norm clip at 0.05: the tiny model's gradient norm is ~0.09,
# so the clip engages (at 5.0 it would not)
FIT_CFG = dict(CFG, max_grad_norm=0.05)


@pytest.fixture(autouse=True)
def _cpu_and_global_rngs():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    T.device._CURRENT[0] = old
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _np(t):
    return S.host(t)


def _loss_and_grads(P, model, data):
    src, sl, trg, tl, lab = (P.to_tensor(a) for a in data)
    logits, mask = model(src, sl, trg, tl)
    loss = S.classes(P)["CrossEntropyCriterion"]()(logits, mask, lab)
    loss.backward()
    grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    return _np(logits), _np(mask), float(_np(loss)), grads


def test_the_program_computes_the_same_loss_and_gradients():
    data = S.batch(CFG)
    jm, tm = S.build(J, CFG), S.build(T, CFG)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [tuple(v.shape) for v in tm.state_dict().values()] == \
        [tuple(v.shape) for v in jm.state_dict().values()]
    with Jdy.guard():
        want = _loss_and_grads(J, jm, data)
    got = _loss_and_grads(T, tm, data)
    np.testing.assert_allclose(got[0], want[0], **F32)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() == data[3].sum()  # the mask counts the lengths
    np.testing.assert_allclose(got[2], want[2], **F32)
    assert set(got[3]) == set(want[3])
    for n, w in want[3].items():
        np.testing.assert_allclose(got[3][n], w, err_msg=n, **GRAD)
    # every parameter has a gradient path, the encoder's LSTM included
    assert all(np.abs(g).max() > 0 for g in got[3].values())


def test_convert_carries_the_reference_weights_by_name():
    """convert.load_jax_state fills the port's model from the reference's
    functional_state (the LSTM weights included) by name."""
    from paddle_tpu.jit import functional_state

    from paddle_tpu_torch import convert

    jm, tm = S.build(J, CFG, seed=0), S.build(T, CFG, seed=9)
    convert.load_jax_state(tm, {k: np.asarray(v) for k, v in
                                functional_state(jm).items()})
    data = S.batch(CFG)
    with Jdy.guard():
        want = _np(jm(*(J.to_tensor(a) for a in data[:4]))[0])
    got = _np(tm(*(torch.from_numpy(a) for a in data[:4]))[0])
    np.testing.assert_allclose(got, want, **F32)


def _dataset(P, data):
    class Pairs(P.io.Dataset):
        def __len__(self):
            return len(data[0])

        def __getitem__(self, i):
            return tuple(a[i] for a in data)

    return Pairs()


def _fit(P, data, adapter="static"):
    net = S.build(P, FIT_CFG)
    if adapter == "dygraph":
        with (Jdy if P is J else Tdy).guard():
            model = S.prepare(P, net, FIT_CFG)
    else:
        model = S.prepare(P, net, FIT_CFG)

    losses = []

    class Record(P.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    model.fit(_dataset(P, data), batch_size=CFG["batch"], epochs=3,
              shuffle=False, verbose=0, callbacks=[Record()])
    return losses, {k: _np(v) for k, v in net.state_dict().items()}


_REFERENCE_FIT = {}


def _reference_fit(data):
    if "fit" not in _REFERENCE_FIT:
        _REFERENCE_FIT["fit"] = _fit(J, data)
    return _REFERENCE_FIT["fit"]


@pytest.mark.parametrize("adapter", ["static", "dygraph"])
def test_three_fit_steps_with_the_clip_match(adapter):
    data = S.batch(CFG)
    # the clip engages: the first step's global gradient norm is past it
    _, _, _, grads = _loss_and_grads(T, S.build(T, CFG), data)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads.values()))
    assert norm > FIT_CFG["max_grad_norm"], norm
    want_losses, want = _reference_fit(data)
    losses, got = _fit(T, data, adapter)
    assert len(losses) == 3 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, **F32)
    start = S.build(T, CFG).state_dict()
    for k, w in want.items():
        assert not np.array_equal(got[k], _np(start[k])), k
        np.testing.assert_allclose(got[k], w, err_msg=k, **FIT)


def test_beam_search_gives_the_reference_beams():
    data = S.batch(CFG)
    out = {}
    for P in (J, T):
        m = S.build(P, CFG)
        with (Jdy.guard() if P is J else torch.no_grad()):
            o = S.beam_search(P, m, P.to_tensor(data[0]),
                              P.to_tensor(data[1]), CFG["beam_size"],
                              CFG["max_out_len"])
        out[P.__name__] = {k: _np(v) for k, v in o.items()}
    j, t = out["paddle_tpu"], out["paddle_tpu_torch"]
    np.testing.assert_array_equal(t["predicted_ids"], j["predicted_ids"])
    np.testing.assert_array_equal(t["parent_ids"], j["parent_ids"])
    np.testing.assert_allclose(t["scores"], j["scores"], **SCORE)
    assert t["predicted_ids"].shape == (CFG["batch"], CFG["max_out_len"],
                                        CFG["beam_size"])


def test_beam_one_is_greedy_and_beams_score_their_tokens():
    """The chip check's two decode holds, on the CPU: beam 1 equals the
    greedy loop over the same cell, and each beam of width 3, followed
    back through its parents, scores what teacher forcing scores."""
    cfg = dict(CFG, max_out_len=12)
    m = S.build(T, cfg, seed=5)
    src, sl = (torch.from_numpy(a) for a in S.batch(cfg, seed=1)[:2])
    # sharpen the output layer and give </s> 0.9 of the column of the
    # token greedy picks most, so some beams finish early and extend
    # with </s> at no cost
    w = m.decoder.output_layer.weight
    with torch.no_grad():
        w.mul_(30.0)
        top = np.bincount(S.greedy(T, m, src, sl, 12).ravel()).argmax()
        w[:, S.EOS] = 0.9 * w[:, top]
    g = S.greedy(T, m, src, sl, cfg["max_out_len"])
    b1 = S.beam_search(T, m, src, sl, 1, cfg["max_out_len"])
    np.testing.assert_array_equal(_np(b1["predicted_ids"])[:, :, 0], g)
    out = S.beam_search(T, m, src, sl, 3, cfg["max_out_len"])
    ids, parents, scores = (_np(out[k]) for k in
                            ("predicted_ids", "parent_ids", "scores"))
    seqs = S.backtrack(ids, parents)
    finished = (seqs == S.EOS).any(-1)
    assert finished.any() and not finished.all()
    np.testing.assert_allclose(S.sequence_scores(T, m, src, sl, seqs),
                               scores[:, -1, :], **SCORE)


def test_backtrack_follows_the_parents():
    ids = np.array([[[5, 6], [7, 8], [9, 10]]])      # (1, 3 steps, 2)
    parents = np.array([[[0, 0], [1, 0], [1, 0]]])
    # last beam 0 <- step-1 beam 1 (8) <- step-0 beam 0 (5)
    np.testing.assert_array_equal(S.backtrack(ids, parents),
                                  [[[5, 8, 9], [6, 7, 10]]])
