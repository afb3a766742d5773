"""The port's Transformer-base WMT model against paddle_tpu's on the CPU,
at TransformerConfig.tiny() (2 + 2 pre-norm layers, d_model 64, 4 heads,
vocabularies of 1000): the JAX model's state (the position tables
included) carried over by `convert.load_jax_state`; logits at S != T
with no mask and with an additive key-padding mask; every gradient of
the smoothed loss; three steps of `build_train_step(bf16=False,
warmup_steps=10)` against the reference's step, and a JAX train state
continued in the port; greedy and beam decoding (W=1 and W=4) token for
token, each chosen token clear of its runner-up by more than the
logit tolerance; the dense beam functions on scores with exact ties and
finished beams.  Parity runs at dropout 0: the eager dropout layers draw
other bits in each package.

Tolerances (f32 on both sides; the two sum in other orders):
LOGIT_TOL (1e-5): logits near 2 through 4 layers (measured 6e-7).
GRAD_TOL (1e-6 absolute): gradients up to ~0.1 (measured below 1e-7).
LOSS_RTOL (1e-5): losses near 7 (measured 4e-7).
SCORE_TOL (2e-5): beam scores, sums of 6 log-probabilities (measured
4e-6).
MOMENT_RL2 (1e-3): Adam's moments after each step, by relative L2
error per tensor (measured up to 8e-5).
MOVE_RL2 (1e-2): how far each parameter moved from its start, by
relative L2 error per tensor (measured up to 9.7e-4): with eps 1e-9, an
element whose gradient is within f32 rounding of 0 takes a whole Adam
step of either sign.
K_BIAS_NOISE (1e-8): the attention's k_proj.bias has an exact gradient
of 0 (a bias on every key adds the same score to every key of a query,
and softmax ignores it), so both packages leave f32 rounding noise
(measured up to 1.3e-9); Adam then moves it by a whole rate-sized step
of random sign in each, so its values after a step are not compared.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.fluid.dygraph import guard, to_variable
from paddle_tpu.jit import functional_call as j_call
from paddle_tpu.jit import functional_state as j_state
from paddle_tpu.models import transformer_wmt as JW
from paddle_tpu.ops import rnn_ops as JR
from paddle_tpu_torch.convert import load_jax_state, load_jax_train_state
from paddle_tpu_torch.models import transformer_wmt as TW
from paddle_tpu_torch.ops import rnn_ops as TR

LOGIT_TOL = 1e-5
GRAD_TOL = 1e-6
LOSS_RTOL = 1e-5
SCORE_TOL = 2e-5
MOMENT_RL2 = 1e-3
MOVE_RL2 = 1e-2
K_BIAS_NOISE = 1e-8
NO_DROP = dict(dropout=0.0)
B, S, T, MAX_LEN = 3, 9, 7, 6
WARMUP, STEPS = 10, 3


@contextlib.contextmanager
def _fresh_jax_stream():
    """paddle_tpu draws a new layer's weights from one process-wide
    stream (`fluid.initializer._eager_seed`), which every parameter made
    earlier in the process has advanced; the models here are drawn from
    a fresh process's stream, restored afterwards (as in
    tests/test_torch_resnet.py)."""
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


def _jax_model(cfg_kw=NO_DROP):
    with _fresh_jax_stream():
        return JW.WMTTransformer(JW.TransformerConfig.tiny(**cfg_kw))


def _port_model(state, cfg_kw=NO_DROP):
    return load_jax_state(
        TW.WMTTransformer(TW.TransformerConfig.tiny(**cfg_kw), device="cpu"),
        state)


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(2, 1000, shape).astype(
        np.int64)


def _pad_mask():
    m = np.zeros((B, 1, 1, S), np.float32)
    m[1, ..., 6:] = -1e9
    m[2, ..., 3:] = -1e9
    return m


@pytest.fixture(scope="module")
def pair():
    """(JAX model in eval mode, its state as numpy, the port's model)."""
    with guard():
        jm = _jax_model()
        jm.eval()
        state = {k: np.asarray(v) for k, v in j_state(jm).items()}
        yield jm, state, _port_model(state).eval()


def test_state_holds_the_position_tables(pair):
    _, state, tm = pair
    assert len(state) == 94
    assert {"src_pos.pe", "tgt_pos.pe"} <= set(state)
    np.testing.assert_array_equal(tm.tgt_pos.pe.numpy(),
                                  TW.sinusoid_position_encoding(64, 64))


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match_jax(pair, masked):
    jm, _, tm = pair
    src, tgt = _ids(0, (B, S)), _ids(1, (B, T))
    mask = _pad_mask() if masked else None
    with guard():
        want = np.asarray(jm(to_variable(src), to_variable(tgt),
                             None if mask is None else to_variable(mask))
                          .numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
                 None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (B, T, 1000)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _jax_loss(jm, params, src, tgt_in, tgt_out, mask):
    """paddle_tpu's step loss (transformer_wmt.build_train_step) in f32."""
    logits, _ = j_call(jm, params, src, tgt_in, mask)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    lab = jax.nn.one_hot(tgt_out, 1000, dtype=jnp.float32)
    smooth = lab * 0.9 + 0.1 / 1000
    return jnp.mean(-jnp.sum(smooth * logp, axis=-1))


def test_gradients_match_jax(pair):
    """Every gradient of the smoothed loss (both position tables too),
    with the key-padding mask, through jax.value_and_grad and autograd."""
    jm, state, _ = pair
    src, tgt = _ids(2, (B, S)), _ids(3, (B, T + 1))
    mask = _pad_mask()
    with guard():
        loss, grads = jax.value_and_grad(
            lambda p: _jax_loss(jm, p, src, tgt[:, :-1], tgt[:, 1:], mask))(
            {k: jnp.asarray(v) for k, v in state.items()})
    tm = _port_model(state).eval()
    tensors = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    for t in tensors.values():
        t.requires_grad_(True)
    got = TW.smoothed_cross_entropy(
        tm(torch.from_numpy(src), torch.from_numpy(tgt[:, :-1]),
           torch.from_numpy(mask)), torch.from_numpy(tgt[:, 1:]), 0.1, 1000)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_RTOL)
    assert set(tensors) == set(grads)
    for k, t in tensors.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(grads[k]),
                                   atol=GRAD_TOL, rtol=0, err_msg=k)
    assert float(np.abs(np.asarray(grads["tgt_pos.pe"])).max()) > 1e-3


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def train_runs():
    """STEPS f32 steps on each side from the same weights and batch: the
    losses and, after every step, the port's and the reference's state."""
    with guard():
        jm = _jax_model()
        state0 = {k: np.asarray(v) for k, v in j_state(jm).items()}
        jstep, js = JW.build_train_step(jm, bf16=False, warmup_steps=WARMUP)
        tstep, ts = TW.build_train_step(_port_model(state0), bf16=False,
                                        warmup_steps=WARMUP)
        batch = JW.fake_batch(JW.TransformerConfig.tiny(), 4, 12, 10, seed=0)
        out = {"state0": state0, "jax": [], "port": []}
        for _ in range(STEPS):
            js, jl = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
            ts, tl = tstep(ts, batch)
            out["jax"].append((float(jl), jax.tree_util.tree_map(
                lambda a: np.array(a), {k: js[k] for k in ("params", "m",
                                                           "v", "t")})))
            out["port"].append((float(tl), {
                part: {k: v.clone().numpy() for k, v in ts[part].items()}
                for part in ("params", "m", "v")} | {"t": ts["t"]}))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_train_steps_match_jax(train_runs, step):
    (jl, js), (tl, ts) = train_runs["jax"][step], train_runs["port"][step]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert ts["t"] == int(js["t"]) == step + 1
    state0 = train_runs["state0"]
    for k in state0:
        if k.endswith("k_proj.bias"):
            continue
        for part in ("m", "v"):
            assert _rel_l2(ts[part][k], js[part][k]) < MOMENT_RL2, (part, k)
        assert _rel_l2(ts["params"][k] - state0[k],
                       js["params"][k] - state0[k]) < MOVE_RL2, k


def test_k_bias_gradient_is_rounding_noise_in_both(train_runs):
    """Why k_proj.bias is left out above: its gradient is 0 in exact
    arithmetic, and each package's is below K_BIAS_NOISE."""
    for _, s in (train_runs["jax"][0], train_runs["port"][0]):
        ks = [k for k in s["m"] if k.endswith("k_proj.bias")]
        assert len(ks) == 6
        assert max(float(np.abs(np.asarray(s["m"][k]) / 0.1).max())
                   for k in ks) < K_BIAS_NOISE


def test_position_tables_train_as_in_the_reference(train_runs):
    """paddle_tpu's state holds the two sinusoid tables and its Adam moves
    them (by 3.95e-3 at step 1: the Noam rate at t=1, warmup 10); the
    port's step does the same."""
    state0 = train_runs["state0"]
    (_, js), (_, ts) = train_runs["jax"][0], train_runs["port"][0]
    for k in ("src_pos.pe", "tgt_pos.pe"):
        moved_j = np.abs(js["params"][k] - state0[k]).max()
        moved_t = np.abs(ts["params"][k] - state0[k]).max()
        np.testing.assert_allclose(moved_t, moved_j, rtol=1e-3)
        np.testing.assert_allclose(moved_t, TW.noam_lr(64, WARMUP, 1),
                                   rtol=1e-3)


def test_jax_train_state_continues_in_the_port(train_runs):
    """convert.load_jax_train_state takes the reference's WMT state (the
    tables included), and one more port step from it gives the loss the
    reference's next step gives."""
    with guard():
        jm = _jax_model()
    (_, js1), (jl2, _) = train_runs["jax"][0], train_runs["jax"][1]
    tm = _port_model(train_runs["state0"])
    tstep, _ = TW.build_train_step(tm, bf16=False, warmup_steps=WARMUP)
    ts = load_jax_train_state(tm, js1)
    assert ts["t"] == 1 and "src_pos.pe" in ts["params"]
    batch = JW.fake_batch(JW.TransformerConfig.tiny(), 4, 12, 10, seed=0)
    _, tl2 = tstep(ts, batch)
    np.testing.assert_allclose(float(tl2), jl2, rtol=LOSS_RTOL)
    del jm


def test_bf16_step_matches_jax_loosely():
    """One step with the forward on a bf16 cast of the masters: bf16
    rounds at other places in the two packages (the loss within 5e-3)."""
    with guard():
        jm = _jax_model()
        state0 = {k: np.asarray(v) for k, v in j_state(jm).items()}
        jstep, js = JW.build_train_step(jm, bf16=True, warmup_steps=WARMUP)
        batch = JW.fake_batch(JW.TransformerConfig.tiny(), 4, 12, 10, seed=1)
        _, jl = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep, ts = TW.build_train_step(_port_model(state0), bf16=True,
                                    warmup_steps=WARMUP)
    _, tl = tstep(ts, batch)
    assert abs(float(tl) - float(jl)) < 5e-3


def test_port_loss_falls_with_dropout():
    """tests/test_wmt.py's check on the port: 10 steps at warmup 10 with
    dropout 0.1 (the step's own dropout stream) on one batch."""
    tm = TW.WMTTransformer(TW.TransformerConfig.tiny(), device="cpu")
    step, state = TW.build_train_step(tm, bf16=False, warmup_steps=WARMUP)
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(2, 50, (4, 8)).astype("int64")
             for k in ("src", "tgt_in", "tgt_out")}
    losses = [float(step(state, batch)[1]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- decoding ----------------------------------------------------------------

@pytest.fixture(scope="module")
def decodes(pair):
    """Greedy and beam (W=1, W=4) decodes of one source batch in both
    packages, and the port's beam steps' candidate totals."""
    jm, _, tm = pair
    src = _ids(4, (B, S))
    with guard():
        jout = {"greedy": np.asarray(
            jm.greedy_decode(to_variable(src), MAX_LEN).numpy())}
        for w in (1, 4):
            s, sc = jm.beam_decode(to_variable(src), w, MAX_LEN)
            jout[w] = (np.asarray(s.numpy()), np.asarray(sc.numpy()))
    totals = []

    def recording_step(pre_ids, pre_scores, cand_ids, scores, w, end_id):
        frozen = torch.full_like(scores, -1e9)
        frozen[:, 0] = pre_scores[:, 0]
        total = torch.where(pre_ids == end_id, frozen, pre_scores + scores)
        totals.append((w, total.reshape(-1, w * scores.shape[1])))
        return TR.dense_beam_step(pre_ids, pre_scores, cand_ids, scores, w,
                                  end_id)

    tsrc = torch.from_numpy(src)
    tout = {"greedy": tm.greedy_decode(tsrc, MAX_LEN).numpy()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "dense_beam_step", recording_step)
        for w in (1, 4):
            s, sc = tm.beam_decode(tsrc, w, MAX_LEN)
            tout[w] = (s.numpy(), sc.numpy())
    return src, jout, tout, totals


def test_greedy_tokens_match_jax_and_are_clear(pair, decodes):
    _, _, tm = pair
    src, jout, tout, _ = decodes
    np.testing.assert_array_equal(tout["greedy"], jout["greedy"])
    assert tout["greedy"].shape == (B, MAX_LEN)
    # teacher forcing: the full forward over BOS + the tokens before each
    # position picks that token, by more than the logit tolerance
    prefix = np.concatenate([np.zeros((B, 1), np.int64),
                             tout["greedy"][:, :-1]], axis=1)
    with torch.no_grad():
        logits = tm(torch.from_numpy(src), torch.from_numpy(prefix))
    top2 = torch.topk(logits, 2, dim=-1)
    np.testing.assert_array_equal(top2.indices[..., 0].numpy(),
                                  tout["greedy"])
    margin = (top2.values[..., 0] - top2.values[..., 1]).min()
    assert float(margin) > 2 * LOGIT_TOL


@pytest.mark.parametrize("w", [1, 4])
def test_beam_tokens_match_jax_and_are_clear(decodes, w):
    _, jout, tout, totals = decodes
    np.testing.assert_array_equal(tout[w][0], jout[w][0])
    np.testing.assert_allclose(tout[w][1], jout[w][1], atol=SCORE_TOL,
                               rtol=0)
    assert tout[w][0].shape == (B, w, MAX_LEN)
    # each step's W selections and their order: the W + 1 best totals of
    # a source lie more than the score tolerance apart
    steps = [t for ww, t in totals if ww == w]
    assert len(steps) == MAX_LEN
    for total in steps:
        best = torch.topk(total, w + 1, dim=1).values
        assert float((best[:, :-1] - best[:, 1:]).min()) > 2 * SCORE_TOL


def test_beam1_is_greedy_and_beam4_is_no_worse(decodes):
    _, _, tout, _ = decodes
    np.testing.assert_array_equal(tout[1][0][:, 0], tout["greedy"])
    assert (tout[4][1][:, 0] >= tout[1][1][:, 0] - 1e-5).all()
    assert (np.diff(tout[4][1], axis=1) <= 1e-5).all()


# -- the dense beam functions -------------------------------------------------

@pytest.mark.parametrize("accumulated", [False, True])
@pytest.mark.parametrize("given_ids", [False, True])
def test_dense_beam_step_matches_jax_with_ties(accumulated, given_ids):
    """Scores on a grid of 8 values, so a source's candidates tie exactly
    and often; a quarter of the beams finished, so their rows tie at
    exactly -1e9: the port must pick the reference's beams (lower flat
    index first among equal totals)."""
    rng = np.random.RandomState(5)
    b, w, k, end = 5, 4, 6, 1
    pre_ids = rng.randint(0, 4, (b * w, 1)).astype(np.int32)
    pre_scores = (rng.randint(-8, 0, (b * w, 1)) / 4).astype(np.float32)
    scores = (rng.randint(-8, 0, (b * w, k)) / 4).astype(np.float32)
    cand = rng.randint(0, 50, (b * w, k)).astype(np.int32) if given_ids \
        else None
    assert (pre_ids == end).any()
    want = JR.dense_beam_step(
        jnp.asarray(pre_ids), jnp.asarray(pre_scores),
        None if cand is None else jnp.asarray(cand), jnp.asarray(scores), w,
        end, is_accumulated=accumulated)
    got = TR.dense_beam_step(
        torch.from_numpy(pre_ids).long(), torch.from_numpy(pre_scores),
        None if cand is None else torch.from_numpy(cand).long(),
        torch.from_numpy(scores), w, end, is_accumulated=accumulated)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_dense_beam_step_all_finished_keeps_the_frozen_beams():
    """Every beam finished: each source keeps its beams best first (equal
    scores in beam order), at their scores, selecting end_id again."""
    b, w, k, end = 2, 3, 5, 1
    pre_ids = np.full((b * w, 1), end, np.int32)
    pre_scores = np.array([[-1.0], [-2.0], [-2.0], [-0.5], [-3.0], [-0.5]],
                          np.float32)
    scores = np.zeros((b * w, k), np.float32)
    want = JR.dense_beam_step(jnp.asarray(pre_ids), jnp.asarray(pre_scores),
                              None, jnp.asarray(scores), w, end)
    got = TR.dense_beam_step(torch.from_numpy(pre_ids).long(),
                             torch.from_numpy(pre_scores), None,
                             torch.from_numpy(scores), w, end)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    np.testing.assert_array_equal(got[2].numpy(), [0, 1, 2, 3, 5, 4])


def test_dense_beam_backtrack_matches_jax():
    rng = np.random.RandomState(6)
    steps, b, w = 7, 3, 4
    ids = rng.randint(0, 100, (steps, b * w)).astype(np.int32)
    parents = (np.arange(b)[None, :, None] * w
               + rng.randint(0, w, (steps, b, w))).reshape(steps, b * w)
    want = JR.dense_beam_backtrack(jnp.asarray(ids),
                                   jnp.asarray(parents.astype(np.int32)))
    got = TR.dense_beam_backtrack(torch.from_numpy(ids).long(),
                                  torch.from_numpy(parents))
    assert got.shape == (b * w, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- entry points --------------------------------------------------------------

def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = TW.TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.WMTTransformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TW.Transformer.generate_square_subsequent_mask(4)


def test_mesh_is_not_ported():
    tm = TW.WMTTransformer(TW.TransformerConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        TW.build_train_step(tm, mesh=object())


def test_fake_batch_matches_jax():
    want = JW.fake_batch(JW.TransformerConfig.tiny(), 4, 12, 10, seed=3)
    got = TW.fake_batch(TW.TransformerConfig.tiny(), 4, 12, 10, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
