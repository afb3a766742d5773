"""The port's BERT pretraining step against paddle_tpu's, on the CPU: the
same weights (carried over by `convert.load_jax_state`), the same numpy
batch, four AdamW steps on each side; the train-state loader; the step's
own rules (no-decay set, the tie, determinism in t, the options it does
not take); the functional helpers and the step-seeded randomness."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.convert import load_jax_state, load_jax_train_state
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.nn import functional as TFn

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LR = 1e-3
# f32 on both sides through 2 layers, the heads and the loss: summation
# order only (measured 5e-7 relative)
LOSS_RTOL = 1e-5
# gradients of step 1 (up to ~0.16), read back from m = 0.1 * g on both
# sides (measured 8e-8)
GRAD_ATOL = 1e-6
# bf16 forward on both sides: bf16 rounds at other places in the two
# frameworks (measured 2e-4 on losses near 7.6)
BF16_LOSS_ATOL = 5e-3


def _jax_model(cfg_kw=NO_DROP, seed=3):
    paddle.seed(seed)
    return JB.BertForPretraining(JB.BertConfig.tiny(**cfg_kw))


def _port_model(state, cfg_kw=NO_DROP):
    return load_jax_state(
        TB.BertForPretraining(TB.BertConfig.tiny(**cfg_kw), device="cpu"),
        state)


def _batch(seed=0):
    return JB.fake_batch(JB.BertConfig.tiny(), 4, 64, num_masked=8,
                         seed=seed)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def f32_runs():
    """Four f32 steps on each side from the same weights and batch: the
    losses, the moments after step 1 and the state after step 4."""
    jm = _jax_model()
    state0 = {k: np.asarray(v)
              for k, v in jax_functional_state(jm).items()}
    batch = _batch()
    jstep, js = JB.build_pretrain_step(jm, bf16=False)
    tm = _port_model(state0)
    tstep, ts = TB.build_pretrain_step(tm, bf16=False)
    out = {"jax_loss": [], "port_loss": []}
    for i in range(4):
        js, jl = jstep(js, _jnp(batch), LR)
        ts, tl = tstep(ts, batch, LR)
        out["jax_loss"].append(float(jl))
        out["port_loss"].append(float(tl))
        if i == 0:
            out["jax_m1"] = _numpy(js["m"])
            out["port_m1"] = {k: v.clone().numpy()
                              for k, v in ts["m"].items()}
    out["jax_state"] = _numpy(js)
    out["port_state"] = ts
    return out


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_losses_match_jax_at_every_step(f32_runs, step):
    np.testing.assert_allclose(f32_runs["port_loss"][step],
                               f32_runs["jax_loss"][step], rtol=LOSS_RTOL)


def test_losses_fall(f32_runs):
    losses = f32_runs["port_loss"]
    assert all(b < a for a, b in zip(losses, losses[1:]))


def test_step1_gradients_match_jax(f32_runs):
    jm1, tm1 = f32_runs["jax_m1"], f32_runs["port_m1"]
    assert set(jm1) == set(tm1)
    for k in jm1:  # m after one step is (1 - b1) * g
        np.testing.assert_allclose(tm1[k] / 0.1, jm1[k] / 0.1,
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)


def test_params_after_four_steps_within_one_adam_step(f32_runs):
    """An Adam step moves an element by about lr at most, so parameters
    that disagree by less than lr after four steps took the same steps."""
    jp = f32_runs["jax_state"]["params"]
    tp = f32_runs["port_state"]["params"]
    worst = max(float(np.abs(tp[k].numpy() - jp[k]).max()) for k in jp)
    assert worst < LR
    assert f32_runs["port_state"]["t"] == int(f32_runs["jax_state"]["t"])


def test_bf16_steps_match_jax_loosely():
    jm = _jax_model()
    state0 = {k: np.asarray(v)
              for k, v in jax_functional_state(jm).items()}
    batch = _batch(1)
    jstep, js = JB.build_pretrain_step(jm, bf16=True)
    tstep, ts = TB.build_pretrain_step(_port_model(state0), bf16=True)
    for _ in range(2):
        js, jl = jstep(js, _jnp(batch), LR)
        ts, tl = tstep(ts, batch, LR)
        np.testing.assert_allclose(float(tl), float(jl), atol=BF16_LOSS_ATOL)
    # the masters stay f32 and so do their moments
    assert all(v.dtype == torch.float32 for v in ts["params"].values())
    assert all(v.dtype == torch.float32 for v in ts["m"].values())


# -- the train-state loader ---------------------------------------------------------

def test_load_jax_train_state_round_trip_and_continue():
    jm = _jax_model(seed=4)
    state0 = {k: np.asarray(v)
              for k, v in jax_functional_state(jm).items()}
    batch = _batch(2)
    jstep, js = JB.build_pretrain_step(jm, bf16=False)
    for _ in range(2):
        js, _ = jstep(js, _jnp(batch), LR)
    jn = _numpy(js)
    tm = _port_model(state0)
    ts = load_jax_train_state(tm, jn)
    assert ts["t"] == 2 and isinstance(ts["t"], int)
    for part in ("params", "m", "v"):
        assert set(ts[part]) == set(jn[part])
        for k, v in ts[part].items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), jn[part][k])
    # the JAX run continues in the port
    tstep, _ = TB.build_pretrain_step(tm, bf16=False)
    js, jl = jstep(js, _jnp(batch), LR)
    ts, tl = tstep(ts, batch, LR)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert ts["t"] == 3


@pytest.mark.parametrize("fault", ["missing_part", "missing_key",
                                   "extra_key", "shape"])
def test_load_jax_train_state_checks(fault):
    jm = _jax_model(seed=5)
    params = {k: np.asarray(v)
              for k, v in jax_functional_state(jm).items()}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    state = {"params": params, "m": dict(zeros), "v": dict(zeros),
             "t": np.int32(0)}
    name = "bert.pooler.dense.weight"
    if fault == "missing_part":
        del state["v"]
        err = KeyError
    elif fault == "missing_key":
        del state["m"][name]
        err = KeyError
    elif fault == "extra_key":
        state["v"]["bert.not_a_param"] = np.zeros(3, np.float32)
        err = KeyError
    else:
        state["params"][name] = np.zeros((3, 3), np.float32)
        err = ValueError
    with pytest.raises(err):
        load_jax_train_state(_port_model(params), state)


# -- the step's own rules -----------------------------------------------------------

def test_no_decay_set_by_name():
    w2d = torch.zeros(4, 4)
    assert TB._decays("bert.encoder.layers.0.linear1.weight", w2d)
    assert not TB._decays("bert.encoder.layers.0.linear1.bias",
                          torch.zeros(4))
    assert not TB._decays("bert.embeddings.layer_norm.weight",
                          torch.zeros(4))
    assert not TB._decays("bert.encoder.layers.0.moe.b1", w2d)
    assert not TB._decays("bert.encoder.layers.0.moe.b2", w2d)


def test_weight_decay_reaches_matrices_only():
    """One step with and without weight decay from the same state: only
    the parameters the rule decays move differently."""
    params = {k: np.asarray(v)
              for k, v in jax_functional_state(_jax_model(seed=6)).items()}
    batch = _batch(3)
    moved = {}
    for wd in (0.0, 0.5):
        step, st = TB.build_pretrain_step(_port_model(params), bf16=False,
                                          weight_decay=wd)
        st, _ = step(st, batch, LR)
        moved[wd] = st["params"]
    for k, p in moved[0.0].items():
        same = torch.equal(p, moved[0.5][k])
        assert same == (not TB._decays(k, p)), k


def test_tie_kept_after_a_step():
    params = {k: np.asarray(v)
              for k, v in jax_functional_state(_jax_model(seed=7)).items()}
    tm = _port_model(params)
    step, st = TB.build_pretrain_step(tm, bf16=False)
    tied = "bert.embeddings.word_embeddings.weight"
    assert "cls.decoder_weight" not in st["params"]
    st, _ = step(st, _batch(4), LR)
    seen = {}

    def hook(module, args):
        seen["decoder"] = module.decoder_weight.data_ptr()
        seen["embedding"] = tm.bert.embeddings.word_embeddings.weight \
            .data_ptr()

    handle = tm.cls.register_forward_pre_hook(hook)
    try:
        st, _ = step(st, _batch(4), LR)
    finally:
        handle.remove()
    want = st["params"][tied].data_ptr()
    assert seen == {"decoder": want, "embedding": want}
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight


def test_step_is_deterministic_in_t():
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    params = {k: np.asarray(v) for k, v in jax_functional_state(
        _jax_model(drop, seed=8)).items()}
    batch = _batch(5)

    def one_step(t):
        step, st = TB.build_pretrain_step(_port_model(params, drop),
                                          bf16=False)
        st["t"] = t
        st, loss = step(st, batch, LR)
        return float(loss), st["params"]

    (l1, p1), (l2, p2), (l3, _) = one_step(0), one_step(0), one_step(5)
    assert l1 == l2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert l3 != l1  # another t draws other dropout masks


def test_loss_is_a_0d_tensor_and_state_is_updated_in_place():
    params = {k: np.asarray(v)
              for k, v in jax_functional_state(_jax_model(seed=9)).items()}
    step, st = TB.build_pretrain_step(_port_model(params), bf16=False)
    before = st["params"]["bert.pooler.dense.weight"]
    snapshot = before.clone()
    out, loss = step(st, {k: torch.from_numpy(v)
                          for k, v in _batch(6).items()}, torch.tensor(LR))
    assert out is st and out["t"] == 1
    assert loss.ndim == 0 and not loss.requires_grad
    assert out["params"]["bert.pooler.dense.weight"] is before
    assert not torch.equal(before, snapshot)


@pytest.mark.parametrize("option", [dict(remat=True), "moe"])
def test_unsupported_options_raise(option):
    """The options of the later model-parallel steps wait for ROADMAP
    queue 1 item 10b (iv) (MoE), remat for queue 1 item 1; data-, tensor-
    and sequence-parallel meshes are taken (test_torch_data_parallel.py,
    test_torch_spmd.py, test_torch_seq_parallel.py)."""
    model = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                                  device="cpu")
    if option == "moe":
        model.bert.config.moe_experts = 4
        option = {}
    item = r"queue 1 item 1\)" if option == dict(remat=True) else "item 10b"
    with pytest.raises(NotImplementedError, match=item):
        TB.build_pretrain_step(model, **option)


@pytest.mark.parametrize("option", [
    "mesh_seq", dict(mp_axis="mp", sp_axis="sp"), dict(sp_axis="sp"),
    dict(use_ring_attention=True), dict(use_ulysses=True)])
def test_the_sequence_options_of_one_process_are_its_step(option):
    """The sequence-parallel options (ROADMAP queue 1 item 10b (iii)) on
    one process: a mesh with a sequence axis, mp and sp axes of one, and
    ring or Ulysses attention without a mesh (the reference routes
    through them only under a mesh) give the one-process step's bits;
    tests/test_torch_seq_parallel.py runs them over four ranks."""
    from paddle_tpu_torch.parallel import mesh as M

    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    if option == "mesh_seq":
        option = dict(mesh=M.make_mesh({"dp": 1, "seq": 2},
                                       devices=range(2)))
    elif "sp_axis" in option:
        axes = {"dp": 1, "mp": 1, "sp": 1} if "mp_axis" in option else \
            {"dp": 1, "sp": 1}
        option = dict(option, mesh=M.make_mesh(axes))
    runs = []
    for kw in ({}, option):
        model = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                                      device="cpu", seed=4)
        step, st = TB.build_pretrain_step(model, bf16=False, **kw)
        st, loss = step(st, batch, LR)
        runs.append((loss, st["params"]))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


@pytest.mark.parametrize("option,match", [
    (dict(use_ring_attention=True), "requires attention_probs_dropout"),
    (dict(use_ulysses=True), "requires attention_probs_dropout"),
    (dict(use_ring_attention=True, use_ulysses=True), "choose ONE"),
    (dict(sp_axis="sp"), "sp_axis needs a mesh")])
def test_the_references_sequence_refusals_stand(option, match):
    """The reference's refusals (models/bert.py:276-287): ring or Ulysses
    with attention dropout, and both at once; and the port's own,
    `sp_axis` without a mesh (ROADMAP queue 3 item 51: the reference
    ignores it)."""
    drop = dict(NO_DROP, attention_probs_dropout_prob=0.1) \
        if "requires" in match else NO_DROP
    model = TB.BertForPretraining(TB.BertConfig.tiny(**drop), device="cpu")
    with pytest.raises(ValueError, match=match):
        TB.build_pretrain_step(model, **option)


def test_a_data_parallel_mesh_of_one_is_the_one_process_step():
    """make_mesh({"dp": 1}) with no group: the step's bits are the
    one-process step's."""
    from paddle_tpu_torch.parallel import mesh as M

    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    runs = []
    for mesh in (None, M.make_mesh({"dp": 1})):
        torch.manual_seed(0)
        model = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                                      device="cpu", seed=4)
        step, st = TB.build_pretrain_step(model, bf16=False, mesh=mesh)
        st, loss = step(st, batch, LR)
        runs.append((loss, st["params"]))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_step_flops_formula_matches_the_benchmark():
    import bench

    for cfg_kw, args in ((dict(), (32, 512, 76)),
                         (dict(num_hidden_layers=2), (4, 128, 20))):
        assert TB.bert_step_flops(TB.BertConfig.base(**cfg_kw), *args) == \
            bench.bert_step_flops(JB.BertConfig.base(**cfg_kw), *args)


# -- functional helpers and step-seeded randomness ---------------------------------

def test_functional_state_counts_the_tie_once():
    tm = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP), device="cpu")
    state = TJ.functional_state(tm)
    assert "bert.embeddings.word_embeddings.weight" in state
    assert "cls.decoder_weight" not in state
    jstate = jax_functional_state(_jax_model())
    assert set(state) == set(jstate)
    assert all(not v.requires_grad for v in state.values())


def test_functional_call_runs_on_the_given_state():
    tm = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                               device="cpu").eval()
    state = {k: v.clone() for k, v in TJ.functional_state(tm).items()}
    state["bert.pooler.dense.bias"] += 1.0
    b = _batch(7)
    args = [torch.from_numpy(b["input_ids"]),
            torch.from_numpy(b["token_type_ids"])]
    with torch.no_grad():
        (_, nsp), new_state = TJ.functional_call(tm, state, *args)
        _, nsp0 = tm(*args)
    assert new_state is state
    assert not torch.allclose(nsp, nsp0)
    assert not tm.bert.pooler.dense.bias.detach().any()


def test_rng_scope_makes_dropout_a_function_of_the_seed():
    x = torch.ones(64, 64)
    layer_gen = torch.Generator().manual_seed(0)
    before = layer_gen.get_state()

    def draw(seed):
        with TFn.rng_scope(seed):
            return (TFn.dropout(x, 0.5, generator=layer_gen),
                    TFn._kernel_seed(layer_gen))

    (a, ka), (b, kb), (c, kc) = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and ka == kb
    assert not torch.equal(a, c) and ka != kc
    # inside a scope the layer's own generator is left alone
    assert torch.equal(layer_gen.get_state(), before)
    assert isinstance(ka, int) and 0 <= ka < 2 ** 31
