"""The port's BERT against paddle_tpu's, on the CPU in float32: weights
carried over by `convert.load_jax_state`, the same numpy batch through
both, dropout 0 in eval mode.  Also the nn surface the model rides on,
the loader's checks and the device rule (CUDA by default, raise without
it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit import functional_call, functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.ops import nn_ops  # noqa: F401 - registers layer_norm
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.nn import functional as TFn
from paddle_tpu_torch.nn import initializer as TI

# f32 on both sides through two encoder layers and the heads
ATOL = RTOL = 1e-4

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def pair():
    """(jax model, its numpy state, port model with that state)."""
    paddle.seed(3)
    jm = JB.BertForPretraining(JB.BertConfig.tiny(**NO_DROP))
    jm.eval()
    state = {k: np.asarray(v) for k, v in functional_state(jm).items()}
    tm = TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP), device="cpu")
    tm.eval()
    load_jax_state(tm, state)
    return jm, state, tm


def _batch(seed, b=3, s=32):
    return JB.fake_batch(JB.BertConfig.tiny(), b, s, num_masked=5,
                         seed=seed)


def _mask4(am):
    return (am != 0)[:, None, None, :]


def _port(fn, *arrays, **kw):
    with torch.no_grad():
        return fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)


def test_pretraining_heads_match_jax(pair):
    jm, state, tm = pair
    b = _batch(1)
    (mlm, nsp), _ = functional_call(
        jm, state, b["input_ids"], b["token_type_ids"],
        attention_mask=_mask4(b["attention_mask"]),
        masked_positions=b["masked_positions"])
    tmlm, tnsp = _port(tm, b["input_ids"], b["token_type_ids"],
                       _mask4(b["attention_mask"]), b["masked_positions"])
    np.testing.assert_allclose(tmlm.numpy(), np.asarray(mlm), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tnsp.numpy(), np.asarray(nsp), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mask_form", ["bool4", "none"])
def test_encoder_and_pooler_match_jax(pair, mask_form):
    jm, state, tm = pair
    b = _batch(2, b=2, s=24)
    am = _mask4(b["attention_mask"]) if mask_form == "bool4" else None
    bert_state = {k[len("bert."):]: v for k, v in state.items()
                  if k.startswith("bert.")}
    (enc, pooled), _ = functional_call(jm.bert, bert_state, b["input_ids"],
                                       b["token_type_ids"],
                                       attention_mask=am)
    tenc, tpooled = _port(
        lambda ids, tt: tm.bert(ids, tt, attention_mask=None if am is None
                                else torch.from_numpy(am)),
        b["input_ids"], b["token_type_ids"])
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled),
                               atol=ATOL, rtol=RTOL)


def test_bert_model_alone_matches_jax():
    """BertModel (no heads) built on its own, as the serving path uses
    it."""
    paddle.seed(5)
    jm = JB.BertModel(JB.BertConfig.tiny(**NO_DROP))
    jm.eval()
    state = {k: np.asarray(v) for k, v in functional_state(jm).items()}
    tm = load_jax_state(TB.BertModel(TB.BertConfig.tiny(**NO_DROP),
                                     device="cpu"), state).eval()
    b = _batch(3, b=2, s=16)
    am = _mask4(b["attention_mask"])
    (enc, pooled), _ = functional_call(jm, state, b["input_ids"],
                                       b["token_type_ids"],
                                       attention_mask=am)
    tenc, tpooled = _port(lambda i, t, m: tm(i, t, attention_mask=m),
                          b["input_ids"], b["token_type_ids"], am)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(pooled),
                               atol=ATOL, rtol=RTOL)


def test_parameter_names_and_shapes_match_jax(pair):
    _, state, tm = pair
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == {k: v.shape for k, v in state.items()}
    assert got["bert.encoder.layers.0.linear1.weight"] == (64, 128)


# -- the loader -------------------------------------------------------------------

def _fresh_port():
    return TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                                 device="cpu")


def test_loader_keeps_the_tie(pair):
    _, state, _ = pair
    tm = load_jax_state(_fresh_port(), state)
    assert tm.cls.decoder_weight is \
        tm.bert.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(
        tm.cls.decoder_weight.detach().numpy(),
        state["bert.embeddings.word_embeddings.weight"])


def test_loader_raises_on_missing_key(pair):
    _, state, _ = pair
    bad = dict(state)
    del bad["cls.decoder_bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(_fresh_port(), bad)


def test_loader_raises_on_unexpected_key(pair):
    _, state, _ = pair
    bad = dict(state, **{"cls.extra.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state(_fresh_port(), bad)
    load_jax_state(_fresh_port(), bad, strict=False)


def test_loader_raises_on_shape_mismatch(pair):
    _, state, _ = pair
    bad = dict(state)
    name = "bert.encoder.layers.1.self_attn.q_proj.weight"
    bad[name] = bad[name].T[:, :32]
    tm = _fresh_port()
    before = tm.bert.pooler.dense.weight.detach().clone()
    with pytest.raises(ValueError, match="q_proj"):
        load_jax_state(tm, bad)
    # nothing was written before the check failed
    torch.testing.assert_close(tm.bert.pooler.dense.weight.detach(), before)


# -- the nn surface -----------------------------------------------------------

def test_layer_norm_matches_paddle_formula():
    from paddle_tpu.nn import functional as JFn
    from paddle_tpu.nn.layer.layers import Tensor

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = JFn.layer_norm(Tensor(x), 32, Tensor(w), Tensor(bias)).numpy()
    got = TFn.layer_norm(torch.from_numpy(x), 32, torch.from_numpy(w),
                         torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.linspace(-8, 8, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approximate))
    got = TFn.gelu(torch.from_numpy(x), approximate=approximate)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_dropout_is_identity_in_eval_and_upscales_in_train():
    x = torch.ones(1000)
    assert TFn.dropout(x, 0.3, training=False) is x
    y = TFn.dropout(x, 0.3, training=True,
                    generator=torch.Generator().manual_seed(0))
    kept = y[y != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.7))
    assert 600 < kept.numel() < 800


def test_initializers_draw_from_the_generator():
    def draw(init, seed):
        return init((64, 32), torch.Generator().manual_seed(seed))

    for init in (TI.Normal(0, 1), TI.TruncatedNormal(0, 0.02), TI.Xavier()):
        torch.testing.assert_close(draw(init, 1), draw(init, 1))
        assert not torch.equal(draw(init, 1), draw(init, 2))
    t = draw(TI.TruncatedNormal(0, 0.02), 3)
    assert t.abs().max() <= 0.04
    assert draw(TI.Xavier(), 4).abs().max() <= (6 / 96) ** 0.5
    assert torch.equal(TI.Constant(0.5)((3,)), torch.full((3,), 0.5))


def test_same_seed_same_weights():
    a = TB.BertModel(TB.BertConfig.tiny(), device="cpu", seed=9)
    b = TB.BertModel(TB.BertConfig.tiny(), device="cpu", seed=9)
    c = TB.BertModel(TB.BertConfig.tiny(), device="cpu", seed=10)
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.pooler.dense.weight, c.pooler.dense.weight)


def test_fake_batch_matches_jax():
    want = JB.fake_batch(JB.BertConfig.tiny(), 4, 64, seed=11)
    got = TB.fake_batch(TB.BertConfig.tiny(), 4, 64, seed=11)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_moe_config_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        TB.BertModel(TB.BertConfig.tiny(moe_experts=4), device="cpu")


# -- the device rule ------------------------------------------------------------

def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-device rule cannot fail")


def test_default_device_raises_without_cuda():
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.BertModel(TB.BertConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.set_device("gpu:0")


def test_named_cpu_device_is_used():
    m = TB.BertModel(TB.BertConfig.tiny(), device="cpu",
                     dtype=torch.bfloat16)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
