"""The 2.x `nn` and `nn.functional` signatures of the port against
paddle_tpu's, and the four repairs of the forms the port refused:
`F.dropout`'s (x, p, axis, training, mode) with `downscale_in_infer`,
`embedding`'s `padding_idx`, `TransformerEncoder`/`Decoder` built from a
layer instance, and `MultiHeadAttention`'s `kdim`, `vdim`,
`need_weights`, `weight_attr` and `bias_attr`.

For every public name of `nn` and `nn.functional` that both packages
have, the port's positional parameters start with the reference's, in
order (keyword-only extras such as `generator` and `weight_init` come
after them); `EXCEPTIONS` lists the names that differ, each with its
reason.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): a float32 transformer forward
of two layers whose only difference is the order of operations.  The
dropout and embedding checks are exact: they move or scale values by
one multiplication.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.jit import functional_state as j_state

import paddle_tpu_torch as T
from paddle_tpu_torch.convert import load_jax_state

F32 = dict(rtol=1e-5, atol=1e-6)

# name -> why its positional parameters differ from the reference's
EXCEPTIONS = {}

# public module attributes that are imports, not API
NOT_API = {"np", "Tensor", "trace_fn", "trace_op"}


@contextlib.contextmanager
def _fresh_jax_stream():
    """paddle_tpu's layers draw from one process-wide init stream; the
    models here come from a fresh copy of it, restored afterwards."""
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


def _positional(obj):
    sig = inspect.signature(obj)
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name not in ("self", "cls")]


def _shared(jmod, tmod):
    names = {n for n in dir(jmod) if not n.startswith("_")} & \
        {n for n in dir(tmod) if not n.startswith("_")}
    return sorted(n for n in names - NOT_API
                  if callable(getattr(jmod, n))
                  and not inspect.ismodule(getattr(jmod, n)))


@pytest.mark.parametrize("pkg", ["nn", "nn.functional"])
def test_shared_names_take_the_reference_positional_parameters(pkg):
    jmod = J.nn if pkg == "nn" else J.nn.functional
    tmod = T.nn if pkg == "nn" else T.nn.functional
    shared = _shared(jmod, tmod)
    assert len(shared) > (100 if pkg == "nn" else 130)
    wrong = {}
    for name in shared:
        want = _positional(getattr(jmod, name))
        got = _positional(getattr(tmod, name))
        if got[:len(want)] != want and f"{pkg}.{name}" not in EXCEPTIONS:
            wrong[name] = (want, got)
    assert not wrong


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- F.dropout and nn.Dropout ----------------------------------------------------

def test_dropout_downscale_in_infer_in_eval_is_the_reference_exactly():
    x = _x(4, 6)
    with Jdy.guard():
        want = J.nn.functional.dropout(J.to_tensor(x), 0.3, None, False,
                                       "downscale_in_infer").numpy()
    got = T.nn.functional.dropout(torch.from_numpy(x), 0.3, None, False,
                                  "downscale_in_infer")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x * np.float32(0.7))
    layer = T.nn.Dropout(0.3, mode="downscale_in_infer").eval()
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_identities_and_training_statistics(mode):
    """Eval of upscale_in_train and p=0 are the identity in both; in
    training the kept elements are x / (1 - p) or x and about p are
    dropped (within 5 standard errors of 20000 draws; torch's bits)."""
    x = np.ones((100, 200), np.float32)
    t = torch.from_numpy(x)
    F = T.nn.functional
    assert F.dropout(t, 0.0, None, True, mode) is t
    if mode == "upscale_in_train":
        assert F.dropout(t, 0.4, None, False, mode) is t
    out = F.dropout(t, 0.4, None, True, mode,
                    generator=torch.Generator().manual_seed(1)).numpy()
    kept = 1 / 0.6 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[out != 0], np.float32(kept))
    assert abs((out == 0).mean() - 0.4) < 5 * (0.24 / x.size) ** 0.5


def test_dropout_axis_raises_and_the_reference_mask_is_elementwise():
    """The reference's op reads no `axis`: with axis=1 its mask still
    varies along axis 0 (an axis-wise mask would repeat each column's
    draw down the rows).  The port raises on a non-None axis."""
    x = np.ones((64, 32), np.float32)
    with Jdy.guard():
        out = J.nn.functional.dropout(J.to_tensor(x), 0.5, axis=1).numpy()
    assert not (out == out[:1]).all(axis=0).all()
    assert 0.3 < (out == 0).mean() < 0.7
    with pytest.raises(NotImplementedError, match="axis"):
        T.nn.functional.dropout(torch.from_numpy(x), 0.5, axis=1)
    with pytest.raises(NotImplementedError, match="axis"):
        T.nn.Dropout(0.5, axis=[0])(torch.from_numpy(x))


# -- embedding -------------------------------------------------------------------

@pytest.mark.parametrize("padding_idx", [2, -1])
def test_embedding_padding_idx_as_the_reference(padding_idx):
    """nn.Embedding zeroes the weight row of `padding_idx` at
    construction (a negative index from the end, as the reference's
    numpy write); F.embedding zeroes the rows of ids equal to it as given
    (so -1 masks none); `sparse` gives the same dense result."""
    ids = np.array([[0, 2, 9], [2, 2, 5]], np.int64)
    with _fresh_jax_stream(), Jdy.guard():
        jl = J.nn.Embedding(10, 4, padding_idx=padding_idx)
        w = np.asarray(jl.weight.numpy())
        want = jl(J.to_tensor(ids)).numpy()
        want_f = J.nn.functional.embedding(
            J.to_tensor(ids), J.to_tensor(w), padding_idx=padding_idx,
            sparse=True).numpy()
    tl = T.nn.Embedding(10, 4, padding_idx=padding_idx)
    assert not tl.weight.detach()[padding_idx].any()
    assert not w[padding_idx].any()
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    got = tl(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    got_f = T.nn.functional.embedding(
        torch.from_numpy(ids), torch.from_numpy(w), padding_idx=padding_idx,
        sparse=True).numpy()
    np.testing.assert_array_equal(got_f, want_f)
    raw = T.nn.functional.embedding(torch.from_numpy(ids),
                                    torch.from_numpy(w)).numpy()
    masked = ids == padding_idx
    np.testing.assert_array_equal(got_f[~masked], raw[~masked])
    assert not got_f[masked].any()


# -- the transformer stacks ------------------------------------------------------

def _encoder_pair(num_layers=2, **kw):
    layer_kw = dict(dropout=0.0, **kw)
    with _fresh_jax_stream(), Jdy.guard():
        jm = J.nn.TransformerEncoder(
            J.nn.TransformerEncoderLayer(16, 2, 32, **layer_kw), num_layers)
        state = {k: np.asarray(v) for k, v in j_state(jm).items()}
    layer = T.nn.TransformerEncoderLayer(16, 2, 32, **layer_kw)
    tm = T.nn.TransformerEncoder(layer, num_layers)
    return jm, tm, layer, state


def test_transformer_encoder_from_an_instance_matches_the_reference():
    """Layer 0 is the instance given, the others fresh layers of its
    config (their own weights and names); after load_jax_state the
    forward equals the reference's."""
    jm, tm, layer, state = _encoder_pair(3)
    assert tm.layers[0] is layer and len(tm.layers) == 3
    w0, w1 = (tm.layers[i].linear1.weight for i in (0, 1))
    assert w0 is not w1 and not torch.equal(w0, w1)
    assert w0.name != w1.name
    load_jax_state(tm, state)
    x = _x(2, 5, 16)
    with Jdy.guard():
        want = jm(J.to_tensor(x)).numpy()
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_transformer_decoder_from_an_instance_and_a_factory():
    layer = T.nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0)
    dec = T.nn.TransformerDecoder(layer, 2)
    assert dec.layers[0] is layer and \
        type(dec.layers[1]) is T.nn.TransformerDecoderLayer
    made = T.nn.TransformerDecoder(
        lambda: T.nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0), 2)
    assert len(made.layers) == 2 and made.layers[0] is not made.layers[1]
    out = dec(torch.randn(2, 3, 16), torch.randn(2, 4, 16))
    assert out.shape == (2, 3, 16)


def test_weight_and_bias_attr_reach_every_projection():
    """bias_attr=False leaves out every bias of the layer in both
    packages, with the same parameter names."""
    jm, tm, _, state = _encoder_pair(1, bias_attr=False)
    assert set(state) == set(dict(tm.named_parameters()))
    assert not any(n.endswith("proj.bias") or n.endswith("linear1.bias")
                   for n in state)
    load_jax_state(tm, state)
    x = _x(2, 4, 16, seed=3)
    with Jdy.guard():
        want = jm(J.to_tensor(x)).numpy()
    np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach()
                               .numpy(), want, **F32)
    tr = T.nn.Transformer(16, 2, 1, 1, 32, dropout=0.0, weight_attr=None,
                          bias_attr=False)
    assert all(not n.endswith("linear2.bias")
               for n, _ in tr.named_parameters())


def test_multi_head_attention_kdim_vdim_as_the_reference():
    q, k, v = _x(2, 3, 16), _x(2, 5, 12, seed=1), _x(2, 5, 10, seed=2)
    with _fresh_jax_stream(), Jdy.guard():
        jm = J.nn.MultiHeadAttention(16, 4, kdim=12, vdim=10)
        state = {k_: np.asarray(t) for k_, t in j_state(jm).items()}
        want = jm(J.to_tensor(q), J.to_tensor(k), J.to_tensor(v))
        assert not isinstance(want, (tuple, list))  # need_weights unused
        want = want.numpy()
    tm = load_jax_state(T.nn.MultiHeadAttention(16, 4, 0.0, 12, 10, False),
                        state)
    assert tuple(tm.k_proj.weight.shape) == (12, 16)
    got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)


def test_need_weights_is_stored_by_the_reference_and_raises_in_the_port():
    with Jdy.guard():
        jm = J.nn.MultiHeadAttention(8, 2, need_weights=True)
        out = jm(J.to_tensor(_x(1, 3, 8)))
    assert jm.need_weights and not isinstance(out, (tuple, list))
    with pytest.raises(NotImplementedError, match="need_weights"):
        T.nn.MultiHeadAttention(8, 2, need_weights=True)


def test_parameter_takes_the_reference_signature():
    p = T.nn.Parameter(torch.ones(3), "w_extra", False)
    assert p.name == "w_extra" and not p.trainable and p.stop_gradient
    assert _positional(T.nn.Parameter)[:3] == ["value", "name", "trainable"]
