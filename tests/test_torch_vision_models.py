"""VGG and MobileNet V1/V2 of the port against paddle_tpu.vision.models on
the CPU, after tests/test_torch_resnet.py: mobilenet_v2(scale=0.25),
mobilenet_v1(scale=0.25) at B=2, 3 x 64 x 64 and vgg11(batch_norm=True)
at B=2, 3 x 32 x 32, 10 classes, with the JAX model's weights and
running statistics carried over by `convert.load_jax_state`.  Eval
logits; train logits, the loss, every gradient of it (the reference's
through `jax.value_and_grad`) and the running statistics after the
train forward (for the MobileNets in float64 in both and the port's
float32 against that; for VGG in float32), with dropout at 0 (eager dropout bits cannot be reproduced); the
state's names and shapes; `_make_divisible`; the full-size models'
parameter counts.

Tolerances.  TOL64 (atol 1e-10, rtol 1e-9): the same values in float64,
where only the summation order separates them.  TOL32 (atol 1e-4, rtol
1e-4): float32 values against that float64 truth (convolution sums,
batch statistics over as few as 8 values a channel) through up to 20
layers, each renormalised by a train-mode BN.  float32 gradients by
their relative L2 error, within KINK (5e-2): a ReLU6 input within f32
rounding of a kink (0 or 6) moves a whole term of a gradient sum, as in
the ResNet test; the BN weights in front of the first ReLU6s have small
gradients that are sums of cancelling terms, so one term moves them by
up to 3.5 % here (mobilenet_v1's features.0.bn.weight).  A gradient that is 0 in exact arithmetic (a BN bias
whose output reaches the loss only through a linear layer and another
train-mode BN, which takes the channel's mean off: the projections of
MobileNetV2) is rounding noise: under 1e-10 in float64, and held under
ZERO32 (1e-4, the noise of float32 sums over the batch and map) in the
port's float32.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.jit import functional_call as j_call
from paddle_tpu.jit import functional_state as j_state
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.jit import functional_state as t_state
from paddle_tpu_torch.vision import models as TM

TOL32 = dict(atol=1e-4, rtol=1e-4)
TOL64 = dict(atol=1e-10, rtol=1e-9)
KINK = 5e-2
ZERO32 = 1e-4
# name -> (builder, image side, the dtype of the truth the port's f32 is
# held against: the MobileNets' small BN gradients need float64's,
# VGG's 128 M parameters (its classifier keeps 4096 x 4096) take the
# reference's float32, as tests/test_torch_resnet.py holds ResNets)
MODELS = {
    "mobilenet_v2": (lambda m, **kw: m.mobilenet_v2(
        scale=0.25, num_classes=10, **kw), 64, "float64"),
    "mobilenet_v1": (lambda m, **kw: m.mobilenet_v1(
        scale=0.25, num_classes=10, **kw), 64, "float64"),
    "vgg11_bn": (lambda m, **kw: m.vgg11(batch_norm=True, num_classes=10,
                                         **kw), 32, "float32"),
}


def _is_buf(k):
    return k.endswith("._mean") or k.endswith("._variance")


@contextlib.contextmanager
def _fresh_jax_stream():
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


def _no_dropout(model):
    for m in model.sublayers() if hasattr(model, "sublayers") else []:
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return model


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(name, JAX model, its state as numpy, a fresh-port factory, the
    image side)."""
    make, hw, _ = MODELS[request.param]
    with _fresh_jax_stream():
        jm = _no_dropout(make(JM))
    state = {k: np.asarray(v) for k, v in j_state(jm).items()}
    rng = np.random.RandomState(1)
    for k in state:  # running statistics other than the defaults
        if _is_buf(k):
            state[k] = state[k] + rng.rand(*state[k].shape).astype(
                np.float32) * 0.5

    def port():
        return _no_dropout(load_jax_state(make(TM, device="cpu"), state))

    return request.param, jm, state, port, hw


def _batch(seed, hw):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, hw, hw).astype(np.float32),
            rng.randint(0, 10, 2).astype(np.int64))


def test_state_keys_and_shapes_match(pair):
    _, _, state, port, _ = pair
    got = {k: tuple(v.shape) for k, v in t_state(port()).items()}
    assert got == {k: tuple(v.shape) for k, v in state.items()}


def test_eval_logits_match(pair):
    _, jm, state, port, hw = pair
    x, _ = _batch(2, hw)
    jm.eval()
    want, _ = jax.jit(lambda s, x: j_call(jm, s, x))(state, jnp.asarray(x))
    with torch.no_grad():
        got = port().eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def _reference_train(jm, state, x, y, dtype):
    """The reference's train forward in `dtype`: logits, loss, gradients
    by jax.value_and_grad, the new running statistics."""
    jm.train()
    state = {k: v.astype(dtype) for k, v in state.items()}
    params = {k: v for k, v in state.items() if not _is_buf(k)}
    bufs = {k: v for k, v in state.items() if _is_buf(k)}

    def loss_fn(p, x, y):
        logits, new = j_call(jm, {**p, **bufs}, x)
        ll = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(ll, y[:, None], axis=1).mean(), \
            (logits, new)

    with jax.enable_x64(dtype == "float64"):
        (loss, (logits, new)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(x.astype(dtype)),
                                    jnp.asarray(y))
        return (np.asarray(logits), float(loss),
                {k: np.asarray(v) for k, v in grads.items()},
                {k: np.asarray(v) for k, v in new.items()})


def _port_train(port, x, y, dtype):
    tm = port().to(getattr(torch, dtype)).train()
    logits = tm(torch.from_numpy(x.astype(dtype)))
    loss = -torch.log_softmax(logits, -1).gather(
        1, torch.from_numpy(y)[:, None]).mean()
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return (logits.detach().numpy(), float(loss.detach()),
            {k: g.numpy() for k, g in zip(named, grads)},
            {k: b.numpy() for k, b in tm.named_buffers()})


def test_train_logits_gradients_and_running_stats_match(pair):
    """For the MobileNets, float64 in both packages: logits, loss, every
    gradient and the running statistics within TOL64; the port's float32
    against that truth (the reference's float32 batch statistics take
    E[x^2] - E[x]^2, ROADMAP queue 3, whose cancellation moves the small
    BN gradients of these narrow models by up to 9.5 %).  For VGG the
    truth is the reference's float32.  Logits, loss and statistics
    within TOL32, gradients within KINK in relative L2, those 0 in exact
    arithmetic (under 1e-10 in float64) under ZERO32."""
    name, jm, state, port, hw = pair
    x, y = _batch(3, hw)
    truth = MODELS[name][2]
    want = _reference_train(jm, state, x, y, truth)
    got32 = _port_train(port, x, y, "float32")
    got64 = got32 if truth == "float32" else _port_train(port, x, y, truth)
    tol = TOL64 if truth == "float64" else TOL32
    np.testing.assert_allclose(got64[0], want[0], **tol)
    np.testing.assert_allclose(got64[1], want[1], **tol)
    np.testing.assert_allclose(got32[0], want[0], **TOL32)
    np.testing.assert_allclose(got32[1], want[1], **TOL32)
    assert set(got64[2]) == set(want[2])
    zeros = 0
    for k, w in want[2].items():
        if truth == "float64":
            np.testing.assert_allclose(got64[2][k], w, err_msg=k, **TOL64)
        g = got32[2][k]
        if np.abs(w).max() < (1e-10 if truth == "float64" else ZERO32 / 10):
            zeros += 1
            assert np.abs(g).max() < ZERO32, k
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert err <= KINK, (k, err)
    assert zeros <= 20
    for k in got32[3]:
        b = want[3][k]
        np.testing.assert_allclose(got64[3][k], b, err_msg=k, **tol)
        np.testing.assert_allclose(got32[3][k], b, err_msg=k, **TOL32)
        assert not np.allclose(got32[3][k], state[k])


@pytest.mark.parametrize("v,want", [(32 * 0.25, 8), (16 * 0.5, 8),
                                    (24 * 0.35, 8), (1280 * 1.3, 1664),
                                    (96 * 0.75, 72), (13, 16)])
def test_make_divisible_as_the_reference(v, want):
    assert TM._make_divisible(v) == JM._make_divisible(v) == want


def test_full_size_parameter_counts():
    """mobilenet_v2() and vgg16() at their published widths: 3,504,872
    and 138,357,544 parameters (the chip phase trains these two)."""
    for make, n in ((TM.mobilenet_v2, 3504872), (TM.vgg16, 138357544)):
        model = make(device="cpu")
        assert sum(p.numel() for p in model.parameters()) == n
        del model
