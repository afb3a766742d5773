"""The port's ResNet family against paddle_tpu.vision.models on the CPU:
resnet18(num_classes=10) and a bottleneck ResNet(BottleneckBlock,
[1, 1, 1, 1], 10) at B=2, 3 x 64 x 64, with the JAX model's weights and
running statistics carried over by `convert.load_jax_state`.  Eval and
train logits, the loss, every gradient of it through
`jax.value_and_grad`, the BN running statistics after a train forward,
and three steps of `vision.train.build_train_step(bf16=False)` against
the same momentum step written here in JAX from bench.py:1104-1133
(`bench_resnet50`), at lr 0.01 (at bench's 0.1 two images are memorised
in one step and the next losses are 0).  Last, bench's own step at its
lr 0.1 and bf16 cast, on resnet50 cut to B=16 and 3 x 32 x 32 images
(1000 classes, as bench), in both packages: the shape of the loss curve
that chip_smoke.py's ResNet phase sees at full size.

Tolerances.  TOL32 (atol 1e-4, rtol 1e-4): float32 values that only the
summation order separates (convolution sums of up to 4608 products,
batch statistics over as few as 2 x 2 x 2 values, E[x^2] - E[x]^2
against a two-pass variance) through up to 20 layers; train-mode BN
renormalises every layer, so the error does not grow with depth.
TOL64 (atol 1e-10, rtol 1e-9): the same in float64, where the two agree
to 1e-13.  float32 gradients, velocities and running statistics after
steps are held by their relative L2 error, within KINK (2e-2): a ReLU
whose input lies within f32 rounding of 0 takes the other side in one
of the two, which moves one term of a gradient sum by a whole term
(measured: up to 2.6 % of a tensor's largest entry, and up to 0.87 % in
relative L2; none in float64).  Parameters after 3 steps: PARAMS32
(atol 1e-3, rtol 1e-3), lr 0.01 times such a velocity difference.

The images are 64 x 64, not 32 x 32: at 32 x 32 layer4 works on 1 x 1
maps, so its train-mode BN normalises two values a channel, and the
f32 logits then move by 0.08 with the summation order (8e-5 at B=4,
2e-5 at 64 x 64).
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
from paddle_tpu_torch.vision.train import build_train_step

TOL32 = dict(atol=1e-4, rtol=1e-4)
TOL64 = dict(atol=1e-10, rtol=1e-9)
PARAMS32 = dict(atol=1e-3, rtol=1e-3)
KINK = 2e-2
LR, MOMENTUM, STEPS = 0.01, 0.9, 3
BENCH_LR, RISE_STEPS, RISE_BATCH, RISE_HW = 0.1, 3, 16, 32
MODELS = {
    "resnet18": lambda m: m.resnet18(num_classes=10),
    "bottleneck": lambda m: m.ResNet(m.BottleneckBlock, [1, 1, 1, 1], 10),
}


def _is_buf(k):
    return k.endswith("._mean") or k.endswith("._variance")


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, 64, 64).astype(np.float32),
            rng.randint(0, 10, 2).astype(np.int64))


@contextlib.contextmanager
def _fresh_jax_stream():
    """paddle_tpu draws a new layer's weights from one process-wide
    stream (`fluid.initializer._eager_seed`: a base seed and a counter
    that every parameter made so far has advanced).  Under `pytest -n
    --dist loadfile` this file shares its process with other test files,
    so the JAX models' weights, and with them how far a ReLU kink flip
    moves an f32 gradient, would depend on what ran before.  Each model
    here is drawn from a fresh process's stream, which is restored
    afterwards."""
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(name, JAX model, its state as numpy, a fresh-port factory)."""
    with _fresh_jax_stream():
        jm = MODELS[request.param](JM)
    state = {k: np.asarray(v) for k, v in j_state(jm).items()}
    # running statistics that are not the 0 / 1 defaults, so that
    # carrying them over is checked too
    rng = np.random.RandomState(1)
    for k in state:
        if _is_buf(k):
            state[k] = (state[k] + rng.rand(*state[k].shape)
                        .astype(np.float32) * 0.5)

    def port():
        return load_jax_state(MODELS[request.param](_CPU), state)

    return request.param, jm, state, port


class _CPU:
    """TM's builders with device="cpu"."""
    resnet18 = staticmethod(lambda **kw: TM.resnet18(device="cpu", **kw))
    BottleneckBlock = TM.BottleneckBlock

    @staticmethod
    def ResNet(*a):
        return TM.ResNet(*a, device="cpu")


def _loss_j(logits, y):
    ll = jax.nn.log_softmax(logits.astype(jnp.promote_types(logits.dtype,
                                                            jnp.float32)))
    return -jnp.take_along_axis(ll, y[:, None], axis=1).mean()


def test_state_keys_and_shapes_match(pair):
    _, _, state, port = pair
    got = {k: tuple(v.shape) for k, v in t_state(port()).items()}
    assert got == {k: tuple(v.shape) for k, v in state.items()}
    assert any(k.endswith("downsample.1._mean") for k in got)


def test_eval_logits_match(pair):
    _, jm, state, port = pair
    x, _ = _batch(2)
    jm.eval()
    want, _ = jax.jit(lambda s, x: j_call(jm, s, x))(state, jnp.asarray(x))
    tm = port().eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def _close_kinked(got, want, err_msg):
    """The relative L2 error within KINK (ReLU kink flips)."""
    err = float(np.linalg.norm(got - want)) / float(np.linalg.norm(want))
    assert err <= KINK, (err_msg, err)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_logits_gradients_and_running_stats_match(pair, dtype):
    _, jm, state, port = pair
    x, y = _batch(3)
    jm.train()
    state = {k: v.astype(dtype) for k, v in state.items()}
    x = x.astype(dtype)
    params = {k: v for k, v in state.items() if not _is_buf(k)}
    bufs = {k: v for k, v in state.items() if _is_buf(k)}

    def loss_fn(p, x, y):
        logits, new = j_call(jm, {**p, **bufs}, x)
        return _loss_j(logits, y), (logits, new)

    with jax.enable_x64(dtype == "float64"):
        (loss, (logits, new)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(x), jnp.asarray(y))
        assert logits.dtype == dtype
    tm = port().to(getattr(torch, dtype)).train()
    t_logits = tm(torch.from_numpy(x))
    t_loss = -torch.log_softmax(t_logits, -1).gather(
        1, torch.from_numpy(y)[:, None]).mean()
    named = dict(tm.named_parameters())
    t_grads = torch.autograd.grad(t_loss, list(named.values()))
    tol = TOL64 if dtype == "float64" else TOL32
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits),
                               **tol)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), **tol)
    assert set(named) == set(grads)
    for (k, _), g in zip(named.items(), t_grads):
        if dtype == "float64":
            np.testing.assert_allclose(g.numpy(), np.asarray(grads[k]),
                                       err_msg=k, **tol)
        else:
            _close_kinked(g.numpy(), np.asarray(grads[k]), k)
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(new[k]), err_msg=k,
                                   **tol)
        assert not np.allclose(b.numpy(), state[k])  # the stats moved


def _jax_steps(jm, state, x, y, lr=LR, steps=STEPS, bf16=False):
    """bench.py:1104-1133's step: value_and_grad through functional_call
    (on a bf16 cast of the parameters and images with `bf16`, as bench
    runs on the chip; buffers stay f32), vel = m vel + g, p -= lr vel,
    running statistics from the forward."""
    jm.train()
    params = {k: jnp.asarray(v) for k, v in state.items()}
    vel = {k: jnp.zeros_like(v) for k, v in params.items() if not _is_buf(k)}

    def loss_fn(p, x, y):
        if bf16:
            p = {k: v if _is_buf(k) else v.astype(jnp.bfloat16)
                 for k, v in p.items()}
        logits, new_state = j_call(jm, p, x)
        bufs = {k: v.astype(jnp.float32) for k, v in new_state.items()
                if _is_buf(k)}
        return _loss_j(logits, y), bufs

    def step(state, x, y):
        p = state["params"]
        (loss, bufs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, x, y)
        new_vel = {k: MOMENTUM * state["vel"][k] + grads[k]
                   for k in state["vel"]}
        new_p = {k: (bufs[k] if k in bufs else
                     (v - lr * new_vel[k] if k in new_vel else v))
                 for k, v in p.items()}
        return {"params": new_p, "vel": new_vel}, loss

    step = jax.jit(step)
    st, losses = {"params": params, "vel": vel}, []
    x = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    for _ in range(steps):
        st, loss = step(st, x, jnp.asarray(y))
        losses.append(float(loss))
    return st, losses


def test_momentum_steps_match(pair):
    _, jm, state, port = pair
    x, y = _batch(4)
    want, want_losses = _jax_steps(jm, state, x, y)
    tm = port().train()
    step_fn, st = build_train_step(tm, lr=LR, momentum=MOMENTUM, bf16=False)
    assert set(st["vel"]) == set(want["vel"])  # parameters only
    losses = []
    for _ in range(STEPS):
        st, loss = step_fn(st, x, y)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, **TOL32)
    assert losses[-1] < losses[0]
    assert set(st["params"]) == set(want["params"])
    for k, v in st["params"].items():
        if _is_buf(k):
            _close_kinked(v.numpy(), np.asarray(want["params"][k]), k)
        else:
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(want["params"][k]),
                                       err_msg=k, **PARAMS32)
    for k, v in st["vel"].items():
        _close_kinked(v.numpy(), np.asarray(want["vel"][k]), k)


def test_bench_lr_loss_falls_then_rises():
    """bench_resnet50's step at its own lr 0.1, bf16 over f32 masters, one
    batch for every step, cut to resnet50(num_classes=1000) at B=16 and
    3 x 32 x 32 for 3 steps, from the port's seed-0 weights: in
    paddle_tpu's step and in the port's `build_train_step` the loss falls
    after the first step and rises again after the second, as
    chip_smoke.py's ResNet phase sees at B=128, 224 x 224 (there from
    step 3, swinging until about step 25).  The curves are held by that shape, not
    value by value: in bf16 the two packages round in other places
    through 50 layers, so their first losses differ by a few percent
    (though their f32 losses agree, as the tests above hold), and lr 0.1
    lets a difference in the first update grow step by step."""
    jm = JM.resnet50(num_classes=1000)
    tm = TM.resnet50(num_classes=1000, device="cpu", seed=0).train()
    state = {k: v.detach().numpy().copy() for k, v in t_state(tm).items()}
    rng = np.random.RandomState(0)
    x = rng.randn(RISE_BATCH, 3, RISE_HW, RISE_HW).astype(np.float32)
    y = rng.randint(0, 1000, RISE_BATCH).astype(np.int64)
    _, want = _jax_steps(jm, state, x, y, lr=BENCH_LR, steps=RISE_STEPS,
                         bf16=True)
    step_fn, st = build_train_step(tm, lr=BENCH_LR, momentum=MOMENTUM,
                                   bf16=True)
    got = []
    for _ in range(RISE_STEPS):
        st, loss = step_fn(st, x, y)
        got.append(float(loss))
    for losses in (want, got):
        assert np.isfinite(losses).all(), (want, got)
        assert losses[1] < losses[0] and losses[2] > losses[1], (want, got)
