"""The port's `paddle.optimizer` and `optimizer.lr` against paddle_tpu's
on the CPU.

The same small network (two Linear layers, one weight with a learning-
rate multiplier of 0.5 through ParamAttr) is built in both packages
under a fresh `unique_name.guard()`, so its parameters carry the same
names, and given the same numpy weights.  Three steps, each with the
same seeded numpy gradients, go through every optimizer with coupled L2
decay (a float `weight_decay`), decoupled decay (AdamW's, with
`apply_decay_param_fun`; Lamb's, with `exclude_from_weight_decay_fn`)
and each of the three grad clips.  Parameters and every state tensor
agree within F32 (rtol 1e-5, atol 1e-7): both run the same float32
formulas in the same order, and only the rounding of fused or reordered
float32 operations separates them (a few units in the last place after
three steps).

The 12 schedulers (13 classes with their base) agree exactly over 50
steps: the same Python arithmetic on the host.  `.pdopt` files written
by either package load in the other.  A `weight_decay` that is not a
float (a `regularizer.L2Decay` object) is ignored by both, as the
reference does (ROADMAP queue 3 item 8).
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as J
from paddle_tpu import framework_io as JIO
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.fluid.param_attr import ParamAttr as JAttr
from paddle_tpu.fluid.regularizer import L2Decay as JL2
from paddle_tpu.optimizer import lr as Jlr

import paddle_tpu_torch as T
from paddle_tpu_torch import framework_io as TIO
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.fluid.param_attr import ParamAttr as TAttr
from paddle_tpu_torch.fluid.regularizer import L2Decay as TL2
from paddle_tpu_torch.optimizer import lr as Tlr

F32 = dict(rtol=1e-5, atol=1e-7)
STEPS = 3


@pytest.fixture(autouse=True)
def _leave_global_rngs():
    """Leave numpy's and torch's global generators as each test found
    them: other files' tests in this process draw from them."""
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _net(pkg, attr):
    """Linear(4, 3) whose weight has a learning-rate multiplier of 0.5,
    then Linear(3, 2), as one Sequential."""
    return pkg.nn.Sequential(
        pkg.nn.Linear(4, 3, weight_attr=attr(learning_rate=0.5)),
        pkg.nn.Linear(3, 2))


@contextlib.contextmanager
def fresh_jax_stream():
    """paddle_tpu draws a layer's weights from one process-wide stream;
    draw from a fresh one and restore it (ROADMAP queue 3 item 6)."""
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


@pytest.fixture
def nets():
    """(reference net, port net) with the same names and weights."""
    with fresh_jax_stream(), JU.guard():
        jnet = _net(J, JAttr)
    with TU.guard():
        tnet = _net(T, TAttr)
    rng = np.random.RandomState(0)
    for jp, tp in zip(jnet.parameters(), tnet.parameters()):
        assert jp.name == tp.name
        v = rng.randn(*jp.shape).astype(np.float32)
        jp.set_value(v)
        with torch.no_grad():
            tp.copy_(torch.from_numpy(v))
    return jnet, tnet


def _grads(step, params):
    rng = np.random.RandomState(100 + step)
    return [(rng.randn(*p.shape) * 3).astype(np.float32) for p in params]


def _step_both(jopt, topt, jnet, tnet, step):
    for jp, tp, g in zip(jnet.parameters(), tnet.parameters(),
                         _grads(step, list(tnet.parameters()))):
        jp._grad = jnp.asarray(g)
        tp.grad = torch.from_numpy(g.copy())
    jopt.step()
    topt.step()


def _close_state(jopt, topt, jnet, tnet, tol=F32):
    for jp, tp in zip(jnet.parameters(), tnet.parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), **tol,
                                   err_msg=tp.name)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert sorted(jsd) == sorted(tsd)
    assert jsd["global_step"] == tsd["global_step"]
    for k, v in jsd.items():
        if k in ("global_step", "LR_Scheduler"):
            continue
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v.numpy()),
                                   **tol, err_msg=k)


def _decay_fn(name):
    return name.endswith("w_0")


OPTIMIZERS = {
    "sgd": lambda m, ps, **kw: m.SGD(0.1, parameters=ps, **kw),
    "momentum": lambda m, ps, **kw: m.Momentum(0.1, 0.9, parameters=ps,
                                               **kw),
    "nesterov": lambda m, ps, **kw: m.Momentum(0.1, 0.9, parameters=ps,
                                               use_nesterov=True, **kw),
    "adam": lambda m, ps, **kw: m.Adam(0.01, parameters=ps, **kw),
    "adamax": lambda m, ps, **kw: m.Adamax(0.01, parameters=ps, **kw),
    "adagrad": lambda m, ps, **kw: m.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1, **kw),
    "adadelta": lambda m, ps, **kw: m.Adadelta(1.0, parameters=ps, **kw),
    "rmsprop": lambda m, ps, **kw: m.RMSProp(0.01, parameters=ps,
                                             momentum=0.5, **kw),
    "rmsprop_centered": lambda m, ps, **kw: m.RMSProp(
        0.01, parameters=ps, centered=True, **kw),
}
DECOUPLED = {
    "adamw": lambda m, ps, **kw: m.AdamW(
        0.01, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=_decay_fn, **kw),
    "lamb": lambda m, ps, **kw: m.Lamb(
        0.01, lamb_weight_decay=0.05, parameters=ps,
        exclude_from_weight_decay_fn=lambda n: n.endswith("b_0"), **kw),
}
CLIPS = {
    "none": lambda m: None,
    "global_norm": lambda m: m.ClipGradByGlobalNorm(1.0),
    "norm": lambda m: m.ClipGradByNorm(0.5),
    "value": lambda m: m.ClipGradByValue(0.7),
}
CASES = ([(o, "none", 1e-3) for o in OPTIMIZERS]
         + [(o, "global_norm", None) for o in OPTIMIZERS]
         + [(o, c, 1e-3) for o in ("momentum", "adam")
            for c in ("norm", "value")]
         + [(o, c, None) for o in DECOUPLED for c in ("none", "global_norm")])


@pytest.mark.parametrize("name,clip,decay", CASES,
                         ids=[f"{o}-{c}-{'l2' if d else 'no_l2'}"
                              for o, c, d in CASES])
def test_three_steps_match(nets, name, clip, decay):
    jnet, tnet = nets
    make = {**OPTIMIZERS, **DECOUPLED}[name]
    kw = {} if decay is None else {"weight_decay": decay}
    jopt = make(J.optimizer, jnet.parameters(),
                grad_clip=CLIPS[clip](J.optimizer), **kw)
    topt = make(T.optimizer, tnet.parameters(),
                grad_clip=CLIPS[clip](T.optimizer), **kw)
    for step in range(STEPS):
        _step_both(jopt, topt, jnet, tnet, step)
    _close_state(jopt, topt, jnet, tnet)


def test_lr_scheduler_and_multiplier(nets):
    """Momentum over a StepDecay stepped between steps: the rate and the
    multiplier both scale the step."""
    jnet, tnet = nets
    jopt = J.optimizer.Momentum(Jlr.StepDecay(0.1, 2, 0.5), 0.9,
                                parameters=jnet.parameters())
    topt = T.optimizer.Momentum(Tlr.StepDecay(0.1, 2, 0.5), 0.9,
                                parameters=tnet.parameters())
    for step in range(STEPS):
        _step_both(jopt, topt, jnet, tnet, step)
        jopt._learning_rate.step()
        topt._learning_rate.step()
        assert jopt.get_lr() == topt.get_lr()
    _close_state(jopt, topt, jnet, tnet)
    assert jopt.state_dict()["LR_Scheduler"] == \
        topt.state_dict()["LR_Scheduler"]


def test_l2decay_object_is_ignored(nets):
    """The reference's quirk, kept: `weight_decay=L2Decay(0.1)` (not a
    float) applies no decay, in both packages."""
    jnet, tnet = nets
    jopt = J.optimizer.Momentum(0.1, 0.9, parameters=jnet.parameters(),
                                weight_decay=JL2(0.1))
    topt = T.optimizer.Momentum(0.1, 0.9, parameters=tnet.parameters(),
                                weight_decay=TL2(0.1))
    plain = T.optimizer.Momentum(0.1, 0.9, parameters=tnet.parameters())
    assert not topt._coupled_decay and topt._l2_coef == 0.0
    assert not jopt._coupled_decay and jopt._l2_coef == 0.0
    before = [p.detach().clone() for p in tnet.parameters()]
    for step in range(STEPS):
        _step_both(jopt, topt, jnet, tnet, step)
    _close_state(jopt, topt, jnet, tnet)
    # the same steps without any decay give the same parameters
    after = [p.detach().clone() for p in tnet.parameters()]
    with torch.no_grad():
        for p, b in zip(tnet.parameters(), before):
            p.copy_(b)
    for step in range(STEPS):
        for p, g in zip(tnet.parameters(),
                        _grads(step, list(tnet.parameters()))):
            p.grad = torch.from_numpy(g.copy())
        plain.step()
    for p, a in zip(tnet.parameters(), after):
        assert torch.equal(p.detach(), a)


def test_clear_grad_and_minimize(nets):
    _, tnet = nets
    opt = T.optimizer.SGD(0.1, parameters=tnet.parameters())
    x = torch.ones(2, 4)
    loss = tnet(x).sum()
    w0 = tnet[1].bias.detach().clone()
    opt.minimize(loss)
    assert all(p.grad is not None for p in tnet.parameters())
    np.testing.assert_allclose(tnet[1].bias.detach().numpy(),
                               (w0 - 0.1 * 2).numpy(), rtol=1e-6)
    opt.clear_grad(set_to_zero=True)
    assert all(float(p.grad.abs().sum()) == 0 for p in tnet.parameters())
    opt.clear_grad()
    assert all(p.grad is None for p in tnet.parameters())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pdopt_loads_both_ways(nets, tmp_path, writer):
    """Adam's state after two steps, saved by one package as .pdopt and
    loaded into the other's fresh optimizer: the same tensors, and the
    next step from them the same parameters."""
    jnet, tnet = nets
    jopt = J.optimizer.Adam(Jlr.ExponentialDecay(0.01, 0.9),
                            parameters=jnet.parameters())
    topt = T.optimizer.Adam(Tlr.ExponentialDecay(0.01, 0.9),
                            parameters=tnet.parameters())
    for step in range(2):
        _step_both(jopt, topt, jnet, tnet, step)
    path = str(tmp_path / "opt.pdopt")
    if writer == "reference":
        JIO.save(jopt.state_dict(), path)
        topt = T.optimizer.Adam(Tlr.ExponentialDecay(0.5, 0.5),
                                parameters=tnet.parameters())
        topt.set_state_dict(TIO.load(path))
    else:
        TIO.save(topt.state_dict(), path)
        jopt = J.optimizer.Adam(Jlr.ExponentialDecay(0.5, 0.5),
                                parameters=jnet.parameters())
        jopt.set_state_dict(JIO.load(path))
    _close_state(jopt, topt, jnet, tnet)
    assert jopt.get_lr() == topt.get_lr()
    _step_both(jopt, topt, jnet, tnet, 2)
    _close_state(jopt, topt, jnet, tnet)


def _schedulers(m):
    return {
        "noam": m.NoamDecay(512, 10, learning_rate=2.0),
        "piecewise": m.PiecewiseDecay([5, 20, 30], [1.0, 0.5, 0.1, 0.01]),
        "natural_exp": m.NaturalExpDecay(0.5, 0.1),
        "inverse_time": m.InverseTimeDecay(0.5, 0.2),
        "polynomial": m.PolynomialDecay(0.5, 20, 0.01, 2.0),
        "polynomial_cycle": m.PolynomialDecay(0.5, 7, 0.01, 1.0, cycle=True),
        "linear_warmup": m.LinearWarmup(m.StepDecay(0.5, 5, 0.5), 10, 0.0,
                                        0.5),
        "exponential": m.ExponentialDecay(0.5, 0.95),
        "multistep": m.MultiStepDecay(0.5, [3, 9, 27], 0.3),
        "step": m.StepDecay(0.5, 4, 0.7),
        "lambda": m.LambdaDecay(0.5, lambda e: 1.0 / (1 + e) ** 0.5),
        "cosine": m.CosineAnnealingDecay(0.5, 13, 0.01),
        "plateau": m.ReduceOnPlateau(0.5, patience=2, cooldown=1,
                                     factor=0.5),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(Tlr)))
def test_schedulers_match_exactly(name):
    js, ts = _schedulers(Jlr)[name], _schedulers(Tlr)[name]
    metrics = np.abs(np.sin(np.arange(50) * 0.7)) + 1.0 / (1 + np.arange(50))
    for e in range(50):
        assert ts() == js(), (name, e)
        if name == "plateau":
            js.step(metrics[e])
            ts.step(metrics[e])
        else:
            js.step()
            ts.step()
    assert ts() == js() and math.isfinite(ts())
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert jsd == tsd
