"""The port's fluid.optimizer, fluid.clip, the regularizers and
initializers of this bucket, and recompute, against paddle_tpu's on the
CPU.

Each of the sixteen update optimizers (Dpsgd at sigma 0, its noise off),
with no gradient clip and with each ClipGradBy*, with L1Decay, and
through Lookahead, ModelAverage and ExponentialMovingAverage,
takes 3 steps of one small program (fc, relu, fc, a squared error) in
both Executors: both packages build the same Program JSON, the port's
Executor runs the reference's JSON from the reference's startup values
with the same feeds, and every persistable var (parameters,
accumulators, counters) agrees after the steps, as do the averages the
wrappers swap in.  RecomputeOptimizer's backward gives the plain
backward's gradients in both packages, replays a dropout mask bit for
bit, and lets the Executor free each segment's interior values before
the backward.

Tolerances.  F32 (rtol 2e-5, atol 2e-6): three f32 steps of a program of
a few dozen ops, whose only difference is the order of sums; ADAGRAD
(atol 5e-5) for Adagrad and DecayedAdagrad, whose first step amplifies
that noise where a gradient element is near their eps (see below).
Recompute against the plain backward in one package: the same ops in the
same order, rtol 1e-6, atol 1e-7.
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU

F32 = dict(rtol=2e-5, atol=2e-6)
SAME = dict(rtol=1e-6, atol=1e-7)
# Adagrad's and DecayedAdagrad's first step moves an element by lr g /
# (|g| sqrt(c) + eps): where |g| is near eps (1e-6) a change of g by f32
# rounding moves the step by up to lr / eps times it, ~1e-5 here
ADAGRAD = dict(rtol=2e-5, atol=5e-5)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _feeds(steps=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(8, 6).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)} for _ in range(steps)]


def _net(fluid):
    L = fluid.layers
    x = fluid.data("x", [8, 6], "float32")
    y = fluid.data("y", [8, 1], "float32")
    h = L.fc(x, 16, act="relu")
    pred = L.fc(h, 1)
    return L.mean(L.square_error_cost(pred, y))


# name -> fluid -> optimizer, for the sixteen update optimizers
OPTIMIZERS = {
    "SGD": lambda f, **k: f.optimizer.SGD(0.05, **k),
    "Momentum": lambda f, **k: f.optimizer.Momentum(0.05, 0.9,
                                                     use_nesterov=True, **k),
    "LarsMomentum": lambda f, **k: f.optimizer.LarsMomentum(
        0.5, 0.9, lars_coeff=0.01, lars_weight_decay=0.001, **k),
    "Adagrad": lambda f, **k: f.optimizer.Adagrad(0.05, **k),
    "Adam": lambda f, **k: f.optimizer.Adam(0.01, **k),
    "AdamW": lambda f, **k: f.optimizer.AdamW(0.01, weight_decay=0.1, **k),
    "Adamax": lambda f, **k: f.optimizer.Adamax(0.01, **k),
    "Adadelta": lambda f, **k: f.optimizer.Adadelta(1.0, rho=0.9, **k),
    "RMSProp": lambda f, **k: f.optimizer.RMSProp(0.01, momentum=0.5,
                                                   centered=True, **k),
    "Lamb": lambda f, **k: f.optimizer.Lamb(0.01, **k),
    "DGCMomentum": lambda f, **k: f.optimizer.DGCMomentum(
        0.05, 0.9, sparsity=[0.5, 0.75], rampup_step=2, **k),
    "DecayedAdagrad": lambda f, **k: f.optimizer.DecayedAdagrad(0.05, **k),
    "ProximalGD": lambda f, **k: f.optimizer.ProximalGD(
        0.05, l1_regularization_strength=0.01,
        l2_regularization_strength=0.1, **k),
    "ProximalAdagrad": lambda f, **k: f.optimizer.ProximalAdagrad(
        0.05, l1_regularization_strength=0.01,
        l2_regularization_strength=0.1, **k),
    "Ftrl": lambda f, **k: f.optimizer.Ftrl(0.05, l1=0.01, l2=0.1, **k),
    "Dpsgd": lambda f, **k: f.optimizer.Dpsgd(0.05, clip=1.0,
                                               batch_size=8.0, sigma=0.0),
}
CLIPS = {
    "none": None,
    "value": lambda f: f.clip.ClipGradByValue(0.05),
    "norm": lambda f: f.clip.ClipGradByNorm(0.1),
    "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.2),
}


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _build(fluid, unique_name, make):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        loss = _net(fluid)
        wrapper = make(fluid, loss)
    return main, startup, loss, wrapper


def _train(make, steps=3, after_step=None):
    """Both packages' programs from `make(fluid, loss)` (which calls
    minimize and returns what after_step needs), the same JSON, `steps`
    steps from the reference's startup values; returns the scopes'
    persistable values (reference, port) and the wrappers."""
    jm, js, jloss, jw = _build(JF, JU, make)
    tm, ts, _, tw = _build(TF, TU, make)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(TF.Program.from_dict(js.to_dict()), scope=tscope)
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})
    tmain = TF.Program.from_dict(jm.to_dict())
    for i, feed in enumerate(_feeds(steps)):
        jl, = jexe.run(jm, feed=feed, fetch_list=[jloss.name], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[jloss.name],
                       scope=tscope)
        np.testing.assert_allclose(tl, jl, err_msg=f"loss {i}", **F32)
        if after_step is not None:
            after_step(jw, jscope, tw, tscope, tmain, jm)
    return jscope, tscope, jw, tw


def _state(scope, names):
    return {n: np.asarray(scope.get(n)) for n in names}


def _assert_same_state(jscope, tscope, tol=F32):
    names = jscope.local_var_names()
    assert sorted(names) == sorted(tscope.local_var_names())
    want, got = _state(jscope, names), _state(tscope, names)
    for n in names:
        w, g = want[n], got[n]
        assert g.shape == w.shape, n
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=n, **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


def _minimizer(opt_name, clip=None, **kw):
    def make(fluid, loss):
        extra = dict(kw)
        if clip is not None:
            extra["grad_clip"] = CLIPS[clip](fluid)
        OPTIMIZERS[opt_name](fluid, **extra).minimize(loss)
    return make


def _tol(opt):
    return ADAGRAD if opt in ("Adagrad", "DecayedAdagrad") else F32


# Dpsgd takes no grad_clip (it clips by its own `clip`)
TRAIN_CASES = [(o, c) for o in sorted(OPTIMIZERS) for c in sorted(CLIPS)
               if o != "Dpsgd" or c == "none"]


@pytest.mark.parametrize("opt,clip", TRAIN_CASES)
def test_optimizer_trains_as_the_reference(opt, clip):
    jscope, tscope, _, _ = _train(_minimizer(opt, CLIPS[clip] and clip))
    _assert_same_state(jscope, tscope, _tol(opt))


@pytest.mark.parametrize("opt", sorted(set(OPTIMIZERS) - {"Dpsgd"}))
def test_optimizer_with_l1_decay_trains_as_the_reference(opt):
    def make(fluid, loss):
        OPTIMIZERS[opt](fluid, regularization=fluid.regularizer.L1Decay(
            0.01)).minimize(loss)

    jscope, tscope, _, _ = _train(make)
    _assert_same_state(jscope, tscope, _tol(opt))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_lookahead_trains_as_the_reference(opt):
    def make(fluid, loss):
        fluid.optimizer.LookaheadOptimizer(
            OPTIMIZERS[opt](fluid), alpha=0.6, k=2).minimize(loss)

    jscope, tscope, _, _ = _train(make, steps=5)
    _assert_same_state(jscope, tscope, _tol(opt))


def _averaged(kind, opt):
    """A minimizer that keeps the wrapper: EMA (with thres_steps) or
    ModelAverage, updated after every step."""
    def make(fluid, loss):
        OPTIMIZERS[opt](fluid).minimize(loss)
        if kind == "ema":
            return fluid.optimizer.ExponentialMovingAverage(0.9,
                                                             thres_steps=1)
        return fluid.optimizer.ModelAverage(0.5)
    return make


def _update(jw, jscope, tw, tscope, tmain, jm):
    jw.update(jscope, jm)
    tw.update(tscope, tmain)


@pytest.mark.parametrize("kind", ["ema", "model_average"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_averages_apply_and_restore_as_the_reference(kind, opt):
    """update() after each of 3 steps; inside apply() every parameter is
    the reference's average, after restore() the training value again,
    bit for bit."""
    jscope, tscope, jw, tw = _train(_averaged(kind, opt),
                                    after_step=_update)
    params = sorted(jw._shadow)
    assert params and params == sorted(tw._shadow)
    trained = {n: tscope.get(n) for n in params}
    with JF.scope_guard(jscope), jw.apply():
        want = _state(jscope, params)
    with TF.scope_guard(tscope), tw.apply():
        got = _state(tscope, params)
    tol = _tol(opt)
    for n in params:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)
        assert not np.array_equal(got[n], trained[n].numpy()), n
    for n in params:
        assert tscope.get(n) is trained[n], n
    _assert_same_state(jscope, tscope, tol)


def test_model_average_rolls_its_window_by_its_rule():
    """min = max window 2, rate 0.5: Paddle's average_accumulates rolls
    when a window fills, so after steps 1..4 the averages are p1, (p1 +
    p2) / 2, (p1 + p2 + p3) / 3 and (p3 + p4) / 2."""
    scope = TF.Scope()
    main = TF.Program()
    with TF.program_guard(main, TF.Program()):
        main.global_block().create_parameter(name="w", shape=[3],
                                             dtype="float32")
    avg = TF.optimizer.ModelAverage(0.5, min_average_window=2,
                                    max_average_window=2)
    ps = [np.full(3, v, np.float32) for v in (1.0, 2.0, 4.0, 8.0)]
    want = [1.0, 1.5, 7.0 / 3.0, 6.0]
    import torch
    for p, w in zip(ps, want):
        scope.set("w", torch.from_numpy(p))
        avg.update(scope, main)
        np.testing.assert_allclose(avg._shadow["w"].numpy(), w, rtol=1e-6)


def test_set_gradient_clip_applies_when_the_optimizer_has_none():
    def make(fluid, loss):
        fluid.clip.set_gradient_clip(fluid.clip.ClipGradByNorm(0.05))
        try:
            fluid.optimizer.SGD(0.1).minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)

    jscope, tscope, _, _ = _train(make)
    _assert_same_state(jscope, tscope)


def test_clip_names_and_guards_answer_as_the_reference():
    assert T.nn.ClipGradByGlobalNorm is TF.clip.ClipGradByGlobalNorm
    assert T.nn.clip is TF.layers.clip
    for fluid in (JF, TF):
        with pytest.warns(RuntimeWarning):
            e = fluid.clip.ErrorClipByValue(1.0)
        assert e.min == -1.0
        with pytest.raises(TypeError):
            fluid.clip.set_gradient_clip(object())
        with pytest.raises(NotImplementedError):
            fluid.optimizer.PipelineOptimizer(fluid.optimizer.SGD(0.1))


def test_initializers_build_the_reference_startup():
    """TruncatedNormal, MSRA, Bilinear and NumpyArray: the same startup
    JSON; the deterministic ones give the reference's values, and the
    truncated draw stays within two std of its mean."""
    def build(fluid, unique_name):
        main, startup = fluid.Program(), fluid.Program()
        I = fluid.initializer
        with fluid.program_guard(main, startup), unique_name.guard():
            x = fluid.data("x", [2, 3, 4, 4], "float32")
            fluid.layers.conv2d(x, 4, 3, param_attr=fluid.ParamAttr(
                name="tn", initializer=I.TruncatedNormal(0.5, 0.1)))
            fluid.layers.conv2d(x, 4, 3, param_attr=fluid.ParamAttr(
                name="msra", initializer=I.MSRA(uniform=False)))
            fluid.layers.conv2d(x, 3, 4, param_attr=fluid.ParamAttr(
                name="bil", initializer=I.Bilinear()))
            fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(
                name="arr", initializer=I.NumpyArray(
                    np.arange(96, dtype=np.float32).reshape(48, 2))))
        return startup

    js, ts = build(JF, JU), build(TF, TU)
    assert _json(ts) == _json(js)
    jscope, tscope = JF.Scope(), TF.Scope()
    JF.Executor().run(js, scope=jscope)
    TF.Executor(TF.CPUPlace()).run(TF.Program.from_dict(js.to_dict()),
                                   scope=tscope)
    for n in ("bil", "arr"):
        np.testing.assert_array_equal(np.asarray(tscope.get(n)),
                                      np.asarray(jscope.get(n)), err_msg=n)
    tn = np.asarray(tscope.get("tn"))
    assert tn.min() >= 0.3 and tn.max() <= 0.7
    msra = np.asarray(tscope.get("msra"))
    assert msra.shape == (4, 3, 3, 3) and 0.05 < msra.std() < 0.8


# -- recompute --------------------------------------------------------------------

def _deep(fluid, dropout):
    L = fluid.layers
    x = fluid.data("x", [8, 6], "float32")
    y = fluid.data("y", [8, 1], "float32")
    h, ckpts = x, []
    for _ in range(3):
        h = L.fc(h, 12, act="tanh")
        if dropout:
            h = L.dropout(h, 0.3, dropout_implementation="upscale_in_train")
        ckpts.append(h)
    loss = L.mean(L.square_error_cost(L.fc(h, 1), y))
    return loss, ckpts[:-1]


def _grads(fluid, unique_name, recompute, dropout, exe, seed=3):
    """The parameters' gradients after one run of the backward (the
    update ops are not appended)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup), unique_name.guard():
        loss, ckpts = _deep(fluid, dropout)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(fluid.optimizer.SGD(0.1))
            opt._set_checkpoints(ckpts)
            pg = opt.backward(loss)
        else:
            pg = fluid.append_backward(loss)
    names = [g.name for _, g in sorted(pg, key=lambda t: t[0].name)]
    return main, startup, loss, names


def _load(fluid, scope, init):
    if fluid is TF:
        load_jax_scope(scope, init)
    else:
        for n, v in init.items():
            scope.set(n, v)


def _run_grads(fluid, unique_name, recompute, dropout, exe, init=None):
    """The loss and the gradients of one run, from the values `init`
    (else the startup's)."""
    main, startup, loss, names = _grads(fluid, unique_name, recompute,
                                        dropout, exe)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        _load(fluid, scope, init)
    out = exe.run(main, feed=_feeds(1)[0], fetch_list=[loss.name] + names,
                  scope=scope)
    return main, [np.asarray(o) for o in out], scope


def test_recompute_gives_the_plain_gradients_in_both_packages():
    jexe = JF.Executor()
    texe = TF.Executor(TF.CPUPlace())
    _, jplain, jscope = _run_grads(JF, JU, False, False, jexe)
    init = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    jmain, jre, _ = _run_grads(JF, JU, True, False, jexe, init)
    tmain, tre, _ = _run_grads(TF, TU, True, False, texe, init)
    _, tplain, _ = _run_grads(TF, TU, False, False, texe, init)
    assert _json(tmain) == _json(jmain)
    assert sum(op.type == "recompute_segment_grad"
               for op in tmain.global_block().ops) == 3
    for w, g in zip(jre, jplain):
        np.testing.assert_allclose(g, w, **SAME)
    for w, g in zip(tplain, tre):
        np.testing.assert_allclose(g, w, **SAME)
    for w, g in zip(jre, tre):
        np.testing.assert_allclose(g, w, **F32)


@pytest.mark.parametrize("fluid,unique_name,exe", [
    (JF, JU, JF.Executor), (TF, TU, lambda: TF.Executor(TF.CPUPlace()))],
    ids=["reference", "port"])
def test_recompute_replays_the_dropout_masks(fluid, unique_name, exe):
    """With dropout in every segment, the replay draws the forward's
    masks: the gradients equal the plain backward's, in each package
    (their bits differ between the packages)."""
    _, plain, scope = _run_grads(fluid, unique_name, False, True, exe())
    init = {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}
    _, re, _ = _run_grads(fluid, unique_name, True, True, exe(), init)
    for w, g in zip(plain, re):
        np.testing.assert_allclose(g, w, **SAME)
    assert any(np.count_nonzero(g) < g.size for g in re[1:])


def test_recompute_frees_each_segment_before_the_backward():
    """In the port's Executor every value made inside a segment (not a
    checkpoint, not a parameter) has its last use in the forward, before
    the first recompute_segment_grad op; the plain backward keeps them
    to their grad ops."""
    from paddle_tpu_torch.fluid.executor import _last_uses

    for recompute in (True, False):
        main, _, loss, names = _grads(TF, TU, recompute, False, None)
        ops = main.global_block().ops
        first_bwd = next(i for i, op in enumerate(ops)
                         if op.attr("op_role", 0) == 1)
        frees = _last_uses(main.global_block(), {loss.name, *names})
        freed_at = {n: i for i, ns in enumerate(frees) for n in ns}
        interior = [n for op in ops[:first_bwd] if op.type == "mul"
                    for n in op.output("Out")]
        assert interior
        early = [freed_at[n] < first_bwd for n in interior]
        assert all(early) if recompute else not any(early)
