"""The static AMP decorator (`fluid.contrib.mixed_precision`) against
paddle_tpu's on the CPU.

- The decorated cut resnet18 (`tests/torch_fluid_amp_program.py`: LARS
  under fp16 with dynamic loss scaling, and bf16 without) builds the
  reference's Program JSON and runs in both Executors from the same
  state before each step: the same overflow flags, loss scales and
  counts, the same losses and parameters.
- A step with an inf injected into the loss scale skips the update: every
  parameter and accumulator stays as it was, bit for bit, while the
  forward's running statistics move.
- Over a sequence of good and bad steps the scale and the counts follow
  the update_loss_scaling rule (its numpy replay), in both packages.
- With no op in reduced precision and no overflow, a decorated step is
  the plain optimizer's step: the update in the sub-block sees the true
  gradients (the double count of ROADMAP queue 3 item 20 does not reach
  it).
- The decorated program's JSON (its sub-block) and a recompute program's
  (its segment attributes) run in the other package.

Tolerances.  Losses and parameters of the fp16 cut resnet18: rtol 2e-3,
atol 2e-4 on the losses and a relative L2 of 2e-3 on each parameter,
since each package rounds the fp16 convolutions' inputs and outputs once
and their sums differ in order (fp16's unit is 9.8e-4).  bf16 (unit
7.8e-3): 2e-2.  f32 programs: rtol 1e-5, atol 1e-6; the same ops in
one package: exactly.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.models import resnet as JR

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.models import resnet as TR

import torch_fluid_amp_program as P

F32 = dict(rtol=1e-5, atol=1e-6)
LOW = {"float16": dict(loss=dict(rtol=2e-3, atol=2e-4), l2=2e-3),
       "bfloat16": dict(loss=dict(rtol=2e-2, atol=2e-3), l2=2e-2)}
CUT = dict(depth=18, class_num=10, image_shape=(3, 32, 32), batch_size=8,
           width=8)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(8, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}


def _both(make, builder):
    """(reference, port) each as (main, startup, fetches, decorated),
    the same JSON; the port's scope loaded with the reference's startup
    values.  Returns those and the two (executor, scope) pairs."""
    out = {}
    for fluid, U in ((JF, JU), (TF, TU)):
        opt = make(fluid)
        main, startup, fetches = builder(fluid, U, opt)
        out[fluid] = (main, startup, fetches, opt)
    assert _json(out[TF][0]) == _json(out[JF][0])
    assert _json(out[TF][1]) == _json(out[JF][1])
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(out[JF][1], scope=jscope)
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(out[TF][1], scope=tscope)
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})
    return out, (jexe, jscope), (texe, tscope)


def _sync(jscope, tscope):
    """The port's scope set to the reference's values: each step below
    starts both packages from the same state, so a step's rounding does
    not compound."""
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})


def _resnet(fluid, U, opt):
    R = JR if fluid is JF else TR
    main, startup, _, fetches = P.build(fluid, R, U, opt, **CUT)
    return main, startup, [v.name for v in fetches]


def _rel_l2(got, want):
    want = want.astype(np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want)) / max(
        float(np.linalg.norm(want)), 1e-6 * want.size ** 0.5)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_decorated_resnet18_trains_as_the_reference(dtype):
    out, (jexe, jscope), (texe, tscope) = _both(
        lambda f: P.amp_optimizer(f, dtype=dtype), _resnet)
    main, _, fetches, opt = out[JF]
    names = list(P.amp_state_names(main, opt)) if dtype == "float16" \
        else []
    tol = LOW[dtype]
    for step in range(3):
        feed = _feed(step)
        _sync(jscope, tscope)
        want = jexe.run(main, feed=feed, fetch_list=fetches + names,
                        scope=jscope)
        got = texe.run(out[TF][0], feed=feed, fetch_list=fetches + names,
                       scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   err_msg=f"loss {step}", **tol["loss"])
        for n, w, g in zip(names, want[2:], got[2:]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=n)
    params = [p.name for p in out[TF][0].all_parameters() if p.trainable]
    for n in params:
        err = _rel_l2(np.asarray(tscope.get(n)), np.asarray(jscope.get(n)))
        assert err < tol["l2"], (n, err)
    if dtype == "bfloat16":
        assert not any(op.type == "conditional_block"
                       for op in out[TF][0].global_block().ops)


def _persistable(scope, names):
    return {n: scope.get(n).clone() for n in names}


def test_an_overflow_skips_the_update_in_both_packages():
    """An inf loss scale makes every scaled gradient overflow: the
    update's sub-block does not run, and each parameter and velocity is
    what it was, bit for bit; the bad count is 1 and the scale stays
    (decr_every_n_nan_or_inf is 2)."""
    out, (jexe, jscope), (texe, tscope) = _both(P.amp_optimizer, _resnet)
    main, _, fetches, opt = out[TF]
    scale, good, bad, found = P.amp_state_names(main, opt)
    params = [p.name for p in main.all_parameters() if p.trainable]
    vel = [n for n in tscope.local_var_names() if "velocity" in n]
    stats = [n for n in tscope.local_var_names()
             if n.startswith("batch_norm") and n.endswith(".w_1")]
    assert len(vel) == len(params) and stats
    for fluid, exe, scope in ((JF, jexe, jscope), (TF, texe, tscope)):
        inf = np.array([np.inf], np.float32)
        if fluid is TF:
            scope.set(scale, torch.from_numpy(inf))
            before = _persistable(scope, params + vel + stats)
        else:
            scope.set(scale, inf)
            before = {n: np.array(scope.get(n)) for n in
                      params + vel + stats}
        got = exe.run(out[fluid][0], feed=_feed(), scope=scope,
                      fetch_list=[found, bad, good])
        assert bool(np.asarray(got[0])[0]) and int(np.asarray(got[1])[0]) \
            == 1 and int(np.asarray(got[2])[0]) == 0
        for n in params + vel:
            a, b = np.asarray(scope.get(n)), np.asarray(before[n])
            np.testing.assert_array_equal(a, b, err_msg=n)
        assert all(not np.array_equal(np.asarray(scope.get(n)),
                                      np.asarray(before[n]))
                   for n in stats)
        assert np.isinf(np.asarray(scope.get(scale))).all()


def _mlp(fluid, U, opt):
    """A small program whose loss a fed factor k multiplies: k = inf
    makes a step overflow."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), U.guard():
        L = fluid.layers
        x = fluid.data("x", [8, 6], "float32")
        y = fluid.data("y", [8, 1], "float32")
        k = fluid.data("k", [1], "float32")
        loss = L.mean(L.square_error_cost(L.fc(L.fc(x, 16, act="relu"), 1),
                                          y))
        loss = L.elementwise_mul(loss, k)
        opt.minimize(loss)
    return main, startup, [loss.name]


FOUND = [False, False, True, True, False, True, False, False, False, True,
         True, True, True, False]


def test_loss_scaling_follows_its_rule_in_both_packages():
    """incr_every_n_steps 2 and decr_every_n_nan_or_inf 2 over a run of
    good and bad steps: the fetched flags, scale and counts are the
    rule's replay, in both packages; the losses of the good steps
    agree."""
    cfg = dict(P.AMP, incr_every_n_steps=2)

    def make(fluid):
        return fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Momentum(0.01), dtype="float16", **cfg)

    out, (jexe, jscope), (texe, tscope) = _both(make, _mlp)
    main, _, fetches, opt = out[TF]
    names = list(P.amp_state_names(main, opt))
    rng = np.random.RandomState(4)
    got_rows, want_rows = [], []
    for f in FOUND:
        feed = {"x": rng.randn(8, 6).astype(np.float32),
                "y": rng.randn(8, 1).astype(np.float32),
                "k": np.array([np.inf if f else 1.0], np.float32)}
        w = jexe.run(out[JF][0], feed=feed, fetch_list=fetches + names,
                     scope=jscope)
        g = texe.run(main, feed=feed, fetch_list=fetches + names,
                     scope=tscope)
        if not f:
            np.testing.assert_allclose(g[0], np.asarray(w[0]), **F32)
        got_rows.append((float(g[1][0]), int(g[2][0]), int(g[3][0]),
                         bool(g[4][0])))
        want_rows.append((float(np.asarray(w[1])[0]),
                          int(np.asarray(w[2])[0]),
                          int(np.asarray(w[3])[0]),
                          bool(np.asarray(w[4])[0])))
    rule = [(s, gd, bd, f) for (s, gd, bd), f in
            zip(P.replay_loss_scaling(FOUND, cfg), FOUND)]
    assert got_rows == want_rows == rule
    assert {r[0] for r in rule} >= {32768.0, 65536.0, 16384.0}


def _momentum_l2_clip(fluid):
    """configs[1]'s Momentum with its L2Decay, under a global-norm clip
    that binds (the cut resnet18's first gradients have a norm above
    0.1)."""
    return fluid.optimizer.Momentum(
        0.1, 0.9, regularization=fluid.regularizer.L2Decay(1e-4),
        grad_clip=fluid.clip.ClipGradByGlobalNorm(0.1))


def test_an_f32_decorated_step_is_the_plain_step():
    """fp16 decoration with every white-listed op moved to the black
    list (so nothing runs in fp16) and no overflow: the scaled, checked
    and unscaled gradients, clipped and regularized as the inner
    optimizer says, give the plain Momentum step with its L2Decay and
    its global-norm clip, the same ops in the same order.  The clip's
    sum of squares runs over the parameters in another order, hence the
    tolerance (rtol 1e-6, atol 1e-7) on the parameters."""
    def decorated(fluid):
        lists = fluid.contrib.mixed_precision.AutoMixedPrecisionLists(
            custom_black_list=["conv2d", "mul", "matmul"])
        return fluid.contrib.mixed_precision.decorate(
            _momentum_l2_clip(fluid), amp_lists=lists, dtype="float16",
            **P.AMP)

    states = []
    for make in (decorated, _momentum_l2_clip):
        opt = make(TF)
        main, startup, fetches = _resnet(TF, TU, opt)
        exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
        torch.manual_seed(0)
        exe.run(startup, scope=scope)
        if states:
            load_jax_scope(scope, {n: v for n, v in states[0][1].items()
                                   if n in scope.local_var_names()})
        init = {n: scope.get(n).numpy().copy()
                for n in scope.local_var_names()}
        loss = exe.run(main, feed=_feed(), fetch_list=fetches, scope=scope)
        params = {p.name: scope.get(p.name).numpy()
                  for p in main.all_parameters()}
        states.append((loss, init, params, main))
    (dl, _, dp, dmain), (pl, _, pp, _) = states
    ops = dmain.global_block().ops
    assert not any(op.type == "cast" for op in ops)
    assert any(op.type == "conditional_block" for op in ops)
    # the clip's and the decay's ops are in the main block, read by the
    # update's sub-block
    sub = {op.type for op in dmain.blocks[1].ops}
    assert sub == {"momentum"} and any(op.type == "sqrt" for op in ops)
    np.testing.assert_array_equal(dl[0], pl[0])
    for n, v in pp.items():
        np.testing.assert_allclose(dp[n], v, err_msg=n, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["amp", "recompute"])
def test_the_program_json_runs_in_the_other_package(kind):
    """The port's program through the reference's Executor and the
    reference's through the port's, from the same state before each of
    2 steps: the same losses."""
    def make(fluid):
        if kind == "amp":
            return P.amp_optimizer(fluid)
        return P.recompute_optimizer(fluid, fluid.optimizer.Momentum(
            0.1, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)))

    out, (jexe, jscope), (texe, tscope) = _both(make, _resnet)
    tmain, jmain = out[TF][0], out[JF][0]
    if kind == "recompute":
        assert sum(op.type == "recompute_segment_grad"
                   for op in tmain.global_block().ops) == 9
        assert len(P.block_outputs(tmain.global_block())) == 8
    fetches = out[TF][2]
    port_in_ref = JF.Program.from_dict(tmain.to_dict())
    ref_in_port = TF.Program.from_dict(jmain.to_dict())
    assert _json(port_in_ref) == _json(jmain)
    for step in range(2):
        feed = _feed(step)
        _sync(jscope, tscope)
        w = jexe.run(port_in_ref, feed=feed, fetch_list=fetches,
                     scope=jscope)
        g = texe.run(ref_in_port, feed=feed, fetch_list=fetches,
                     scope=tscope)
        tol = LOW["float16"]["loss"] if kind == "amp" else F32
        np.testing.assert_allclose(g[0], np.asarray(w[0]), **tol)


def test_a_reference_for_test_clone_of_an_amp_program_runs_in_the_port():
    """clone(for_test=True) prunes the backward and the update in both
    packages alike (the same JSON), and keeps the `logical_not` of the
    overflow flag whose writer it pruned.  The reference's Executor drops
    that op as dead code and so does the port's: the reference's test
    clone, through the port's Executor, gives the reference's loss on
    the same state (its fc layers in fp16: rtol 2e-3, atol 2e-4)."""
    out, (jexe, jscope), (texe, tscope) = _both(P.amp_optimizer, _mlp)
    jtest = out[JF][0].clone(for_test=True)
    ttest = out[TF][0].clone(for_test=True)
    assert _json(ttest) == _json(jtest)
    assert jtest.global_block().ops[-1].type == "logical_not"
    rng = np.random.RandomState(5)
    feed = {"x": rng.randn(8, 6).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32),
            "k": np.ones(1, np.float32)}
    fetches = out[TF][2]
    want = jexe.run(jtest, feed=feed, fetch_list=fetches, scope=jscope)
    got = texe.run(TF.Program.from_dict(jtest.to_dict()), feed=feed,
                   fetch_list=fetches, scope=tscope)
    np.testing.assert_allclose(got[0], np.asarray(want[0]),
                               **LOW["float16"]["loss"])
    # a var no op writes, read by an op whose output is fetched, still
    # raises
    with pytest.raises(RuntimeError, match="neither fed nor initialized"):
        texe.run(ttest, feed=feed, fetch_list=[
            ttest.global_block().ops[-1].output("Out")[0]], scope=tscope)
