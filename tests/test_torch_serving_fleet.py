"""The port's multi-tenant fleet (serving/registry.py, the batcher's
per-tenant admission, ProgramModel) against paddle_tpu's on the CPU.

- Two tenants, the same in both packages: "ctr", a ProgramModel over a
  small Fluid program (fc 4 -> 8 tanh -> 3, the port's startup weights
  carried into the reference's scope), and "scale", a callable.  Each
  registry answers the same requests; every response within F32 of the
  other package's (float32 products in other orders).
- Admission: the over-quota rejection (its resource, bound and the
  tenant depths), and the batcher's pick order for a fixed queue under
  priority aging (submit times pinned), the same in both packages.
- cancel_tenant / unregister touch only their tenant; reload_weights
  from a checkpoint root gives the new weights' forward in both; a
  Predictor or callable tenant's reload raises TypeError; a tenant's
  cache evicts only its own entries.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu import ckpt as JC
from paddle_tpu import serving as JS
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.serving.batcher import DynamicBatcher as JBatcher
from paddle_tpu.serving.batcher import Request as JRequest

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import ckpt as TC
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import profiler
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.serving import metrics as TM
from paddle_tpu_torch.serving.batcher import DynamicBatcher as TBatcher
from paddle_tpu_torch.serving.batcher import Request as TRequest

F32 = dict(rtol=2e-6, atol=2e-6)
X = np.ones((2, 4), np.float32)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 4], "float32")
        h = fluid.layers.fc(x, 8, act="tanh")
        y = fluid.layers.fc(h, 3)
    return main.clone(for_test=True), startup, y


@pytest.fixture(scope="module")
def start():
    main, startup, _ = _program(TF)
    scope = TF.Scope()
    TF.Executor(TF.CPUPlace()).run(startup, scope=scope)
    return {n: scope.get(n).numpy() for n in scope.local_var_names()}


def _registry(pkg, start, cfg=None):
    """(registry, scope) serving "ctr" and "scale" in `pkg`."""
    serving = TS if pkg == "port" else JS
    fluid = TF if pkg == "port" else JF
    cfg = cfg or serving.EngineConfig(max_batch_size=8,
                                      max_queue_delay_ms=1.0, max_queue=64,
                                      **({"device": "cpu"}
                                         if pkg == "port" else {}))
    main, _, y = _program(fluid)
    scope = fluid.Scope()
    for n, v in start.items():
        scope.set(n, torch.from_numpy(v.copy()) if pkg == "port" else v)
    exe = fluid.Executor(fluid.CPUPlace()) if pkg == "port" \
        else fluid.Executor()
    reg = serving.ModelRegistry(cfg)
    reg.register("ctr", serving.ProgramModel(exe, main, ["x"], [y],
                                             scope=scope),
                 quota=16, priority=1.0)
    if pkg == "port":
        reg.register("scale", lambda x: [torch.tanh(x) * 3.0], quota=16)
    else:
        import jax.numpy as jnp

        reg.register("scale", lambda x: [jnp.tanh(x) * 3.0], quota=16)
    return reg, scope


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    return [("ctr" if i % 3 else "scale",
             rng.randn(int(rng.randint(1, 6)), 4).astype(np.float32))
            for i in range(n)]


def test_both_registries_answer_each_request_alike(start):
    reqs = _requests(18, 1)
    answers = {}
    for pkg in ("reference", "port"):
        reg, _ = _registry(pkg, start)
        with reg:
            resps = [None] * len(reqs)

            def client(lo, reg=reg, resps=resps):
                for i in range(lo, len(reqs), 3):
                    name, x = reqs[i]
                    resps[i] = reg.submit(name, [x])

            threads = [threading.Thread(target=client, args=(lo,))
                       for lo in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            answers[pkg] = [np.asarray(r.result(timeout=120)[0])
                            for r in resps]
            stats = reg.stats("ctr")
            assert stats["completed_total"] >= 12 and "latency" in stats
    for (name, x), got, want in zip(reqs, answers["port"],
                                    answers["reference"]):
        assert got.shape == want.shape == (x.shape[0],
                                           3 if name == "ctr" else 4)
        np.testing.assert_allclose(got, want, **F32)
    assert TS.active_tenants() == []


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_an_over_quota_tenant_is_rejected_alone(pkg):
    serving, tenant_stat = (TS, TM.tenant_stat) if pkg == "port" else \
        (JS, JS.tenant_stat)
    stats = profiler.get_int_stats if pkg == "port" else \
        __import__("paddle_tpu").profiler.get_int_stats
    kw = {"device": "cpu"} if pkg == "port" else {}
    eng = serving.Engine(config=serving.EngineConfig(max_queue=64, **kw),
                         start=False)
    eng.add_model("greedy", lambda x: [x], quota=2)
    eng.add_model("polite", lambda x: [x], quota=2)
    eng.submit([X], model="greedy")
    eng.submit([X], model="greedy")
    r0 = stats().get(tenant_stat("greedy", "rejected_total"), 0)
    with pytest.raises(serving.EngineOverloaded) as ei:
        eng.submit([X], model="greedy")
    assert (ei.value.resource, ei.value.bound) == ("tenant:greedy", 2)
    assert stats()[tenant_stat("greedy", "rejected_total")] == r0 + 1
    eng.submit([X], model="polite")
    assert (eng._batcher.tenant_depth("greedy"),
            eng._batcher.tenant_depth("polite")) == (2, 1)
    with pytest.raises(serving.EngineClosed):
        eng.submit([X], model="ghost")


def _pick_order(Batcher, Request):
    """The tenants of each batch drained from one fixed queue: tenants of
    priorities 0, 2 and 5, requests submitted 0-180 ms ago (pinned), two
    signatures, aging 20 ms a point."""
    b = Batcher(max_batch_size=4, max_queue_delay_ms=0.0, aging_ms=20.0)
    for name, prio in (("lo", 0.0), ("mid", 2.0), ("hi", 5.0)):
        b.set_tenant(name, priority=prio)
    now = time.perf_counter()
    plan = [("lo", 180, 4), ("hi", 10, 4), ("mid", 90, 4), ("lo", 60, 8),
            ("hi", 0, 8), ("mid", 150, 4), ("lo", 120, 4), ("hi", 40, 4)]
    for name, ago, width in plan:
        req = Request([np.ones((1, width), np.float32)], tenant=name)
        req.submitted_at = now - ago / 1e3
        b.submit(req)
    order = []
    while True:
        batch = b.next_batch(timeout=0.01)
        if not batch:
            return order
        order.append([(r.tenant, r.inputs[0].shape[1]) for r in batch])


def test_the_batcher_picks_in_the_references_order():
    want = _pick_order(JBatcher, JRequest)
    assert _pick_order(TBatcher, TRequest) == want
    assert len(want) >= 4 and all(len({t for t, _ in b}) == 1 for b in want)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_cancel_tenant_touches_only_its_tenant(pkg):
    serving = TS if pkg == "port" else JS
    kw = {"device": "cpu"} if pkg == "port" else {}
    eng = serving.Engine(config=serving.EngineConfig(max_queue=64, **kw),
                         start=False)
    eng.add_model("doomed", lambda x: [x], quota=8)
    eng.add_model("survivor", lambda x: [x], quota=8)
    doomed = [eng.submit([X], model="doomed") for _ in range(3)]
    alive = eng.submit([X], model="survivor")
    assert eng._batcher.cancel_tenant("doomed") == 3
    for resp in doomed:
        with pytest.raises(serving.RequestCancelled):
            resp.result(timeout=1.0)
    assert not alive.done()
    assert eng._batcher.tenant_depth("survivor") == 1
    eng.remove_model("doomed")
    assert eng.model_names() == ["survivor"]


def test_reload_weights_swaps_a_program_tenant_in_both(start, tmp_path):
    w = next(n for n in start if n.endswith(".w_0") and
             start[n].shape == (4, 8))
    new = {w: start[w] * -2.0}
    root = str(tmp_path / "root")
    TC.CheckpointManager(root).save({w: torch.from_numpy(start[w])}, 1)
    JC.CheckpointManager(root).save(new, 2)  # the newest wins
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    got = {}
    for pkg in ("reference", "port"):
        reg, scope = _registry(pkg, start)
        with reg:
            before = np.asarray(reg.infer("ctr", [x], timeout=120)[0])
            assert reg.reload_weights("ctr", root) == 1
            got[pkg] = (before, np.asarray(reg.infer("ctr", [x],
                                                     timeout=120)[0]),
                        np.asarray(reg.infer("scale", [x],
                                             timeout=120)[0]))
            np.testing.assert_array_equal(np.asarray(scope.get(w)), new[w])
    np.testing.assert_allclose(got["port"][0], got["reference"][0], **F32)
    np.testing.assert_allclose(got["port"][1], got["reference"][1], **F32)
    assert np.abs(got["port"][1] - got["port"][0]).max() > 0.1
    np.testing.assert_allclose(got["port"][2], np.tanh(x) * 3.0, **F32)


def test_a_predictor_or_callable_tenant_reload_raises(tmp_path):
    lin = T.nn.Linear(4, 2)
    prefix = TI.save_inference_model(str(tmp_path / "lin"), lin, [X])
    pred = TI.load_inference_model(prefix, device="cpu")
    with TS.ModelRegistry(TS.EngineConfig(device="cpu")) as reg:
        reg.register("pred", pred, quota=4)
        reg.register("fn", lambda x: [x], quota=4)
        (y,) = reg.infer("pred", [X[:1]], timeout=120)
        np.testing.assert_allclose(
            y, lin(torch.from_numpy(X[:1])).detach().numpy(), **F32)
        for name in ("pred", "fn"):
            with pytest.raises(TypeError, match="bakes its weights"):
                reg.reload_weights(name, str(tmp_path))
        with pytest.raises(KeyError):
            reg.reload_weights("ghost", str(tmp_path))
    eng = TS.Engine(pred, TS.EngineConfig(device="cpu"), start=False)
    with pytest.raises(TypeError, match="ProgramModel"):
        eng.reload_weights(str(tmp_path))


def test_a_tenant_cache_evicts_only_its_own_entries():
    with TS.ModelRegistry(TS.EngineConfig(max_batch_size=8,
                                          max_queue_delay_ms=0.0,
                                          device="cpu")) as reg:
        reg.register("churner", lambda x: [x + 1.0], quota=16,
                     cache_capacity=1, aot_token="ignored")
        reg.register("steady", lambda x: [x * 7.0], quota=16,
                     cache_capacity=4)
        reg.infer("steady", [X], timeout=120)
        for w in (4, 6, 8):
            reg.infer("churner", [np.ones((2, w), np.float32)], timeout=120)
        assert reg.stats("steady")["cache_entries"] == 1
        assert reg.stats("steady")["cache_evictions"] == 0
        assert reg.stats("churner")["cache_evictions"] >= 2
        np.testing.assert_array_equal(reg.infer("steady", [X],
                                                timeout=120)[0], X * 7.0)
        reg.unregister("churner")
        assert reg.model_names() == ["steady"]
