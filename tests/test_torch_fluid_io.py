"""`fluid.io`, `fluid.compiler` and the `static` names over them, against
paddle_tpu's on the CPU.

- An inference model saved by either package (params.npz, program.json,
  meta.json) loads and runs in the other: the same outputs within F32.
- save_persistables / load_persistables into a fresh scope give every
  value back bit for bit; a bfloat16 var comes back from its float32
  file; a program of one persistable var saves and loads (the npz
  bundle, not the save_combine of ROADMAP queue 3 item 24).
- Pruning: a feed that reaches no target raises in both, naming it.
- CompiledProgram and ParallelExecutor on one device give Executor.run's
  bits; more than one place, a mesh of more than one device, or more
  than one trainer raises NotImplementedError naming ROADMAP queue 1
  item 10.
- static.save / load / load_program_state / set_program_state round
  trip a program's state.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import static as TS

F32 = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _mlp(fluid):
    """x -> fc 16 relu -> fc 3 softmax, with an SGD step on a label."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 8], "float32")
        label = fluid.data("label", [-1, 1], "int64")
        pred = fluid.layers.fc(fluid.layers.fc(x, 16, act="relu"), 3,
                               act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, pred, loss


def _feed(seed=0, n=5):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype("float32"),
            "label": rng.randint(0, 3, (n, 1)).astype("int64")}


def _trained(fluid, exe, scope):
    main, startup, pred, loss = _mlp(fluid)
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    return main, pred


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_an_inference_model_runs_in_the_other_package(saver, tmp_path):
    d = str(tmp_path)
    pairs = {"port": (TF, TF.Executor(TF.CPUPlace())),
             "reference": (JF, JF.Executor())}
    fluid, exe = pairs[saver]
    scope = fluid.Scope()
    main, pred = _trained(fluid, exe, scope)
    with fluid.scope_guard(scope):
        names = fluid.io.save_inference_model(d, ["x"], [pred], exe, main)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta == {"feed": ["x"], "fetch": names,
                    "format": "paddle_tpu.inference.v1"}
    x = _feed(1)["x"]
    outs = []
    for fluid, exe in pairs.values():
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
        assert feeds == ["x"]
        assert not any(op.type == "sgd" for op in prog.global_block().ops)
        outs.append(exe.run(prog, feed={"x": x}, fetch_list=fetches,
                            scope=scope)[0])
    np.testing.assert_allclose(outs[0], outs[1], **F32)


def test_persistables_round_trip_bit_for_bit(tmp_path):
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    main, _ = _trained(TF, exe, scope)
    with TF.program_guard(main):
        TF.layers.create_global_var([3], 1.5, "bfloat16", persistable=True,
                                    name="half_state")
    scope.set("half_state", torch.tensor([1.5, -2.25, 3.0],
                                         dtype=torch.bfloat16))
    with TF.scope_guard(scope):
        TF.io.save_persistables(exe, str(tmp_path), main)
    with np.load(tmp_path / "params.npz") as data:
        assert data["half_state"].dtype == np.float32
    fresh = TF.Scope()
    with TF.scope_guard(fresh):
        TF.io.load_params(exe, str(tmp_path), main)
    names = [v.name for v in main.list_vars() if v.persistable]
    assert sorted(fresh.local_var_names()) == sorted(names)
    for n in names:
        assert fresh.get(n).dtype == scope.get(n).dtype, n
        assert torch.equal(fresh.get(n), scope.get(n)), n


def test_a_program_of_one_persistable_var_saves_and_loads(tmp_path):
    main = TF.Program()
    with TF.program_guard(main):
        TF.layers.create_global_var([2, 2], 0.0, "float32", persistable=True,
                                    name="only")
    scope = TF.Scope()
    scope.set("only", torch.arange(4.0).reshape(2, 2))
    with TF.scope_guard(scope):
        TF.io.save_persistables(None, str(tmp_path), main, filename="one")
    fresh = TF.Scope()
    with TF.scope_guard(fresh):
        TF.io.load_persistables(None, str(tmp_path), main, filename="one")
    assert torch.equal(fresh.get("only"), scope.get("only"))


def test_a_feed_that_reaches_no_target_raises_in_both(tmp_path):
    msgs = []
    for fluid in (JF, TF):
        main, _, pred, _ = _mlp(fluid)
        with pytest.raises(ValueError, match="do not reach") as e:
            fluid.io.save_inference_model(str(tmp_path / fluid.__name__),
                                          ["x", "label"], [pred], None, main,
                                          program_only=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _runs(prog_of, steps=3):
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    main, startup, pred, loss = _mlp(TF)
    exe.run(startup, scope=scope)
    out = [exe.run(prog_of(main, loss), feed=_feed(i), fetch_list=[loss],
                   scope=scope)[0] for i in range(steps)]
    return out, {n: scope.get(n).numpy() for n in scope.local_var_names()}


def test_compiled_program_gives_executor_runs_bits():
    plain = _runs(lambda main, loss: main)
    compiled = _runs(lambda main, loss: TF.CompiledProgram(
        main).with_data_parallel(loss_name=loss.name,
                                 build_strategy=TF.BuildStrategy(),
                                 exec_strategy=TF.ExecutionStrategy(),
                                 places=[TF.CPUPlace()]))
    np.testing.assert_array_equal(compiled[0], plain[0])
    for n, v in plain[1].items():
        np.testing.assert_array_equal(compiled[1][n], v, err_msg=n)


def test_parallel_executor_gives_executor_runs_bits():
    main, startup, pred, loss = _mlp(TF)
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    exe.run(startup, scope=scope)
    state = {n: scope.get(n).clone() for n in scope.local_var_names()}
    want = [exe.run(main, feed=_feed(i), fetch_list=[loss],
                    scope=scope)[0] for i in range(2)]
    for n, v in state.items():
        scope.set(n, v)
    pe = TS.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                             main_program=main, scope=scope)
    got = [pe.run(fetch_list=[loss], feed=_feed(i))[0] for i in range(2)]
    np.testing.assert_array_equal(got, want)


def test_more_than_one_device_raises():
    """One process drives one card: several places raise (start a rank a
    card); a data axis of two, a sequence axis of two, or two trainers,
    needs a live group of two (test_torch_data_parallel.py,
    test_torch_spmd.py and test_torch_seq_parallel.py run them)."""
    main = TF.Program()
    with pytest.raises(NotImplementedError, match="one process drives one"):
        TF.CompiledProgram(main).with_data_parallel(
            places=[TF.CUDAPlace(0), TF.CUDAPlace(1)])
    bs = TF.BuildStrategy()
    bs.mesh_axes = {"data": 2}
    with pytest.raises(ValueError, match="!= 1 ranks"):
        TF.CompiledProgram(main, bs).with_data_parallel()
    bs.mesh_axes = {"data": 1, "seq": 2}
    with pytest.raises(ValueError, match="!= 1 ranks"):
        TF.CompiledProgram(main, bs).with_data_parallel()
    bs.mesh_axes = {"data": 1}
    TF.CompiledProgram(main, bs).with_data_parallel()
    with pytest.raises(RuntimeError, match="num_trainers=2"):
        TS.ParallelExecutor(use_cuda=False, main_program=main,
                            num_trainers=2)


def test_static_save_load_and_program_state(tmp_path):
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    main, _ = _trained(TF, exe, scope)
    state = {n: scope.get(n).numpy() for n in scope.local_var_names()}
    TS.save(state, str(tmp_path / "state"))
    TS.save(main, str(tmp_path / "prog.json"))
    assert TS.load(str(tmp_path / "prog.json")).to_dict() == main.to_dict()
    loaded = TS.load_program_state(str(tmp_path / "state"))
    assert sorted(loaded) == sorted(state)
    fresh = TF.Scope()
    with TF.scope_guard(fresh):
        TS.set_program_state(main, loaded)
    for n, v in state.items():
        np.testing.assert_array_equal(fresh.get(n).numpy(), v)
    with pytest.raises(ValueError, match="not in the program"):
        TS.set_program_state(main, {"no_such_var": np.zeros(1)})
