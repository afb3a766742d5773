"""The small names of the top level, `fluid`, `static` and `amp`, and the
flag registry, against paddle_tpu's on the CPU.

- Every name the reference's top level, `fluid`, `static` and `amp`
  give for this slice exists in the port.
- A LoDTensor feeds the Executor as its array does, in both packages.
- The flags: the port registers every name of the reference's registry
  with the reference's default; check_nan_inf acts (its raise is held
  in tests/test_torch_dataset.py); a flag of machinery the port lacks
  takes its default and raises NotImplementedError naming its ROADMAP
  item on another value, set or from the environment; a parity flag
  takes any value.
- The answers that differ by design: is_compiled_with_cuda (torch's
  CUDA, where the reference says False), the CUDA rng state (torch's
  generators, where the reference returns []).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as JFL

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import static as TS
from paddle_tpu_torch.fluid import flags as TFL

TOP = ["get_flags", "set_flags", "LoDTensor", "LoDTensorArray",
       "is_compiled_with_cuda", "disable_static_mode", "tpu_places",
       "get_cuda_rng_state", "set_cuda_rng_state"]
FLUID = ["LoDTensor", "LoDTensorArray", "device_count",
         "is_compiled_with_cuda", "is_compiled_with_tpu", "tpu_places",
         "cuda_places", "dataset", "DatasetFactory", "InMemoryDataset",
         "QueueDataset", "io", "compiler", "CompiledProgram",
         "BuildStrategy", "ExecutionStrategy"]
STATIC = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
          "ParallelExecutor", "save", "load", "load_program_state",
          "set_program_state"]
AMP = ["AmpScaler", "amp_guard", "cast_inputs_if_amp"]
UNPORTED = {"check_numerics": True, "verify_program": "off",
            "graph_transforms": "off", "transform_debug": True,
            "obs_http_port": 0,
            "obs_flight_dir": "x", "quant_collectives": "int8",
            "quant_collectives_min_bytes": 1, "aot_cache": "off",
            "aot_cache_dir": "y", "autotune": "force",
            "autotune_trial_steps": 1}
PARITY = {"allocator_strategy": "naive_best_fit",
          "eager_delete_tensor_gb": 1.0,
          "fraction_of_gpu_memory_to_use": 0.5, "paddle_num_threads": 4,
          "sync_nccl_allreduce": False, "use_pinned_memory": False,
          "sort_sum_gradient": True}


@pytest.mark.parametrize("module,names", [
    ("top", TOP), ("fluid", FLUID), ("static", STATIC), ("amp", AMP)])
def test_the_names_exist_in_both(module, names):
    ref = {"top": J, "fluid": JF, "static": J.static, "amp": J.amp}[module]
    port = {"top": T, "fluid": TF, "static": TS, "amp": T.amp}[module]
    assert [n for n in names if not hasattr(ref, n)] == []
    assert [n for n in names if not hasattr(port, n)] == []


def test_a_lodtensor_feeds_as_its_array():
    x = np.arange(12, dtype="float32").reshape(3, 4)
    outs = []
    for fluid, exe in ((JF, JF.Executor()), (TF, TF.Executor(TF.CPUPlace()))):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            v = fluid.data("x", [-1, 4], "float32")
            y = fluid.layers.scale(v, 2.0)
        t = fluid.LoDTensor()
        t.set(x, fluid.CPUPlace())
        t.set_recursive_sequence_lengths([[1, 2]])
        assert t.shape() == [3, 4] and t.lod() == [[1, 2]]
        outs.append(exe.run(main, feed={"x": t}, fetch_list=[y])[0])
    np.testing.assert_array_equal(outs[1], outs[0])
    t = TF.LoDTensor()
    t.set(x)
    assert np.asarray(t) is t._array  # fed without a host copy


def test_every_reference_flag_is_registered_with_its_default():
    assert set(TFL._REGISTRY) == set(JFL._REGISTRY)
    for name, entry in JFL._REGISTRY.items():
        assert TFL._REGISTRY[name]["default"] == entry["default"], name
    assert T.get_flags("FLAGS_check_nan_inf") is False
    with pytest.raises(ValueError, match="unknown flag"):
        T.set_flags({"FLAGS_no_such_flag": 1})


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_a_flag_of_missing_machinery_takes_its_default_only(name):
    default = TFL.get_flags(name)
    T.set_flags({f"FLAGS_{name}": default})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        T.set_flags({f"FLAGS_{name}": UNPORTED[name]})
    assert TFL.get_flags(name) == default


def test_a_flag_of_missing_machinery_from_the_environment_raises_at_use(
        monkeypatch):
    monkeypatch.setitem(TFL._REGISTRY["aot_cache"], "value", "off")
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        TF.layers.scale(TF.data("x", [-1, 2], "float32"), 2.0)
    with pytest.raises(NotImplementedError, match="item 11"):
        TF.Executor(TF.CPUPlace()).run(
            main, feed={"x": np.ones((1, 2), "float32")})


def test_a_parity_flag_takes_any_value():
    old = TFL.get_flags(list(PARITY))
    try:
        T.set_flags({f"FLAGS_{k}": v for k, v in PARITY.items()})
        assert TFL.get_flags(list(PARITY)) == PARITY
    finally:
        T.set_flags(old)


def test_the_answers_that_differ_by_design():
    assert J.is_compiled_with_cuda() is False
    assert T.is_compiled_with_cuda() == torch.cuda.is_available()
    assert TF.is_compiled_with_tpu() is False
    assert TF.device_count() == torch.cuda.device_count()
    assert J.get_cuda_rng_state() == []
    if not torch.cuda.is_available():
        assert T.get_cuda_rng_state() == []
        T.set_cuda_rng_state([])
    assert TF.tpu_places is TF.cuda_places


def test_cast_inputs_if_amp_casts_as_the_reference():
    import jax.numpy as jnp

    x = np.ones((2, 2), "float32")
    for op, level in (("matmul", "O1"), ("softmax", "O1"), ("relu", "O2")):
        with J.amp.amp_guard(level=level):
            want, jcast = J.amp.cast_inputs_if_amp(op, {"X": [jnp.asarray(x)]})
        with T.amp.amp_guard(level=level):
            got, tcast = T.amp.cast_inputs_if_amp(
                op, {"X": [torch.from_numpy(x)]})
        assert tcast == jcast, op
        assert str(got["X"][0].dtype).split(".")[-1] == \
            str(want["X"][0].dtype), op
    assert T.amp.cast_inputs_if_amp("matmul", {"X": [1]}) == (
        {"X": [1]}, False)
    assert T.amp.AmpScaler is T.amp.GradScaler
