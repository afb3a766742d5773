"""The int8 blockwise quantized collectives of the port
(parallel/quant_collectives.py), held against the reference's
(paddle_tpu/parallel/quant_collectives.py, tests/test_quant_collectives.py):

* the codec in one process: codes and scales bit for bit with the
  reference's `quantize_blockwise` on the same blocks (round half to
  even), the half-step error bound, zero blocks safe, `wire_bytes` equal,
  the mode's parsing;
* over four gloo ranks on the CPU (one spawn of the JAX-free
  tests/torch_dist_worker.py suite `quant`): `quant_allreduce_sum`,
  `quant_reducescatter` and `quant_allgather` on 2 and 4 ranks against
  the reference's inside `shard_map` over as many devices, within 1e-6
  relative, and within the half-step bound of the exact sum; the
  c_allreduce_sum / c_reducescatter / c_allgather rules under
  PADDLE_QUANT_COLLECTIVES=int8 against full width (2 % relative, a 3.5x
  drop of `collective_bytes_<op>`, as test_explicit_parity_and_counter_drop)
  and the min-bytes floor; the tiny transformer on the compiler's SPMD
  arm over {data: 2, fsdp: 2}, int8 against full width: losses, update
  ratios and the gradient norm within 5 % (the reference's
  test_spmd_quantized_train_health_within_5pct), the gradients' wire
  bytes down 3.5x.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.parallel import mesh as Jmesh
from paddle_tpu.parallel import quant_collectives as jqc

from paddle_tpu_torch.parallel import quant_collectives as qc

import torch_dist_worker as W
from test_torch_collective import finish_ranks, fork_ranks

WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


@pytest.fixture
def env(monkeypatch):
    for k in ("PADDLE_QUANT_COLLECTIVES",
              "PADDLE_QUANT_COLLECTIVES_MIN_BYTES"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# -- the codec ---------------------------------------------------------------------

@pytest.mark.parametrize("size,scale", [(1000, 3.0), (256, 1e-3), (7, 50.0),
                                        (4096, 1.0)])
def test_codes_are_the_references_bit_for_bit(size, scale):
    rng = np.random.RandomState(size)
    x = (rng.randn(size) * scale).astype(np.float32)
    x[::97] = 0.5 * np.abs(x).max() / 127 * (2 * (np.arange(
        len(x[::97])) % 2) - 1)  # exact half steps: round half to even
    blocks = qc.pack(torch.from_numpy(x))
    jblocks = jqc.pack(jnp.asarray(x))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    q, s = qc.quantize_blockwise(blocks)
    jq, js = jqc.quantize_blockwise(jblocks)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = qc.dequantize_blockwise(q, s)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jqc.dequantize_blockwise(jq, js)))
    assert (back - blocks).abs().le(s[:, None] / 2 + 1e-7).all()


def test_zero_blocks_are_safe():
    q, s = qc.quantize_blockwise(qc.pack(torch.zeros(512)))
    assert q.eq(0).all() and s.eq(0).all()
    back = qc.dequantize_blockwise(q, s)
    assert torch.isfinite(back).all() and back.eq(0).all()


@pytest.mark.parametrize("shape,axis_size", [((8,), None), ((8, 512), 8),
                                             ((16, 300), 4), ((3, 5), 2)])
def test_wire_bytes_are_the_references(shape, axis_size):
    assert qc.wire_bytes(torch.zeros(shape), axis_size=axis_size) == \
        jqc.wire_bytes(np.zeros(shape, np.float32), axis_size=axis_size)


def test_the_mode_is_parsed_as_the_references(env):
    for value, want in ((None, "off"), ("int8", "int8"), ("1", "int8"),
                        ("ON", "int8"), ("garbage", "off"), ("off", "off")):
        if value is None:
            env.delenv("PADDLE_QUANT_COLLECTIVES", raising=False)
        else:
            env.setenv("PADDLE_QUANT_COLLECTIVES", value)
        assert qc.mode() == want == jqc.mode()
    assert qc.signature_token() == jqc.signature_token()
    env.setenv("PADDLE_QUANT_COLLECTIVES_MIN_BYTES", "64")
    assert qc.min_bytes() == 64 == jqc.min_bytes()


# -- four gloo ranks --------------------------------------------------------------

def _reference_functions():
    """The reference's three collectives inside shard_map over n devices
    (one jit of the three a size): each rank's result."""
    out = {}
    fns = (("allreduce", jqc.quant_allreduce_sum),
           ("reducescatter", jqc.quant_reducescatter),
           ("allgather", jqc.quant_allgather))
    for n in (2, WORLD):
        mesh = Jmesh.make_mesh({"d": n}, devices=jax.devices()[:n])
        x = jnp.asarray(W.quant_input(n).reshape(
            n * W.QUANT_ROWS, W.QUANT_COLS))
        got = jax.jit(shard_map(
            lambda a: tuple(fn(a, "d") for _, fn in fns), mesh=mesh,
            in_specs=JP("d"), out_specs=(JP("d"),) * len(fns),
            check_rep=False))(x)
        for (name, _), y in zip(fns, got):
            out[f"fn{n}.{name}"] = np.split(np.asarray(y), n)
    return out


@pytest.fixture(scope="module", autouse=True)
def _ranks(tmp_path_factory, _no_shared_aot_cache):
    """The gloo ranks start with the module, so they run beside the
    codec's tests; they wait for the initial weights (`ready`).  `runs`
    collects them."""
    workdir = tmp_path_factory.mktemp("quant")
    started = fork_ranks("quant", WORLD, workdir)
    try:
        main, startup, _ = W.tiny_program(JF, JU)
        exe, scope = JF.Executor(), JF.Scope()
        exe.run(startup, scope=scope)
        np.savez(os.path.join(workdir, "tiny_startup.npz"),
                 **{n: np.asarray(scope.get(n))
                    for n in scope.local_var_names()})
    finally:
        (workdir / "ready").touch()
    yield started
    for p in started[3]:
        if p.poll() is None:  # no test asked for `runs`
            p.communicate()


@pytest.fixture(scope="module")
def runs(_ranks):
    ref = _reference_functions()
    return finish_ranks(_ranks), ref


@pytest.mark.parametrize("n", [2, WORLD])
@pytest.mark.parametrize("name", ["allreduce", "reducescatter", "allgather"])
def test_the_collectives_match_the_references(runs, name, n):
    res, ref = runs
    x = W.quant_input(n)
    exact = {"allreduce": lambda r: x.sum(0),
             "reducescatter": lambda r: np.split(x.sum(0), n)[r],
             "allgather": lambda r: x.reshape(-1, W.QUANT_COLS)}[name]
    for r in range(n):
        got = res[r][0][f"fn{n}.{name}"]
        want = ref[f"fn{n}.{name}"][r]
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        # the half-step bound: one quantization of each rank's chunk, and
        # (all-reduce) one of the partial sum
        step = np.abs(x).max() / 127
        bound = step / 2 * (n + (n if name == "allreduce" else 0)) \
            if name != "allgather" else step / 2
        assert np.abs(got - exact(r)).max() <= bound + 1e-6


@pytest.mark.parametrize("op_type", [t for t, _ in W.QUANT_RULES])
def test_the_rules_quantize_and_their_bytes_drop(runs, op_type):
    res, _ = runs
    for arrays, meta in res:
        full, quant = (arrays[f"rule.{op_type}.{m}"] for m in ("off", "int8"))
        assert quant.shape == full.shape
        rel = np.abs(quant - full).max() / np.abs(full).max()
        assert rel < 0.02, rel
        ratio = meta[f"rule.{op_type}.off"] / meta[f"rule.{op_type}.int8"]
        assert ratio >= 3.5, ratio
        assert meta[f"rule.{op_type}.off"] == 16 * 512 * 4


def test_the_floor_keeps_small_payloads_full_width(runs):
    res, _ = runs
    for arrays, meta in res:
        assert meta["rule.floor"] == 16 * 4 * 4
        np.testing.assert_allclose(arrays["rule.floor"],
                                   np.full((16, 4), WORLD), rtol=1e-6)


def test_the_spmd_arms_quantized_training_stays_healthy(runs):
    res, _ = runs
    for arrays, meta in res:
        f, q = (arrays[f"spmd.{m}.losses"] for m in ("off", "int8"))
        np.testing.assert_allclose(q, f, rtol=0.02, atol=0.01)
        fr, qr = (arrays[f"spmd.{m}.update_ratio"] for m in ("off", "int8"))
        assert np.all(np.abs(qr - fr) <= 0.05 * np.abs(fr) + 1e-9)
        gf, gq = (meta[f"spmd.{m}.grad_norm"] for m in ("off", "int8"))
        assert abs(gq - gf) <= 0.05 * abs(gf)
        wire = lambda m: sum(v for k, v in meta[f"spmd.{m}.bytes"].items()
                             if k.endswith(("all_reduce", "reduce_scatter")))
        assert wire("off") / wire("int8") >= 3.5
        assert not any(k.endswith("reduce_scatter")
                       for k in meta["spmd.int8.bytes"])
