"""Sharded checkpoints of the port over two gloo ranks on the CPU (one
spawn of the JAX-free tests/torch_dist_worker.py suite `ckpt`), held
against the reference (paddle_tpu/ckpt/manager.py):

* tests/test_spmd_sharding.py::TestShardedCheckpoint's cases on two live
  ranks: a DTensor's layout recorded in the manifest (its spec, the live
  mesh axes) and restored, another live mesh refused naming both, the
  weights-only restore; a replicated state under a mesh keeps the
  merge-all format; a checkpoint with a recorded mesh restored
  owned-shards-only (each rank reads its own file); and a restore by
  another process count refused naming both;
* checkpoints that cross packages both ways: the reference's sharded
  checkpoint (two mocked hosts) restored by the port's ranks, the port's
  read by the reference's `read_state` and owned-only `restore`;
* the compiler's SPMD arm (the tiny transformer over {data: 1, fsdp: 2})
  through train_from_dataset with a checkpoint a step, stopped after
  step 2 and resumed by a fresh Executor, scope and CompiledProgram: the
  uninterrupted run's losses and parameters bit for bit.
"""

import os

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as JP

import paddle_tpu.fluid as JF
from paddle_tpu.ckpt import manager as JM
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.parallel import mesh as Jmesh

import torch_dist_worker as W
from test_torch_collective import finish_ranks, fork_ranks

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ckpt")
    # the ranks start first and wait for the reference's checkpoint and
    # the initial weights (`ready`)
    started = fork_ranks("ckpt", WORLD, workdir)
    try:
        main, startup, _ = W.tiny_program(JF, JU)
        exe, scope = JF.Executor(), JF.Scope()
        exe.run(startup, scope=scope)
        np.savez(os.path.join(workdir, "tiny_startup.npz"),
                 **{n: np.asarray(scope.get(n))
                    for n in scope.local_var_names()})
        # the reference's sharded checkpoint, written by two mocked hosts
        mesh = Jmesh.make_mesh({"data": 4, "fsdp": 2})
        Jmesh.set_current_mesh(mesh)
        try:
            sh = NamedSharding(mesh, JP("fsdp"))
            state = {n: jax.device_put(v, sh)
                     for n, v in W.CKPT_OWNED.items()}
            for host in (1, 0):  # host 0 commits last
                JM.CheckpointManager(str(workdir / "from_reference"),
                                     process_index=host,
                                     process_count=2).save(state, step=3)
        finally:
            Jmesh.set_current_mesh(None)
    finally:
        (workdir / "ready").touch()
    return finish_ranks(started), workdir


def test_the_manifest_records_the_layout_and_round_trips(runs):
    res, _ = runs
    for rank, (arrays, meta) in enumerate(res):
        man = meta["layout.manifest"]
        assert man["mesh_axes"] == {"data": 1, "fsdp": 2, "tp": 1}
        assert man["process_count"] == 2
        assert man["shards"] == ["shard_00000.npz", "shard_00001.npz"]
        assert meta["layout.vars"]["w"]["spec"] == ["fsdp", "tp"]
        assert meta["layout.vars"]["w"]["shape"] == [16, 8]
        assert "spec" not in meta["layout.vars"]["b"]
        # owned shards only: the var dealt to this rank, whole
        mine = sorted(n for n, v in meta["layout.vars"].items()
                      if v["shard"] == rank)
        assert meta["layout.back"] == mine
        if "w" in mine:
            np.testing.assert_array_equal(arrays["layout.w"], W.CKPT_W)
        assert "mesh axes" in meta["layout.other_mesh"]
        assert "{'data': 2}" in meta["layout.other_mesh"]
        assert meta["layout.loose"] == ["b", "w"]
        np.testing.assert_array_equal(arrays["layout.loose_w"], W.CKPT_W)


def test_a_replicated_checkpoint_stays_legacy(runs):
    res, _ = runs
    assert [meta["legacy.mesh_axes"] for _, meta in res] == [False, False]


def test_each_rank_restores_only_its_own_shards(runs):
    res, _ = runs
    owned = [meta["owned.back"] for _, meta in res]
    assert owned[0] and owned[1] and set(owned[0]).isdisjoint(owned[1])
    assert sorted(owned[0] + owned[1]) == sorted(W.CKPT_OWNED)
    for arrays, meta in res:
        assert meta["owned.back"] == meta["owned.mine"]
        for n in meta["owned.back"]:
            np.testing.assert_array_equal(arrays[f"owned.{n}"],
                                          W.CKPT_OWNED[n])


def test_another_process_count_is_refused_naming_both(runs):
    res, _ = runs
    for _, meta in res:
        msg = meta["owned.one_host"]
        assert "topology mismatch" in msg and "2 host(s)" in msg \
            and "runs 1" in msg
        assert meta["owned.loose"] == sorted(W.CKPT_OWNED)


def test_the_ports_ranks_restore_the_references_checkpoint(runs):
    res, workdir = runs
    man = JM.CheckpointManager(str(workdir / "from_reference"),
                               process_index=0, process_count=2)
    manifest = man.read_meta(man.latest())
    for rank, (arrays, meta) in enumerate(res):
        mine = sorted(n for n, v in manifest["vars"].items()
                      if v["shard"] == rank)
        assert meta["from_reference.back"] == mine
        for n in mine:
            np.testing.assert_array_equal(arrays[f"from_reference.{n}"],
                                          W.CKPT_OWNED[n])


def test_the_reference_reads_the_ports_sharded_checkpoint(runs):
    _, workdir = runs
    root = str(workdir / "owned")
    state, manifest = JM.read_state(root)
    assert manifest["mesh_axes"] == {"data": 1, "fsdp": 2}
    assert manifest["vars"]["w0"]["spec"] == ["fsdp"]
    for n, v in W.CKPT_OWNED.items():
        np.testing.assert_array_equal(np.asarray(state[n]), v)
    Jmesh.set_current_mesh(None)
    back, _ = JM.CheckpointManager(root, process_index=0,
                                   process_count=2).restore()
    mine = sorted(n for n, v in manifest["vars"].items() if v["shard"] == 0)
    assert sorted(back) == mine


def test_a_resumed_spmd_run_is_the_uninterrupted_run_bit_for_bit(runs):
    res, _ = runs
    for arrays, meta in res:
        r = meta["resume"]
        steps = [str(k) for k in range(1, W.CKPT_STEPS + 1)]
        assert sorted(r["whole"]) == steps
        assert sorted(r["part"]) == steps[:W.CKPT_PREEMPT]
        assert sorted(r["rest"]) == steps[W.CKPT_PREEMPT:]
        for k in steps[:W.CKPT_PREEMPT]:
            assert r["part"][k] == r["whole"][k]
        for k in steps[W.CKPT_PREEMPT:]:
            assert r["rest"][k] == r["whole"][k]
        names = sorted(k[len("resume.whole."):] for k in arrays
                       if k.startswith("resume.whole."))
        assert "fc_0.w_0" in names and "fc_0.w_0_moment1_0" in names
        for n in names:
            np.testing.assert_array_equal(arrays[f"resume.rest.{n}"],
                                          arrays[f"resume.whole.{n}"],
                                          err_msg=n)
        # each rank held its half of the fsdp-split weight, and the
        # checkpoint recorded the mesh
        assert r["shards"] == [[8, 64], [8, 64]]
        assert meta["resume.manifest"] == {"data": 1, "fsdp": 2}
