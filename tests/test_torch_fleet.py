"""Fleet's surface in the port against the reference's, on the CPU.

In one process: every ported meta-optimizer's program rewrite (the
reference's fleet_meta_optimizer_base.py pattern: build, minimize,
compare) gives the reference's main and startup Program JSON and
applied_meta_list, with UserDefinedRoleMaker(worker_num=2) where the
strategy needs several workers (test_distributed.py:97); the
dropped-candidate warning; Fleet's sharding strategy annotating what
the reference's does; the strategies and names that wait for ROADMAP
queue 1 item 10b (ii)-(iv) raise naming it; the role makers, get_cluster
and the trainer environment; the backend rule (nccl on CUDA, gloo on
the CPU or when asked; two NCCL ranks on one card refused).  Then two
spawns at once: distributed.launch of a two-rank script (tests/
torch_dist_worker.py `launched`) whose rank 1 exits with 7, and spawn of
a two-rank function whose rank 1 exits with 5: each rank joins the
group under the PADDLE_* contract, and the launcher returns (spawn's
join returns, a joining spawn raises with) the first nonzero exit code.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu.distributed import fleet as Jfleet
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch.distributed as TD
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.distributed import fleet as Tfleet
from paddle_tpu_torch.distributed import launch as Tlaunch
from paddle_tpu_torch.distributed import launch_utils as TLU
from paddle_tpu_torch.distributed import parallel as TP
from paddle_tpu_torch.fluid import unique_name as TU

import torch_dist_worker as W


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _strategy(fleet, **kw):
    s = fleet.DistributedStrategy()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _minimized(fluid, fleet, unique_name, strategy_kw, opt, nranks,
               checkpoint=False):
    """main, startup, applied_meta_list and the warnings of one fleet
    minimize of the fc net of test_distributed.py."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard(), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = fluid.data("x", [-1, 8], "float32")
        label = fluid.data("label", [-1, 1], "int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(fluid.layers.fc(h, 16, act="relu"), 4)
        loss = fluid.layers.reduce_mean(
            fluid.layers.loss.softmax_with_cross_entropy(pred, label))
        kw = dict(strategy_kw)
        if checkpoint:
            kw["recompute_configs"] = {"checkpoints": [h.name]}
        strategy = _strategy(fleet, **kw)
        fleet.fleet.init(role_maker=fleet.UserDefinedRoleMaker(
            worker_num=nranks, current_id=0), strategy=strategy)
        fo = fleet.fleet.distributed_optimizer(opt(fluid), strategy)
        fo.minimize(loss)
    return (main, startup, fleet.fleet.applied_meta_list(),
            [str(w.message) for w in caught
             if "NOT applied" in str(w.message)])


SGD = lambda f: f.optimizer.SGD(0.1)  # noqa: E731
ADAM = lambda f: f.optimizer.Adam(0.001)  # noqa: E731
MOMENTUM = lambda f: f.optimizer.Momentum(0.1, 0.9)  # noqa: E731

# name -> (strategy fields, inner optimizer, workers, checkpoints?)
STRATEGIES = {
    "graph_execution": ({}, SGD, 2, False),
    "amp": ({"amp": True}, ADAM, 1, False),
    "amp_over_two": ({"amp": True}, ADAM, 2, False),
    "recompute": ({"recompute": True}, ADAM, 1, True),
    "gradient_merge": ({"gradient_merge": True,
                        "gradient_merge_configs": {"k_steps": 4,
                                                   "avg": True}},
                       ADAM, 2, False),
    "lamb": ({"lamb": True}, ADAM, 2, False),
    "lars": ({"lars": True}, MOMENTUM, 2, False),
    "localsgd": ({"localsgd": True}, SGD, 2, False),
    "dgc": ({"dgc": True, "dgc_configs": {"rampup_begin_step": 0,
                                          "sparsity": [0.5]}},
            MOMENTUM, 2, False),
    "fp16_allreduce": ({"fp16_allreduce": True}, SGD, 2, False),
    "amp_drops_dgc": ({"amp": True, "dgc": True,
                       "dgc_configs": {"rampup_begin_step": 0}},
                      MOMENTUM, 2, False),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_meta_optimizer_program_is_the_references(name):
    kw, opt, nranks, ckpt = STRATEGIES[name]
    jm, js, japplied, jwarn = _minimized(JF, Jfleet, JU, kw, opt, nranks,
                                         ckpt)
    tm, ts, tapplied, twarn = _minimized(TF, Tfleet, TU, kw, opt, nranks,
                                         ckpt)
    assert tapplied == japplied and tapplied
    assert twarn == jwarn
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)


def test_the_choice_and_order_are_the_references():
    applied = {n: _minimized(TF, Tfleet, TU, *STRATEGIES[n])[2]
               for n in ("graph_execution", "amp_over_two", "dgc",
                         "fp16_allreduce", "lamb")}
    assert applied == {
        "graph_execution": ["GraphExecutionOptimizer"],
        "amp_over_two": ["AMPOptimizer", "GraphExecutionOptimizer"],
        "dgc": ["DGCOptimizer"],
        "fp16_allreduce": ["FP16AllReduceOptimizer"],
        "lamb": ["LambOptimizer", "GraphExecutionOptimizer"]}
    main = _minimized(TF, Tfleet, TU, *STRATEGIES["graph_execution"])[0]
    types = [op.type for op in main.global_block().ops]
    assert types.count("c_allreduce_sum") == 6  # 3 weights + 3 biases


def test_a_dropped_candidate_warns_and_flips_its_flag():
    *_, applied, warned = _minimized(TF, Tfleet, TU,
                                     *STRATEGIES["amp_drops_dgc"])
    assert applied == ["AMPOptimizer", "GraphExecutionOptimizer"]
    assert warned == ["fleet: DGCOptimizer is incompatible with the "
                      "selected meta-optimizer chain and was NOT applied"]
    assert Tfleet.fleet._user_defined_strategy.dgc is False


@pytest.mark.parametrize("field", ["sharding", "pipeline"])
def test_the_model_parallel_strategies_raise_naming_10b(field):
    """`pipeline` waits for ROADMAP queue 1 item 10b (iv) and raises;
    `sharding` is taken since 10b (i): the program and the applied list
    are the reference's, and the same accumulators carry its ZeRO
    annotation (stages 1 and 3; the run is in test_torch_spmd.py)."""
    if field == "pipeline":
        with pytest.raises(NotImplementedError, match="item 10b"):
            _minimized(TF, Tfleet, TU, {field: True}, ADAM, 2)
        return
    for stage in (1, 3):
        kw = {field: True, "sharding_configs": {"stage": stage}}
        got = [_minimized(pkg, fleet, un, kw, ADAM, 2)
               for pkg, fleet, un in ((JF, Jfleet, JU), (TF, Tfleet, TU))]
        (jm, _, japplied, _), (tm, _, tapplied, _) = got
        assert tapplied == japplied == ["ShardingOptimizer"]
        assert _json(tm) == _json(jm)
        marked = [{n: getattr(v, "_sharding_axes", None)
                   for n, v in m.global_block().vars.items()
                   if getattr(v, "_sharding_axes", None)} for m in (jm, tm)]
        assert marked[1] == marked[0] and marked[1]
        assert any(".w_0" == n[-4:] for n in marked[1]) == (stage == 3)


def test_the_other_10b_names_raise():
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        PipelineOptimizer, ShardingOptimizer)
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.parallel import mesh as M

    with pytest.raises(NotImplementedError, match="item 10b"):
        _minimized(TF, Tfleet, TU, {"localsgd": True,
                                    "localsgd_configs": {"k_steps": 2}},
                   SGD, 2)
    for cls in (PipelineOptimizer,):
        with pytest.raises(NotImplementedError, match="item 10b"):
            cls(None).minimize_impl(None)
    # ShardingOptimizer and the fsdp / tp axes are taken
    # (test_torch_spmd.py), the sequence axes too
    # (test_torch_seq_parallel.py); the pipeline axis is not
    assert ShardingOptimizer(None).meta_optimizers_white_list == [
        "GraphExecutionOptimizer"]
    for axes in ({"data": 1, "seq": 2}, {"sp": 2}):
        assert M.make_mesh(axes, devices=range(2)).shape == axes
    with pytest.raises(NotImplementedError, match="item 10b"):
        M.make_mesh({"pipe": 2}, devices=range(2))
    bs = TF.BuildStrategy()
    bs.mesh_axes = {"model": 2}
    with pytest.raises(NotImplementedError, match="item 10b"):
        TF.CompiledProgram(TF.Program(), bs).with_data_parallel()
    model = TB.BertForPretraining(TB.BertConfig.tiny(), device="cpu")
    model.bert.config.moe_experts = 4
    with pytest.raises(NotImplementedError, match="item 10b"):
        TB.build_pretrain_step(model)


def test_a_world_of_one_is_todays_program():
    """fleet.init with one worker applies nothing (no transpile) and
    with_data_parallel runs the program itself."""
    main, _, applied, _ = _minimized(TF, Tfleet, TU, {}, SGD, 1)
    assert applied == []
    assert "c_allreduce_sum" not in [op.type for op in
                                     main.global_block().ops]
    compiled = TF.CompiledProgram(main).with_data_parallel()
    assert compiled._program_to_run() is main


# -- role makers, topology, backend -------------------------------------------------

def test_role_makers_read_the_contract(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3,127.0.0.1:4")
    for fleet in (Jfleet, Tfleet):
        rm = fleet.PaddleCloudRoleMaker(is_collective=True)
        assert (rm.worker_index(), rm.worker_num()) == (2, 4)
        assert not rm.is_first_worker() and rm.is_worker()
        assert len(rm.get_trainer_endpoints()) == 4
        um = fleet.UserDefinedRoleMaker(current_id=1, worker_num=3)
        assert (um.worker_index(), um.worker_num()) == (1, 3)
    env = TP.ParallelEnv()
    assert (env.rank, env.world_size, env.local_rank) == (2, 4, 2)
    assert TP.process_index() == 2 and TP.process_count() == 4
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(k)
    files = [f"f{i}" for i in range(7)]
    Tfleet.fleet.init(role_maker=Tfleet.UserDefinedRoleMaker(
        current_id=1, worker_num=3))
    Jfleet.fleet.init(role_maker=Jfleet.UserDefinedRoleMaker(
        current_id=1, worker_num=3))
    assert Tfleet.util.get_file_shard(files) == \
        Jfleet.util.get_file_shard(files) == ["f3", "f4"]


def test_get_cluster_deals_the_cards():
    cluster, pod = TLU.get_cluster(["10.0.0.1", "10.0.0.2"], "10.0.0.2",
                                   6170, 3, gpus=[0, 1])
    assert cluster.world_size() == 6 and pod.ip == "10.0.0.2"
    assert [t.rank for t in pod.trainers] == [3, 4, 5]
    assert [t.accelerators for t in pod.trainers] == [[0], [1], [0]]
    assert cluster.endpoints()[:3] == ["10.0.0.1:6170", "10.0.0.1:6171",
                                       "10.0.0.1:6172"]
    env = TLU.trainer_env(cluster, pod.trainers[1])
    assert env["PADDLE_TRAINER_ID"] == "4"
    assert env["PADDLE_TRAINERS_NUM"] == "6"
    assert env["PADDLE_CURRENT_ENDPOINT"] == "10.0.0.2:6171"
    assert env["PADDLE_LOCAL_RANK"] == "1"
    assert env["FLAGS_selected_gpus"] == "1"
    assert not hasattr(TLU, "get_cluster_from_tpu_env")
    with pytest.raises(ValueError):
        TLU.get_cluster(["10.0.0.1"], "10.0.0.9", 6170, 1)
    cpu_cluster, cpu_pod = TLU.get_cluster(["127.0.0.1"], "127.0.0.1", 6170,
                                           1)
    # no cards: the launcher sets no FLAGS_selected_gpus of its own
    assert cpu_pod.trainers[0].accelerators == []
    assert TLU.trainer_env(cpu_cluster, cpu_pod.trainers[0]).get(
        "FLAGS_selected_gpus") == os.environ.get("FLAGS_selected_gpus")


def test_the_backend_rule(monkeypatch):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND", raising=False)
    assert TP.select_backend(cuda) == "nccl"
    assert TP.select_backend(cpu) == "gloo"
    assert TP.select_backend(cuda, "gloo") == "gloo"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TP.select_backend(cpu, "nccl")
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    assert TP.select_backend(cuda) == "gloo"
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "mpi")
    with pytest.raises(ValueError):
        TP.select_backend(cuda)


def test_two_nccl_ranks_on_one_card_are_refused(monkeypatch):
    """Nothing starts: the refusal names both counts."""
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND", raising=False)
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"2 NCCL ranks on this host but "
                       r"1 card"):
        TD.init_parallel_env(rank=0, world_size=2,
                             store=torch.distributed.HashStore())
    assert not TP.is_initialized()
    assert TP.rank_device().index == 0


def test_a_multi_trainer_parallel_executor_needs_its_group():
    from paddle_tpu_torch import static as TS

    with pytest.raises(RuntimeError, match="num_trainers=2"):
        TS.ParallelExecutor(use_cuda=False, main_program=TF.Program(),
                            num_trainers=2, trainer_id=1)


# -- launch and spawn ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """distributed.launch of the worker's `launched` script (rank 1 exits
    with 7) and, at the same time, spawn of its `spawned` function (rank
    1 exits with 5) without joining; each rank under the PADDLE_*
    contract, the group through a FileStore in its directory.  Returns
    (launch dir, launch exit code, spawn dir, spawn's first exit code)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    saved = {k: os.environ.get(k) for k in (
        "PYTHONPATH", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
        "PADDLE_TRAINER_ENDPOINTS", "CUDA_VISIBLE_DEVICES")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [root, os.path.join(root, "tests")] + [
            p for p in (saved["PYTHONPATH"] or "").split(os.pathsep) if p])
    for k in list(saved)[1:]:
        os.environ.pop(k, None)
    launch_dir = tmp_path_factory.mktemp("launch")
    spawn_dir = tmp_path_factory.mktemp("spawn")
    try:
        ctx = TD.spawn(W.spawned, args=(str(spawn_dir), 1), nprocs=2,
                       gpus=[], join=False)
        args = Tlaunch._parse_args(["--nproc_per_node", "2", "--gpus", "",
                                    W.__file__, "launched",
                                    str(launch_dir)])
        launch_rc = Tlaunch.launch_collective(args)
        spawn_rc = ctx.join()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launch_dir, launch_rc, spawn_dir, spawn_rc


def test_launch_runs_the_contract_and_returns_the_first_failure(jobs):
    tmp_path, rc, _, _ = jobs
    assert rc == 7
    sums = [float(np.load(tmp_path / f"launch.{r}.npz")["sum"][0])
            for r in range(2)]
    assert sums == [3.0, 3.0]
    envs = [json.load(open(tmp_path / f"launch.{r}.json")) for r in range(2)]
    assert [e["PADDLE_TRAINER_ID"] for e in envs] == ["0", "1"]
    assert {e["PADDLE_TRAINERS_NUM"] for e in envs} == {"2"}
    assert [e["PADDLE_LOCAL_RANK"] for e in envs] == ["0", "1"]
    assert envs[1]["PADDLE_CURRENT_ENDPOINT"] == \
        envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")[1]


def test_spawn_raises_with_the_first_failure(jobs):
    """The two ranks' all-gather, joined to rank 1's exit code; joining
    spawn raises with the first nonzero code (here of a function that
    exits at once on every rank); an unimportable function is refused."""
    _, _, tmp_path, rc = jobs
    assert rc == 5
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"spawn1.{r}.npz")["gathered"], [0.0, 1.0])
    with pytest.raises(RuntimeError, match="exit code 5"):
        TD.spawn(sys.exit, args=(5,), nprocs=2, gpus=[])
    with pytest.raises(ValueError, match="importable"):
        TD.spawn(lambda: None, nprocs=1)
