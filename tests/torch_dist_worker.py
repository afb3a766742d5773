"""The ranks of the port's multi-rank CPU tests (JAX-free: it imports
torch, numpy and paddle_tpu_torch only).

    python tests/torch_dist_worker.py SUITE RANK WORLD WORKDIR

joins a gloo group of WORLD ranks on the CPU through a FileStore under
WORKDIR (no TCP port, so parallel test workers cannot collide), runs
SUITE's checks with one thread, and writes what it computed to
WORKDIR/SUITE.RANK.npz (and .json), which the test module holds against
the JAX package.  The inputs come from numpy seeds (CASES below) or from
WORKDIR/*.npz / *.json the test module wrote first.  `launched` is the
script distributed.launch starts; `spawned` the function spawn calls.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

# (name, op type, per-rank input shape, attrs); rank r's input is block r
# of case_input(name, world)
CASES = [
    ("allreduce_sum", "c_allreduce_sum", (4, 3), {}),
    ("allreduce_max", "c_allreduce_max", (4, 3), {}),
    ("allreduce_min", "c_allreduce_min", (4, 3), {}),
    ("allreduce_prod", "c_allreduce_prod", (4, 3), {}),
    ("mp_allreduce_sum", "mp_allreduce_sum", (4, 3), {}),
    ("reduce_sum", "c_reduce_sum", (4, 3), {"root_id": 0}),
    ("broadcast", "c_broadcast", (4, 3), {"root": 2}),
    ("allgather", "c_allgather", (2, 3), {"nranks": 4}),
    ("reducescatter", "c_reducescatter", (8, 3), {}),
    ("concat", "c_concat", (2, 3), {}),
    ("split", "c_split", (2, 8), {}),
    ("identity", "c_identity", (4, 3), {}),
    ("alltoall", "alltoall", (8, 3), {}),
    ("barrier", "barrier", (4, 3), {}),
    ("sync_calc", "c_sync_calc_stream", (4, 3), {}),
    ("sync_comm", "c_sync_comm_stream", (4, 3), {}),
    ("sum_comm_stream", "c_allreduce_sum", (4, 3),
     {"use_calc_stream": False}),
]
# rules with no output: they must run and return nothing
NO_OUTPUT = ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
             "c_wait_calc_stream", "c_wait_comm_stream")
# the differentiable rules whose backward is the adjoint collective
ADJOINT = {"allreduce_sum": "c_allreduce_sum", "broadcast": "c_broadcast",
           "allgather": "c_allgather", "reducescatter": "c_reducescatter",
           "concat": "c_concat", "alltoall": "alltoall"}
P2P_SRC, P2P_DST = 1, 3


def case_input(name: str, world: int) -> np.ndarray:
    """(world, *shape) float32: block r is rank r's input."""
    i = [c[0] for c in CASES].index(name)
    shape = CASES[i][2]
    rng = np.random.RandomState(100 + i)
    if name == "allreduce_prod":
        return rng.uniform(0.5, 1.5, (world,) + shape).astype(np.float32)
    return rng.randn(world, *shape).astype(np.float32)


def cotangent(name: str, world: int, out_shape) -> np.ndarray:
    rng = np.random.RandomState(500 + [c[0] for c in CASES].index(name))
    return rng.randn(world, *out_shape).astype(np.float32)


# -- helpers ------------------------------------------------------------------

def _init(rank, world, workdir, tag):
    import paddle_tpu_torch.distributed as dist

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(os.path.join(workdir, f"store.{tag}"),
                                        world)
    dist.init_parallel_env(device="cpu", store=store, rank=rank,
                           world_size=world)


def _op(op_type, attrs, ins=("X",), outs=("Out",)):
    from paddle_tpu_torch.fluid import framework as TFW

    return TFW.Operator(TFW.Program().global_block(), 0, op_type,
                        {s: [f"{s}_0"] for s in ins},
                        {s: [f"{s}_0"] for s in outs}, dict(attrs))


def _ctx():
    from paddle_tpu_torch.ops import registry as TREG

    return TREG.LowerCtx(0, device="cpu")


def _rule(op_type):
    from paddle_tpu_torch.ops import registry as TREG

    return TREG.forward_rule(op_type)


def _save(workdir, suite, rank, arrays, meta=None):
    np.savez(os.path.join(workdir, f"{suite}.{rank}.npz"), **arrays)
    if meta is not None:
        with open(os.path.join(workdir, f"{suite}.{rank}.json"), "w") as f:
            json.dump(meta, f)


# -- suite: collective (world 4) ----------------------------------------------

def suite_collective(rank, world, workdir):
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.metrics import metric

    out, meta = {}, {}
    for name, op_type, shape, attrs in CASES:
        x = torch.from_numpy(case_input(name, world)[rank])
        got = _rule(op_type)(_ctx(), _op(op_type, {"ring_id": 0, **attrs}),
                             {"X": [x]})
        out[name] = got["Out"][0].numpy()
    for op_type in NO_OUTPUT:
        meta[op_type] = _rule(op_type)(_ctx(), _op(op_type, {}, (), ()),
                                       {})
    # send_v2 then recv_v2 on one context, paired FIFO on ring 0
    ctx = _ctx()
    x = torch.from_numpy(case_input("identity", world)[rank])
    _rule("send_v2")(ctx, _op("send_v2", {"peer": P2P_DST}, ("X",), ()),
                     {"X": [x]})
    got = _rule("recv_v2")(ctx, _op("recv_v2", {"peer": P2P_SRC,
                                                "out_shape": [4, 3]},
                                     (), ("Out",)), {})
    out["p2p"] = got["Out"][0].numpy()
    try:
        _rule("recv_v2")(_ctx(), _op("recv_v2", {"peer": 0}, (), ("Out",)),
                         {})
        meta["unpaired_recv"] = "returned"
    except ValueError as e:
        meta["unpaired_recv"] = str(e)
    try:
        _rule("c_allreduce_sum")(_ctx(), _op("c_allreduce_sum",
                                             {"ring_id": 3}), {"X": [x]})
        meta["unknown_ring"] = "returned"
    except ValueError as e:
        meta["unknown_ring"] = str(e)
    # the adjoints: the gradient of sum(rule(x) * ct_r) over the ranks
    for name, op_type in ADJOINT.items():
        i = [c[0] for c in CASES].index(name)
        xv = torch.from_numpy(case_input(name, world)[rank]) \
            .requires_grad_(True)
        y = _rule(op_type)(_ctx(), _op(op_type, {"ring_id": 0, **CASES[i][3]}),
                           {"X": [xv]})["Out"][0]
        ct = torch.from_numpy(cotangent(name, world, tuple(y.shape))[rank])
        (g,) = torch.autograd.grad((y * ct).sum(), [xv])
        out[f"grad_{name}"] = g.numpy()
    # the 2.x eager API, in place where Paddle 2.x is
    base = torch.from_numpy(case_input("allreduce_sum", world)[rank])
    t = base.clone()
    coll.all_reduce(t)
    out["api_all_reduce"] = t.numpy()
    t = base.clone()
    coll.all_reduce(t, op=coll.ReduceOp.MAX)
    out["api_all_reduce_max"] = t.numpy()
    t = base.clone()
    coll.broadcast(t, 1)
    out["api_broadcast"] = t.numpy()
    lst = []
    coll.all_gather(lst, base)
    out["api_all_gather"] = torch.stack(lst).numpy()
    out["api_reduce_scatter"] = coll.reduce_scatter(base).numpy()
    t = torch.zeros(3)
    coll.scatter(t, [torch.full((3,), float(10 * k + 1))
                     for k in range(world)] if rank == 0 else None, src=0)
    out["api_scatter"] = t.numpy()
    meta["api_rank_world"] = [coll.get_rank(), coll.get_world_size()]
    # fleet.util and the fleet metrics over the group
    util = fleet.util
    out["util_all_reduce"] = util.all_reduce(np.array([rank + 1.0, 2.0]))
    out["util_all_reduce_max"] = util.all_reduce(np.array([rank, -rank]),
                                                 "max")
    out["util_all_gather"] = np.stack(util.all_gather(np.array([rank])))
    meta["file_shard"] = util.get_file_shard([f"f{i}" for i in range(10)])
    meta["metric_acc"] = metric.acc(np.array([rank + 1.0]),
                                    np.array([10.0]))
    util.barrier()
    _save(workdir, "collective", rank, out, meta)


# -- suite: dp (world 2) ------------------------------------------------------

def _fc_net(fluid):
    x = fluid.data("x", [-1, 8], "float32")
    label = fluid.data("label", [-1, 1], "int64")
    h = fluid.layers.fc(x, 16, act="relu")
    h2 = fluid.layers.fc(h, 16, act="relu")
    pred = fluid.layers.fc(h2, 4)
    loss = fluid.layers.reduce_mean(
        fluid.layers.loss.softmax_with_cross_entropy(pred, label))
    return loss


def fleet_program(fluid, fleet, coll, unique_name, nranks, rank=0):
    """The fc net of the reference's test_distributed.py:127, minimized
    through Fleet with SGD 0.1 for `nranks` workers, and the global mean
    loss (scale(all_reduce(loss), 1/nranks)); the same builder runs on
    both packages."""
    from_ = fleet.UserDefinedRoleMaker
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        loss = _fc_net(fluid)
        main.random_seed = 11
        startup.random_seed = 11
        fleet.fleet.init(role_maker=from_(worker_num=nranks,
                                          current_id=rank),
                         strategy=fleet.DistributedStrategy())
        fo = fleet.fleet.distributed_optimizer(fluid.optimizer.SGD(0.1))
        fo.minimize(loss)
        fetch = fluid.layers.scale(coll.all_reduce(loss), 1.0 / nranks)
    return main, startup, loss, fetch


def fleet_data():
    rng = np.random.RandomState(0)
    return (rng.rand(16, 8).astype("float32"),
            rng.randint(0, 4, size=(16, 1)).astype("int64"))


def _rows(a, rank, world):
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


def _dp_fleet(rank, world, workdir, out, meta):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.convert import load_jax_scope
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.fluid import unique_name

    main, startup, loss, fetch = fleet_program(fluid, fleet, coll,
                                               unique_name, world, rank)
    meta["fleet_main_json"] = json.dumps(main.to_dict(), sort_keys=True,
                                         default=str)
    meta["fleet_applied"] = fleet.fleet.applied_meta_list()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    init = np.load(os.path.join(workdir, "fleet_startup.npz"))
    load_jax_scope(scope, {k: init[k] for k in init.files})
    X, L = fleet_data()
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses, local = [], []
    for _ in range(5):
        lo, gl = exe.run(prog, feed={"x": _rows(X, rank, world),
                                     "label": _rows(L, rank, world)},
                         fetch_list=[loss, fetch], scope=scope)
        local.append(float(np.asarray(lo).reshape(-1)[0]))
        losses.append(float(np.asarray(gl).reshape(-1)[0]))
    out["fleet_losses"] = np.array(losses)
    out["fleet_local_losses"] = np.array(local)
    for p in main.all_parameters():
        out[f"fleet_param.{p.name}"] = scope.get(p.name).numpy()
    # a program handed to with_data_parallel without Fleet: the compiler
    # adds the gradient all-reduce itself
    main2, startup2 = fluid.Program(), fluid.Program()
    with fluid.program_guard(main2, startup2), unique_name.guard():
        loss2 = _fc_net(fluid)
        main2.random_seed = startup2.random_seed = 11
        fluid.optimizer.SGD(0.1).minimize(loss2)
    scope2 = fluid.Scope()
    exe.run(startup2, scope=scope2)
    load_jax_scope(scope2, {k: init[k] for k in init.files})
    prog2 = fluid.CompiledProgram(main2).with_data_parallel(
        loss_name=loss2.name)
    for _ in range(5):
        exe.run(prog2, feed={"x": _rows(X, rank, world),
                             "label": _rows(L, rank, world)},
                fetch_list=[loss2], scope=scope2)
    for p in main2.all_parameters():
        out[f"compiled_param.{p.name}"] = scope2.get(p.name).numpy()


def dygraph_data(steps=6):
    rng = np.random.RandomState(1)
    return [(rng.randn(32, 16).astype("float32"),
             rng.randint(0, 10, (32,)).astype("int64"))
            for _ in range(steps)]


def _dp_dygraph(rank, world, workdir, out, meta):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import comm
    from paddle_tpu_torch.nn import functional as F

    init = np.load(os.path.join(workdir, "dygraph_init.npz"))
    net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 10))
    params = list(net.parameters())
    # the reference's initial weights on rank 0 only: DataParallel's
    # broadcast carries them to the other ranks
    if rank == 0:
        with torch.no_grad():
            for k, p in enumerate(params):
                p.copy_(torch.from_numpy(init[f"p{k}"]))
    model = paddle.DataParallel(net)
    meta["dp_synced_at_build"] = all(
        np.array_equal(p.detach().numpy(), init[f"p{k}"])
        for k, p in enumerate(params))
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=params)
    glob, scaled = [], []
    for x, y in dygraph_data():
        xr = torch.from_numpy(_rows(x, rank, world))
        yr = torch.from_numpy(_rows(y, rank, world))
        loss = F.cross_entropy(model(xr), yr)
        s = model.scale_loss(loss)
        s.backward()
        model.apply_collective_grads()
        if not glob:
            out["dygraph_grads_step1"] = np.concatenate(
                [p.grad.numpy().reshape(-1) for p in params])
            out["dygraph_local_loss1"] = np.array(float(loss))
        opt.step()
        opt.clear_grad()
        scaled.append(float(s))
        glob.append(float(comm.all_reduce(s.detach())))
    out["dygraph_losses"] = np.array(glob)
    out["dygraph_scaled"] = np.array(scaled)
    out["dygraph_params"] = np.concatenate(
        [p.detach().numpy().reshape(-1) for p in params])


def _dp_bert(rank, world, workdir, out, meta):
    from paddle_tpu_torch.convert import load_jax_state
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.parallel import mesh as M

    init = np.load(os.path.join(workdir, "bert_init.npz"))
    batch = np.load(os.path.join(workdir, "bert_batch.npz"))
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = load_jax_state(TB.BertForPretraining(TB.BertConfig.tiny(**no_drop),
                                                 device="cpu"),
                           {k: init[k] for k in init.files})
    mesh = M.make_mesh({"dp": world})
    step, state = TB.build_pretrain_step(model, bf16=False, mesh=mesh,
                                         dp_axis="dp")
    mine = M.shard_host_batch(mesh, {k: batch[k] for k in batch.files})
    losses = []
    for _ in range(4):
        state, loss = step(state, mine, 1e-3)
        losses.append(float(loss))
    out["bert_losses"] = np.array(losses)
    out["bert_params"] = np.concatenate(
        [v.reshape(-1).numpy() for _, v in sorted(state["params"].items())])


def sbn_input():
    return np.random.RandomState(7).randn(8, 3, 4, 4).astype("float32")


def _dp_sync_bn(rank, world, workdir, out, meta):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.fluid import framework as TFW

    x = torch.from_numpy(_rows(sbn_input(), rank, world)) \
        .requires_grad_(True)
    bn = nn.SyncBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    y = bn(x)
    ct = torch.from_numpy(_rows(np.random.RandomState(8).randn(
        8, 3, 4, 4).astype("float32"), rank, world))
    dx, dw, db = torch.autograd.grad((y * ct).sum(), [x, bn.weight, bn.bias])
    out.update(sbn_y=y.detach().numpy(), sbn_dx=dx.numpy(),
               sbn_dw=dw.numpy(), sbn_db=db.numpy(),
               sbn_mean=bn._mean.numpy(), sbn_var=bn._variance.numpy())
    # the static rule on the same rows
    op = TFW.Operator(TFW.Program().global_block(), 0, "sync_batch_norm",
                      {s: [s] for s in ("X", "Scale", "Bias", "Mean",
                                        "Variance")},
                      {s: [s] for s in ("Y", "MeanOut", "VarianceOut",
                                        "SavedMean", "SavedVariance",
                                        "ReserveSpace")},
                      {"epsilon": 1e-5, "momentum": 0.9})
    got = _rule("sync_batch_norm")(_ctx(), op, {
        "X": [x.detach()], "Scale": [torch.ones(3)], "Bias": [torch.zeros(3)],
        "Mean": [torch.zeros(3)], "Variance": [torch.ones(3)]})
    out["sbn_rule_y"] = got["Y"][0].numpy()
    out["sbn_rule_mean"] = got["MeanOut"][0].numpy()
    out["sbn_rule_var"] = got["VarianceOut"][0].numpy()


def suite_dp(rank, world, workdir):
    out, meta = {}, {}
    _dp_fleet(rank, world, workdir, out, meta)
    _dp_dygraph(rank, world, workdir, out, meta)
    _dp_bert(rank, world, workdir, out, meta)
    _dp_sync_bn(rank, world, workdir, out, meta)
    _save(workdir, "dp", rank, out, meta)


# -- launch and spawn -----------------------------------------------------------

def launched(workdir):
    """Started by distributed.launch: the PADDLE_* contract gives the rank
    and world; rank 1 exits with 7 after the all-reduce."""
    import paddle_tpu_torch.distributed as dist

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    _init(rank, world, workdir, "launch")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    env = {k: os.environ.get(k) for k in (
        "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
        "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT")}
    _save(workdir, "launch", rank, {"sum": t.numpy()}, env)
    dist.destroy_parallel_env()
    if rank == 1:
        sys.exit(7)


def spawned(workdir, fail_rank):
    """Called by spawn: the ranks' all-gather; `fail_rank` exits with 5
    afterwards."""
    import paddle_tpu_torch.distributed as dist

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    _init(rank, world, workdir, f"spawn{fail_rank}")
    got = []
    dist.all_gather(got, torch.tensor([float(rank)]))
    _save(workdir, f"spawn{fail_rank}", rank,
          {"gathered": torch.cat(got).numpy()})
    dist.destroy_parallel_env()
    if rank == fail_rank:
        sys.exit(5)


SUITES = {"collective": suite_collective, "dp": suite_dp}


def main(argv):
    if argv[0] == "launched":
        launched(argv[1])
        return
    suite, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        argv[3]
    _init(rank, world, workdir, suite)
    import paddle_tpu_torch.distributed as dist

    SUITES[suite](rank, world, workdir)
    dist.destroy_parallel_env()


if __name__ == "__main__":
    main(sys.argv[1:])
