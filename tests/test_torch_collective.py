"""The 23 collective rules of the port (ops/collective_ops.py) and its
2.x collective API, against the reference's rules on the CPU.

In one process (no group, and a live gloo group of one): every rule is
the identity, as the reference's is outside a mesh, bit for bit; the
registry holds every reference op but `run_program`.  Over four gloo
ranks (one spawn of tests/torch_dist_worker.py, which imports no JAX):
each rule's per-rank output against the reference's rule traced inside
a `shard_map` over the first four of the eight virtual CPU devices (the
pattern of test_ops_collective_variants.py), send_v2 / recv_v2 paired
FIFO, the unpaired recv_v2 and an unnamed ring raising, the adjoint
collectives as the rules' backward against `jax.grad` through the
reference's shard_map, and the 2.x API, fleet.util and fleet.metrics
against numpy.

Tolerance: one collective over four f32 values, whose only difference
is the order of the sums (and prod's exp/log): rtol 1e-6, atol 1e-6;
max, min, the moves (broadcast, gather, split, alltoall, p2p) exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from paddle_tpu.fluid import framework as JFW
from paddle_tpu.ops import registry as JREG
from paddle_tpu.parallel.compiler import _shard_map_compat
from paddle_tpu.parallel.mesh import make_mesh

import paddle_tpu_torch.distributed as TD
from paddle_tpu_torch.fluid import framework as TFW
from paddle_tpu_torch.ops import registry as TREG

import torch_dist_worker as W

WORLD = 4
TOL = dict(rtol=1e-6, atol=1e-6)
EXACT = {"allreduce_max", "allreduce_min", "broadcast", "allgather",
         "concat", "split", "identity", "alltoall", "barrier", "sync_calc",
         "sync_comm"}
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
SPAWN_TIMEOUT_S = 240


def _rank_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_DISTRI_BACKEND"):
        env.pop(k, None)
    return env


def start_ranks(suite, world, workdir):
    """Start `world` ranks of the worker's `suite`; finish_ranks waits."""
    procs = [subprocess.Popen([sys.executable, WORKER, suite, str(r),
                               str(world), str(workdir)], env=_rank_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return suite, world, workdir, procs


def fork_ranks(suite, world, workdir):
    """As start_ranks, but the ranks are forked from one process that
    imports torch and the port once (the worker's `forked`)."""
    procs = [subprocess.Popen([sys.executable, WORKER, "forked", suite,
                               str(world), str(workdir)], env=_rank_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    return suite, world, workdir, procs


def finish_ranks(started):
    """Each rank's (arrays, meta); fails with the ranks' output if any
    rank failed."""
    suite, world, workdir, procs = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        o[-3000:] for o in outs)
    res = []
    for r in range(world):
        arrays = dict(np.load(os.path.join(workdir, f"{suite}.{r}.npz")))
        meta_path = os.path.join(workdir, f"{suite}.{r}.json")
        meta = json.load(open(meta_path)) if os.path.exists(meta_path) \
            else {}
        res.append((arrays, meta))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's per-rank outputs and adjoints, the ranks'
    results): the reference runs while the ranks do."""
    started = start_ranks("collective", WORLD, tmp_path_factory.mktemp("coll"))
    ref = _reference_runs()
    return ref, finish_ranks(started)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def _jop(op_type, attrs, ins=("X",), outs=("Out",)):
    return JFW.Operator(JFW.Program().global_block(), 0, op_type,
                        {s: [f"{s}_0"] for s in ins},
                        {s: [f"{s}_0"] for s in outs}, dict(attrs))


def _top(op_type, attrs, ins=("X",), outs=("Out",)):
    return TFW.Operator(TFW.Program().global_block(), 0, op_type,
                        {s: [f"{s}_0"] for s in ins},
                        {s: [f"{s}_0"] for s in outs}, dict(attrs))


def _mesh():
    return make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _sharded(per_shard):
    """per_shard(x (shape,)) -> out, over the stacked (WORLD, *shape)
    input; returns the (WORLD, *out shape) per-rank outputs' function."""

    def per(x):
        return per_shard(x[0])[None]

    return jax.jit(_shard_map_compat(per, _mesh(), (P("data"),),
                                     P("data")))


def _jctx():
    return JREG.LowerCtx(jax.random.PRNGKey(0), mesh_axes={"data": "data"})


def _cases_sharded(names):
    """The rules of the cases `names` on their shards as one function of
    the stacked inputs (one trace and one compile for them all)."""
    cases = {c[0]: c for c in W.CASES}

    def per_shard(xs):
        out = {}
        for name in names:
            _, op_type, _, attrs = cases[name]
            op = _jop(op_type, {"ring_id": 0, **{
                k: v for k, v in attrs.items() if k != "use_calc_stream"}})
            out[name] = JREG._FORWARD[op_type](
                _jctx(), op, {"X": [xs[name][0]]})["Out"][0][None]
        return out

    spec = {n: P("data") for n in names}
    return jax.jit(_shard_map_compat(per_shard, _mesh(), (spec,), spec))


def _reference_runs():
    """The reference's per-rank outputs of every case over a mesh of four,
    and jax.grad of sum_r <rule(x)_r, ct_r> for the ADJOINT cases."""
    names = [c[0] for c in W.CASES]
    xs = {n: jnp.asarray(W.case_input(n, WORLD)) for n in names}
    outs = _cases_sharded(names)(xs)
    f = _cases_sharded(sorted(W.ADJOINT))
    xa = {n: xs[n] for n in W.ADJOINT}
    cts = {n: jnp.asarray(W.cotangent(n, WORLD, outs[n].shape[1:]))
           for n in W.ADJOINT}
    grads = jax.grad(lambda v: sum(jnp.sum(f(v)[n] * cts[n])
                                   for n in W.ADJOINT))(xa)
    return ({n: np.asarray(v) for n, v in outs.items()},
            {n: np.asarray(grads[n]) for n in W.ADJOINT})


# -- one process ------------------------------------------------------------------

ALL_RULES = [c[1] for c in W.CASES if c[0] != "sum_comm_stream"] \
    + list(W.NO_OUTPUT) + ["send_v2", "recv_v2"]


def test_the_registry_lacks_only_run_program():
    assert set(W.NO_OUTPUT) | {c[1] for c in W.CASES} \
        | {"send_v2", "recv_v2"} == set(ALL_RULES)
    assert len(set(ALL_RULES)) == 23
    assert set(ALL_RULES) <= set(TREG.registered_ops())
    assert set(JREG.registered_ops()) - set(TREG.registered_ops()) \
        == {"run_program"}
    assert len(TREG.registered_ops()) == len(JREG.registered_ops()) - 1


def _one_process(op_type):
    """(port output, reference output) of one rule in one process; the
    p2p pair runs send_v2 then recv_v2 on one context."""
    x = W.case_input("identity", 1)[0]
    if op_type in ("send_v2", "recv_v2"):
        tctx = TREG.LowerCtx(0, device="cpu")
        jctx = JREG.LowerCtx(jax.random.PRNGKey(0))
        for ctx, reg, mk, v in ((tctx, TREG.forward_rule, _top,
                                 torch.from_numpy(x)),
                                (jctx, lambda t: JREG._FORWARD[t], _jop,
                                 jnp.asarray(x))):
            reg("send_v2")(ctx, mk("send_v2", {"peer": 0}, ("X",), ()),
                           {"X": [v]})
        got = TREG.forward_rule("recv_v2")(
            tctx, _top("recv_v2", {"peer": 0}, (), ("Out",)), {})
        want = JREG._FORWARD["recv_v2"](
            jctx, _jop("recv_v2", {"peer": 0}, (), ("Out",)), {})
        return got["Out"][0].numpy(), np.asarray(want["Out"][0])
    if op_type in W.NO_OUTPUT:
        got = TREG.forward_rule(op_type)(
            TREG.LowerCtx(0, device="cpu"), _top(op_type, {}, (), ()), {})
        want = JREG._FORWARD[op_type](JREG.LowerCtx(jax.random.PRNGKey(0)),
                                      _jop(op_type, {}, (), ()), {})
        return got, want
    got = TREG.forward_rule(op_type)(
        TREG.LowerCtx(0, device="cpu"), _top(op_type, {"ring_id": 0}),
        {"X": [torch.from_numpy(x)]})["Out"][0].numpy()
    want = JREG._FORWARD[op_type](
        JREG.LowerCtx(jax.random.PRNGKey(0)), _jop(op_type, {"ring_id": 0}),
        {"X": [jnp.asarray(x)]})["Out"][0]
    return got, np.asarray(want)


@pytest.mark.parametrize("op_type", ALL_RULES)
def test_every_rule_is_the_identity_in_one_process(op_type):
    """No group, then a gloo group of one: the reference's bits (its
    rules outside a mesh) both times."""
    first = _one_process(op_type)
    TD.init_parallel_env(backend="gloo", device="cpu", rank=0, world_size=1)
    try:
        second = _one_process(op_type)
    finally:
        TD.destroy_parallel_env()
    for got, want in (first, second):
        if op_type in W.NO_OUTPUT:
            assert got == want == {}
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got,
                                          W.case_input("identity", 1)[0])


def test_an_unpaired_recv_raises_in_both():
    for ctx, rule, mk in (
            (TREG.LowerCtx(0, device="cpu"), TREG.forward_rule("recv_v2"),
             _top),
            (JREG.LowerCtx(jax.random.PRNGKey(0)), JREG._FORWARD["recv_v2"],
             _jop)):
        with pytest.raises(ValueError, match="no data source"):
            rule(ctx, mk("recv_v2", {"peer": 0}, (), ("Out",)), {})


def test_shape_inference_keeps_the_declared_shapes():
    """At build time a rule is the identity on meta tensors, as the
    reference's InferShape traces it outside a mesh."""
    import paddle_tpu_torch.fluid as TF

    main = TF.Program()
    with TF.program_guard(main, TF.Program()):
        x = TF.data("x", [8, 4], "float32")
        out = TD.all_gather(x)
    assert list(main.global_block().var(out.name).shape) == [8, 4]


# -- four ranks ---------------------------------------------------------------------

@pytest.mark.parametrize("name,op_type,attrs",
                         [(c[0], c[1], c[3]) for c in W.CASES])
def test_rule_matches_the_reference_over_four_ranks(runs, name, op_type,
                                                    attrs):
    (want, _), ranks = runs
    want = want[name]
    got = np.stack([arrays[name] for arrays, _ in ranks])
    assert got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_the_rules_without_output_run_on_every_rank(ranks):
    for _, meta in ranks:
        for op_type in W.NO_OUTPUT:
            assert meta[op_type] == {}, op_type


def test_send_recv_pair_fifo_like_the_reference(ranks):
    send = _jop("send_v2", {"peer": W.P2P_DST, "ring_id": 0}, ("X",), ())
    recv = _jop("recv_v2", {"peer": W.P2P_SRC, "ring_id": 0,
                            "out_shape": [4, 3]}, (), ("Out",))

    def per(x):
        ctx = _jctx()
        JREG._FORWARD["send_v2"](ctx, send, {"X": [x]})
        return JREG._FORWARD["recv_v2"](ctx, recv, {})["Out"][0]

    want = np.asarray(_sharded(per)(jnp.asarray(
        W.case_input("identity", WORLD))))
    got = np.stack([arrays["p2p"] for arrays, _ in ranks])
    np.testing.assert_array_equal(got, want)
    assert not got[[0, 1, 2]].any()


def test_an_unpaired_recv_and_an_unnamed_ring_raise(ranks):
    for _, meta in ranks:
        assert "no data source" in meta["unpaired_recv"]
        assert "ring_id 3" in meta["unknown_ring"] \
            and "item 10b" in meta["unknown_ring"]


@pytest.mark.parametrize("name", sorted(W.ADJOINT))
def test_the_backward_is_the_adjoint_collective(runs, name):
    """The gradient of sum_r <rule(x)_r, ct_r> with respect to each
    rank's x: the port's autograd through its collective against
    jax.grad through the reference's shard_map."""
    (_, grads), ranks = runs
    want = grads[name]
    got = np.stack([arrays[f"grad_{name}"] for arrays, _ in ranks])
    np.testing.assert_allclose(got, want, **TOL)


def test_the_eager_api_and_fleet_util_over_four_ranks(ranks):
    x = W.case_input("allreduce_sum", WORLD)
    for r, (a, meta) in enumerate(ranks):
        np.testing.assert_allclose(a["api_all_reduce"], x.sum(0), **TOL)
        np.testing.assert_array_equal(a["api_all_reduce_max"], x.max(0))
        np.testing.assert_array_equal(a["api_broadcast"], x[1])
        np.testing.assert_array_equal(a["api_all_gather"], x)
        np.testing.assert_allclose(a["api_reduce_scatter"], x.sum(0)[r:r + 1],
                                   **TOL)
        np.testing.assert_array_equal(a["api_scatter"],
                                      np.full(3, 10.0 * r + 1))
        assert meta["api_rank_world"] == [r, WORLD]
        np.testing.assert_array_equal(a["util_all_reduce"],
                                      [1.0 + 2 + 3 + 4, 2.0 * WORLD])
        np.testing.assert_array_equal(a["util_all_reduce_max"], [3, 0])
        np.testing.assert_array_equal(a["util_all_gather"].ravel(),
                                      np.arange(WORLD))
        # ten files over four workers, the reference's contiguous split
        want = [[0, 1, 2], [3, 4, 5], [6, 7], [8, 9]][r]
        assert meta["file_shard"] == [f"f{i}" for i in want]
        assert meta["metric_acc"] == pytest.approx((1 + 2 + 3 + 4) / 40.0)
