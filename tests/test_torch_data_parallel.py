"""Data parallelism of the port over two gloo ranks on the CPU (one spawn
of tests/torch_dist_worker.py, which imports no JAX), held against the
reference's data-parallel runs over two of its virtual CPU devices:

* the fc net of test_distributed.py:127 minimized through Fleet
  (GraphExecutionOptimizer -> GradAllReduce) and run 5 steps through
  CompiledProgram.with_data_parallel, each rank on its half of the
  batch: the global mean loss against the reference's run over a mesh of
  two at its rtol 2e-3 / atol 2e-4, the port's transpiled Program JSON
  the reference's, and the parameters bit-identical across the ranks
  (also for a program handed to with_data_parallel without Fleet, whose
  gradient all-reduce the compiler adds);
* dygraph DataParallel on the net of test_convergence_parity.py:164,
  6 SGD steps: the global losses against the reference's one-device
  run at its rtol 2e-4, rank 0's weights broadcast at construction;
* BERT-tiny's build_pretrain_step(mesh=dp 2), 4 f32 steps at dropout 0:
  the losses against the reference's build_pretrain_step over a dp mesh
  of two (the step of test_convergence_parity.py's _bert_losses, on the
  batch of test_torch_train.py) at its TOL, rtol 2e-3 / atol 2e-4;
* SyncBatchNorm and the sync_batch_norm rule over the two halves against
  the reference's batch_norm rule on the whole batch (f32: y, running
  statistics and jax.vjp's gradients to rtol 1e-5, atol 1e-5; the sums
  run in another order).

and the three ways the port's data parallelism differs from the
reference's, one test each (ROADMAP queue 3 items 42-44).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as JP
import paddle_tpu.fluid as JF
from paddle_tpu.distributed import collective as Jcoll
from paddle_tpu.distributed import fleet as Jfleet
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.ops import registry as JREG
from paddle_tpu.parallel.mesh import make_mesh

from paddle_tpu_torch.models import bert as TB

import torch_dist_worker as W
from test_torch_collective import finish_ranks, start_ranks

WORLD = 2
DIST_TOL = dict(rtol=2e-3, atol=2e-4)   # test_distributed.py:124
DYGRAPH_RTOL = 2e-4                      # test_convergence_parity.py:196
BERT_TOL = dict(rtol=2e-3, atol=2e-4)    # test_convergence_parity.py:28
SBN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


# Each reference below is a generator: it writes what the ranks load,
# yields, and then yields its runs, which go on while the ranks run.

def _fleet_reference(workdir):
    """The reference's program, startup values and run over two
    devices."""
    main, startup, loss, fetch = W.fleet_program(JF, Jfleet, Jcoll, JU,
                                                 WORLD)
    exe, scope = JF.Executor(), JF.Scope()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}
    np.savez(os.path.join(workdir, "fleet_startup.npz"), **init)
    yield
    X, L = W.fleet_data()
    prog = JF.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=jax.devices()[:WORLD])
    losses = []
    for _ in range(5):
        (gl,) = exe.run(prog, feed={"x": X, "label": L}, fetch_list=[fetch],
                        scope=scope)
        losses.append(float(np.asarray(gl).reshape(-1)[0]))
    # each half's loss under the startup values (a one-device forward)
    test = main.clone(for_test=True)
    tscope = JF.Scope()
    for n, v in init.items():
        tscope.set(n, jnp.asarray(v))
    halves = [float(np.asarray(exe.run(
        test, feed={"x": W._rows(X, r, WORLD), "label": W._rows(L, r, WORLD)},
        fetch_list=[loss], scope=tscope)[0]).reshape(-1)[0])
        for r in range(WORLD)]
    yield {"losses": losses, "halves": halves,
           "json": json.dumps(main.to_dict(), sort_keys=True, default=str)}


def _dygraph_reference(workdir):
    """test_convergence_parity.py:164's one-device run, its initial
    weights written for the ranks."""
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    from paddle_tpu.fluid.dygraph import guard, to_variable
    from paddle_tpu.optimizer import SGD

    with guard():
        JP.seed(0)
        net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 10))
        np.savez(os.path.join(workdir, "dygraph_init.npz"),
                 **{f"p{k}": np.asarray(p._value)
                    for k, p in enumerate(net.parameters())})
        yield
        opt = SGD(learning_rate=0.1, parameters=net.parameters())
        losses = []
        for x, y in W.dygraph_data():
            loss = F.cross_entropy(net(to_variable(x)), to_variable(y))
            loss.backward()
            opt.minimize(loss)
            for p in net.parameters():
                p.clear_gradient()
            losses.append(float(loss.numpy()))
    yield losses


def _bert_reference(workdir):
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    JP.seed(3)
    jm = JB.BertForPretraining(JB.BertConfig.tiny(**no_drop))
    np.savez(os.path.join(workdir, "bert_init.npz"),
             **{k: np.asarray(v)
                for k, v in jax_functional_state(jm).items()})
    batch = JB.fake_batch(JB.BertConfig.tiny(), 4, 64, num_masked=8, seed=0)
    np.savez(os.path.join(workdir, "bert_batch.npz"), **batch)
    yield
    mesh = make_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
    step, state = JB.build_pretrain_step(jm, bf16=False, mesh=mesh,
                                         dp_axis="dp")
    losses = []
    for _ in range(4):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                           jnp.float32(1e-3))
        losses.append(float(loss))
    yield losses


def _sbn_reference():
    """The reference's batch_norm rule on the whole batch: y, the running
    statistics, and jax.vjp's gradients for the cotangent."""
    from paddle_tpu.fluid import framework as JFW

    op = JFW.Operator(JFW.Program().global_block(), 0, "batch_norm",
                      {s: [s] for s in ("X", "Scale", "Bias", "Mean",
                                        "Variance")},
                      {s: [s] for s in ("Y", "MeanOut", "VarianceOut",
                                        "SavedMean", "SavedVariance",
                                        "ReserveSpace")},
                      {"epsilon": 1e-5, "momentum": 0.9})
    x = jnp.asarray(W.sbn_input())
    ct = jnp.asarray(np.random.RandomState(8).randn(8, 3, 4, 4)
                     .astype("float32"))

    def run(x, w, b):
        return JREG._FORWARD["batch_norm"](
            JREG.LowerCtx(jax.random.PRNGKey(0)), op,
            {"X": [x], "Scale": [w], "Bias": [b],
             "Mean": [jnp.zeros(3)], "Variance": [jnp.ones(3)]})

    w = jnp.asarray([1.0, 2.0, 0.5])
    b = jnp.asarray([0.1, -0.2, 0.3])

    @jax.jit
    def both(x, w, b):
        outs, vjp = jax.vjp(lambda *a: run(*a), x, w, b)
        ct_y = jax.tree_util.tree_map(jnp.zeros_like, outs)
        ct_y["Y"] = [ct]
        return outs, vjp(ct_y), run(x, jnp.ones(3), jnp.zeros(3))

    outs, (dx, dw, db), plain = both(x, w, b)
    return {"y": np.asarray(outs["Y"][0]),
            "mean": np.asarray(outs["MeanOut"][0]),
            "var": np.asarray(outs["VarianceOut"][0]),
            "dx": np.asarray(dx), "dw": np.asarray(dw), "db": np.asarray(db),
            "rule_y": np.asarray(plain["Y"][0])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp")
    gens = {"fleet": _fleet_reference(workdir),
            "dygraph": _dygraph_reference(workdir),
            "bert": _bert_reference(workdir)}
    for g in gens.values():
        next(g)
    started = start_ranks("dp", WORLD, workdir)
    ref = {k: next(g) for k, g in gens.items()}
    ref["sbn"] = _sbn_reference()
    init = np.load(os.path.join(workdir, "dygraph_init.npz"))
    ref["dygraph_init"] = [init[f"p{k}"] for k in range(len(init.files))]
    return ref, finish_ranks(started)


def _same_on_every_rank(ranks, key):
    a0 = ranks[0][0][key]
    for arrays, _ in ranks[1:]:
        np.testing.assert_array_equal(arrays[key], a0, err_msg=key)


# -- Fleet and CompiledProgram ---------------------------------------------------

def test_fleet_program_is_the_references(runs):
    ref, ranks = runs
    for _, meta in ranks:
        assert meta["fleet_main_json"] == ref["fleet"]["json"]
        assert meta["fleet_applied"] == ["GraphExecutionOptimizer"]


def test_fleet_losses_match_the_references_run_over_two(runs):
    ref, ranks = runs
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["fleet_losses"],
                                   ref["fleet"]["losses"], **DIST_TOL)


def test_fleet_parameters_are_bit_identical_across_ranks(runs):
    _, ranks = runs
    keys = [k for k in ranks[0][0] if k.startswith(("fleet_param.",
                                                    "compiled_param."))]
    assert len(keys) == 12
    for k in keys:
        _same_on_every_rank(ranks, k)


def test_compiled_program_adds_the_gradient_allreduce(runs):
    """The same program minimized without Fleet and handed to
    with_data_parallel takes the same steps as Fleet's transpiled one."""
    _, ranks = runs
    for arrays, _ in ranks:
        for k in [k for k in arrays if k.startswith("fleet_param.")]:
            np.testing.assert_allclose(
                arrays["compiled_param." + k.split(".", 1)[1]], arrays[k],
                rtol=1e-6, atol=1e-7, err_msg=k)


def test_feeds_and_fetches_are_per_rank(runs):
    """Queue 3 item 42: each rank is fed its own rows and fetches its own
    loss (the reference's exe.run takes the global batch); step 1's
    fetches are one-device forwards of each half, whose mean is the
    global loss."""
    ref, ranks = runs
    local = [arrays["fleet_local_losses"][0] for arrays, _ in ranks]
    np.testing.assert_allclose(local, ref["fleet"]["halves"], rtol=1e-6)
    assert local[0] != local[1]
    np.testing.assert_allclose(np.mean(local),
                               ranks[0][0]["fleet_losses"][0], rtol=1e-6)


# -- dygraph DataParallel --------------------------------------------------------

def test_dygraph_losses_match_the_references_one_device_run(runs):
    ref, ranks = runs
    for arrays, meta in ranks:
        assert meta["dp_synced_at_build"]
        np.testing.assert_allclose(arrays["dygraph_losses"], ref["dygraph"],
                                   rtol=DYGRAPH_RTOL)
    _same_on_every_rank(ranks, "dygraph_params")


def test_scale_loss_divides_and_apply_collective_grads_sums(runs):
    """Queue 3 item 43: scale_loss is the rank's loss over the ranks and
    apply_collective_grads sums the gradients (identities in the
    reference, whose loss is already global): the summed gradients are
    the one-process gradients of the whole batch."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    ref, ranks = runs
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["dygraph_scaled"][0],
                                   arrays["dygraph_local_loss1"] / WORLD,
                                   rtol=1e-6)
    _same_on_every_rank(ranks, "dygraph_grads_step1")
    net = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 10))
    x, y = W.dygraph_data()[0]
    with torch.no_grad():
        for k, p in enumerate(net.parameters()):
            p.copy_(torch.from_numpy(ref["dygraph_init"][k]))
    F.cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    want = np.concatenate([p.grad.numpy().reshape(-1)
                           for p in net.parameters()])
    np.testing.assert_allclose(ranks[0][0]["dygraph_grads_step1"], want,
                               rtol=1e-5, atol=1e-7)


# -- BERT's data-parallel step ------------------------------------------------------

def test_bert_dp_losses_match_the_references_dp_step(runs):
    ref, ranks = runs
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["bert_losses"], ref["bert"],
                                   **BERT_TOL)
    _same_on_every_rank(ranks, "bert_params")
    _same_on_every_rank(ranks, "bert_losses")


def test_dropout_masks_are_per_rank():
    """Queue 3 item 44: rank 0 draws the one-process step's masks of its
    rows, another rank from a seed mixed with its index (the reference
    draws the global batch's masks from one key)."""
    for t in (1, 2, 7):
        assert TB._dropout_seed(t, 0) == TB._step_seed(TB._DROPOUT_KEY, t)
        assert TB._dropout_seed(t, 1) != TB._dropout_seed(t, 0)
        assert TB._dropout_seed(t, 1) != TB._dropout_seed(t + 1, 1)


# -- SyncBatchNorm -----------------------------------------------------------------

def test_sync_batch_norm_is_the_whole_batchs(runs):
    ref, ranks = runs
    sbn = ref["sbn"]
    got = {k: np.concatenate([a[f"sbn_{k}"] for a, _ in ranks])
           for k in ("y", "dx", "rule_y")}
    np.testing.assert_allclose(got["y"], sbn["y"], **SBN_TOL)
    np.testing.assert_allclose(got["rule_y"], sbn["rule_y"], **SBN_TOL)
    np.testing.assert_allclose(got["dx"], sbn["dx"], **SBN_TOL)
    for arrays, _ in ranks:
        # the parameters' gradients are each rank's share: they sum to
        # the whole batch's
        np.testing.assert_allclose(arrays["sbn_mean"], sbn["mean"],
                                   **SBN_TOL)
        np.testing.assert_allclose(arrays["sbn_var"], sbn["var"], **SBN_TOL)
        np.testing.assert_allclose(arrays["sbn_rule_mean"], sbn["mean"],
                                   **SBN_TOL)
        np.testing.assert_allclose(arrays["sbn_rule_var"], sbn["var"],
                                   **SBN_TOL)
    np.testing.assert_allclose(sum(a["sbn_dw"] for a, _ in ranks), sbn["dw"],
                               **SBN_TOL)
    np.testing.assert_allclose(sum(a["sbn_db"] for a, _ in ranks), sbn["db"],
                               **SBN_TOL)


def test_convert_sync_batchnorm_keeps_the_state():
    """convert_sync_batchnorm swaps each BatchNorm for a SyncBatchNorm
    that shares its parameters and running statistics, in both packages;
    with no group the converted net computes the BatchNorm's bits, and
    the reference's state loads into it by convert.load_jax_state (the
    names are BatchNorm's)."""
    import paddle_tpu.nn as jnn
    from paddle_tpu.fluid import dygraph as Jdy

    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.convert import load_jax_state

    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    bn = net[1]
    x = torch.from_numpy(W.sbn_input())
    want = net(x).detach()
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    assert conv[1].weight is bn.weight and conv[1]._mean is bn._mean
    bn._mean.zero_()
    bn._variance.fill_(1.0)
    assert torch.equal(conv(x).detach(), want)
    with Jdy.guard():
        jnet = jnn.SyncBatchNorm.convert_sync_batchnorm(
            jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4)))
        assert isinstance(jnet[1], jnn.SyncBatchNorm)
        state = {k: np.asarray(v._value)
                 for k, v in jnet.state_dict().items()}
    load_jax_state(conv, state)
    np.testing.assert_array_equal(conv[0].weight.detach().numpy(),
                                  state["0.weight"])
