"""Model parallelism of the port over four gloo ranks on the CPU (one
spawn of the JAX-free tests/torch_dist_worker.py suite `spmd`, with the
reference's runs overlapped), held against the reference:

* the reference's tiny transformer (test_spmd_sharding.py:142-201: Adam
  0.01, batch 16, 4 steps) through the compiler's SPMD arm on
  {data: 1, fsdp: 2, tp: 2} and {data: 2, fsdp: 2}, and through Fleet's
  sharding strategy at stages 1 and 3 on {data: 4}: the mean of the
  ranks' losses against the reference's {data: 8} run at its rtol 2e-3
  / atol 2e-4; each rank's scope holding only its shard (fc_0.w_0's
  first moment an (8, 32) quarter on fsdp 2 x tp 2, as the reference
  asserts at :217-222); the gathered moment the reference's; the
  `spmd_specs_applied` and `collective_bytes_spmd_*` counters risen;
* the arm's shards against DTensor's `distribute_tensor` under
  `spec_layout.placements`, on a case whose shard order shows;
* BERT-tiny's tensor-parallel step (build_pretrain_step(mp_axis=...)) on
  {dp: 1, mp: 4} and {dp: 2, mp: 2} at dropout 0 against the reference's
  one-process losses and masters (the oracle of
  test_convergence_parity.py:57-73, its TOL), and on {dp: 1, mp: 4} at
  dropout 0.1 against the port's own one-process step within rtol 1e-5
  (f32, the plain versions: the masks are the one-process step's, the
  kernels' hash taking each rank's heads and d_ff columns by their
  global index; the reference's eager dropout draws from jax.random,
  which torch does not reproduce).

And in one process: the plain versions' offsets (`_keep_mask3` and
`_ffn_keep` at an offset are the global mask's slice and at offset 0 the
JAX package's bits), the vocab fit (ROADMAP queue 3), and the refusal of
a tensor axis that does not divide the heads.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as JP
import paddle_tpu.fluid as JF
import paddle_tpu.fluid.initializer as Jinit
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.parallel import mesh as Jmesh

from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.ops.kernels import ffn as TFF
from paddle_tpu_torch.parallel import mesh as Tmesh

import torch_dist_worker as W
from test_torch_collective import finish_ranks, start_ranks

WORLD = 4
TOL = dict(rtol=2e-3, atol=2e-4)  # test_spmd_sharding.py:208, parity :28


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _tiny_reference(workdir):
    """The reference's tiny transformer: its startup values for the
    ranks, then its run over {data: 8}."""
    main, startup, loss = W.tiny_program(JF, JU)
    exe, scope = JF.Executor(), JF.Scope()
    exe.run(startup, scope=scope)
    np.savez(os.path.join(workdir, "tiny_startup.npz"),
             **{n: np.asarray(scope.get(n))
                for n in scope.local_var_names()})
    yield
    ids, label = W.tiny_data()
    bs = JF.BuildStrategy()
    bs.mesh_axes = {"data": 8}
    try:
        prog = JF.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        losses = []
        for _ in range(4):
            (lo,) = exe.run(prog, feed={"ids": ids, "label": label},
                            fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(lo).reshape(-1)[0]))
    finally:
        Jmesh.set_current_mesh(None)
    yield {"losses": losses,
           "moment": np.asarray(scope.get(W.MOMENT)),
           "params": np.concatenate([np.asarray(scope.get(p.name))
                                     .reshape(-1)
                                     for p in main.all_parameters()])}


def _bert_reference(workdir):
    """The parity oracle's one-process step at dropout 0: BERT-tiny from
    paddle.seed(0), fake_batch(8, 128, 10 masked, seed 7), 4 f32 steps
    at lr 1e-3; its initial weights and batch for the ranks."""
    no_drop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    saved = list(Jinit._eager_seed)
    try:
        JP.seed(0)
        jm = JB.BertForPretraining(JB.BertConfig.tiny(**no_drop))
    finally:
        Jinit._eager_seed[:] = saved
    np.savez(os.path.join(workdir, "bert_init.npz"),
             **{k: np.asarray(v)
                for k, v in jax_functional_state(jm).items()})
    batch = JB.fake_batch(JB.BertConfig.tiny(), 8, 128, num_masked=10,
                          seed=7)
    np.savez(os.path.join(workdir, "bert_batch.npz"), **batch)
    yield
    step, state = JB.build_pretrain_step(jm, bf16=False)
    losses = []
    for _ in range(4):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                           jnp.float32(1e-3))
        losses.append(float(loss))
    yield {"losses": losses,
           "params": np.concatenate([np.asarray(state["params"][k])
                                     .reshape(-1)
                                     for k in sorted(state["params"])])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("spmd")
    gens = {"tiny": _tiny_reference(workdir),
            "bert": _bert_reference(workdir)}
    for g in gens.values():
        next(g)
    started = start_ranks("spmd", WORLD, workdir)
    ref = {k: next(g) for k, g in gens.items()}
    return ref, finish_ranks(started)


def _same_on_every_rank(ranks, key):
    for arrays, _ in ranks[1:]:
        np.testing.assert_array_equal(arrays[key], ranks[0][0][key],
                                      err_msg=key)


# -- the static SPMD arm and Fleet's sharding --------------------------------

@pytest.mark.parametrize("tag", sorted(W.SPMD_RUNS))
def test_spmd_losses_match_the_references_dp_run(runs, tag):
    """Each rank fetches the loss of its rows; their mean is the global
    batch's (every batch index has as many ranks)."""
    ref, ranks = runs
    got = np.mean([a[f"{tag}.losses"] for a, _ in ranks], axis=0)
    assert ref["tiny"]["losses"][0] > ref["tiny"]["losses"][-1]
    np.testing.assert_allclose(got, ref["tiny"]["losses"], **TOL)


@pytest.mark.parametrize("tag,shard,share", [
    ("fsdp_tp", (8, 32), 4), ("data_fsdp", (8, 64), 2),
    ("stage1", (4, 64), 4), ("stage3", (4, 64), 4)])
def test_each_rank_stores_only_its_shard(runs, tag, shard, share):
    ref, ranks = runs
    full = ref["tiny"]["moment"]
    assert full.shape == (16, 64)
    for arrays, meta in ranks:
        got = arrays[f"{tag}.moment_shard"]
        assert got.shape == shard and got.nbytes * share == full.nbytes
        if tag != "data_fsdp":
            # the optimizer state (moments and pow accumulators) shrinks
            # as the reference's does (test_spmd_sharding.py:226)
            assert meta[tag]["state_bytes"] * 2.5 < meta[tag]["full_bytes"]


@pytest.mark.parametrize("tag", sorted(W.SPMD_RUNS))
def test_gathered_state_matches_the_references(runs, tag):
    ref, ranks = runs
    _same_on_every_rank(ranks, f"{tag}.moment")
    _same_on_every_rank(ranks, f"{tag}.params")
    np.testing.assert_allclose(ranks[0][0][f"{tag}.moment"],
                               ref["tiny"]["moment"], **TOL)
    np.testing.assert_allclose(ranks[0][0][f"{tag}.params"],
                               ref["tiny"]["params"], **TOL)


def test_the_references_arrays_load_into_shards_and_gather_back(runs):
    """convert.load_jax_scope_sharded cuts the reference's full arrays to
    each rank's shards of a scope the arm holds; gather_sharded_scope
    gives them back whole."""
    _, ranks = runs
    for _, meta in ranks:
        assert meta["roundtrip"] and meta["roundtrip_shard"] == [8, 32]


@pytest.mark.parametrize("tag", sorted(W.SPMD_RUNS))
def test_the_arm_counts_what_the_reference_counts(runs, tag):
    _, ranks = runs
    for _, meta in ranks:
        stats = meta[tag]["stats"]
        assert stats.get("spmd_specs_applied", 0) > 0
        assert any(v > 0 for k, v in stats.items()
                   if k.startswith("collective_bytes_spmd_"))


def test_shards_are_dtensors(runs):
    """fsdp-major, tp-minor on one dim (("fsdp", "tp")) and one axis a
    dim: the arm's shard is DTensor's local tensor on every rank, and the
    all-gather gives the whole tensor back."""
    _, ranks = runs
    full = np.arange(48, dtype=np.float32).reshape(8, 6)
    for arrays, meta in ranks:
        c = meta["coords"]
        for tag in ("joint", "split"):
            np.testing.assert_array_equal(arrays[f"place.{tag}"],
                                          arrays[f"place.{tag}.dtensor"])
            np.testing.assert_array_equal(arrays[f"place.{tag}.gathered"],
                                          full)
        k = c["fsdp"] * 2 + c["tp"]
        np.testing.assert_array_equal(arrays["place.joint"],
                                      full[2 * k:2 * k + 2])
        np.testing.assert_array_equal(
            arrays["place.split"],
            full[4 * c["fsdp"]:4 * c["fsdp"] + 4,
                 3 * c["tp"]:3 * c["tp"] + 3])


# -- BERT's tensor-parallel step ---------------------------------------------

@pytest.mark.parametrize("tag", ["mp4", "dp2_mp2"])
def test_bert_tp_matches_the_references_one_process_step(runs, tag):
    ref, ranks = runs
    for arrays, meta in ranks:
        np.testing.assert_allclose(arrays[f"{tag}.losses"],
                                   ref["bert"]["losses"], **TOL)
        assert "bert.embeddings.word_embeddings.weight" in meta[tag]["split"]
    _same_on_every_rank(ranks, f"{tag}.params")
    np.testing.assert_allclose(ranks[0][0][f"{tag}.params"],
                               ref["bert"]["params"], **TOL)
    # each rank keeps a share of the split weights
    full = ref["bert"]["params"].size * 4
    assert ranks[0][1][tag]["param_bytes"] < full


def test_bert_tp_dropout_draws_the_one_process_masks(runs):
    _, ranks = runs
    one = ranks[0][0]["mp4_drop.one_process"]
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["mp4_drop.losses"], one,
                                   rtol=1e-5)
    nodrop = ranks[0][0]["mp4.losses"]
    assert not np.allclose(one, nodrop, rtol=1e-5)


def test_the_vocab_fits_to_replicated_where_the_axis_does_not_divide():
    """ROADMAP queue 3: the reference's device_put refuses a (30522, 768)
    table over mp 4 (30522 % 4 != 0); the port keeps it whole on every
    rank (spec_rules.fit_entries) and splits it over mp 2."""
    name, shape = "bert.embeddings.word_embeddings.weight", (30522, 768)
    assert tuple(TB.mp_spec(name, shape, Tmesh.make_mesh(
        {"dp": 1, "mp": 4}, devices=range(4)))) == ()
    assert tuple(TB.mp_spec(name, shape, Tmesh.make_mesh(
        {"dp": 1, "mp": 2}, devices=range(2)))) == ("mp",)
    from jax.sharding import NamedSharding, PartitionSpec as P

    m = Jmesh.make_mesh({"dp": 1, "mp": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="divisible by 4"):
        jax.device_put(np.zeros((30, 8), np.float32),
                       NamedSharding(m, JB.bert_param_spec(name, (30, 8))))
    assert JB.bert_param_spec(name, (30, 8)) == P("mp", None)


def test_an_axis_that_does_not_divide_the_heads_raises():
    """ROADMAP queue 3: the reference's GSPMD splits the columns whatever
    the heads; the port's step runs whole heads and d_ff columns a
    rank."""
    model = TB.BertForPretraining(TB.BertConfig.tiny(), device="cpu")
    for axes in ({"dp": 1, "mp": 3}, {"dp": 1, "mp": 8}):
        mesh = Tmesh.make_mesh(axes, devices=range(axes["mp"]))
        with pytest.raises(ValueError, match="must divide"):
            TB.build_pretrain_step(model, mesh=mesh, mp_axis="mp")


# -- the plain versions' offsets ------------------------------------------------

def test_head_offsets_are_the_global_masks_slice():
    from paddle_tpu.ops.pallas import attention as JA

    b, h, sq, sk, p, seed = 2, 8, 16, 24, 0.3, 1234
    whole = TA._keep_mask3(seed, 0, 0, 0, b * h, sq, sk, p).view(
        b, h, sq, sk)
    for size in (2, 4):
        hl = h // size
        for r in range(size):
            part = TA._keep_mask3(seed, 0, 0, 0, b * hl, sq, sk, p,
                                  heads=hl, heads_total=h,
                                  head_offset=r * hl).view(b, hl, sq, sk)
            assert torch.equal(part, whole[:, r * hl:(r + 1) * hl])
    want = np.asarray(JA._keep_mask3(jnp.uint32(seed), 0, 0, 0, b * h, sq,
                                     sk, p))
    np.testing.assert_array_equal(whole.view(b * h, sq, sk).numpy(), want)
    # the plain forward and backward at an offset: the whole tensor's
    # heads.  Their f32 products run at other shapes than the whole
    # tensor's, so the CPU's kernels may sum them in other orders (seen:
    # 1e-4 apart where dS cancels); a wrong mask moves a value by a
    # whole dropped probability
    near = dict(rtol=1e-4, atol=1e-4)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, sq, h, 16, generator=g) for _ in range(3))
    out, _ = TA.flash_forward_reference(q, k, v, seed=seed, dropout_p=p)
    part, _ = TA.flash_forward_reference(q[:, :, 4:6], k[:, :, 4:6],
                                         v[:, :, 4:6], seed=seed,
                                         dropout_p=p, heads_total=h,
                                         head_offset=4)
    torch.testing.assert_close(part, out[:, :, 4:6], **near)
    gr = torch.randn(b, sq, h, 16, generator=g)
    _, lse = TA.flash_forward_reference(q, k, v, seed=seed, dropout_p=p)
    dq, dk, dv = TA.flash_backward_reference(q, k, v, None, seed, out, lse,
                                             gr, dropout_p=p)
    sl = slice(4, 6)
    got = TA.flash_backward_reference(
        q[:, :, sl], k[:, :, sl], v[:, :, sl], None, seed, out[:, :, sl],
        lse[:, sl], gr[:, :, sl], dropout_p=p, heads_total=h, head_offset=4)
    for a, w in zip(got, (dq, dk, dv)):
        torch.testing.assert_close(a, w[:, :, sl], **near)


def test_column_offsets_are_the_global_masks_slice():
    from paddle_tpu.ops.pallas import ffn as JFF

    t, f, p, seed = 24, 64, 0.2, 77
    whole = TFF._ffn_keep(seed, 0, 0, t, f, p)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(JFF._ffn_keep(jnp.uint32(seed), 0, 0, t,
                                                f, p)))
    for size in (2, 4):
        fl = f // size
        for r in range(size):
            assert torch.equal(TFF._ffn_keep(seed, 0, r * fl, t, fl, p),
                               whole[:, r * fl:(r + 1) * fl])
    g = torch.Generator().manual_seed(1)
    pre, dh = torch.randn(t, f, generator=g), torch.randn(t, f, generator=g)
    b1 = torch.randn(f, generator=g)
    h = TFF.ffn_act_fwd(pre, b1, "gelu", p, seed)
    dpre, _ = TFF.ffn_act_bwd(pre, b1, dh, "gelu", p, seed)
    sl = slice(32, 48)
    assert torch.equal(TFF.ffn_act_fwd(pre[:, sl], b1[sl], "gelu", p, seed,
                                       col_offset=32), h[:, sl])
    assert torch.equal(TFF.ffn_act_bwd(pre[:, sl], b1[sl], dh[:, sl], "gelu",
                                       p, seed, col_offset=32)[0], dpre[:, sl])
    # the fused FFN's plain version: a column slice's hidden units drop
    # as the whole FFN's do
    x = torch.randn(t, 16, generator=g)
    w1, w2 = torch.randn(16, f, generator=g), torch.randn(f, 16, generator=g)
    zero = torch.zeros(16)
    whole_h = TFF.ffn_forward_reference(x, w1[:, sl], b1[sl], w2[sl],
                                        zero, "relu", p, seed,
                                        col_offset=32)
    keep = whole[:, sl]
    pre_s = torch.relu(x @ w1[:, sl] + b1[sl])
    want = torch.where(keep, pre_s / (1 - p), torch.zeros_like(pre_s)) \
        @ w2[sl]
    torch.testing.assert_close(whole_h, want, rtol=1e-5, atol=1e-5)
