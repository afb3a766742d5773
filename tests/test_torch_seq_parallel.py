"""Sequence parallelism of the port over four gloo ranks on the CPU (one
spawn of the JAX-free tests/torch_dist_worker.py suite `seq`, with the
reference's runs overlapped), held against the reference:

* ring attention and Ulysses (parallel/ring_attention.py, ulysses.py)
  on the sequence split four ways, causal off and on, Ulysses with the
  key-padding masks of tests/test_ulysses.py and a row with no key:
  outputs and the gradients of q, k and v against the reference's
  `ring_attention` / `ulysses_attention` on a mesh of four devices and
  `jax.vjp`, within rtol 2e-3 / atol 2e-4 (tests/test_torch_spmd.py's
  TOL); the reference's refusals raise through the dispatcher's scopes;
* BERT-tiny's build_pretrain_step(sp_axis=...) on {dp: 1, sp: 4} with K/V
  gathered at attention, ring attention and Ulysses, and on {dp: 1,
  mp: 2, sp: 2} with Ulysses, f32 at dropout 0: two steps' losses and
  masters against the reference's one-process step (the parity oracle's
  batch; unpadded for the ring, whose mask the reference drops); at
  hidden dropout 0.1 against the port's own one-process step within rtol
  1e-5 (each rank's tokens draw the one-process masks); the ring refuses
  a padded batch (ROADMAP queue 3 item 49).

And in one process: the FFN hash's row map (a sequence rank's tokens
hash as the whole batch's), the mesh's sequence axis and the batch's
sequence cut.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as JP
import paddle_tpu.fluid.initializer as Jinit
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.parallel import mesh as Jmesh
from paddle_tpu.parallel.ring_attention import ring_attention as j_ring
from paddle_tpu.parallel.ulysses import ulysses_attention as j_ulysses

from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.ops.kernels import ffn as TFF
from paddle_tpu_torch.parallel import mesh as Tmesh

import torch_dist_worker as W
from test_torch_collective import finish_ranks, fork_ranks

WORLD = 4
TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_torch_spmd.py


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _attention_reference():
    """The reference's ring and Ulysses attention on four devices: each
    case's output and (dq, dk, dv) under the cotangent (every case in one
    jit)."""
    mesh = Jmesh.make_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])
    q, k, v, g = (jnp.asarray(a) for a in W.seq_qkv(3))

    def case(kind, causal, rows):
        if kind == "ring":
            return lambda q, k, v: j_ring(mesh, "sp")(q, k, v,
                                                      is_causal=causal)
        mask = None if rows is None else jnp.asarray(W.seq_mask(rows))
        return lambda q, k, v: j_ulysses(mesh, "sp")(
            q, k, v, mask=mask, is_causal=causal)

    def every(q, k, v, g):
        out = {}
        for name, kind, causal, rows in W.SEQ_ATTN:
            o, vjp = jax.vjp(case(kind, causal, rows), q, k, v)
            out[name] = (o,) + tuple(vjp(g))
        return out

    return {name: tuple(np.asarray(x) for x in got)
            for name, got in jax.jit(every)(q, k, v, g).items()}


def _bert_reference(workdir):
    """The parity oracle's one-process step at dropout 0 (BERT-tiny from
    paddle.seed(0), W.SEQ_BERT_STEPS f32 steps at lr 1e-3, one jit) on
    the padded and the unpadded batch; its initial weights for the
    ranks."""
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
    yield
    step, start = JB.build_pretrain_step(jm, bf16=False)
    out = {}
    for padded in (True, False):
        # the step donates its state: each run from a copy of the start
        state = jax.tree_util.tree_map(jnp.copy, start)
        batch = {k: jnp.asarray(v) for k, v in W.seq_batch(padded).items()}
        losses = []
        for _ in range(W.SEQ_BERT_STEPS):
            state, loss = step(state, batch, jnp.float32(1e-3))
            losses.append(float(loss))
        out[padded] = {"losses": losses, "params": np.concatenate(
            [np.asarray(state["params"][k]).reshape(-1)
             for k in sorted(state["params"])])}
    yield out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("seq")
    bert = _bert_reference(workdir)
    next(bert)
    started = fork_ranks("seq", WORLD, workdir)
    ref = {"attn": _attention_reference(), "bert": next(bert)}
    return finish_ranks(started), ref


def _whole(res, key):
    """The ranks' sequence shards of `key` joined along dim 1."""
    return np.concatenate([a[key] for a, _ in res], axis=1)


@pytest.mark.parametrize("name", [c[0] for c in W.SEQ_ATTN])
def test_attention_matches_the_reference(runs, name):
    res, ref = runs
    want = ref["attn"][name]
    for i, part in enumerate(("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(_whole(res, f"attn.{name}.{part}"),
                                   want[i], **TOL, err_msg=part)


def test_the_ring_step_and_the_tiled_all_to_all_and_their_adjoints(runs):
    """comm.ring_shift_diff: rank r receives rank r - 1's x, and x's
    gradient is rank r + 1's cotangent; comm.all_to_all_tiled_diff(x, 1,
    0): block k of dim 1 to rank k, the blocks stacked along dim 0 in
    rank order (lax.all_to_all tiled), its backward the inverse."""
    res, _ = runs
    for r, (arrays, _) in enumerate(res):
        np.testing.assert_array_equal(arrays["comm.ring"],
                                      np.full((2, 3), (r - 1) % WORLD))
        np.testing.assert_array_equal(arrays["comm.ring_grad"],
                                      np.full((2, 3), 10.0 * ((r + 1)
                                                              % WORLD)))
        xs = [np.arange(WORLD * 6, dtype=np.float32).reshape(2, WORLD, 3)
              + 100 * j for j in range(WORLD)]
        want = np.concatenate([x[:, r:r + 1] for x in xs], axis=0)
        np.testing.assert_array_equal(arrays["comm.a2a"], want)
        np.testing.assert_array_equal(arrays["comm.a2a_grad"], 2 * xs[r])


def test_a_row_with_no_key_gives_zeros(runs):
    res, _ = runs
    got = _whole(res, "attn.uly_dead_row.out")
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
    assert np.abs(got[1]).sum() > 0


def test_the_ring_and_the_all_to_alls_move_their_bytes(runs):
    res, _ = runs
    b, s, h, d = (W.SEQ_QKV[k] for k in "BSHD")
    kv = 2 * b * (s // WORLD) * h * d * 4  # a rank's K and V, f32
    ring = [c for c in W.SEQ_ATTN if c[1] == "ring"]
    uly = [c for c in W.SEQ_ATTN if c[1] == "ulysses"]
    for _, meta in res:
        # forward: K/V n - 1 hops; backward: K/V n - 1 hops, dK/dV n hops
        want = len(ring) * ((WORLD - 1) * kv * 2 + WORLD * kv)
        assert meta["bytes"]["seq_parallel_ring_bytes"] == want
        # q, k, v and the output, forward and backward (counted at the
        # forward's calls: four a case)
        assert meta["bytes"]["seq_parallel_all_to_all_bytes"] == \
            len(uly) * 4 * kv // 2


@pytest.mark.parametrize("case", ["ring_mask", "ring_dropout",
                                  "uly_dropout", "uly_heads",
                                  "uly_dense_mask"])
def test_the_references_refusals_raise(runs, case):
    res, _ = runs
    msg = res[0][1]["refusals"][case]
    assert msg is not None
    assert ("ring" in msg) if case.startswith("ring") or case == \
        "uly_heads" else ("ulysses" in msg)


def test_the_ring_refuses_a_padded_batch(runs):
    res, _ = runs
    for _, meta in res:
        assert "padded" in meta["ring_padded"]


@pytest.mark.parametrize("tag", [t for t, v in W.SEQ_BERT.items()
                                 if not v[2]])
def test_bert_matches_the_references_step(runs, tag):
    res, ref = runs
    want = ref["bert"][W.SEQ_BERT[tag][3]]
    for arrays, meta in res:
        np.testing.assert_allclose(arrays[f"bert.{tag}.losses"],
                                   want["losses"], **TOL)
        np.testing.assert_allclose(arrays[f"bert.{tag}.params"],
                                   want["params"], **TOL)
    ids = res[1][1][f"bert.{tag}.ids"]
    assert ids[1] == 128 // W.SEQ_BERT[tag][0]["sp"]


@pytest.mark.parametrize("tag", [t for t, v in W.SEQ_BERT.items() if v[2]])
def test_bert_dropout_is_the_one_process_step(runs, tag):
    res, _ = runs
    want = res[0][0][f"bert.{tag}.one_process"]
    for arrays, _ in res:
        np.testing.assert_allclose(arrays[f"bert.{tag}.losses"], want,
                                   rtol=1e-5)


# -- one process ------------------------------------------------------------------

def test_a_sequence_ranks_ffn_mask_is_the_whole_batchs():
    b, s, f, n, p, seed = 3, 32, 40, 4, 0.3, 1234
    whole = TFF._ffn_keep(seed, 0, 0, b * s, f, p).view(b, s, f)
    sl = s // n
    for j in range(n):
        got = TFF._ffn_keep(seed, 0, 0, b * sl, f, p,
                            row_map=(sl, s, j * sl))
        assert torch.equal(got, whole[:, j * sl:(j + 1) * sl].reshape(-1, f))
    assert torch.equal(TFF._ffn_keep(seed, 0, 0, b * s, f, p,
                                     row_map=(0, 0, 0)).view(b, s, f), whole)


def test_the_mesh_takes_a_sequence_axis_and_cuts_the_sequence():
    mesh = Tmesh.make_mesh({"dp": 1, "sp": 2}, devices=[0, 1])
    assert Tmesh.seq_axis(mesh) == "sp"
    assert tuple(Tmesh.batch_spec(mesh, 8, seq=True)) == (None, "sp")
    assert tuple(Tmesh.batch_spec(mesh, 8)) == ()
    mesh = Tmesh.make_mesh({"data": 2, "seq": 2}, devices=range(4))
    assert tuple(Tmesh.batch_spec(mesh, 8, seq=True)) == ("data", "seq")
    batch = W.seq_batch(True)
    mine = Tmesh.shard_host_batch(mesh, batch, seq_keys=TB.SEQ_KEYS)
    # no group: this process stands for rank 0 of each axis
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(mine[key], batch[key][:4, :64])
    for key in ("masked_positions", "masked_labels"):
        np.testing.assert_array_equal(mine[key], batch[key][:4])
    # the caller names the sequence leaves: without, rows only
    np.testing.assert_array_equal(
        Tmesh.shard_host_batch(mesh, batch)["input_ids"],
        batch["input_ids"][:4])


def test_a_plain_split_refuses_attention_dropout():
    """ROADMAP queue 3 item 50: over a sequence split without ring or
    Ulysses the kernels' hash would index a rank's queries from 0, so
    attention dropout raises, at the step's build and in the scope."""
    mesh = Tmesh.make_mesh({"dp": 1, "sp": 2}, devices=range(2))
    cfg = TB.BertConfig.tiny(attention_probs_dropout_prob=0.1)
    model = TB.BertForPretraining(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3 item 50"):
        TB.build_pretrain_step(model, mesh=mesh, sp_axis="sp")
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        with TA.gathered_kv_scope(mesh, "sp"):
            TA.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
