"""The port's decode path on the CPU, against the JAX package: the ragged
paged-attention plain version against paddle_tpu's Pallas kernel in
interpret mode and its dense-gather oracle; the in-place page writes
against paddle_tpu's, bit for bit; the PageTable's rules; the
AutoregressiveEngine's scenarios (chunked prefill, lazy growth,
pause/preempt, multi-layer KV, zero device->host transfers in the decode
loop, the single-layer contract) on toy models written in torch from the
numpy weights of paddle_tpu's own decode tests, held against their dense
numpy references; and the slice as a whole: tiny BERT as a causal
LayeredDecoder through paddle_tpu's engine and through the port's, the
same tokens out.  Inputs are numpy arrays from seeds, handed to both
packages; everything runs in float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import serving as JS
from paddle_tpu.fluid import initializer as jax_init
from paddle_tpu.fluid.dygraph import tracer as jax_tracer
from paddle_tpu.fluid.dygraph.tracer import no_grad as jax_no_grad
from paddle_tpu.fluid.dygraph.varbase import Tensor as JTensor
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.nn.layer.transformer import \
    _dense_ffn_block as jax_dense_ffn_block
from paddle_tpu.ops.pallas import attention as JA
from paddle_tpu.serving import kv_cache as JKV
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.nn.layer.transformer import _dense_ffn_block
from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.serving import (AutoregressiveEngine, EngineOverloaded,
                                      LayeredDecoder, PagedKVCache,
                                      PageTable, RequestCancelled)
from paddle_tpu_torch.serving import kv_cache as TKV

# f32 on both sides; the two differ in summation order only
ATOL = RTOL = 1e-5
# teacher-forced logits of tiny BERT (2 layers, f32) in the two packages
LOGIT_ATOL = 1e-4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _stat(name):
    return profiler.get_int_stats().get(name, 0)


# -- ragged paged attention: plain version vs the JAX kernel -------------------

def _paged_case(lengths, t=1, page_size=4, heads=2, dim=8, seed=0):
    """paddle_tpu's test layout: each sequence owns ceil(len/S) distinct
    pages, unused row entries point at scratch page 0, and the whole pool
    (scratch included) is random so masking bugs cannot hide behind
    zeros.  numpy arrays (q, k_pages, v_pages, rows, lengths)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    width = max(2, max(-(-max(1, ln) // page_size) for ln in lengths))
    rows = np.zeros((b, width), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-max(1, ln) // page_size)):
            if ln > 0:
                rows[i, j] = nxt
                nxt += 1
    pool = (nxt, page_size, heads, dim)
    q = rng.randn(b, t, heads, dim).astype(np.float32)
    kp = rng.randn(*pool).astype(np.float32)
    vp = rng.randn(*pool).astype(np.float32)
    return q, kp, vp, rows, np.asarray(lengths, np.int32)


# (lengths, T, seed, first query position or None for the default
# lengths - T .. lengths - 1)
RAGGED_CASES = {
    "ragged+len0": ([5, 13, 0], 1, 0, None),
    "one,exact-page,short": ([1, 16, 3], 1, 0, None),
    "single-seq": ([7], 1, 0, None),
    "uniform": ([4, 4, 4, 4], 1, 0, None),
    "all-len0": ([0, 0], 1, 0, None),
    "causal-tail": ([9, 14], 6, 1, None),
    "chunk-positions": ([12], 4, 2, 8),
    "padded-chunk-lanes": ([10], 4, 3, 8),
}


def _qpos(lengths, t, first):
    if first is None:
        return (lengths[:, None] - t + np.arange(t)[None, :]).astype(
            np.int32)
    return np.broadcast_to(first + np.arange(t, dtype=np.int32),
                           (len(lengths), t)).copy()


@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_ragged_reference_matches_the_jax_kernel(case):
    """Every lane, padded chunk lanes included: both follow the skip
    rule, so they agree where the dense oracle does not."""
    lengths, t, seed, first = RAGGED_CASES[case]
    q, kp, vp, rows, lens = _paged_case(lengths, t=t, seed=seed)
    qpos = _qpos(lens, t, first)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = JA._ragged_paged_forward(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(q),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(qpos),
        page_size=kp.shape[1], scale=float(scale), interpret=True)
    got = TA.ragged_paged_reference(*map(torch.from_numpy,
                                         (rows, lens, q, kp, vp, qpos)),
                                    float(scale))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_paged_attention_matches_the_dense_oracles_on_valid_lanes(case):
    """paged_attention (the plain version on CPU tensors) and the port's
    dense oracle against JAX's `_dense_paged_attention`, on the lanes
    whose query position lies inside the sequence."""
    lengths, t, seed, first = RAGGED_CASES[case]
    q, kp, vp, rows, lens = _paged_case(lengths, t=t, seed=seed)
    qpos = _qpos(lens, t, first)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = np.asarray(JA._dense_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(qpos),
        float(scale)))
    tq, tkp, tvp, trows, tlens, tqpos = map(
        torch.from_numpy, (q, kp, vp, rows, lens, qpos))
    got = TA.paged_attention(
        tq, tkp, tvp, trows, tlens,
        q_positions=None if first is None else tqpos).numpy()
    oracle = TA.dense_paged_attention(tq, tkp, tvp, trows, tlens, tqpos,
                                      float(scale)).numpy()
    valid = qpos < lens[:, None]
    assert valid.any()
    for arr in (got, oracle):
        np.testing.assert_allclose(arr[valid], want[valid], rtol=RTOL,
                                   atol=ATOL)


def test_paged_attention_over_scattered_pages_matches_dense_attention():
    """paged_attention over pages written by write_prefill == dense
    attention over each sequence's own keys (the seam's numerical
    contract, paddle_tpu's TestPagedAttention)."""
    rng = np.random.RandomState(0)
    B, H, D, S = 2, 2, 4, 4
    lengths = [6, 3]
    cache = PagedKVCache(num_pages=16, page_size=S, num_heads=H,
                         head_dim=D, device="cpu")
    max_pages = 3
    rows = np.zeros((B, max_pages), np.int32)
    ks, vs = [], []
    for i, L in enumerate(lengths):
        k = rng.randn(8, H, D).astype(np.float32)   # padded to 8
        v = rng.randn(8, H, D).astype(np.float32)
        cache.table.allocate(i, L)
        rows[i] = cache.table.rows(i, max_pages)
        TKV.write_prefill(cache.k, cache.v, rows[i], L,
                          torch.from_numpy(k), torch.from_numpy(v))
        ks.append(k)
        vs.append(v)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    out = TA.paged_attention(torch.from_numpy(q), cache.k, cache.v,
                             torch.from_numpy(rows),
                             torch.tensor(lengths, dtype=torch.int32))
    for i, L in enumerate(lengths):
        want = TA.dense_attention(torch.from_numpy(q[i:i + 1]),
                                  torch.from_numpy(ks[i][None, :L]),
                                  torch.from_numpy(vs[i][None, :L]))
        np.testing.assert_allclose(out[i].numpy(), want[0].numpy(),
                                   rtol=2e-5, atol=2e-5)
    assert all(c.value == 0 for c in COUNTERS.values())  # CPU: no kernel


# -- in-place page writes, bit for bit against paddle_tpu's -----------------------

def _pools(rng, shape):
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("start,length,tb", [(0, 6, 8), (4, 3, 8),
                                             (8, 8, 8), (0, 0, 4)])
def test_write_prefill_matches_jax_bit_for_bit(layers, start, length, tb):
    """Random pools, so the scratch rewrite of padded rows is visible;
    the padded rows of the last case run past the page row."""
    rng = np.random.RandomState(start * 31 + length)
    P, S, H, D = 9, 4, 2, 3
    lead = () if layers is None else (layers,)
    kc, vc = _pools(rng, lead + (P, S, H, D))
    k, v = _pools(rng, lead + (tb, H, D))
    rows = np.array([3, 5, 1, 0], np.int32)
    want = JKV.write_prefill(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(rows), jnp.int32(length),
                             jnp.asarray(k), jnp.asarray(v), start=start)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = TKV.write_prefill(tkc, tvc, torch.from_numpy(rows), length,
                            torch.from_numpy(k), torch.from_numpy(v),
                            start=start)
    assert got[0] is tkc and got[1] is tvc  # written in place
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(want[1]))


def test_append_token_matches_jax_bit_for_bit():
    """Active slots write at their position; inactive ones (one of them
    with a position past its row) rewrite scratch page 0 in place."""
    rng = np.random.RandomState(7)
    P, S, H, D = 10, 4, 2, 3
    kc, vc = _pools(rng, (P, S, H, D))
    k, v = _pools(rng, (4, H, D))
    page_rows = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [7, 8, 9]],
                         np.int32)
    positions = np.array([9, 5, 2, 12], np.int32)
    active = np.array([True, True, False, False])
    want = JKV.append_token(jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(page_rows), jnp.asarray(positions),
                            jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(active))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = TKV.append_token(tkc, tvc, *map(torch.from_numpy,
                                          (page_rows, positions, k, v,
                                           active)))
    assert got[0] is tkc and got[1] is tvc
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(want[1]))


def test_layered_pool_matches_stacked_single_layer_pools():
    """write_prefill on an (L, P, S, H, D) pool scatters each layer
    exactly like L single-layer pools given the same page row, chunked
    writes at an offset included."""
    L, P, S, H, D = 2, 8, 4, 1, 4
    rng = np.random.RandomState(5)
    multi = PagedKVCache(P, S, H, D, num_layers=L, device="cpu")
    singles = [PagedKVCache(P, S, H, D, device="cpu") for _ in range(L)]
    assert multi.k.shape == (L, P, S, H, D)
    rows = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
    for start, ln in ((0, 6), (6, 3)):
        k = torch.from_numpy(rng.randn(L, 6, H, D).astype(np.float32))
        v = torch.from_numpy(rng.randn(L, 6, H, D).astype(np.float32))
        TKV.write_prefill(multi.k, multi.v, rows, ln, k, v, start=start)
        for li, c in enumerate(singles):
            TKV.write_prefill(c.k, c.v, rows, ln, k[li], v[li], start=start)
    for li, c in enumerate(singles):
        assert torch.equal(multi.k[li], c.k)
        assert torch.equal(multi.v[li], c.v)


def test_layered_pool_is_one_allocation():
    one = PagedKVCache(8, 4, 1, 4, device="cpu")
    two = PagedKVCache(8, 4, 1, 4, num_layers=2, device="cpu")
    assert two.table.bytes_per_page == 2 * one.table.bytes_per_page
    assert one.k.dtype == torch.float32 and one.k.device.type == "cpu"
    with pytest.raises(ValueError):
        PagedKVCache(8, 4, 1, 4, num_layers=0, device="cpu")


def test_paged_kv_cache_without_cuda_and_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-device rule cannot fail")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(8, 4, 1, 4)


# -- PageTable --------------------------------------------------------------------

def test_page_table_allocate_extend_free():
    t = PageTable(num_pages=8, page_size=4)
    assert t.capacity == 7
    pages = t.allocate("a", 9)          # ceil(9/4) = 3 pages
    assert len(pages) == 3 and 0 not in pages
    assert t.in_use == 3 and t.seqs == 1
    t.extend("a", 2)
    assert len(t.pages_of("a")) == 5
    assert _stat("serving_kv_pages_in_use") == 5
    assert t.free("a") == 5
    assert t.in_use == 0 and t.free("a") == 0
    with pytest.raises(ValueError):
        PageTable(num_pages=1, page_size=4)


def test_page_table_exhaustion_is_typed_and_atomic():
    t = PageTable(num_pages=5, page_size=4)   # 4 usable pages
    t.allocate("a", 12)                       # 3 pages
    with pytest.raises(EngineOverloaded) as ei:
        t.allocate("b", 8)                    # needs 2, only 1 left
    assert ei.value.resource == "kv_pages"
    assert t.available == 1                   # nothing leaked
    with pytest.raises(EngineOverloaded) as ei:
        t.extend("a", 2)
    assert ei.value.resource == "kv_pages"
    t.allocate("b", 4)                        # 1 page still fits
    with pytest.raises(ValueError):
        t.allocate("b", 4)                    # already holds pages
    with pytest.raises(KeyError):
        t.extend("zz")


def test_page_table_rows_pad_with_the_scratch_page():
    t = PageTable(num_pages=8, page_size=4)
    t.allocate("a", 6)
    row = t.rows("a", 5)
    assert row.dtype == np.int32 and row.shape == (5,)
    assert list(row[2:]) == [0, 0, 0]
    with pytest.raises(EngineOverloaded) as ei:
        t.rows("a", 1)
    assert ei.value.resource == "kv_rows"


def test_page_table_matches_jax_over_one_history():
    ops = [("allocate", "a", 9), ("allocate", "b", 4), ("extend", "a", 2),
           ("free", "b"), ("allocate", "c", 13), ("free", "a")]
    tables = [JKV.PageTable(12, 4), PageTable(12, 4)]
    for op in ops:
        outs = [getattr(t, op[0])(*op[1:]) for t in tables]
        assert outs[0] == outs[1], op
        assert tables[0].in_use == tables[1].in_use
        np.testing.assert_array_equal(tables[0].rows("c", 5),
                                      tables[1].rows("c", 5))


# -- toy decoders in torch, with the dense numpy references of paddle_tpu's
#    decode tests (the same weights from the same seeds) ---------------------

def _toy_lm():
    """Single-layer toy LM: embedding is Q=K=V, one output projection."""
    V, D = 13, 4
    rng = np.random.RandomState(3)
    embn = rng.randn(V, D).astype(np.float32)
    wn = rng.randn(D, V).astype(np.float32)
    emb, w = torch.from_numpy(embn), torch.from_numpy(wn)

    def qkv_fn(tokens, positions):
        q = emb[tokens.long()][:, :, None, :]
        return q, q, q

    def out_fn(attn):
        return attn[:, :, 0, :] @ w

    def ref(prompt, n):
        seq = list(prompt)
        out = []
        for _ in range(n):
            x = embn[np.array(seq)]
            L = len(seq)
            s = x @ x.T / np.sqrt(D)
            s[np.triu(np.ones((L, L), bool), 1)] = -1e30
            e = np.exp(s - s.max(axis=1, keepdims=True))
            p = e / e.sum(axis=1, keepdims=True)
            out.append(int(np.argmax((p @ x)[-1] @ wn)))
            seq.append(out[-1])
        return out

    return qkv_fn, out_fn, ref, D


def _toy_transformer(num_layers=2):
    """N-layer toy transformer for the LayeredDecoder contract: Q=K=V =
    x @ W_i per layer, residual merge, shared unembedding."""
    V, D = 11, 4
    rng = np.random.RandomState(9)
    embn = rng.randn(V, D).astype(np.float32)
    wsn = [rng.randn(D, D).astype(np.float32) for _ in range(num_layers)]
    woutn = rng.randn(D, V).astype(np.float32)
    emb, wout = torch.from_numpy(embn), torch.from_numpy(woutn)

    def make_layer(w):
        def qkv(x, positions):
            hh = (x @ w)[:, :, None, :]
            return hh, hh, hh

        def merge(x, attn):
            return x + attn[:, :, 0, :]

        return qkv, merge

    model = LayeredDecoder(
        embed=lambda tokens, positions: emb[tokens.long()],
        layers=[make_layer(torch.from_numpy(w)) for w in wsn],
        unembed=lambda x: x @ wout)

    def ref(prompt, n):
        seq = list(prompt)
        out = []
        for _ in range(n):
            x = embn[np.array(seq)]
            L = len(seq)
            mask = np.triu(np.ones((L, L), bool), 1)
            for wn_ in wsn:
                h = x @ wn_
                s = h @ h.T / np.sqrt(D)
                s[mask] = -1e30
                e = np.exp(s - s.max(axis=1, keepdims=True))
                x = x + (e / e.sum(axis=1, keepdims=True)) @ h
            out.append(int(np.argmax(x[-1] @ woutn)))
            seq.append(out[-1])
        return out

    return model, ref


def _lm_engine(**kw):
    qkv_fn, out_fn, ref, D = _toy_lm()
    args = dict(num_heads=1, head_dim=D, num_pages=32, page_size=4,
                max_slots=2, max_pages_per_seq=8, prompt_buckets=(8,),
                device="cpu")
    args.update(kw)
    return AutoregressiveEngine(qkv_fn, out_fn, **args), ref


def _toks(a):
    return list(map(int, a))


# -- chunked prefill ------------------------------------------------------------------

def test_chunked_matches_single_shot_and_reference():
    prompt = np.arange(1, 12)
    chunked, ref = _lm_engine(num_pages=64, prompt_buckets=(4, 16),
                              prefill_chunk=4)
    single, _ = _lm_engine(num_pages=64, prompt_buckets=(16,),
                           prefill_chunk=16)
    c0 = _stat("serving_prefill_chunks")
    toks_c = chunked.generate(prompt, max_new_tokens=6)
    assert _stat("serving_prefill_chunks") - c0 == 3
    toks_s = single.generate(prompt, max_new_tokens=6)
    assert toks_c.dtype == np.int32
    assert _toks(toks_c) == _toks(toks_s) == ref(list(prompt), 6)


def test_long_prompt_interleaves_with_decode():
    """One chunk per step: while a long prompt prefills chunk by chunk,
    the co-resident decode slot advances one token EVERY step."""
    eng, ref = _lm_engine(num_pages=64, max_pages_per_seq=16,
                          prompt_buckets=(4, 16), prefill_chunk=4)
    short = eng.submit(np.array([1, 2, 3]), max_new_tokens=32)
    eng.step()
    assert eng._slot_gen[0] >= 1
    c0 = _stat("serving_prefill_chunks")
    long_req = eng.submit(np.arange(12) % 13, max_new_tokens=4)
    prefill_steps = 0
    for _ in range(10):
        d0 = _stat("serving_decode_steps")
        g0 = eng._slot_gen[0]
        eng.step()
        assert _stat("serving_decode_steps") == d0 + 1
        assert eng._slot_gen[0] == g0 + 1
        if any(j.req is long_req for j in eng._prefilling.values()):
            prefill_steps += 1
        else:
            break
    assert prefill_steps == 2
    assert _stat("serving_prefill_chunks") - c0 == 3
    eng.run_until_idle()
    assert _toks(long_req.result(timeout=60)) == ref(list(np.arange(12)
                                                          % 13), 4)
    assert _toks(short.result(timeout=60)) == ref([1, 2, 3], 32)


# -- lazy KV page growth -----------------------------------------------------------------

def test_admission_reservation_proportional_to_prompt():
    eng, ref = _lm_engine(num_pages=64, max_pages_per_seq=16, page_slack=1)
    table = eng.kv.table
    req = eng.submit(np.array([1, 2, 3, 4, 5]), max_new_tokens=32)
    eng.step()
    owned = len(table.pages_of(id(req)))
    assert owned == table.pages_needed(5) + 1
    assert owned < table.pages_needed(5 + 32 - 1)
    assert _stat("serving_kv_pages_in_use") == owned
    eng.run_until_idle()
    assert _toks(req.result(timeout=60)) == ref([1, 2, 3, 4, 5], 32)


def test_growth_invariant_every_step_and_freed_at_retirement():
    eng, ref = _lm_engine(num_pages=64, max_pages_per_seq=16, page_slack=1)
    table = eng.kv.table
    req = eng.submit(np.array([1, 2, 3, 4, 5]), max_new_tokens=12)
    grew = set()
    while not req.done():
        eng.step()
        for i, r in enumerate(eng._slots):
            if r is None or i in eng._prefilling:
                continue
            owned = len(table.pages_of(id(r)))
            assert owned == min(table.pages_needed(eng._slot_len[i])
                                + eng.page_slack, eng.max_pages_per_seq)
            # the device row mirrors the table
            np.testing.assert_array_equal(
                eng._state["page_rows"][i].numpy(),
                table.rows(id(r), eng.max_pages_per_seq))
            grew.add(owned)
    assert len(grew) > 1, "sequence never grew a page"
    assert table.in_use == 0
    assert _stat("serving_kv_pages_in_use") == 0
    assert _stat("serving_kv_pages_capacity") == table.capacity
    assert _toks(req.result(timeout=60)) == ref([1, 2, 3, 4, 5], 12)


def test_backpressure_pauses_slot_then_completes():
    """Capacity 7 data pages: b's final length needs all 7, so it must
    pause while a holds pages, then resume and finish in full."""
    eng, ref = _lm_engine(num_pages=8, page_size=2, prompt_buckets=(4,))
    p0 = _stat("serving_kv_paused_total")
    b0 = _stat("serving_kv_backpressure_total")
    k0 = _stat("serving_kv_preempt_total")
    a = eng.submit(np.array([1, 2, 3, 4]), max_new_tokens=5)
    b = eng.submit(np.array([5, 6, 7, 8]), max_new_tokens=10)
    eng.run_until_idle()
    assert _stat("serving_kv_backpressure_total") > b0
    assert _stat("serving_kv_paused_total") > p0
    assert _stat("serving_kv_preempt_total") == k0
    assert _toks(a.result(timeout=60)) == ref([1, 2, 3, 4], 5)
    assert _toks(b.result(timeout=60)) == ref([5, 6, 7, 8], 10)
    assert eng.kv.table.in_use == 0


def test_all_paused_preemption_escape():
    eng, ref = _lm_engine(num_pages=6, page_size=2, prompt_buckets=(4,))
    k0 = _stat("serving_kv_preempt_total")
    a = eng.submit(np.array([1, 2, 3, 4]), max_new_tokens=8)
    b = eng.submit(np.array([5, 6, 7, 8]), max_new_tokens=8)
    eng.run_until_idle()
    assert _stat("serving_kv_preempt_total") > k0
    for req, prompt in ((a, [1, 2, 3, 4]), (b, [5, 6, 7, 8])):
        toks = req.result(timeout=60)
        assert 1 <= len(toks) <= 8
        assert _toks(toks) == ref(prompt, 8)[:len(toks)]
    assert eng.kv.table.in_use == 0


# -- multi-layer engine -------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_two_layer_engine_matches_reference(chunked):
    model, ref = _toy_transformer(num_layers=2)
    kw = dict(prompt_buckets=(4, 16), prefill_chunk=4) if chunked \
        else dict(prompt_buckets=(8,))
    eng = AutoregressiveEngine(model=model, num_heads=1, head_dim=4,
                               num_pages=32, page_size=4, max_slots=2,
                               max_pages_per_seq=8, device="cpu", **kw)
    assert eng.kv.num_layers == 2 and eng.kv.k.shape[0] == 2
    prompt = np.arange(10) % 11 if chunked else np.array([1, 2, 3, 4, 5])
    c0 = _stat("serving_prefill_chunks")
    toks = eng.generate(prompt, max_new_tokens=6)
    assert _stat("serving_prefill_chunks") - c0 == (3 if chunked else 0)
    assert _toks(toks) == ref(list(prompt), 6)


# -- zero device->host transfers in the decode loop ---------------------------------

def test_chunked_lazy_decode_syncs_only_at_retirement():
    eng, ref = _lm_engine(num_pages=64, max_pages_per_seq=16,
                          prompt_buckets=(4, 16), prefill_chunk=4)
    eng.generate(np.arange(12) % 13, max_new_tokens=4)  # warm every entry
    profiler.stat_reset("executor_sync_count")
    t0 = _stat("serving_trace_count")
    toks = eng.generate(np.arange(12) % 13, max_new_tokens=8)
    assert len(toks) == 8
    assert _stat("executor_sync_count") == 1
    assert _stat("serving_trace_count") == t0  # no entry warmed twice


def test_decode_loop_zero_transfers():
    eng, ref = _lm_engine()
    eng.generate(np.array([1, 2, 3]), max_new_tokens=3)
    s0 = _stat("executor_sync_count")
    d0 = _stat("serving_decode_steps")
    toks = eng.generate(np.array([2, 4, 6]), max_new_tokens=8)
    assert len(toks) == 8
    assert _stat("serving_decode_steps") - d0 == 7
    assert _stat("executor_sync_count") - s0 == 1


# -- the single-layer contract (paddle_tpu's TestAutoregressiveEngine) -------------

def test_decode_matches_dense_reference():
    eng, ref = _lm_engine()
    assert _toks(eng.generate(np.array([1, 2, 3, 4, 5]),
                              max_new_tokens=6)) == ref([1, 2, 3, 4, 5], 6)
    assert _toks(eng.generate(np.array([7, 8]), max_new_tokens=4)) \
        == ref([7, 8], 4)


def test_results_survive_the_reuse_of_their_slot():
    """A retired request's tokens are a host copy: the next request to
    take its slot writes the same device buffer."""
    eng, ref = _lm_engine(max_slots=1)
    r1 = eng.submit(np.array([1, 2, 3, 4, 5]), max_new_tokens=6)
    r2 = eng.submit(np.array([7, 8]), max_new_tokens=6)
    eng.run_until_idle()
    assert _toks(r1.result(0)) == ref([1, 2, 3, 4, 5], 6)
    assert _toks(r2.result(0)) == ref([7, 8], 6)


def test_continuous_batching_two_slots():
    eng, ref = _lm_engine()
    r1 = eng.submit(np.array([1, 2, 3, 4, 5]), max_new_tokens=6)
    r2 = eng.submit(np.array([7, 8]), max_new_tokens=4)
    eng.run_until_idle()
    assert _toks(r1.result(0)) == ref([1, 2, 3, 4, 5], 6)
    assert _toks(r2.result(0)) == ref([7, 8], 4)


def test_pages_returned_at_retirement():
    eng, _ = _lm_engine()
    assert eng.kv.table.in_use == 0
    eng.generate(np.array([1, 2, 3, 4, 5]), max_new_tokens=4)
    assert eng.kv.table.in_use == 0


def test_admission_rejects_oversized_request():
    eng, _ = _lm_engine(max_pages_per_seq=2, page_size=4)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(np.arange(1, 9), max_new_tokens=8)  # needs 4 pages
    assert ei.value.resource == "kv_pages"


def test_pool_pressure_parks_request():
    eng, ref = _lm_engine(num_pages=5, page_size=4, max_pages_per_seq=4)
    r1 = eng.submit(np.array([1, 2, 3, 4, 5, 6, 7]), max_new_tokens=6)
    r2 = eng.submit(np.array([7, 8]), max_new_tokens=4)
    eng.run_until_idle()
    assert _toks(r1.result(0)) == ref([1, 2, 3, 4, 5, 6, 7], 6)
    assert _toks(r2.result(0)) == ref([7, 8], 4)


def test_cancel_pending_generation():
    eng, _ = _lm_engine()
    req = eng.submit(np.array([1, 2]), max_new_tokens=4)
    assert req.cancel()
    eng.run_until_idle()
    with pytest.raises(RequestCancelled):
        req.result(0)


def test_queue_bound_background_loop_and_shutdown():
    eng, ref = _lm_engine(max_queue=2)
    eng.submit(np.array([1, 2]), max_new_tokens=2)
    eng.submit(np.array([3, 4]), max_new_tokens=2)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(np.array([5]), max_new_tokens=2)
    assert ei.value.resource == "queue"
    eng.start()
    assert _toks(eng.generate(np.array([7, 8]), max_new_tokens=4,
                              timeout=60)) == ref([7, 8], 4)
    eng.shutdown(drain=True)
    assert eng.kv.table.in_use == 0
    with pytest.raises(Exception, match="shut down"):
        eng.submit(np.array([1]), max_new_tokens=1)


def test_engine_without_cuda_and_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-device rule cannot fail")
    qkv_fn, out_fn, _, D = _toy_lm()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoregressiveEngine(qkv_fn, out_fn, num_heads=1, head_dim=D)


# -- the slice: tiny BERT as a causal decoder in both packages ------------------

def _jax_bert_decoder(jm):
    """paddle_tpu's BertForPretraining as a causal JS.LayeredDecoder, its
    layers called on jnp values inside the engine's jitted entries."""
    T = JTensor
    bert, cls = jm.bert, jm.cls

    def embed(tokens, positions):
        with jax_no_grad():
            return bert.embeddings(T(tokens), None, T(positions))._value

    def make_layer(layer):
        sa = layer.self_attn

        def qkv(x, positions):
            with jax_no_grad():
                return tuple(sa._split_heads(p(T(x)))._value
                             for p in (sa.q_proj, sa.k_proj, sa.v_proj))

        def merge(x, attn):
            b, t = attn.shape[0], attn.shape[1]
            with jax_no_grad():
                h = x + sa.out_proj(T(attn.reshape(b, t, -1)))._value
                h = layer.norm1(T(h))._value
                f = jax_dense_ffn_block(layer, T(h))._value
                return layer.norm2(T(h + f))._value

        return qkv, merge

    def unembed(x):
        with jax_no_grad():
            y = cls.layer_norm(cls.activation(cls.transform(T(x))))._value
        return jnp.dot(y, cls.decoder_weight._value.T) \
            + cls.decoder_bias._value

    return JS.LayeredDecoder(embed, [make_layer(lyr) for lyr in
                                     bert.encoder.layers], unembed)


def _port_bert_decoder(tm):
    """The port's BertForPretraining as a causal LayeredDecoder (the same
    adapter chip_smoke.py runs at BERT-base width)."""
    bert, cls = tm.bert, tm.cls
    top = tm.bert.config.max_position_embeddings - 1

    def embed(tokens, positions):
        # padded rows of a bucket may run past the position table
        return bert.embeddings(tokens, position_ids=positions.clamp(max=top))

    def make_layer(layer):
        sa = layer.self_attn

        def qkv(x, positions):
            return tuple(sa._split_heads(p(x))
                         for p in (sa.q_proj, sa.k_proj, sa.v_proj))

        def merge(x, attn):
            b, t = attn.shape[0], attn.shape[1]
            h = layer.norm1(x + sa.out_proj(attn.reshape(b, t, -1)))
            return layer.norm2(h + _dense_ffn_block(layer, h))

        return qkv, merge

    def unembed(x):
        y = cls.layer_norm(cls.activation(cls.transform(x)))
        return torch.matmul(y, cls.decoder_weight.t()) + cls.decoder_bias

    return LayeredDecoder(embed, [make_layer(lyr) for lyr in
                                  bert.encoder.layers], unembed)


def _jax_teacher_forced(dec, tokens):
    """(n, V) logits of a dense causal forward of `tokens`."""
    n = len(tokens)
    pos = jnp.arange(n, dtype=jnp.int32)[None]
    x = dec.embed(jnp.asarray(tokens, jnp.int32)[None], pos)
    causal = jnp.tril(jnp.ones((n, n), bool))
    for qkv, merge in dec.layers:
        q, k, v = qkv(x, pos)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
        p = jax.nn.softmax(jnp.where(causal, s, -1e30), axis=-1)
        x = merge(x, jnp.einsum("bhqk,bkhd->bqhd", p, v))
    return np.asarray(dec.unembed(x)[0])


def _port_teacher_forced(dec, tokens):
    n = len(tokens)
    pos = torch.arange(n, dtype=torch.int32)[None]
    with torch.inference_mode():
        x = dec.embed(torch.tensor(tokens, dtype=torch.int32)[None], pos)
        for qkv, merge in dec.layers:
            q, k, v = qkv(x, pos)
            x = merge(x, TA.dense_attention(q, k, v, is_causal=True))
        return dec.unembed(x)[0].numpy()


@pytest.fixture(scope="module")
def bert_pair():
    # paddle.seed moves the JAX package's global draw streams, which later
    # test files of the same worker draw their initial weights from: put
    # them back as they were
    saved_init = list(jax_init._eager_seed)
    saved_trace = {k: getattr(jax_tracer._STATE, k)
                   for k in ("rng_seed", "rng_counter")
                   if hasattr(jax_tracer._STATE, k)}
    try:
        paddle.seed(13)
        jm = JB.BertForPretraining(JB.BertConfig.tiny(**NO_DROP))
    finally:
        jax_init._eager_seed[:] = saved_init
        for k in ("rng_seed", "rng_counter"):
            if k in saved_trace:
                setattr(jax_tracer._STATE, k, saved_trace[k])
            elif hasattr(jax_tracer._STATE, k):
                delattr(jax_tracer._STATE, k)
    jm.eval()
    state = {k: np.asarray(v) for k, v in jax_functional_state(jm).items()}
    tm = load_jax_state(TB.BertForPretraining(TB.BertConfig.tiny(**NO_DROP),
                                              device="cpu"), state).eval()
    return _jax_bert_decoder(jm), _port_bert_decoder(tm)


def test_tiny_bert_decodes_the_same_tokens_in_both_engines(bert_pair):
    """Two single-shot prompts and one chunked prompt (16 + 16 + 8),
    decoding together over shared pages: the port's tokens equal
    paddle_tpu's; each package's teacher-forced logits of the generated
    sequences agree within LOGIT_ATOL, and every generated token is the
    argmax of its position."""
    jdec, tdec = bert_pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 1024, n).astype(np.int32)
               for n in (11, 5, 40)]
    new = [8, 10, 6]
    kw = dict(num_heads=4, head_dim=16, num_pages=64, page_size=8,
              max_slots=3, max_pages_per_seq=8, prompt_buckets=(8, 16),
              prefill_chunk=16)
    jeng = JS.AutoregressiveEngine(model=jdec, **kw)
    teng = AutoregressiveEngine(model=tdec, device="cpu", **kw)
    c0 = _stat("serving_prefill_chunks")
    results = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts,
                                                                  new)]
        eng.run_until_idle()
        results.append([_toks(r.result(0)) for r in reqs])
    assert _stat("serving_prefill_chunks") - c0 == 3  # the port's chunks
    assert results[0] == results[1]
    for prompt, toks in zip(prompts, results[1]):
        seq = list(prompt) + toks[:-1]
        want = _jax_teacher_forced(jdec, seq)
        got = _port_teacher_forced(tdec, seq)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        tail = got[len(prompt) - 1:]
        assert [int(i) for i in tail.argmax(-1)] == toks
    assert teng.kv.table.in_use == 0
