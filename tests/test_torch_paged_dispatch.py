"""paged_attention's dispatch on the CPU: the dense arm
(`dense_paged_attention`, the port of paddle_tpu's
`_dense_paged_attention`) against the reference's on the same pages, in
float32 with head_dim 80 (a head_dim and dtype the ragged kernel does not
take), ragged lengths, decode steps and a chunk with explicit
`q_positions`; and `_ragged_takes`, the rule that sends CUDA tensors to
one arm or the other, against the checks `_ragged_paged_cuda` makes
before any launch, rule by rule.

Tolerance: RTOL = ATOL = 1e-5, float32 on both sides, which differ in
summation order only (80-term dot products, softmax over up to 24 keys).
Only lanes whose query position lies inside the sequence are compared:
the others are unspecified in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as JA
from paddle_tpu_torch import profiler
from paddle_tpu_torch.ops.kernels import attention as TA

RTOL = ATOL = 1e-5


def _pages(lengths, t, page_size=4, heads=2, dim=80, seed=0):
    """Each sequence owns ceil(len / S) distinct pages, unused row entries
    point at scratch page 0, the whole pool is random."""
    rng = np.random.RandomState(seed)
    width = max(2, max(-(-max(1, n) // page_size) for n in lengths))
    rows = np.zeros((len(lengths), width), np.int32)
    nxt = 1
    for i, n in enumerate(lengths):
        for j in range(-(-n // page_size)):
            rows[i, j] = nxt
            nxt += 1
    pool = (nxt, page_size, heads, dim)
    return (rng.randn(len(lengths), t, heads, dim).astype(np.float32),
            rng.randn(*pool).astype(np.float32),
            rng.randn(*pool).astype(np.float32), rows,
            np.asarray(lengths, np.int32))


# lengths, T, page size, first query position (None: the newest T)
CASES = {
    "decode": ([5, 13, 1], 1, 4, None),
    "decode_pages8": ([9, 24, 3], 1, 8, None),
    "tail": ([7, 11], 3, 4, None),
    "chunk_q_positions": ([12, 6], 4, 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_arm_matches_the_reference(case):
    lengths, t, page_size, first = CASES[case]
    q, kp, vp, rows, lens = _pages(lengths, t, page_size)
    if first is None:
        qpos = (lens[:, None] - t + np.arange(t)[None, :]).astype(np.int32)
    else:
        qpos = np.broadcast_to(first + np.arange(t, dtype=np.int32),
                               (len(lengths), t)).copy()
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = np.asarray(JA._dense_paged_attention(
        *map(jnp.asarray, (q, kp, vp, rows, lens, qpos)), float(scale)))
    got = TA.dense_paged_attention(
        *map(torch.from_numpy, (q, kp, vp, rows, lens, qpos)),
        float(scale)).numpy()
    valid = qpos < lens[:, None]
    assert valid.sum() >= 2
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL,
                               atol=ATOL)
    # the kernel's plain version, which CPU tensors take, agrees there
    before = profiler.get_int_stats().get("serving_ragged_fallback_total",
                                          0)
    plain = TA.paged_attention(
        *map(torch.from_numpy, (q, kp, vp, rows, lens)),
        q_positions=None if first is None else torch.from_numpy(qpos))
    np.testing.assert_allclose(plain.numpy()[valid], want[valid],
                               rtol=RTOL, atol=ATOL)
    assert profiler.get_int_stats().get("serving_ragged_fallback_total",
                                        0) == before


def _kernel_rejects(monkeypatch, dtype, head_dim, page_size):
    """Whether `_ragged_paged_cuda` refuses these inputs before any
    launch (NotImplementedError); inputs it takes reach the launch, which
    a stub library here turns into a sentinel."""
    class Launched(Exception):
        pass

    def no_launch():
        raise Launched

    monkeypatch.setattr(TA, "_sm_count", lambda index: 132)
    monkeypatch.setattr(TA, "_ragged_lib", no_launch)
    b, t, h, w = 2, 1, 2, 3
    q = torch.zeros((b, t, h, head_dim), dtype=dtype)
    pages = torch.zeros((4, page_size, h, head_dim), dtype=dtype)
    try:
        TA._ragged_paged_cuda(torch.zeros((b, w), dtype=torch.int32),
                              torch.ones(b, dtype=torch.int32), q, pages,
                              pages, torch.zeros((b, t), dtype=torch.int32),
                              0.125)
    except NotImplementedError:
        return True
    except Launched:
        return False
    raise AssertionError("the call neither refused nor launched")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("page_size", [4, 8, 16, 12, 32])
def test_ragged_takes_agrees_with_the_kernel_checks(monkeypatch, dtype,
                                                    head_dim, page_size):
    takes = TA._ragged_takes((dtype, dtype, dtype), head_dim, page_size)
    assert takes == (not _kernel_rejects(monkeypatch, dtype, head_dim,
                                         page_size))
    assert takes == (dtype == torch.bfloat16
                     and head_dim in (16, 32, 64, 128)
                     and page_size % 8 == 0)


def test_ragged_takes_needs_every_operand_in_bf16():
    bf, f32 = torch.bfloat16, torch.float32
    assert TA._ragged_takes((bf, bf, bf), 64, 16)
    for dtypes in ((f32, bf, bf), (bf, f32, bf), (bf, bf, f32)):
        assert not TA._ragged_takes(dtypes, 64, 16)
