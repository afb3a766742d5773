"""The ragged paged-attention kernel's launch plan and its split path's
arithmetic, on the CPU.

`_ragged_plan` (paddle_tpu_torch/ops/kernels/attention.py) picks one of
the two paths of csrc/ragged_paged.cu from shapes alone: the split path
(decode steps, and page sizes that do not divide 64) or the tiled path
(prefill chunks).  These tests hold the choice, the split path's runs of
pages (from W and the SM count only), its head groups, the shared memory
every CTA asks for and the grids' limits.  `ragged_paged_split_reference`,
the plain emulation of the split path's split-and-merge, is held against
`ragged_paged_reference` and against paddle_tpu's Pallas kernel in
interpret mode, on inputs made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as JA
from paddle_tpu_torch.ops.kernels import attention as TA

SMS = 132             # an H100 SXM
SMEM = 232_448        # shared-memory bytes an H100 block may use
# f32 on both sides; the split emulation and the plain version differ in
# summation order only
ATOL = RTOL = 1e-5
# bf16 outputs: two bf16 units in the last place (the emulation rounds p
# against each run's max, the plain version against the row's)
BF16 = dict(atol=2 ** -6, rtol=2 ** -6)

HEAD_DIMS = (16, 32, 64, 128)
PAGE_SIZES = (8, 16, 24, 32, 64)


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("t,s,path", [
    (1, 16, "split"), (4, 16, "split"), (5, 16, "tiled"), (64, 8, "tiled"),
    (256, 16, "tiled"), (256, 32, "tiled"), (256, 64, "tiled"),
    (1, 64, "split"), (256, 24, "split"), (33, 24, "split"),
    (17, 40, "split")])
def test_path_by_rows_and_page_size_not_head_dim(t, s, d, path):
    """More than four query rows go to the tiled path when a 64-key tile
    is whole pages (S divides 64); everything else to the split path;
    the head dim never changes the choice."""
    assert TA._ragged_plan(2, t, 12, d, s, 32, SMS)["path"] == path


def test_decode_step_and_chunk_plans_at_bert_base():
    """(a) a decode step: 16 lanes, 12 heads of 64, pages of 16, rows of
    32: runs of 4 pages, 8 a row, all 12 heads in one CTA of 12 warps,
    a 101,376-value f32 workspace; (b) a 256-token chunk: 4 x 12 CTAs of
    two warpgroups, no workspace."""
    a = TA._ragged_plan(16, 1, 12, 64, 16, 32, SMS)
    assert (a["path"], a["pages_per_split"], a["splits"], a["head_groups"],
            a["heads_per_group"], a["keys_per_stage"], a["threads"]) == \
        ("split", 4, 8, 1, 12, 16, 384)
    assert a["grid"] == (8, 1, 16) and a["ctas"] == 128
    assert a["workspace"] == 16 * 8 * 12 * 66
    b = TA._ragged_plan(1, 256, 12, 64, 16, 32, SMS)
    assert (b["path"], b["grid"], b["ctas"], b["threads"], b["workspace"]) \
        == ("tiled", (4, 12, 1), 48, 256, 0)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 31, 32, 33, 100, 528, 529,
                               4096])
def test_splits_depend_only_on_w_and_the_sm_count(w):
    """The runs of a row come from W and the SM count, whatever the batch,
    rows, heads, head dim or page size: they cover the row once (the last
    one may be short), four pages each unless the row is longer than
    four pages a SM."""
    plans = [TA._ragged_plan(b, t, h, d, s, w, SMS)
             for b in (1, 16, 64) for t in (1, 3) for h in (2, 12, 16)
             for d in HEAD_DIMS for s in (8, 16, 24)]
    runs = {(p["pages_per_split"], p["splits"]) for p in plans}
    assert len(runs) == 1
    pps, splits = runs.pop()
    assert pps == max(4, -(-w // SMS))
    assert splits * pps >= w > (splits - 1) * pps
    assert TA._ragged_plan(16, 1, 12, 64, 16, w, 66)["pages_per_split"] \
        == max(4, -(-w // 66))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", PAGE_SIZES)
@pytest.mark.parametrize("h", [1, 2, 4, 12, 16])
def test_every_cta_fits_shared_memory(d, s, h):
    """Both paths' CTAs fit the 227 KB an H100 block may use at every head
    dim, page size and head count the tests use, rows of 2-300 pages,
    1-256 query rows."""
    for w in (2, 9, 32, 300):
        for t in (1, 5, 33, 256):
            plan = TA._ragged_plan(2, t, h, d, s, w, SMS)
            assert plan["smem"] <= SMEM, plan


def test_heads_split_into_groups_only_when_a_stage_does_not_fit():
    """16 heads of 128 in pages of 16: two stages of all heads would take
    262,176 bytes, so the plan takes two groups of 8; 12 heads of 128 in
    pages of 64, staged 16 keys at a time, fit in one group."""
    assert TA._ragged_split_smem(128, 16, 16, 4) > SMEM
    plan = TA._ragged_plan(2, 1, 16, 128, 16, 32, SMS)
    assert (plan["head_groups"], plan["heads_per_group"], plan["threads"]) \
        == (2, 8, 256)
    assert plan["smem"] == TA._ragged_split_smem(128, 8, 16, 4) <= SMEM
    plan = TA._ragged_plan(2, 1, 12, 128, 64, 8, SMS)
    assert (plan["keys_per_stage"], plan["head_groups"]) == (16, 1)


@pytest.mark.parametrize("b,t,h,d,s,w", [
    (16, 1, 12, 64, 16, 32), (1, 256, 12, 64, 16, 32),
    (65535, 1, 2, 64, 16, 4), (3, 1000, 16, 128, 24, 9),
    (2, 4, 7, 32, 8, 2000), (1, 4096, 40, 128, 64, 64), (8, 3, 33, 16, 16, 1)])
def test_grids_within_launch_limits_and_cover_every_head(b, t, h, d, s, w):
    plan = TA._ragged_plan(b, t, h, d, s, w, SMS)
    gx, gy, gz = plan["grid"]
    assert gx < 2 ** 31 and gy <= 65535 and gz <= 65535
    assert plan["ctas"] == gx * gy * gz
    assert gz == b
    if plan["path"] == "split":
        assert gx == plan["splits"] * t
        hg, groups = plan["heads_per_group"], plan["head_groups"]
        assert gy == groups and groups * hg >= h > (groups - 1) * hg
        assert plan["threads"] == 32 * hg <= 512
    else:
        assert (gx, gy) == (-(-t // 64), h) and plan["threads"] == 256


def test_tiled_path_needs_the_rows_page_ids_in_shared_memory():
    """A row of 60,000 page ids does not fit beside the tiled path's
    ring, so such a chunk runs on the split path."""
    assert TA._ragged_plan(1, 256, 12, 64, 16, 60_000, SMS)["path"] == \
        "split"
    assert TA._ragged_plan(1, 256, 12, 64, 16, 20_000, SMS)["path"] == \
        "tiled"


# -- the split-and-merge emulation ------------------------------------------------

def _paged_case(lengths, w, t=1, page_size=4, heads=2, dim=8, seed=0):
    """Each sequence owns ceil(len/S) distinct pages, unused row entries
    point at scratch page 0, and the whole pool (scratch included) is
    random so masking bugs cannot hide behind zeros.  numpy arrays (q,
    k_pages, v_pages, rows, lengths)."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    rows = np.zeros((b, w), np.int32)
    nxt = 1
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // page_size)):
            rows[i, j] = nxt
            nxt += 1
    pool = (nxt, page_size, heads, dim)
    q = rng.randn(b, t, heads, dim).astype(np.float32)
    kp = rng.randn(*pool).astype(np.float32)
    vp = rng.randn(*pool).astype(np.float32)
    return q, kp, vp, rows, np.asarray(lengths, np.int32)


def _qpos(lengths, t, first):
    if first is None:
        return (lengths[:, None] - t + np.arange(t)[None, :]).astype(np.int32)
    return np.broadcast_to(first + np.arange(t, dtype=np.int32),
                           (len(lengths), t)).copy()


# (lengths, W, T, pages a run, first query position or None); pages of 4
SPLIT_CASES = {
    # 8 keys = two pages = one run exactly; 9 opens a second run
    "run-edge": ([8, 9, 16, 17], 6, 1, 2, None),
    # every lane's pages inside the first run
    "one-run": ([1, 4, 7, 0], 5, 1, 2, None),
    # W = 5 pages in runs of 2: the last run is one page
    "w-not-a-multiple": ([20, 17, 3], 5, 1, 2, None),
    "len0": ([0, 0, 5], 2, 1, 2, None),
    "runs-of-3": ([12, 13, 24, 1], 6, 1, 3, None),
    "runs-of-1": ([5, 11, 0], 3, 1, 1, None),
    "rows-of-queries": ([14, 9], 4, 5, 2, None),
    "chunk-positions": ([16], 4, 4, 2, 8),
    "padded-chunk-lanes": ([10], 4, 4, 3, 8),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_reference_matches_the_plain_version(case):
    lengths, w, t, pps, first = SPLIT_CASES[case]
    q, kp, vp, rows, lens = _paged_case(lengths, w, t=t)
    qpos = _qpos(lens, t, first)
    args = [torch.from_numpy(x) for x in (rows, lens, q, kp, vp, qpos)]
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = TA.ragged_paged_split_reference(*args, scale, pps)
    want = TA.ragged_paged_reference(*args, scale)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_reference_matches_the_jax_kernel(case):
    """Every lane, padded chunk lanes and length-0 lanes included."""
    lengths, w, t, pps, first = SPLIT_CASES[case]
    q, kp, vp, rows, lens = _paged_case(lengths, w, t=t, seed=1)
    qpos = _qpos(lens, t, first)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = JA._ragged_paged_forward(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(q),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(qpos),
        page_size=kp.shape[1], scale=float(scale), interpret=True)
    got = TA.ragged_paged_split_reference(
        *map(torch.from_numpy, (rows, lens, q, kp, vp, qpos)), float(scale),
        pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_split_reference_in_bf16_at_the_decode_step_plan():
    """bf16 inputs at the decode step's runs (4 pages of 16), lengths on
    both sides of run edges: within two bf16 units of the plain version,
    which rounds p against the row's max instead of each run's."""
    lengths = [0, 1, 63, 64, 65, 129, 255, 256, 257, 511, 512]
    q, kp, vp, rows, lens = _paged_case(lengths, 32, page_size=16, heads=3,
                                        dim=64, seed=2)
    qpos = _qpos(lens, 1, None)
    args = [torch.from_numpy(x) for x in (rows, lens, qpos)]
    q, kp, vp = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, kp, vp))
    pps = TA._ragged_plan(len(lengths), 1, 3, 64, 16, 32, SMS)[
        "pages_per_split"]
    got = TA.ragged_paged_split_reference(args[0], args[1], q, kp, vp,
                                          args[2], 0.125, pps)
    want = TA.ragged_paged_reference(args[0], args[1], q, kp, vp, args[2],
                                     0.125)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16)
