"""The layout-probe kernel's launch plan, on the CPU: how `_probe_plan`
(paddle_tpu_torch/ops/kernels/probe.py) cuts the queries of every
(batch, head) into CTAs of one or two 64-query warpgroups (every query
tile and head covered once, ragged edges included, the card filled when
there are few heads), and what shared memory a CTA asks for (within the
227 KB a block may use, at every head dim and whatever S is)."""

import pytest

from paddle_tpu_torch.ops.kernels import probe as P

SMS = 132  # an H100 SXM
SMEM_LIMIT = 232448  # bytes a block may use on the H100 (227 KB)


def test_probe_plan_at_the_tools_shape():
    """(8, 512, 12, 64): 128-query CTAs, 4 query tiles x 96 heads, two
    CTAs an SM by shared memory (81,000 + 1,080 bytes each)."""
    block_q, grid, smem = P._probe_plan(8, 12, 512, 64, SMS)
    assert (block_q, grid, smem) == (128, (4, 96), 83000)
    assert 2 * smem <= SMEM_LIMIT


def test_probe_plan_with_fewer_heads_than_sms():
    """(2, 512, 4, 64): 8 heads make 32 CTAs of 128 queries, under one
    wave, so the plan takes 64-query CTAs: twice as many."""
    assert P._probe_plan(2, 4, 512, 64, SMS) == (64, (8, 8), 83000)
    # exactly one wave of 128-query CTAs is enough for two warpgroups
    assert P._probe_plan(1, 33, 512, 64, SMS)[0] == 128
    assert P._probe_plan(1, 32, 512, 64, SMS)[0] == 64


def test_probe_plan_at_head_dim_128():
    """(4, 512, 6, 128): the resident Q rows and the ring double, and an
    SM holds one CTA; 96 CTAs of 128 queries then beat 192 of 64, which
    would run one warpgroup an SM in two waves."""
    block_q, grid, smem = P._probe_plan(4, 6, 512, 128, SMS)
    assert (block_q, grid) == (128, (4, 24))
    assert smem == 1280 * 128 + 1080 <= SMEM_LIMIT
    # with few enough heads, 64-query CTAs fit one wave and spread out
    assert P._probe_plan(1, 8, 512, 128, SMS) == (64, (8, 8), smem)


@pytest.mark.parametrize("s", [1, 200, 768, 2048, 4096])
@pytest.mark.parametrize("b,h", [(8, 12), (2, 4), (1, 1), (64, 16)])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_probe_plan_covers_every_query_tile_and_head(s, b, h, d):
    """Every (query tile, head) has its CTA, the last tile holds S's
    last rows and at most a block's worth past them, and the CTA's
    shared memory does not grow with S."""
    block_q, (tiles, heads), smem = P._probe_plan(b, h, s, d, SMS)
    assert block_q in (64, 128)
    assert heads == b * h
    assert (tiles - 1) * block_q < s <= tiles * block_q
    assert smem == P._probe_smem(d) <= SMEM_LIMIT
    if s <= 64:  # a second warpgroup would hold no query
        assert block_q == 64
    if block_q == 64 and s > 64:  # more CTAs, but still one wave
        assert -(-s // 128) * heads < SMS
        assert tiles * heads <= SMS * min(4, 233472 // (smem + 1024))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_probe_smem_is_the_kernels_layout(d):
    """Q: 128 rows of d bf16; the ring: 4 stages of a 64-key K and V
    tile; 4 full barriers, the Q barrier, 4 release counts and 1024
    bytes of alignment slack (Tile<D> in probe4d.cu)."""
    assert P._probe_smem(d) == 128 * d * 2 + 4 * 2 * 64 * d * 2 \
        + 5 * 8 + 4 * 4 + 1024
