"""The flash kernels' launch plans and operand preparation, on the CPU:
how `_flash_plan` (paddle_tpu_torch/ops/kernels/attention.py) cuts the
queries into CTAs of one or two 64-query warpgroups (every query covered
once, ragged edges included, the card filled at the decode prefills),
how `_flash_bwd_plan` cuts the backward's dq pass over the queries and
its dkv pass over the keys the same way and what shared memory their
CTAs ask for, which (B, S, H, D) layouts the 4-D tensor maps read in
place (`_tma_ready`: q/k/v/g), and the f32 rows they read by 2-D maps
(`_bias_for_tma`, `_f32_rows_for_tma`: key biases, lse, delta); and how
`_dx_plan` (ops/kernels/ffn.py) cuts the FFN dx pass into its dpre and
dx grids and sizes the dpre workspace."""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.ops.kernels import ffn as TF

SMS = 132  # an H100 SXM


def _covered_once(ranges, total):
    """The ranges [b, e) are nonempty, in order, and tile [0, total)."""
    assert all(b < e for b, e in ranges)
    assert [b for b, _ in ranges] == [0] + [e for _, e in ranges[:-1]]
    return ranges[-1][1] == total


@pytest.mark.parametrize("b,h,sq", [
    (32, 12, 512), (8, 12, 512), (2, 12, 200), (1, 12, 64), (1, 12, 128),
    (1, 12, 256), (11, 12, 130), (1, 1, 1), (2, 66, 193), (24, 12, 300),
    (1, 12, 4096), (64, 16, 128)])
def test_flash_plan_covers_every_query_once(b, h, sq):
    block_q, block_k, ctas = TA._flash_plan(b, h, sq, sq, 64, SMS)
    assert block_q in (64, 128) and block_k == 64
    tiles = [(i * block_q, min(sq, (i + 1) * block_q))
             for i in range(-(-sq // block_q))]
    assert _covered_once(tiles, sq)
    assert ctas == len(tiles) * b * h
    # the last tile's rows past Sq are at most a block's worth
    assert 0 < sq - tiles[-1][0] <= block_q


def test_flash_plan_takes_two_warpgroups_unless_the_card_is_short():
    """BERT-base (32 x 512, 12 heads): 128-query CTAs, 1536 of them; a
    decode prefill (one sequence of 64-256 tokens) fills fewer than 132
    CTAs either way, so it takes 64-query CTAs: twice as many."""
    assert TA._flash_plan(32, 12, 512, 512, 64, SMS) == (128, 64, 1536)
    for s, ctas in ((64, 12), (128, 24), (256, 48)):
        assert TA._flash_plan(1, 12, s, s, 64, SMS) == (64, 64, ctas)
    # exactly one wave of 128-query CTAs is enough for two warpgroups
    assert TA._flash_plan(11, 12, 130, 130, 64, SMS)[0] == 128
    assert TA._flash_plan(5, 12, 130, 130, 64, SMS)[0] == 64


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_plan_does_not_depend_on_head_dim_or_keys(d):
    assert TA._flash_plan(4, 12, 300, 77, d, SMS) == \
        TA._flash_plan(4, 12, 300, 300, 64, SMS)


def test_tma_ready_reads_nested_strides_in_place():
    """A packed (B, S, 3, H, D) projection's q/k/v views nest their
    strides and are read in place; a head-major layout seen through a
    transpose does not, and is copied to a contiguous one."""
    qkv = torch.zeros(2, 96, 3, 4, 64)
    q = qkv[:, :, 0]
    assert TA._tma_ready(q).data_ptr() == q.data_ptr()
    hm = torch.zeros(2, 4, 96, 64).transpose(1, 2)
    ready = TA._tma_ready(hm)
    assert ready.is_contiguous() and ready.data_ptr() != hm.data_ptr()
    assert torch.equal(ready, hm)


@pytest.mark.parametrize("sk", [1, 63, 64, 65, 130, 512])
def test_bias_for_tma(sk):
    """The bias is read in place when its f32 rows are 16-byte aligned,
    else from a copy padded to a multiple of 4 keys; no bias, no copy."""
    bias = torch.randn(3, sk)
    kb, ld = TA._bias_for_tma(bias, 3, sk)
    assert ld % 4 == 0 and kb.shape == (3, ld) and kb.dtype == torch.float32
    assert torch.equal(kb[:, :sk], bias)
    assert (kb.data_ptr() == bias.data_ptr()) == (sk % 4 == 0)
    assert TA._bias_for_tma(None, 3, sk) == (None, 0)
    with pytest.raises(ValueError):
        TA._bias_for_tma(bias, 2, sk)


@pytest.mark.parametrize("b,h,sq,sk", [
    (32, 12, 512, 512), (8, 12, 512, 512), (2, 3, 70, 200), (2, 3, 200, 70),
    (2, 3, 64, 1), (2, 3, 1, 1), (3, 2, 1, 77), (11, 12, 130, 130),
    (1, 131, 100, 100), (1, 133, 100, 100), (1, 12, 256, 256),
    (2, 66, 193, 4096)])
def test_flash_bwd_plan_covers_every_query_and_key_once(b, h, sq, sk):
    """The dq pass's CTAs tile the queries of each batch*head once, the
    dkv pass's the keys, each in blocks of 64 or 128 rows (the last one
    ragged); dq takes the forward's own plan, so the two see the same
    causal tile skips."""
    plan = TA._flash_bwd_plan(b, h, sq, sk, 64, SMS)
    for rows, block, ctas in ((sq, plan["dq_block"], plan["dq_ctas"]),
                              (sk, plan["dkv_block"], plan["dkv_ctas"])):
        assert block in (64, 128)
        tiles = [(i * block, min(rows, (i + 1) * block))
                 for i in range(-(-rows // block))]
        assert _covered_once(tiles, rows)
        assert ctas == len(tiles) * b * h
    assert (plan["dq_block"], plan["dq_ctas"]) == \
        TA._flash_plan(b, h, sq, sk, 64, SMS)[::2]
    # the card is short of CTAs only where 64-row CTAs cannot fill it
    big = -(-sk // 128) * b * h
    assert plan["dkv_block"] == (128 if big >= SMS else 64)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_bwd_shared_memory_fits_a_cta(d):
    """Each pass's CTA fits the 227 KB an H100 block may use, at every
    head dim; at D=64 (BERT-base) 83,756 bytes (dq) and 84,524 (dkv)."""
    for dkv in (False, True):
        assert TA._flash_bwd_smem_bytes(d, dkv) <= 232_448
    assert TA._flash_bwd_smem_bytes(d, True) - \
        TA._flash_bwd_smem_bytes(d, False) == 3 * 64 * 4
    plan = TA._flash_bwd_plan(2, 12, 512, 512, d, SMS)
    assert plan["dq_smem"] == TA._flash_bwd_smem_bytes(d, False)
    assert plan["dkv_smem"] == TA._flash_bwd_smem_bytes(d, True)
    if d == 64:
        assert (plan["dq_smem"], plan["dkv_smem"]) == (83_756, 84_524)


def test_tma_ready_reads_g_beside_q_in_place():
    """q and the output gradient g as views of one packed (B, S, 2, H, D)
    buffer are both read in place; g's own strides go to its map."""
    qg = torch.zeros(2, 70, 2, 3, 64)
    q, g = qg[:, :, 0], qg[:, :, 1]
    for t in (q, g):
        assert TA._tma_ready(t).data_ptr() == t.data_ptr()
    # a D-strided view (every other element) is copied
    wide = torch.zeros(2, 70, 3, 128)[..., ::2]
    ready = TA._tma_ready(wide)
    assert ready.is_contiguous() and torch.equal(ready, wide)


@pytest.mark.parametrize("sq", [1, 3, 4, 64, 65, 200, 512])
def test_f32_rows_for_tma(sq):
    """lse and delta, (B*H, Sq) f32 rows: read in place when the rows are
    16-byte aligned (Sq a multiple of 4), else from a copy padded to a
    multiple of 4 columns whose first Sq hold the values."""
    lse = torch.randn(2, 3, sq)
    rows, ld = TA._f32_rows_for_tma(lse.reshape(6, sq))
    assert ld % 4 == 0 and rows.shape == (6, ld) and ld - sq < 4
    assert rows.dtype == torch.float32
    assert torch.equal(rows[:, :sq], lse.reshape(6, sq))
    assert (rows.data_ptr() == lse.data_ptr()) == (sq % 4 == 0)
    # another dtype or a strided view is made contiguous f32 first
    half, _ = TA._f32_rows_for_tma(lse.reshape(6, sq).half())
    assert half.dtype == torch.float32
    cols, cld = TA._f32_rows_for_tma(torch.randn(sq, 6).t())
    assert cols.is_contiguous() and cld % 4 == 0


@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024])
@pytest.mark.parametrize("t", [1, 31, 100, 127, 128, 129, 1000, 16384])
def test_dx_plan_covers_every_token_and_column_once(h, t):
    for f in (64, 192, 4 * h):
        plan = TF._dx_plan(t, h, f)
        nf, mt = plan["dpre_grid"]
        nn, mt2 = plan["dx_grid"]
        assert mt == mt2 == -(-t // plan["block_t"])
        rows = [(i * plan["block_t"], min(t, (i + 1) * plan["block_t"]))
                for i in range(mt)]
        assert _covered_once(rows, t)
        cols = [(j * plan["block_f"], min(f, (j + 1) * plan["block_f"]))
                for j in range(nf)]
        assert _covered_once(cols, f)
        # a last d_ff tile of 64 columns when f is an odd number of 64s
        assert cols[-1][1] - cols[-1][0] in (64, 128)
        assert nn * plan["block_n"] == h
        assert plan["workspace_bytes"] == t * f * 2


def test_dx_plan_at_bert_base():
    """32 x 512 tokens, d_model 768, d_ff 3072: 24 x 128 dpre CTAs, 6 x
    128 dx CTAs, a 100.7 MB dpre workspace (freed after the call)."""
    plan = TF._dx_plan(16384, 768, 3072)
    assert plan["dpre_grid"] == (24, 128)
    assert plan["dx_grid"] == (6, 128)
    assert plan["workspace_bytes"] == 100_663_296
