"""The flash forward kernel's launch plan and operand preparation, on the
CPU: how `_flash_plan` (paddle_tpu_torch/ops/kernels/attention.py) cuts
the queries into CTAs of one or two 64-query warpgroups (every query
covered once, ragged edges included, the card filled at the decode
prefills), which (B, S, H, D) layouts its 4-D tensor maps read in place
(`_tma_ready`), and the key biases it reads by TMA (`_bias_for_tma`);
and how `_dx_plan` (ops/kernels/ffn.py) cuts the
FFN dx pass into its dpre and dx grids and sizes the dpre workspace."""

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
