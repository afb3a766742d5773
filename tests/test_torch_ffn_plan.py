"""The FFN kernels' launch plans, on the CPU: how `_fwd_plan` and
`_dw_plan` (paddle_tpu_torch/ops/kernels/ffn.py) cut the work of the
forward and dW kernels over a card's SMs — every d_ff column and every
token covered exactly once, enough CTAs for few tokens, the f32
workspace under its cap — and the plain forward, which the card holds the
kernel against, vs the JAX package's `fused_ffn` (Pallas, interpret mode)
at token counts that are not multiples of the kernel's tile.  Inputs are
numpy arrays from a seed, handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import ffn as JF
from paddle_tpu_torch.ops.kernels import build
from paddle_tpu_torch.ops.kernels import ffn as TF

SMS = 132  # an H100 SXM
HIDDEN = (128, 256, 512, 768, 1024)
TOKENS = (1, 2, 15, 16, 17, 63, 64, 65, 100, 255, 512, 1000, 4096, 4097,
          16384, 65536)
# f32 on both sides; the two only differ in summation order
FFN_ATOL = 1e-5


def _covered_once(ranges, total):
    """The ranges [b, e) are nonempty, in order, and tile [0, total)."""
    assert all(b < e for b, e in ranges)
    assert [b for b, _ in ranges] == [0] + [e for _, e in ranges[:-1]]
    return ranges[-1][1] == total


@pytest.mark.parametrize("h", HIDDEN)
@pytest.mark.parametrize("f_mult", ["64", "192", "4h"])
def test_fwd_plan_covers_every_column_and_token_once(h, f_mult):
    f = {"64": 64, "192": 192, "4h": 4 * h}[f_mult]
    for t in TOKENS:
        block_t, n_split = TF._fwd_plan(t, h, f, SMS)
        step = TF._FWD_BLOCK_F
        ranges = TF._split_ranges(-(-f // step), n_split)
        assert len(ranges) == n_split
        # the splits' columns, the last step cut at f, tile [0, f)
        assert _covered_once(
            [(step * b, min(f, step * e)) for b, e in ranges], f)
        tiles = [(i * block_t, min(t, (i + 1) * block_t))
                 for i in range(-(-t // block_t))]
        assert _covered_once(tiles, t)
        # the column groups tile d_model
        assert h % TF._fwd_groups(h) == 0
        assert h // TF._fwd_groups(h) in (128, 256, 384)


@pytest.mark.parametrize("h", HIDDEN)
def test_fwd_plan_keeps_the_workspace_under_its_cap(h):
    for t in TOKENS:
        for f in (64, 192, 4 * h):
            _, n_split = TF._fwd_plan(t, h, f, SMS)
            assert n_split == 1 or n_split * t * h * 4 <= TF._FWD_WS_CAP


def test_fwd_plan_fills_the_card_at_few_tokens():
    """BERT-base widths: the decode step's 16 tokens and a 512-token
    batch spread over the SMs; 16,384 tokens take one split."""
    h, f = 768, 3072
    ctas = {}
    for t in (16, 512, 16384):
        block_t, n_split = TF._fwd_plan(t, h, f, SMS)
        ctas[t] = -(-t // block_t) * n_split * TF._fwd_groups(h)
        assert ctas[t] <= 4 * SMS or n_split == 1
    assert ctas[16] >= 48
    assert ctas[512] >= 128
    assert TF._fwd_plan(16384, h, f, SMS)[1] == 1


@pytest.mark.parametrize("h", HIDDEN[:4])
def test_dw_plan_covers_every_slice_and_token_once(h):
    for f in (64, 192, 4 * h):
        for t in TOKENS:
            block_t, block_f, n_split = TF._dw_plan(t, h, f, SMS)
            assert f % block_f == 0
            n_tiles = -(-t // block_t)
            ranges = TF._split_ranges(n_tiles, n_split)
            assert len(ranges) == n_split
            assert _covered_once(ranges, n_tiles)
            assert 1 <= n_split <= 8
            assert (n_split == 1
                    or n_split * (2 * h * f + f) * 4 <= TF._DW_WS_CAP)


def test_dw_plan_fills_whole_waves_at_bert_base():
    """192 slices of 16 d_ff columns: two token splits put 384 CTAs in
    three nearly full waves of 132 (one split leaves 27 % of a wave
    idle)."""
    _, block_f, n_split = TF._dw_plan(16384, 768, 3072, SMS)
    assert (block_f, n_split) == (16, 2)
    assert TF._dw_plan(1, 768, 3072, SMS)[2] == 1


def test_plans_run_without_a_card():
    """The wrappers ask the card for its SM count once per device; the
    plans themselves are plain arithmetic."""
    assert TF._fwd_plan(16, 768, 3072, 132) == (64, 24)
    assert TF._dw_plan(100, 768, 3072, 132)[2] == 2


@pytest.mark.parametrize("t", [1, 17, 1000])
@pytest.mark.parametrize("activation,p", [("gelu", 0.0), ("relu", 0.0),
                                          ("gelu", 0.1)])
def test_ffn_reference_matches_pallas_at_ragged_token_counts(t, activation,
                                                             p):
    rng = np.random.default_rng(t)
    h, f = 128, 256
    x = rng.standard_normal((t, h)).astype(np.float32)
    w1 = (rng.standard_normal((h, f)) * h ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, h)) * f ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(h) * 0.1).astype(np.float32)
    want = np.asarray(JF.fused_ffn(
        x, w1, b1, w2, b2, activation=activation, dropout_p=p,
        dropout_seed=jnp.array([77], jnp.int32), interpret=True))
    got = TF.ffn_forward_reference(
        *(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)), activation, p,
        77)
    np.testing.assert_allclose(got.numpy(), want, atol=FFN_ATOL, rtol=0)


def test_a_header_edit_renames_the_library(tmp_path, monkeypatch):
    """Library names hash the source and the csrc headers it includes, so
    an edited shared header never loads a stale build."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    assert [p.name for p in build._sources(src)] == ["k.cu", "a.cuh", "b.cuh"]
    before = build._target(src)
    (tmp_path / "b.cuh").write_text("// two\n")
    assert build._target(src) != before
