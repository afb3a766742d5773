"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same inputs: every compiled instantiation (head dims,
model widths, activations) forward and backward, dropout, causal offsets,
ragged and strided inputs, the FFN kernels' plans (token tiles around
their edges, d_ff splits, column groups, a d_ff that is not a whole
number of steps) and the same bits in two runs, the ragged paged-attention kernel at the
decode path's shapes (length-0 lanes, exact page multiples, chunk
positions, every head dim and several page sizes; its split path at the
edges of its runs of pages, with head groups and a refilled ring; its
tiled path at T = 64-256 over every page size that divides 64; the same
bits in two runs; the grid of its plan, read from the profiler), the shapes and types
the wrappers refuse, tiny BERT served on the card, decoded on the card
through AutoregressiveEngine, its train step on the card, and the
layout-probe kernel in its three layouts (4d, fold3d, merged) at the
probe tool's shape, ragged and long S, bit for bit alike and twice, a
checkpoint's snapshot ordered before the next in-place update, and a
tiny BERT exported to a Predictor that launches the kernels.  These
need an NVIDIA GPU with nvcc; the `cuda` fixture skips them, with a
reason, where there is none.  Run them on the card with

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: the repository's conftest imports JAX, which the GPU
machine does not have; this file imports no JAX).  TF32 is off, so the
plain versions' float32 products are full float32 products.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import io as TIO
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.nn import functional as Fn
from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.ops.kernels import attention as A
from paddle_tpu_torch.ops.kernels import ffn as F
from paddle_tpu_torch.ops.kernels import probe as P
from paddle_tpu_torch.serving import Engine, EngineConfig

# bf16 outputs: kernel and plain version round the same f32 math to bf16
# after different summation orders: two bf16 units in the last place
BF16 = dict(atol=2 ** -6, rtol=2 ** -6)
# bf16 gradients are sums of products of bf16 tiles (p~, dS, h, dpre)
# whose f32 inputs differ in summation order, so a tile element may round
# the other way; a flip moves a sum by one bf16 unit of a TERM, and terms
# scale with the gradient's largest entries, not with an entry that
# cancels to near 0.  Each element: within 2^-6 of the largest |entry|
# (plus 2^-6 relative); the mean error: within 2^-7 of the mean |entry|.
# GRAD_FLOOR: a gradient that is 0 in exact arithmetic (one key: dS =
# p (dP - delta) cancels) keeps the f32 rounding of dP - delta.
GRAD_FRAC = 2 ** -6
GRAD_FLOOR = 2 ** -16
# f32 log-sum-exp: summation order only
LSE = dict(atol=1e-4, rtol=1e-5)
# the kernels a train step launches, once per layer each
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "ffn_fwd",
                 "ffn_bwd_dw", "ffn_bwd_dx")


@pytest.fixture
def cuda(monkeypatch):
    """Skips without a GPU.  Pins fused_ffn to its kernel arm (opt-in, as
    in paddle_tpu), so the model paths here go on launching the FFN
    kernels; the library arm's tests close it themselves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(F, "_FFN_DISABLED", None)
    return torch.Generator().manual_seed(0)


def _bf16(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to("cuda",
                                                        torch.bfloat16)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _close_grad(got, want):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want,
                               atol=GRAD_FRAC * scale + GRAD_FLOOR,
                               rtol=GRAD_FRAC)
    err = float((got - want).abs().mean())
    assert err <= GRAD_FRAC / 2 * float(want.abs().mean()) + GRAD_FLOOR, err


def _close_grad_relu(got, want, slack):
    """_close_grad's rule after `slack` (_relu_slack) is taken off each
    element's error."""
    got, want = got.float(), want.float()
    over = ((got - want).abs() - slack).clamp(min=0.0)
    bound = GRAD_FRAC * float(want.abs().max()) + GRAD_FRAC * want.abs() \
        + GRAD_FLOOR
    assert torch.isfinite(got).all() and bool((over <= bound).all()), \
        float((over - bound).max())
    assert float(over.mean()) <= GRAD_FRAC / 2 * float(want.abs().mean()) \
        + GRAD_FLOOR


# |pre| under which relu's step may fall on either side (_relu_slack)
RELU_KINK = 1e-4


def _relu_slack(x, w1, b1, w2, g, seed, p):
    """What relu's step may move the FFN gradients by.  relu' jumps at
    pre = 0, and the kernels and the plain version sum pre's products in
    other f32 orders (about 1e-6 apart), so an element with |pre| under
    RELU_KINK may take the other side in one of them (on the card: one
    such element at 16,384 tokens moved its token's dx row; one at 100
    tokens x 4096 columns a dW1 column): dpre there is 0 or the dropped,
    scaled dh.  Bounds: dx by amb @ |W1|^T, dW1 by |x|^T @ amb, db1 by
    amb's column sums, amb = |dh| on those elements (h = relu(pre) is
    continuous, so dW2 and db2 do not move)."""
    t, f = x.shape[0], w1.shape[1]
    pre = x.float() @ w1.float() + b1.float()
    dh = g.float() @ w2.float().t()
    if p > 0.0:
        keep = F._ffn_keep(seed, 0, 0, t, f, p, device=x.device)
        dh = torch.where(keep, dh / (1.0 - p), torch.zeros_like(dh))
    amb = torch.where(pre.abs() < RELU_KINK, dh.abs(), torch.zeros_like(dh))
    return dict(dx=amb @ w1.float().abs().t(),
                dw1=x.float().abs().t() @ amb, db1=amb.sum(0))


def _bias(g, b, sk):
    lens = torch.randint(max(1, sk // 2), sk + 1, (b,), generator=g)
    return torch.where(torch.arange(sk)[None, :] < lens[:, None], 0.0,
                       A.DEFAULT_MASK_VALUE).cuda()


# -- flash forward --------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.0),
                                      (False, 0.2), (True, 0.1)])
def test_flash_matches_plain(cuda, d, causal, p):
    q, k, v = (_bf16(cuda, 2, 130, 3, d) for _ in range(3))
    bias = _bias(cuda, 2, 130)
    out, lse = A.flash_forward(q, k, v, bias, 99, causal, None, None, p)
    ref, ref_lse = A.flash_forward_reference(q, k, v, bias, 99, causal,
                                             None, None, p)
    _close(out, ref, BF16)
    _close(lse, ref_lse, LSE)


@pytest.mark.parametrize("sq,sk", [(1, 64), (70, 200), (200, 70), (64, 1)])
def test_flash_ragged_and_causal_offsets(cuda, sq, sk):
    """Sq != Sk: causal offset sk - sq may be negative, leaving rows with
    no key at all (uniform over the masked keys, as in the TPU kernel)."""
    q = _bf16(cuda, 2, sq, 2, 64)
    k, v = _bf16(cuda, 2, sk, 2, 64), _bf16(cuda, 2, sk, 2, 64)
    for causal in (False, True):
        out, lse = A.flash_forward(q, k, v, None, 0, causal)
        ref, ref_lse = A.flash_forward_reference(q, k, v, None, 0, causal)
        _close(out, ref, BF16)
        _close(lse, ref_lse, LSE)


def test_flash_reads_strided_qkv_in_place(cuda):
    """q/k/v as views of one packed (B, S, 3, H, D) projection."""
    qkv = _bf16(cuda, 2, 96, 3, 4, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, _ = A.flash_forward(q, k, v)
    ref, _ = A.flash_forward_reference(q, k, v)
    _close(out, ref, BF16)


def test_flash_fully_masked_rows_are_finite(cuda):
    q, k, v = (_bf16(cuda, 1, 80, 2, 64) for _ in range(3))
    bias = torch.full((1, 80), A.DEFAULT_MASK_VALUE, device="cuda")
    out, lse = A.flash_forward(q, k, v, bias)
    ref, ref_lse = A.flash_forward_reference(q, k, v, bias)
    assert torch.isfinite(out.float()).all()
    _close(out, ref, BF16)
    _close(lse, ref_lse, LSE)


def test_flash_dropout_keeps_the_hash_bits(cuda):
    """With v = identity columns the output exposes which probabilities
    were dropped: the kernel's and the plain version's masks agree."""
    s, d = 64, 64
    q, k = _bf16(cuda, 1, s, 1, d, scale=0.1), _bf16(cuda, 1, s, 1, d,
                                                     scale=0.1)
    v = torch.eye(s, d, device="cuda", dtype=torch.bfloat16)[None, :, None]
    out, _ = A.flash_forward(q, k, v, None, 5, False, None, None, 0.5)
    ref, _ = A.flash_forward_reference(q, k, v, None, 5, False, None, None,
                                       0.5)
    assert torch.equal(out[0, :, 0] == 0, ref[0, :, 0] == 0)


def test_flash_refuses_what_it_cannot_compute(cuda):
    q = torch.randn(1, 16, 2, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="bf16"):
        A.flash_forward(q, q, q)
    q = _bf16(cuda, 1, 16, 2, 48)
    with pytest.raises(NotImplementedError, match="head_dim"):
        A.flash_forward(q, q, q)


def test_dense_mask_on_the_card_runs_dense_attention(cuda):
    """A mask that varies per query or per head goes to dense_attention on
    the card too, as paddle_tpu sends it to _xla_attention; the flash
    kernel is not launched for it, and is for a key-padding mask."""
    for c in COUNTERS.values():
        c.reset()
    q, k, v = (_bf16(cuda, 2, 40, 3, 64) for _ in range(3))
    causal = torch.ones(1, 1, 40, 40, dtype=torch.bool, device="cuda").tril()
    head = torch.rand(1, 3, 1, 40, generator=cuda).cuda() > 0.3
    for mask in (causal, head, torch.where(causal, 0.0, -1e30)):
        got = A.scaled_dot_product_attention(q, k, v, mask=mask)
        assert torch.equal(got, A.dense_attention(q, k, v, mask=mask))
    assert COUNTERS["flash_fwd"].value == 0
    pad = _bias(cuda, 2, 40)[:, None, None, :]
    A.scaled_dot_product_attention(q, k, v, mask=pad)
    assert COUNTERS["flash_fwd"].value == 1


@pytest.mark.parametrize("b,h,s,causal", [
    (1, 12, 64, True), (1, 12, 128, True), (1, 12, 200, True),
    (1, 12, 256, True), (12, 12, 130, False), (12, 12, 130, True),
    (1, 1, 1, False), (2, 66, 193, False), (24, 12, 300, True),
    (32, 12, 512, False)])
def test_flash_under_every_plan(cuda, b, h, s, causal):
    """The decode prefills (one sequence, 64-query CTAs), query tiles
    whose second warpgroup lies wholly past Sq, one query, and BERT-base
    (128-query CTAs); dropout on, where the kernel rebuilds its bits."""
    q, k, v = (_bf16(cuda, b, s, h, 64) for _ in range(3))
    bias = _bias(cuda, b, s)
    for p in (0.0, 0.1):
        out, lse = A.flash_forward(q, k, v, bias, 21, causal, None, None, p)
        ref, ref_lse = A.flash_forward_reference(q, k, v, bias, 21, causal,
                                                 None, None, p)
        _close(out, ref, BF16)
        _close(lse, ref_lse, LSE)


def test_flash_gives_the_same_bits_twice(cuda):
    q, k, v = (_bf16(cuda, 8, 512, 12, 64) for _ in range(3))
    bias = _bias(cuda, 8, 512)
    a = A.flash_forward(q, k, v, bias, 3, False, None, None, 0.1)
    b = A.flash_forward(q, k, v, bias, 3, False, None, None, 0.1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- fused FFN forward -----------------------------------------------------------

@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
def test_ffn_matches_plain(cuda, h, act):
    t, f = 100, 4 * h
    x = _bf16(cuda, t, h)
    w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
    w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
    for p in (0.0, 0.1):
        out = F.ffn_forward(x, w1, b1, w2, b2, act, p, 7)
        ref = F.ffn_forward_reference(x, w1, b1, w2, b2, act, p, 7)
        _close(out, ref, BF16)


def test_ffn_refuses_what_it_cannot_compute(cuda):
    x = torch.randn(8, 128, device="cuda")
    w1, w2 = torch.randn(128, 256, device="cuda"), torch.randn(256, 128,
                                                               device="cuda")
    b1, b2 = torch.zeros(256, device="cuda"), torch.zeros(128, device="cuda")
    with pytest.raises(NotImplementedError, match="bf16"):
        F.ffn_forward(x, w1, b1, w2, b2)
    bf = lambda t: t.to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d_model"):
        F.ffn_forward(bf(x[:, :96]), bf(w1[:96]), bf(b1), bf(w2[:, :96]),
                      bf(b2[:96]))
    with pytest.raises(NotImplementedError, match="d_ff"):
        F.ffn_forward(bf(x), bf(w1[:, :100]), bf(b1[:100]),
                      bf(w2[:100]), bf(b2))


def test_each_launch_is_counted_once(cuda):
    for c in COUNTERS.values():
        c.reset()
    q = _bf16(cuda, 1, 32, 2, 64)
    A.flash_forward(q, q, q)
    A.flash_forward(q, q, q)
    x = _bf16(cuda, 8, 128)
    F.ffn_forward(x, _bf16(cuda, 128, 256), _bf16(cuda, 256),
                  _bf16(cuda, 256, 128), _bf16(cuda, 128))
    A.flash_forward_reference(q, q, q)
    pages = _bf16(cuda, 3, 16, 2, 64)
    rows = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([20], dtype=torch.int32, device="cuda")
    A.paged_attention(q[:, :1], pages, pages, rows, lens)
    A.ragged_paged_reference(rows, lens, q[:, :1], pages, pages,
                             lens[:, None] - 1, 0.125)
    pre, b1 = _bf16(cuda, 8, 256), _bf16(cuda, 256)
    F.ffn_act_fwd(pre, b1)
    F.ffn_act_bwd(pre, b1, pre)
    F.ffn_act_bwd(pre, b1, pre)
    F.ffn_act_fwd_reference(pre, b1)
    assert {n: c.value for n, c in COUNTERS.items()} == {
        "flash_fwd": 2, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
        "ffn_fwd": 1, "ffn_bwd_dw": 0, "ffn_bwd_dx": 0, "ragged_paged": 1,
        "probe_4d": 0, "probe_fold3d": 0, "probe_merged": 0,
        "ffn_act_fwd": 1, "ffn_act_bwd": 2}


@pytest.mark.parametrize("t", [1, 16, 17, 63, 64, 65, 512, 1000, 4097])
@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024])
def test_ffn_fwd_tiles_splits_and_ragged_d_ff(cuda, t, h):
    """Token counts around the 64-token tile, d_ff one step, one and a
    half 128-wide steps, and 4H; every plan (one split, many splits,
    column groups) against the plain version, dropout off and on."""
    x = _bf16(cuda, t, h)
    for f in (64, 192, 4 * h):
        w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
        w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
        for p in (0.0, 0.1):
            out = F.ffn_forward(x, w1, b1, w2, b2, "gelu", p, 11)
            ref = F.ffn_forward_reference(x, w1, b1, w2, b2, "gelu", p, 11)
            _close(out, ref, BF16)


@pytest.mark.parametrize("t", [16, 512, 16384])
def test_ffn_fwd_gives_the_same_bits_twice(cuda, t):
    """The splits' partials are summed in a fixed order: no atomics."""
    h, f = 768, 3072
    x = _bf16(cuda, t, h)
    ws = (_bf16(cuda, h, f, scale=0.03), _bf16(cuda, f, scale=0.1),
          _bf16(cuda, f, h, scale=0.03), _bf16(cuda, h, scale=0.1))
    a = F.ffn_forward(x, *ws, "gelu", 0.1, 3)
    b = F.ffn_forward(x, *ws, "gelu", 0.1, 3)
    assert torch.equal(a, b)


def test_one_launch_is_counted_per_ffn_call(cuda):
    """A split forward and the dW pass launch two kernels each (the
    kernel and its reduce); each wrapper call counts one."""
    for c in COUNTERS.values():
        c.reset()
    h, f = 768, 3072
    x, g = _bf16(cuda, 16, h), _bf16(cuda, 16, h)
    ws = (_bf16(cuda, h, f, scale=0.03), _bf16(cuda, f, scale=0.1),
          _bf16(cuda, f, h, scale=0.03), _bf16(cuda, h, scale=0.1))
    assert F._fwd_plan(16, h, f, 132)[1] > 1
    F.ffn_forward(x, *ws)
    F.ffn_backward(x, *ws, 0, g)
    assert {n: c.value for n, c in COUNTERS.items()} == {
        n: int(n in ("ffn_fwd", "ffn_bwd_dw", "ffn_bwd_dx")) for n in COUNTERS}


# -- backward kernels -----------------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.0),
                                      (False, 0.2), (True, 0.1)])
def test_flash_backward_matches_plain(cuda, d, causal, p):
    q, k, v, g = (_bf16(cuda, 2, 130, 3, d) for _ in range(4))
    bias = _bias(cuda, 2, 130)
    out, lse = A.flash_forward(q, k, v, bias, 99, causal, None, None, p)
    got = A.flash_backward(q, k, v, bias, 99, out, lse, g, causal, None,
                           None, p)
    want = A.flash_backward_reference(q, k, v, bias, 99, out, lse, g,
                                      causal, None, None, p)
    for gt, w in zip(got, want):
        _close_grad(gt, w)


@pytest.mark.parametrize("sq,sk", [(70, 200), (200, 70), (64, 1)])
def test_flash_backward_ragged_and_strided(cuda, sq, sk):
    """Sq != Sk with causal offsets, and q/k/v/g as strided views."""
    qg = _bf16(cuda, 2, sq, 2, 2, 64)
    kv = _bf16(cuda, 2, sk, 2, 2, 64)
    q, g, k, v = qg[:, :, 0], qg[:, :, 1], kv[:, :, 0], kv[:, :, 1]
    for causal in (False, True):
        out, lse = A.flash_forward(q, k, v, None, 0, causal)
        got = A.flash_backward(q, k, v, None, 0, out, lse, g, causal)
        want = A.flash_backward_reference(q, k, v, None, 0, out, lse, g,
                                          causal)
        for gt, w in zip(got, want):
            _close_grad(gt, w)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,offset,p", [
    # B*H about the SM count: 128-query CTAs whose second warpgroup lies
    # past Sq (11 x 12), 64-query CTAs (131 heads of one sequence), and
    # 128-query CTAs again (133)
    (11, 12, 130, 130, 64, False, None, 0.1),
    (1, 131, 100, 100, 64, True, None, 0.1),
    (1, 133, 100, 100, 64, False, None, 0.0),
    # Sq and Sk not multiples of 64, both causal offsets' signs
    (2, 3, 70, 200, 64, True, None, 0.1), (2, 3, 200, 70, 64, True, None, 0.1),
    (2, 3, 190, 330, 32, False, None, 0.2),
    # one key, one query
    (2, 3, 64, 1, 64, False, None, 0.1), (2, 3, 1, 1, 16, True, None, 0.0),
    (3, 2, 1, 77, 64, True, None, 0.1),
    # D = 128 with a causal offset and dropout
    (2, 3, 100, 230, 128, True, None, 0.1),
    (2, 3, 230, 100, 128, True, None, 0.1),
    # an explicit offset that leaves keys 64.. to no query (dK = dV = 0)
    (2, 3, 64, 256, 64, True, 0, 0.1),
    # a decode prefill's shape
    (1, 12, 256, 256, 64, True, None, 0.1)])
def test_flash_backward_under_every_plan(cuda, b, h, sq, sk, d, causal,
                                         offset, p):
    """Both backward kernels at the edges of their plans (CTAs of 64 or
    128 rows, ragged tiles, causal tiles skipped or leading), with a
    key-padding bias, against the plain version."""
    q, g = _bf16(cuda, b, sq, h, d), _bf16(cuda, b, sq, h, d)
    k, v = _bf16(cuda, b, sk, h, d), _bf16(cuda, b, sk, h, d)
    bias = _bias(cuda, b, sk)
    out, lse = A.flash_forward(q, k, v, bias, 17, causal, offset, None, p)
    got = A.flash_backward(q, k, v, bias, 17, out, lse, g, causal, offset,
                           None, p)
    want = A.flash_backward_reference(q, k, v, bias, 17, out, lse, g,
                                      causal, offset, None, p)
    for gt, w in zip(got, want):
        _close_grad(gt, w)


def test_flash_backward_gives_the_same_bits_twice(cuda):
    """No atomics and a fixed order of summation: dq, dk and dv are the
    same bits in two runs, at BERT-base's attention with dropout."""
    q, k, v, g = (_bf16(cuda, 8, 512, 12, 64) for _ in range(4))
    bias = _bias(cuda, 8, 512)
    out, lse = A.flash_forward(q, k, v, bias, 5, False, None, None, 0.1)
    a = A.flash_backward(q, k, v, bias, 5, out, lse, g, False, None, None,
                         0.1)
    b = A.flash_backward(q, k, v, bias, 5, out, lse, g, False, None, None,
                         0.1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_backward_shared_memory_is_the_plans(cuda):
    """The plan's shared-memory bytes (checked against 227 KB on the CPU)
    are what the kernels ask for."""
    import ctypes

    lib = A._bwd_lib()
    fn = lib.flash_bwd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for d in (16, 32, 64, 128):
        for dkv in (False, True):
            assert fn(d, int(dkv)) == A._flash_bwd_smem_bytes(d, dkv)


@pytest.mark.parametrize("act,h", [
    (act, h) for h in (128, 256, 512, 768) for act in (
        "gelu", "gelu_tanh", "relu")] + [("gelu", 1024),
                                         ("gelu_tanh", 1024)])
def test_ffn_backward_matches_plain(cuda, h, act):
    t, f = 100, 4 * h
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
    w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
    for p in (0.0, 0.1):
        got = F.ffn_backward(x, w1, b1, w2, b2, 7, g, act, p)
        want = F.ffn_backward_reference(x, w1, b1, w2, b2, 7, g, act, p)
        for gt, w in zip(got, want):
            assert gt.dtype == w.dtype == torch.bfloat16
            _close_grad(gt, w)


def test_ffn_backward_relu_at_d_model_1024(cuda):
    """relu at d_model 1024, every gradient under _relu_slack."""
    h, t, f = 1024, 100, 4096
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
    w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
    for p in (0.0, 0.1):
        got = F.ffn_backward(x, w1, b1, w2, b2, 7, g, "relu", p)
        want = F.ffn_backward_reference(x, w1, b1, w2, b2, 7, g, "relu", p)
        slack = _relu_slack(x, w1, b1, w2, g, 7, p)
        for name, gt, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
            _close_grad_relu(gt, w, slack.get(name, 0.0))


@pytest.mark.parametrize("t", [1, 31, 100, 1000, 16384])
@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024])
def test_ffn_bwd_dw_tiles_and_splits(cuda, t, h):
    """The dW kernel (and dx beside it) at token counts around the
    32-token tile and across token splits, d_ff of one, three and 4H/16
    slices, dropout off and on."""
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    for f in (64, 192, 4 * h):
        w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
        w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
        for p in (0.0, 0.1):
            got = F.ffn_backward(x, w1, b1, w2, b2, 5, g, "gelu", p)
            want = F.ffn_backward_reference(x, w1, b1, w2, b2, 5, g, "gelu",
                                            p)
            for gt, w in zip(got, want):
                _close_grad(gt, w)


@pytest.mark.parametrize("t", [1000, 16384])
def test_ffn_bwd_dw_gives_the_same_bits_twice(cuda, t):
    h, f = 768, 3072
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    ws = (_bf16(cuda, h, f, scale=0.03), _bf16(cuda, f, scale=0.1),
          _bf16(cuda, f, h, scale=0.03), _bf16(cuda, h, scale=0.1))
    a = F.ffn_backward(x, *ws, 2, g, "gelu", 0.1)
    b = F.ffn_backward(x, *ws, 2, g, "gelu", 0.1)
    assert all(torch.equal(u, v) for u, v in zip(a[1:4], b[1:4]))


@pytest.mark.parametrize("t", [1000, 16384])
def test_ffn_bwd_dx_gives_the_same_bits_twice(cuda, t):
    """dpre is written once and read back by a GEMM with a fixed K order:
    no atomics, so dx does not depend on scheduling."""
    h, f = 768, 3072
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    ws = (_bf16(cuda, h, f, scale=0.03), _bf16(cuda, f, scale=0.1),
          _bf16(cuda, f, h, scale=0.03), _bf16(cuda, h, scale=0.1))
    a = F.ffn_backward(x, *ws, 2, g, "gelu", 0.1)
    b = F.ffn_backward(x, *ws, 2, g, "gelu", 0.1)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("t", [1, 31, 100, 1000, 16384])
@pytest.mark.parametrize("h", [128, 256, 512, 768, 1024])
def test_ffn_bwd_dx_every_activation(cuda, t, h):
    """dx at token counts around the 128-token tile, every d_model the
    dx pass takes, every activation (relu under _relu_slack), dropout off
    and on, a d_ff of one and a half 128-column tiles beside 4H."""
    x, g = _bf16(cuda, t, h), _bf16(cuda, t, h)
    for f in (192, 4 * h):
        w1, b1 = _bf16(cuda, h, f, scale=h ** -0.5), _bf16(cuda, f, scale=0.1)
        w2, b2 = _bf16(cuda, f, h, scale=f ** -0.5), _bf16(cuda, h, scale=0.1)
        for act in ("gelu", "gelu_tanh", "relu"):
            for p in (0.0, 0.1):
                grads, _, launch_dx = F._ffn_bwd_launchers(
                    x, w1, b1, w2, b2, 9, g, act, p)
                launch_dx()
                want = F.ffn_backward_reference(x, w1, b1, w2, b2, 9, g, act,
                                                p)[0]
                if act == "relu":
                    _close_grad_relu(grads[0], want, _relu_slack(
                        x, w1, b1, w2, g, 9, p)["dx"])
                else:
                    _close_grad(grads[0], want)


def test_backward_refuses_what_it_cannot_compute(cuda):
    q = torch.randn(1, 16, 2, 64, device="cuda")
    out, lse = torch.zeros_like(q), torch.zeros(1, 2, 16, device="cuda")
    with pytest.raises(NotImplementedError, match="bf16"):
        A.flash_backward(q, q, q, None, 0, out, lse, q)
    x = _bf16(cuda, 8, 96)
    w1, w2 = _bf16(cuda, 96, 192), _bf16(cuda, 192, 96)
    b1, b2 = _bf16(cuda, 192), _bf16(cuda, 96)
    with pytest.raises(NotImplementedError, match="d_model"):
        F.ffn_backward(x, w1, b1, w2, b2, 0, x)
    x = _bf16(cuda, 8, 1024)
    with pytest.raises(NotImplementedError, match="bf16"):
        F.ffn_backward(x.float()[:, :128], w1.float()[:128, :256],
                       b1.float()[:256], w2.float()[:256, :128],
                       b2.float()[:128], 0, x.float()[:, :128])


def test_autograd_launches_each_backward_kernel_once(cuda):
    for c in COUNTERS.values():
        c.reset()
    q, k, v = (_bf16(cuda, 2, 64, 2, 64).requires_grad_() for _ in range(3))
    A.flash_attention(q, k, v, dropout_p=0.1, dropout_seed=3).sum() \
        .backward()
    x = _bf16(cuda, 2, 40, 128).requires_grad_()
    ws = [_bf16(cuda, 128, 256), _bf16(cuda, 256), _bf16(cuda, 256, 128),
          _bf16(cuda, 128)]
    for w in ws:
        w.requires_grad_()
    F.fused_ffn(x, *ws, dropout_p=0.1, dropout_seed=4).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all()
               for t in (q, k, v, x, *ws))
    assert {n: c.value for n, c in COUNTERS.items()} == {
        n: int(n in TRAIN_KERNELS) for n in COUNTERS}


def test_dropout_draws_on_the_card_from_a_host_generator(cuda):
    """The repair: a layer's CPU generator seeds a generator on the card
    instead of being refused by torch.rand on a CUDA tensor."""
    x = torch.ones(256, 256, device="cuda")
    gen = torch.Generator().manual_seed(1)
    y = Fn.dropout(x, 0.5, generator=gen)
    assert y.is_cuda and 0.4 < float((y == 0).float().mean()) < 0.6
    with Fn.rng_scope(7):
        a = Fn.dropout(x, 0.5, generator=gen)
    with Fn.rng_scope(7):
        b = Fn.dropout(x, 0.5, generator=gen)
    assert torch.equal(a, b)


# -- tiny BERT on the card ---------------------------------------------------------

# tiny depth and vocabulary, a width the FFN kernel takes (d_model 128)
TINY = dict(hidden_size=128, intermediate_size=256)


def _tiny_batch(b, s, seed):
    fb = bert.fake_batch(bert.BertConfig.tiny(**TINY), b, s, seed=seed)
    return [fb["input_ids"], fb["token_type_ids"], fb["attention_mask"]]


def test_tiny_bert_on_the_card_matches_the_cpu(cuda):
    cfg = bert.BertConfig.tiny(**TINY)
    gpu = bert.BertModel(cfg, dtype=torch.bfloat16, seed=4).eval()
    cpu = bert.BertModel(cfg, device="cpu", seed=4).eval()
    ids, types, am = _tiny_batch(3, 64, 1)
    mask = torch.from_numpy((am != 0)[:, None, None, :])
    with torch.inference_mode():
        g = gpu(torch.from_numpy(ids).cuda(), torch.from_numpy(types).cuda(),
                attention_mask=mask.cuda())
        c = cpu(torch.from_numpy(ids), torch.from_numpy(types),
                attention_mask=mask)
    # bf16 on the card vs f32 on the CPU through 2 layers
    for got, want in zip(g, c):
        torch.testing.assert_close(got.float().cpu(), want, atol=0.1,
                                   rtol=0.05)


def test_engine_serves_tiny_bert_on_the_card(cuda):
    model = bert.BertModel(bert.BertConfig.tiny(**TINY), dtype=torch.bfloat16,
                           seed=4).eval()

    def fn(ids, types, am):
        return model(ids, types, attention_mask=(am != 0)[:, None, None, :])

    reqs = [_tiny_batch(n, 64, seed) for seed, n in enumerate([1, 5, 3, 8])]
    with Engine(fn, EngineConfig(max_batch_size=8)) as eng:
        results = [eng.submit(r) for r in reqs]
        results = [r.result(timeout=120) for r in results]
    with torch.inference_mode():
        for req, (enc, pooled) in zip(reqs, results):
            d_enc, d_pooled = fn(*[torch.from_numpy(a).cuda() for a in req])
            np.testing.assert_allclose(enc, d_enc.float().cpu().numpy(),
                                       atol=0.05, rtol=0)
            np.testing.assert_allclose(pooled,
                                       d_pooled.float().cpu().numpy(),
                                       atol=0.05, rtol=0)


def test_tiny_bert_train_steps_on_the_card(cuda):
    """train() mode with dropout 0.1 (which raised on the card before the
    dropout repair): finite falling losses, each kernel launched once per
    layer per step, finite moments (so no NaN gradient)."""
    cfg = bert.BertConfig.tiny(**TINY)
    model = bert.BertForPretraining(cfg, seed=2)
    step, state = bert.build_pretrain_step(model)
    fb = bert.fake_batch(cfg, 4, 64, num_masked=8, seed=3)
    batch = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    for c in COUNTERS.values():
        c.reset()
    losses = []
    for _ in range(3):
        state, loss = step(state, batch, 1e-3)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert {n: c.value for n, c in COUNTERS.items()} == {
        n: 3 * cfg.num_hidden_layers if n in TRAIN_KERNELS else 0
        for n in COUNTERS}
    assert all(torch.isfinite(m).all() for m in state["m"].values())


def test_tiny_bert_train_step_on_the_card_matches_the_cpu(cuda):
    """One bf16 step on the card against one f32 step on the CPU from the
    same weights, dropout 0: the loss, and the updated parameters.  A
    first Adam step moves an element by lr times the sign of its
    gradient, so a near-zero gradient whose sign differs between bf16 and
    f32 moves it 2 lr apart, and no further."""
    cfg = bert.BertConfig.tiny(hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0, **TINY)
    fb = bert.fake_batch(cfg, 4, 64, num_masked=8, seed=5)
    runs = {}
    for dev, bf16 in (("cuda", True), ("cpu", False)):
        model = bert.BertForPretraining(cfg, device=dev, seed=6)
        step, state = bert.build_pretrain_step(model, bf16=bf16)
        state, loss = step(state, fb, 1e-3)
        runs[dev] = (float(loss), state["params"])
    assert abs(runs["cuda"][0] - runs["cpu"][0]) < 0.05
    for k, p in runs["cpu"][1].items():
        assert float((runs["cuda"][1][k].cpu() - p).abs().max()) <= 2.01e-3


# -- ragged paged attention -------------------------------------------------------

def _paged(g, lengths, t, h=2, d=64, s=16, w=None, qpos0=None):
    """(rows, lengths, q, k pool, v pool, qpos) on the card, from the
    builder chip_smoke's ragged row uses, with one (P, S, H, D) pool and
    rows just wide enough unless `w` is given."""
    from chip_smoke import _paged_inputs

    w = w or max(2, max(-(-n // s) for n in lengths))
    c = _paged_inputs(g, lengths, t, qpos0=qpos0, h=h, d=d, s=s, w=w,
                      layers=None)
    return tuple(c[k] for k in ("rows", "lens", "q", "kc", "vc", "qpos"))


def _ragged_check(args, scale=0.125):
    out = A.ragged_paged_forward(*args, scale)
    ref = A.ragged_paged_reference(*args, scale)
    assert torch.isfinite(out.float()).all()
    _close(out, ref, BF16)
    return out


def test_ragged_paged_at_the_decode_step_shape(cuda):
    """B=16, T=1, 12 heads of 64, pages of 16, rows of 32: ragged lengths
    over 1-511 with a length-0 lane and an exact page multiple."""
    lengths = [0, 256] + torch.randint(1, 512, (14,), generator=cuda).tolist()
    _ragged_check(_paged(cuda, lengths, 1, h=12, w=32))


def test_ragged_paged_at_the_chunk_step_shape(cuda):
    """B=1, T=256, explicit positions 256..511 over length 512."""
    _ragged_check(_paged(cuda, [512], 256, h=12, w=32, qpos0=256))


def test_ragged_paged_length_zero_lanes_are_uniform_over_page_zero(cuda):
    rows, lens, q, kp, vp, qpos = _paged(cuda, [0, 0, 5], 1)
    out = _ragged_check((rows, lens, q, kp, vp, qpos))
    want = vp[0].float().mean(0)  # page 0, every key weighted alike
    torch.testing.assert_close(out[0, 0].float(), want, **BF16)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [8, 16, 24, 64])
def test_ragged_paged_matches_plain(cuda, d, s):
    """Every compiled head dim, page sizes that do and do not divide the
    32-key block, T from 1 to past one 16-row tile, padded chunk lanes
    (qpos >= length) included."""
    for lengths, t, qpos0 in (([3, 70, 0, 33], 1, None),
                              ([41, 9], 5, None), ([30], 17, 20),
                              ([130], 33, 100)):
        _ragged_check(_paged(cuda, lengths, t, d=d, s=s, qpos0=qpos0),
                      scale=d ** -0.5)


def test_ragged_paged_reads_a_layer_plane_of_a_layered_pool(cuda):
    rows, lens, q, kp, vp, qpos = _paged(cuda, [37, 12], 1)
    kl, vl = torch.stack([kp.flip(0), kp]), torch.stack([vp.flip(0), vp])
    out = A.ragged_paged_forward(rows, lens, q, kl[1], vl[1], qpos, 0.125)
    torch.testing.assert_close(
        out, A.ragged_paged_forward(rows, lens, q, kp, vp, qpos, 0.125),
        atol=0, rtol=0)


def test_ragged_paged_refuses_what_it_cannot_compute(cuda):
    rows, lens, q, kp, vp, qpos = _paged(cuda, [5], 1)
    with pytest.raises(NotImplementedError, match="bf16"):
        A.ragged_paged_forward(rows, lens, q.float(), kp.float(),
                               vp.float(), qpos, 0.125)
    q48 = _bf16(cuda, 1, 1, 2, 48)
    p48 = _bf16(cuda, kp.shape[0], 16, 2, 48)
    with pytest.raises(NotImplementedError, match="head_dim"):
        A.ragged_paged_forward(rows, lens, q48, p48, p48, qpos, 0.125)
    p12 = _bf16(cuda, 3, 12, 2, 64)
    with pytest.raises(NotImplementedError, match="page_size"):
        A.ragged_paged_forward(rows, lens, q, p12, p12, qpos, 0.125)


def _ragged_plan_of(args):
    rows, _, q, kp = args[:4]
    b, t, h, d = q.shape
    return A._ragged_plan(b, t, h, d, kp.shape[1], rows.shape[1],
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)


def _ragged_twice(args, scale=0.125):
    """The kernel against its plain version, and the same bits again."""
    out = _ragged_check(args, scale)
    torch.testing.assert_close(A.ragged_paged_forward(*args, scale), out,
                               atol=0, rtol=0)
    return out


def test_ragged_paged_split_boundaries_at_the_decode_step_shape(cuda):
    """(a)'s shape (B=16, T=1, 12 heads of 64, pages of 16, rows of 32)
    with lengths on both sides of the split path's run edges (four
    pages, 64 keys, a run): lanes whose pages fit the first run, lanes
    one key into the next run, full rows."""
    lengths = [0, 1, 63, 64, 65, 127, 128, 129, 192, 255, 256, 257, 448,
               449, 511, 512]
    args = _paged(cuda, lengths, 1, h=12, w=32)
    plan = _ragged_plan_of(args)
    assert (plan["path"], plan["pages_per_split"], plan["splits"]) == \
        ("split", 4, 8)
    _ragged_twice(args)


@pytest.mark.parametrize("h,d,s,lengths,w", [
    (16, 128, 16, [40, 300, 0], 32),   # head groups: 2 of 8
    (12, 128, 64, [200, 64, 65], 8),   # 4 stages a page: the ring refills
    (2, 64, 8, [2400, 1000, 7], 300),  # runs of 4 pages: the ring refills
])
def test_ragged_paged_split_path_groups_stages_and_long_rows(
        cuda, h, d, s, lengths, w):
    args = _paged(cuda, lengths, 1, h=h, d=d, s=s, w=w)
    plan = _ragged_plan_of(args)
    assert plan["path"] == "split"
    assert plan["head_groups"] * plan["heads_per_group"] >= h
    _ragged_twice(args, scale=d ** -0.5)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_ragged_paged_tiled_path(cuda, d, s):
    """The tiled path at T = 64, 65, 128, B = 2: default positions (the
    newest T of each lane) and chunk positions with padded lanes (qpos
    past a lane's length)."""
    for t in (64, 65, 128):
        for lengths, qpos0 in (([t + 40, t + 3], None), ([230, 150], 100)):
            args = _paged(cuda, lengths, t, d=d, s=s, qpos0=qpos0)
            assert _ragged_plan_of(args)["path"] == "tiled"
            _ragged_twice(args, scale=d ** -0.5)


def test_ragged_paged_chunk_with_a_ragged_last_page(cuda):
    """T=256 over a length of 500 (31 pages and a quarter), at the decode
    path's width, default positions 244..499 and chunk positions."""
    _ragged_twice(_paged(cuda, [500], 256, h=12, w=32))
    _ragged_twice(_paged(cuda, [500, 300], 256, h=12, w=32, qpos0=244))


def test_ragged_paged_launches_the_plans_grid(cuda, tmp_path):
    """The kernel the profiler sees runs the plan's grid and block: the
    split path at a decode step (and its merge kernel), the tiled path
    at a chunk."""
    import json

    from torch.profiler import ProfilerActivity, profile

    for lengths, t in (([5, 300, 77], 1), ([500], 256)):
        args = _paged(cuda, lengths, t, h=12, w=32)
        plan = _ragged_plan_of(args)
        A.ragged_paged_forward(*args, 0.125)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            A.ragged_paged_forward(*args, 0.125)
            torch.cuda.synchronize()
        trace = tmp_path / f"t{t}.json"
        prof.export_chrome_trace(str(trace))
        kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") == "kernel" and "ragged" in e["name"]]
        main = [e for e in kernels
                if f"ragged_{plan['path']}_kernel" in e["name"]]
        assert len(main) == 1
        assert tuple(main[0]["args"]["grid"]) == plan["grid"]
        assert main[0]["args"]["block"][0] == plan["threads"]
        assert len(kernels) == 1 + (plan["splits"] > 1)


def test_tiny_bert_decodes_on_the_card(cuda):
    """TINY BERT (bf16) as a causal decoder through AutoregressiveEngine on
    the card: single-shot and chunked prompts, exact token counts, every
    page freed, one host sync per request, exact launch counts, and each
    token's logit within 0.125 of the largest logit of a dense causal
    forward of its prefix."""
    from chip_smoke import bert_decoder  # the adapter chip_smoke runs

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving import AutoregressiveEngine

    cfg = bert.BertConfig.tiny(**TINY)
    dec = bert_decoder(bert.BertForPretraining(cfg, dtype=torch.bfloat16,
                                               seed=3).eval())
    eng = AutoregressiveEngine(model=dec, num_heads=4, head_dim=32,
                               num_pages=64, page_size=16, max_slots=4,
                               max_pages_per_seq=8, prompt_buckets=(16, 32),
                               prefill_chunk=32, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 30, 75, 20)]
    profiler.stat_reset()
    for c in COUNTERS.values():
        c.reset()
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run_until_idle()
    launches = {n: c.value for n, c in COUNTERS.items()}
    stats = profiler.get_int_stats()
    steps, chunks = stats["serving_decode_steps"], \
        stats["serving_prefill_chunks"]
    layers = cfg.num_hidden_layers
    assert chunks == 3  # the 75-token prompt: 32 + 32 + 11
    assert launches == {n: 0 for n in COUNTERS} | dict(
        ragged_paged=layers * (steps + chunks), flash_fwd=layers * 3,
        ffn_fwd=layers * (3 + chunks + steps))
    assert stats["executor_sync_count"] == len(reqs)
    assert eng.kv.table.in_use == 0
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            toks = r.result(0)
            assert len(toks) == 12
            seq = np.concatenate([p, toks[:-1]])
            pos = torch.arange(len(seq), dtype=torch.int32,
                               device="cuda")[None]
            x = dec.embed(torch.from_numpy(seq).cuda()[None], pos)
            for qkv, merge in dec.layers:
                q, k, v = qkv(x, pos)
                x = merge(x, A.dense_attention(q, k, v, is_causal=True))
            logits = dec.unembed(x)[0, len(p) - 1:].float()
            got = logits.gather(
                1, torch.from_numpy(toks.astype(np.int64)).cuda()[:, None])
            assert float((logits.max(1).values - got[:, 0]).max()) <= 0.125


# -- the layout-probe kernels ------------------------------------------------------

def _probe_all(q, k, v):
    """(kernel, plain) outputs of the three probe kernels on q/k/v
    (B, S, H, D), the fold3d and merged ones as (B, S, H, D)."""
    b, s, h, d = q.shape
    to3 = lambda x: x.reshape(b, s, h * d)
    m = P.merge_heads
    un = lambda x: P.unmerge_heads(x, h)
    return {
        "4d": (P.probe_4d(q, k, v), P.probe_4d_reference(q, k, v)),
        "fold3d": (P.probe_fold3d(to3(q), to3(k), to3(v), h).view(q.shape),
                   P.probe_fold3d_reference(to3(q), to3(k), to3(v),
                                            h).view(q.shape)),
        "merged": (un(P.probe_merged(m(q), m(k), m(v))),
                   un(P.probe_merged_reference(m(q), m(k), m(v))))}


@pytest.mark.parametrize("shape", [(8, 512, 12, 64), (2, 200, 12, 64),
                                   (2, 130, 3, 128), (3, 1, 2, 64),
                                   (2, 768, 2, 16), (1, 96, 4, 32),
                                   (1, 769, 2, 64), (1, 2048, 2, 64),
                                   (1, 4096, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_kernels_match_plain(cuda, shape):
    """The tool's shape, ragged S (200, 130, 96, 769), D=128, S=1, long
    S (the keys stream through twice, so S has no limit), and every head
    dim.  Unit-scale inputs, so the softmax is far from uniform and a
    wrong scale shows.  One kernel body reads the three layouts, so they
    give the same bits (merged once unmerged)."""
    q, k, v = (_bf16(cuda, *shape) for _ in range(3))
    outs = _probe_all(q, k, v)
    for got, want in outs.values():
        assert torch.isfinite(got.float()).all()
        _close(got, want, BF16)
    assert torch.equal(outs["4d"][0], outs["fold3d"][0])
    assert torch.equal(outs["4d"][0], outs["merged"][0])


@pytest.mark.parametrize("shape", [(8, 512, 12, 64), (2, 200, 3, 128),
                                   (2, 130, 4, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_kernels_give_the_same_bits_twice(cuda, shape):
    q, k, v = (_bf16(cuda, *shape) for _ in range(3))
    first, second = _probe_all(q, k, v), _probe_all(q, k, v)
    for name in first:
        assert torch.equal(first[name][0], second[name][0]), name


def test_probe_4d_reads_a_packed_projection_in_place(cuda):
    """q/k/v as views of one packed (B, S, 3, H, D) projection."""
    qkv = _bf16(cuda, 2, 200, 3, 4, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    _close(P.probe_4d(q, k, v), P.probe_4d_reference(q, k, v), BF16)
    torch.testing.assert_close(
        P.probe_4d(q, k, v),
        P.probe_4d(q.contiguous(), k.contiguous(), v.contiguous()),
        atol=0, rtol=0)


def test_probe_kernels_refuse_what_they_cannot_compute(cuda):
    h = torch.randn(1, 16, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="bf16"):
        P.probe_4d(h, h, h)
    with pytest.raises(NotImplementedError, match="bf16"):
        P.probe_fold3d(*(h.view(1, 16, 128),) * 3, 2)
    with pytest.raises(NotImplementedError, match="bf16"):
        P.probe_merged(*(P.merge_heads(h),) * 3)
    q48 = _bf16(cuda, 1, 16, 2, 48)
    with pytest.raises(NotImplementedError, match="head_dim"):
        P.probe_4d(q48, q48, q48)
    q = _bf16(cuda, 1, 16, 2, 64)
    odd = _bf16(cuda, 1, 16, 2, 68)[..., :64]  # rows 136 bytes apart
    with pytest.raises(ValueError, match="in place"):
        P.probe_4d(odd, q, q)


def test_probe_launches_are_counted_once(cuda):
    for c in COUNTERS.values():
        c.reset()
    q = _bf16(cuda, 1, 64, 2, 64)
    _probe_all(q, q, q)
    assert {n: c.value for n, c in COUNTERS.items()} == {
        n: int(n.startswith("probe_")) for n in COUNTERS}


def test_probe_tool_on_the_card(cuda):
    """The tool at a small shape: every arm builds and agrees, and the
    five chains are timed."""
    from paddle_tpu_torch.tools import kernel4d_probe as K4

    out = K4.run(2, 128, 2, 64)
    assert out["mode"] == "gpu" and out["ok"] is True, out
    assert out["builds"] == {"4d": True, "fold3d": True, "merged": True}
    for key in ("per_call_ms_4d", "per_call_ms_fold3d",
                "per_call_ms_merged_incl_transpose", "per_call_ms_flash_fwd",
                "per_call_ms_sdpa", "per_call_ms_merge_copies"):
        assert out[key] > 0


# -- the FFN's library arm: the element pass (csrc/ffn_act.cu) -------------------

# the element pass against its plain version: one unit in the last place
# of the operand type, and an absolute 1e-5: act' takes the fast exp and
# reciprocal (csrc/ffn_common.cuh), a few f32 units off the accurate form,
# which |pre| up to 8 and |dh| up to 4 scale (3.1e-6 measured at
# gelu_tanh)
ACT_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7),
           torch.float32: dict(atol=1e-5, rtol=1e-5)}


@pytest.mark.parametrize("t,f,act,p,dtype", [
    (1, 3072, "gelu", 0.1, torch.bfloat16),
    (17, 3072, "gelu_tanh", 0.1, torch.bfloat16),
    (1000, 768, "relu", 0.1, torch.bfloat16),
    (4096, 3072, "gelu", 0.0, torch.bfloat16),
    (33, 100, "gelu", 0.1, torch.bfloat16),    # per-value path
    (7, 36, "relu", 0.0, torch.bfloat16),
    (64, 128, "gelu", 0.1, torch.float32),
    (37, 130, "gelu_tanh", 0.1, torch.float32)])
def test_ffn_act_matches_plain(cuda, t, f, act, p, dtype):
    pre = (torch.randn(t, f, generator=cuda) * 2.0).to("cuda", dtype)
    b1 = (torch.randn(f, generator=cuda) * 0.1).to("cuda", dtype)
    dh = torch.randn(t, f, generator=cuda).to("cuda", dtype)
    h = F.ffn_act_fwd(pre, b1, act, p, 31)
    dpre, h2 = F.ffn_act_bwd(pre, b1, dh, act, p, 31)
    _close(h, F.ffn_act_fwd_reference(pre, b1, act, p, 31), ACT_TOL[dtype])
    _close(dpre, F.ffn_act_bwd_reference(pre, b1, dh, act, p, 31)[0],
           ACT_TOL[dtype])
    assert torch.equal(h, h2) and torch.equal(h, F.ffn_act_fwd(
        pre, b1, act, p, 31))
    if p > 0.0:
        drop = ~F._ffn_keep(31, 0, 0, t, f, p, device=pre.device)
        assert not h[drop].any() and not dpre[drop].any()


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1])
def test_ffn_act_mask_is_ffn_keep_bit_for_bit(cuda, seed):
    t, f, p = 300, 3072, 0.1
    pre = torch.full((t, f), 3.0, dtype=torch.bfloat16, device="cuda")
    zero = torch.zeros(f, dtype=torch.bfloat16, device="cuda")
    keep = F._ffn_keep(seed, 0, 0, t, f, p, device=pre.device)
    assert torch.equal(F.ffn_act_fwd(pre, zero, "relu", p, seed) != 0, keep)
    dpre, _ = F.ffn_act_bwd(pre, zero, torch.ones_like(pre), "relu", p, seed)
    assert torch.equal(dpre != 0, keep)


def test_ffn_act_refuses_what_it_cannot_compute(cuda):
    pre = _bf16(cuda, 4, 64)
    with pytest.raises(NotImplementedError, match="one dtype"):
        F.ffn_act_fwd(pre, pre[0].float())
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        F.ffn_act_fwd(pre.half(), pre[0].half())
    with pytest.raises(NotImplementedError):
        F.ffn_act_fwd(pre, pre[0], "swish")
    with pytest.raises(ValueError):
        F.ffn_act_bwd(pre, pre[0], pre[:2])


def test_library_arm_launches_the_element_pass(cuda, monkeypatch):
    """The default arm on the card: no FFN kernel, one launch of each
    element pass, and the same function as the kernels' plain version."""
    monkeypatch.setattr(F, "_FFN_DISABLED", "the reference's default")
    for c in COUNTERS.values():
        c.reset()
    x = _bf16(cuda, 2, 40, 768).requires_grad_()
    ws = [_bf16(cuda, 768, 3072, scale=0.03), _bf16(cuda, 3072, scale=0.1),
          _bf16(cuda, 3072, 768, scale=0.03), _bf16(cuda, 768, scale=0.1)]
    for w in ws:
        w.requires_grad_()
    out = F.fused_ffn(x, *ws, dropout_p=0.1, dropout_seed=4)
    g = _bf16(cuda, 2, 40, 768)
    grads = torch.autograd.grad(out, [x, *ws], g)
    assert {n: c.value for n, c in COUNTERS.items()} == {
        n: int(n in ("ffn_act_fwd", "ffn_act_bwd")) for n in COUNTERS}
    xt = x.detach().reshape(80, 768)
    _close(out.reshape(80, 768), F.ffn_forward_reference(
        xt, *ws, "gelu", 0.1, 4), BF16)
    want = F.ffn_backward_reference(xt, *ws, 4, g.reshape(80, 768), "gelu",
                                    0.1)
    _close_grad(grads[0].reshape(80, 768), want[0])
    for got, w in zip(grads[1:], want[1:]):
        _close_grad(got, w)


def test_f32_and_odd_widths_take_the_dense_and_library_arms(cuda):
    """What the kernels do not take (f32, d_model 64, head_dim 48) runs on
    the card through dense_attention and the FFN's library arm, as the
    reference sends it to XLA."""
    from paddle_tpu_torch import profiler

    for c in COUNTERS.values():
        c.reset()
    profiler.stat_reset("attention_dispatch_dense")
    q = torch.randn(2, 32, 2, 48, generator=cuda).cuda()
    out = A.scaled_dot_product_attention(q, q, q)
    ref = A.dense_attention(q.cpu(), q.cpu(), q.cpu())
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)
    assert profiler.get_int_stats()["attention_dispatch_dense"] == 1
    assert all(c.value == 0 for c in COUNTERS.values())
    cfg = bert.BertConfig.tiny()
    gpu = bert.BertModel(cfg, seed=1).eval()
    cpu = bert.BertModel(cfg, device="cpu", seed=1).eval()
    fb = bert.fake_batch(cfg, 2, 64, seed=3)
    ids, tt = (torch.from_numpy(fb[k]) for k in ("input_ids",
                                                 "token_type_ids"))
    am = (torch.from_numpy(fb["attention_mask"]) != 0)[:, None, None, :]
    with torch.inference_mode():
        g_enc, _ = gpu(ids.cuda(), tt.cuda(), attention_mask=am.cuda())
        c_enc, _ = cpu(ids, tt, attention_mask=am)
    torch.testing.assert_close(g_enc.cpu(), c_enc, atol=1e-4, rtol=1e-4)
    assert COUNTERS["ffn_act_fwd"].value == cfg.num_hidden_layers


def test_resnet18_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 step of vision.train.build_train_step on the card (cuDNN,
    channels_last) against the CPU: the loss and running statistics
    within 1e-4 (cuDNN's other summation orders; with TF32 on, the H100
    reads 8.2e-4 in the running statistics of this model), parameters
    within 1e-3 after the step at lr 0.01 (a ReLU flip moves a gradient
    term, lr times that a parameter)."""
    from paddle_tpu_torch.vision import models as VM
    from paddle_tpu_torch.vision import train as VT

    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, 4)
    runs = []
    for dev in ("cuda", "cpu"):
        model = VM.resnet18(num_classes=10, device=dev, seed=2)
        step, state = VT.build_train_step(model, lr=0.01, bf16=False)
        state, loss = step(state, x, y)
        runs.append((float(loss), {k: v.cpu()
                                   for k, v in state["params"].items()}))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-4 * abs(runs[1][0])
    for k, v in runs[1][1].items():
        tol = 1e-4 if k.endswith(("._mean", "._variance")) else 1e-3
        torch.testing.assert_close(runs[0][1][k], v, atol=tol, rtol=tol,
                                   msg=k)


# -- the WMT Transformer's shapes (models/transformer_wmt.py) -----------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_at_the_wmt_cross_attention_shape(cuda, masked, p):
    """The WMT train step's cross-attention: T=120 queries against S=128
    keys (Sq != Sk, neither a multiple of the 64-row tiles' 128), 8 heads
    of 64, B=32; the forward and both backward kernels, with and without
    a key-padding bias, at the step's dropout 0.1 and at 0."""
    q, g = _bf16(cuda, 32, 120, 8, 64), _bf16(cuda, 32, 120, 8, 64)
    k, v = _bf16(cuda, 32, 128, 8, 64), _bf16(cuda, 32, 128, 8, 64)
    bias = _bias(cuda, 32, 128) if masked else None
    out, lse = A.flash_forward(q, k, v, bias, 13, False, None, None, p)
    ref, ref_lse = A.flash_forward_reference(q, k, v, bias, 13, False, None,
                                             None, p)
    _close(out, ref, BF16)
    _close(lse, ref_lse, LSE)
    got = A.flash_backward(q, k, v, bias, 13, out, lse, g, False, None, None,
                           p)
    want = A.flash_backward_reference(q, k, v, bias, 13, out, lse, g, False,
                                      None, None, p)
    for gt, w in zip(got, want):
        _close_grad(gt, w)


@pytest.mark.parametrize("t", [1, 7, 32, 128])
def test_flash_at_the_wmt_decode_step_shape(cuda, t):
    """A WMT decode step: one query a row (B*W = 32 rows of 8 heads, B*H =
    256) against t keys of the growing self-attention cache, or the 128
    of the memory's static cache; twice for the same bits."""
    q = _bf16(cuda, 32, 1, 8, 64)
    k, v = _bf16(cuda, 32, t, 8, 64), _bf16(cuda, 32, t, 8, 64)
    out, lse = A.flash_forward(q, k, v)
    again = A.flash_forward(q, k, v)
    ref, ref_lse = A.flash_forward_reference(q, k, v)
    _close(out, ref, BF16)
    _close(lse, ref_lse, LSE)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_ffn_act_relu_at_the_wmt_shape_bit_for_bit(cuda, p):
    """The library arm's element pass at the WMT step's FFN: relu over
    3840 tokens x d_ff 2048, bf16: relu has no approximation, so h and
    dpre equal their plain versions bit for bit."""
    pre, dh = _bf16(cuda, 3840, 2048, scale=2.0), _bf16(cuda, 3840, 2048)
    b1 = _bf16(cuda, 2048, scale=0.1)
    h = F.ffn_act_fwd(pre, b1, "relu", p, 21)
    dpre, h2 = F.ffn_act_bwd(pre, b1, dh, "relu", p, 21)
    assert torch.equal(h, F.ffn_act_fwd_reference(pre, b1, "relu", p, 21))
    want_dpre, want_h = F.ffn_act_bwd_reference(pre, b1, dh, "relu", p, 21)
    assert torch.equal(dpre, want_dpre) and torch.equal(h2, want_h)


def test_tiny_wmt_trains_and_decodes_on_the_card(cuda):
    """TransformerConfig.tiny() (head_dim 16, d_model 64: the FFN takes
    its library arm) on the card: two bf16 train steps launch each flash
    kernel once for each attention that takes it (2 encoder + 2 cross a
    step), each element pass once a layer, and send the 2 decoder
    self-attentions (causal mask) to the dense path; greedy equals beam 1
    token for token, and every decode step launches flash_fwd 4 times."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models import transformer_wmt as W

    cfg = W.TransformerConfig.tiny()
    model = W.WMTTransformer(cfg, seed=1)
    step, state = W.build_train_step(model, warmup_steps=10)
    batch = W.fake_batch(cfg, 4, 24, 20, seed=2)
    for c in COUNTERS.values():
        c.reset()
    profiler.stat_reset("attention_dispatch_dense")
    losses = [float(step(state, batch)[1]) for _ in range(2)]
    launches = {n: c.value for n, c in COUNTERS.items() if c.value}
    assert all(np.isfinite(losses))
    assert launches == {n: 8 for n in ("flash_fwd", "flash_bwd_dkv",
                                       "flash_bwd_dq", "ffn_act_fwd",
                                       "ffn_act_bwd")}
    assert profiler.get_int_stats()["attention_dispatch_dense"] == 4
    model = W.WMTTransformer(cfg, dtype=torch.bfloat16, seed=1).eval()
    src = torch.from_numpy(batch["src"]).cuda()
    for c in COUNTERS.values():
        c.reset()
    greedy = model.greedy_decode(src, max_len=8)
    assert COUNTERS["flash_fwd"].value == 2 + 4 * 8
    seqs, _ = model.beam_decode(src, beam_size=1, max_len=8)
    torch.testing.assert_close(seqs[:, 0], greedy, atol=0, rtol=0)


# -- the 2.x front end on the card --------------------------------------------

class _Digits(TIO.Dataset):
    """n 1 x 28 x 28 float32 images and (1,) int64 labels from a seed."""

    def __init__(self, n=16, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.rand(n, 1, 28, 28).astype(np.float32)
        self.y = rng.randint(0, 10, (n, 1)).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def test_hapi_fit_on_the_card_matches_the_cpu(cuda):
    """LeNet through Model.fit (static-mode adapter, f32, Momentum with L2
    and a global-norm clip) on the card and on the CPU: the same losses
    and parameters within f32's summation order (TF32 off)."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.vision import models as VM

    out = {}
    for dev in ("cuda", "cpu"):
        net = VM.LeNet(device=dev)
        model = T.Model(net)
        model.prepare(T.optimizer.Momentum(
            0.01, parameters=net.parameters(), weight_decay=1e-4,
            grad_clip=T.optimizer.ClipGradByGlobalNorm(1.0)),
            T.nn.CrossEntropyLoss(), T.metric.Accuracy(topk=(1, 3)))
        hist = model.fit(_Digits(), batch_size=8, epochs=2, shuffle=False,
                         verbose=0)
        out[dev] = (hist, {k: v.detach().cpu() for k, v in
                           net.state_dict().items()})
    for (a, b) in zip(out["cuda"][0], out["cpu"][0]):
        assert a["acc_top1"] == b["acc_top1"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for k, v in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], v, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("adapter", ["static", "dygraph"])
def test_hapi_resnet18_o1_steps_match_a_plain_bf16_step(cuda, adapter):
    """resnet18 at O1 through two Model.train_batch calls on the card
    against the plain O1 step written out (tests/torch_plain_steps.py)
    from the same weights and batches of 4 x 3 x 64 x 64, with cuDNN's
    deterministic algorithms: each parameter's and running statistic's
    change within 1e-5 in relative L2, the losses within 1e-6 relative
    (the CPU test's limits).  Measured on the H100: 0 and equal, both
    adapters; controls that leave the gradients scaled or batch norm's
    parameters out of the update read >= 1.0 on the CPU."""
    from torch_plain_steps import resnet18_o1_steps

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, _, losses, want_losses, errs = resnet18_o1_steps(
            adapter, "cuda", (3, 64, 64))
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"{adapter}: losses {losses} plain {want_losses}; worst change "
          f"{max(errs.values()):.3g} at {max(errs, key=errs.get)}")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    bad = {k: e for k, e in errs.items() if e > 1e-5}
    assert not bad, bad


def test_hapi_static_adapter_skips_a_non_finite_step(cuda):
    """amp O1 on the card: a batch with an inf image gives non-finite
    gradients, so the parameters and the optimizer state stay as they
    were (decided on the device) and the step is still counted."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.vision import models as VM

    net = VM.LeNet()
    model = T.Model(net)
    model.prepare(T.optimizer.Momentum(0.1, parameters=net.parameters()),
                  T.nn.CrossEntropyLoss(), amp_configs="O1")
    d = _Digits(8)
    model.train_batch([d.x], [d.y])
    before = {k: v.clone() for k, v in net.state_dict().items()
              if "_mean" not in k and "_variance" not in k}
    vel = {k: v.clone() for k, v in model._optimizer.state_dict().items()
           if isinstance(v, torch.Tensor)}
    x = d.x.copy()
    x[0, 0, 0, 0] = np.inf
    model.train_batch([x], [d.y])
    for k, v in before.items():
        assert torch.equal(net.state_dict()[k], v), k
    after = model._optimizer.state_dict()
    assert all(torch.equal(after[k], v) for k, v in vel.items())
    assert after["global_step"] == 2


def _own_collate(batch):
    return TIO.default_collate_fn(batch)


@pytest.mark.parametrize("workers,ring", [(0, False), (2, False),
                                          (3, True)])
def test_dataloader_buffer_reader_on_the_card(cuda, workers, ring):
    """Batches reach the card in the sampler's order with their values,
    through the side stream (from the pinned ring with the default
    collate, through the workers' queues with another), across two
    epochs."""
    d = _Digits(37)
    loader = TIO.DataLoader(d, batch_size=4, shuffle=True, drop_last=False,
                            num_workers=workers,
                            collate_fn=None if ring else _own_collate)
    for epoch in range(2):
        np.random.seed(epoch)
        order = np.random.permutation(37)
        np.random.seed(epoch)
        got = list(loader)
        assert len(got) == 10
        for i, (x, y) in enumerate(got):
            idx = order[4 * i: 4 * i + 4]
            assert x.is_cuda and y.is_cuda
            torch.testing.assert_close(x.cpu(), torch.from_numpy(d.x[idx]),
                                       atol=0, rtol=0)
            torch.testing.assert_close(y.cpu(), torch.from_numpy(d.y[idx]),
                                       atol=0, rtol=0)


def test_dataloader_left_early_on_the_card(cuda):
    """An epoch left early with the buffer reader and the pinned ring, by
    a break and by an iterator kept open, then two whole epochs: each
    gives the sampler's batches bit for bit."""
    d = _Digits(37)
    loader = TIO.DataLoader(d, batch_size=4, shuffle=True, num_workers=3)

    def epoch(seed):
        np.random.seed(seed)
        order = np.random.permutation(37)
        np.random.seed(seed)
        got = [(x.cpu(), y.cpu()) for x, y in loader]
        assert len(got) == 10
        for i, (x, y) in enumerate(got):
            idx = order[4 * i: 4 * i + 4]
            assert torch.equal(x, torch.from_numpy(d.x[idx]))
            assert torch.equal(y, torch.from_numpy(d.y[idx]))

    for j, _ in enumerate(loader):
        if j == 1:
            break
    epoch(0)
    held = iter(loader)
    next(held)
    epoch(1)
    epoch(2)
    held.close()
    epoch(3)


def test_accuracy_and_optimizers_on_the_card(cuda):
    """Accuracy on card tensors equals the CPU's; three Adam, Momentum
    and Lamb steps on the card match the CPU within f32."""
    import paddle_tpu_torch as T

    rng = np.random.RandomState(0)
    pred = rng.randn(64, 10).astype(np.float32)
    label = rng.randint(0, 10, (64, 1)).astype(np.int64)
    a, b = T.metric.Accuracy(topk=(1, 5)), T.metric.Accuracy(topk=(1, 5))
    a.update(a.compute(torch.from_numpy(pred).cuda(),
                       torch.from_numpy(label).cuda()))
    b.update(b.compute(torch.from_numpy(pred), torch.from_numpy(label)))
    assert a.accumulate() == b.accumulate()
    for make in (lambda ps: T.optimizer.Adam(1e-2, parameters=ps),
                 lambda ps: T.optimizer.Momentum(0.1, parameters=ps,
                                                 weight_decay=1e-3),
                 lambda ps: T.optimizer.Lamb(1e-2, parameters=ps)):
        res = {}
        for dev in ("cuda", "cpu"):
            params = [T.nn.Parameter(torch.from_numpy(
                np.random.RandomState(i).randn(5, 3).astype(np.float32)
            ).to(dev), name=f"p{i}") for i in range(3)]
            opt = make(params)
            for step in range(3):
                for i, p in enumerate(params):
                    p.grad = torch.from_numpy(np.random.RandomState(
                        10 * step + i).randn(5, 3).astype(np.float32)).to(dev)
                opt.step()
            res[dev] = [p.detach().cpu() for p in params]
        for g, c in zip(res["cuda"], res["cpu"]):
            torch.testing.assert_close(g, c, atol=1e-6, rtol=1e-5)


# -- recurrent layers and the seq2seq program (no hand-written kernel) ----

@pytest.mark.parametrize("mode", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_cudnn_recurrence_matches_the_plain_loop(cuda, mode, direction):
    """The fused recurrence (cuDNN on the card, TF32 off) against the
    reference's per-step loop, forward and gradients, 2 layers of 20
    steps with dropout between them under one scope seed: f32 sums in
    two orders, within 1e-4 + 1e-3 relative (outputs) and 1e-3 of each
    gradient's largest element."""
    from paddle_tpu_torch import nn

    layer = getattr(nn, mode)(48, 64, num_layers=2, direction=direction,
                              dropout=0.2, generator=cuda).to("cuda")
    x = torch.randn(8, 20, 48, generator=cuda).to("cuda")
    runs = []
    for fn in (layer.forward, layer.plain_forward):
        leaf = x.clone().requires_grad_()
        with Fn.rng_scope(3):
            outs = fn(leaf)
        g = torch.Generator().manual_seed(1)
        cts = [torch.randn(o.shape, generator=g).to("cuda") for o in outs]
        grads = torch.autograd.grad(outs, [leaf] + list(layer.parameters()),
                                    cts)
        runs.append((outs, grads))
    for a, b in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)
    for a, b in zip(runs[0][1], runs[1][1]):
        assert float((a - b).abs().max()) <= \
            1e-3 * float(b.abs().max()) + 1e-6


def test_recurrent_layers_run_on_the_card_without_a_host_read(cuda):
    """Without lengths, neither the fused layers nor the cells read
    anything back to the host."""
    from paddle_tpu_torch import nn

    lstm = nn.LSTM(16, 32, num_layers=2).to("cuda")
    cell = nn.RNN(nn.GRUCell(16, 32)).to("cuda")
    x = torch.randn(4, 10, 16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, (h, c) = lstm(x)
        y2, h2 = cell(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.is_cuda and y.shape == (4, 10, 32) and h2.shape == (4, 32)


def test_tiny_seq2seq_trains_and_decodes_on_the_card(cuda):
    """The seq2seq program at the parity tests' size on the card: the
    loss and gradients of one batch against the CPU (f32, TF32 off), a
    Model.fit whose loss falls, beam 1 equal to greedy and the beams'
    scores against teacher forcing."""
    import sys
    from pathlib import Path

    import paddle_tpu_torch as paddle

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_seq2seq_program as S

    cfg = dict(S.TINY, hidden=32, steps=9, max_out_len=9)
    data = S.batch(cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        paddle.set_device(dev)
        net = S.build(paddle, cfg).to(dev)
        src, sl, trg, tl, lab = (torch.from_numpy(a).to(dev) for a in data)
        logits, mask = net(src, sl, trg, tl)
        loss = S.classes(paddle)["CrossEntropyCriterion"]()(logits, mask,
                                                            lab)
        loss.backward()
        out[dev] = (float(loss), {n: p.grad.cpu() for n, p in
                                  net.named_parameters()})
    try:
        assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(
            out["cpu"][0])
        for n, g in out["cpu"][1].items():
            torch.testing.assert_close(out["cuda"][1][n], g, atol=1e-5,
                                       rtol=1e-3, msg=n)
        net = S.build(paddle, cfg).to("cuda")
        model = S.prepare(paddle, net, cfg)
        batch = [tuple(torch.from_numpy(a).cuda() for a in data)] * 8
        losses = []

        class Rec(paddle.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])

        model.fit(batch, epochs=1, verbose=0, callbacks=[Rec()])
        assert len(losses) == 8 and losses[-1] < losses[0]
        src, sl = (torch.from_numpy(a).cuda() for a in data[:2])
        greedy = S.greedy(paddle, net, src, sl, cfg["max_out_len"])
        one = S.beam_search(paddle, net, src, sl, 1, cfg["max_out_len"])
        assert np.array_equal(S.host(one["predicted_ids"])[:, :, 0], greedy)
        beams = S.beam_search(paddle, net, src, sl, 3, cfg["max_out_len"])
        ids, par, sc = (S.host(beams[k]) for k in
                        ("predicted_ids", "parent_ids", "scores"))
        forced = S.sequence_scores(paddle, net, src, sl,
                                   S.backtrack(ids, par))
        np.testing.assert_allclose(forced, sc[:, -1, :], rtol=1e-4,
                                   atol=1e-4)
    finally:
        paddle.device._CURRENT[0] = None


def test_a_checkpoint_snapshot_is_ordered_before_the_next_update(cuda,
                                                                 tmp_path):
    """CheckpointManager.save_async copies CUDA tensors into pinned host
    memory on a side stream and returns; an in-place update enqueued right
    after (a long kernel queue ahead of both) does not reach the file, and
    the copy's device time is counted."""
    from paddle_tpu_torch import ckpt, profiler

    w = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    h = torch.ones(256, 4, dtype=torch.bfloat16, device="cuda")
    big = torch.randn(4096, 4096, device="cuda")
    for _ in range(8):
        big = big @ big / 64.0  # keeps the stream busy past save_async
    m = ckpt.CheckpointManager(str(tmp_path))
    profiler.time_reset("ckpt_copy_ms")
    m.save_async({"w": w, "h": h, "step": torch.tensor(3)}, step=1)
    w.mul_(-1.0)
    h.zero_()
    m.wait()
    state, _ = ckpt.read_state(str(tmp_path))
    assert torch.equal(state["w"], torch.arange(1 << 20,
                                                dtype=torch.float32))
    assert state["h"].dtype == torch.bfloat16 and bool((state["h"] == 1).all())
    assert int(state["step"]) == 3
    assert profiler.get_time_stats()["ckpt_copy_ms"] > 0
    assert bool(torch.isfinite(big).all())


def test_the_kernel_operators_on_the_card(cuda, tmp_path):
    """A tiny BERT at a kernel width exported on the card: its Predictor
    launches flash_fwd and ffn_act_fwd once a layer, gives the eager
    model's outputs, and refuses the CPU; a gradient asked of an operator
    itself raises."""
    from paddle_tpu_torch import inference, nn

    cfg = bert.BertConfig.tiny(hidden_size=128, intermediate_size=256,
                               num_attention_heads=2,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()

    class Serve(nn.Layer):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, ids, types, mask):
            return self.model(ids, types,
                              attention_mask=(mask != 0)[:, None, None, :])

    fb = bert.fake_batch(cfg, 4, 64, seed=1)
    feeds = [fb[k] for k in ("input_ids", "token_type_ids",
                             "attention_mask")]
    arm = F._FFN_DISABLED
    F._FFN_DISABLED = "the default arm"
    try:
        prefix = inference.save_inference_model(str(tmp_path / "b"),
                                                Serve(), feeds)
        pred = inference.load_inference_model(prefix)
        pred.run(feeds)  # the bucket's warm-up run
        for c in COUNTERS.values():
            c.reset()
        got = pred.run(feeds)
        assert COUNTERS["flash_fwd"].value == COUNTERS[
            "ffn_act_fwd"].value == cfg.num_hidden_layers
        with torch.inference_mode():
            want = Serve()(*[torch.from_numpy(a).cuda() for a in feeds])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.float().cpu().numpy())
    finally:
        F._FFN_DISABLED = arm
    with pytest.raises(RuntimeError, match="traced on cuda"):
        inference.load_inference_model(prefix, device="cpu")
    q = _bf16(cuda, 1, 16, 2, 64).requires_grad_()
    out, _ = A.flash_forward(q, q, q)
    with pytest.raises(NotImplementedError, match="autograd Function"):
        out.float().sum().backward()
