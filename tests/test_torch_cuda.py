"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same inputs: every compiled instantiation (head dims,
model widths, activations), dropout, causal offsets, ragged and strided
inputs, the shapes and types the wrappers refuse, and tiny BERT served on
the card.  These need an NVIDIA GPU with nvcc; the `cuda` fixture skips
them, with a reason, where there is none.  Run them on the card with

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: the repository's conftest imports JAX, which the GPU
machine does not have; this file imports no JAX).  TF32 is off, so the
plain versions' float32 products are full float32 products.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.ops.kernels import attention as A
from paddle_tpu_torch.ops.kernels import ffn as F
from paddle_tpu_torch.serving import Engine, EngineConfig

# bf16 outputs: kernel and plain version round the same f32 math to bf16
# after different summation orders: two bf16 units in the last place
BF16 = dict(atol=2 ** -6, rtol=2 ** -6)
# f32 log-sum-exp: summation order only
LSE = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _bf16(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to("cuda",
                                                        torch.bfloat16)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), **tol)


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
    q = _bf16(cuda, 1, 16, 2, 64)
    with pytest.raises(NotImplementedError):
        A.scaled_dot_product_attention(
            q, q, q, mask=torch.ones(1, 1, 16, 16, dtype=torch.bool,
                                     device="cuda").tril())


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
    assert {n: c.value for n, c in COUNTERS.items()} == {
        "flash_fwd": 2, "ffn_fwd": 1}


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
