"""Port kernels vs the JAX package: the plain PyTorch versions of the
flash-attention forward and the fused FFN forward (paddle_tpu_torch.ops.
kernels) against paddle_tpu's Pallas kernels in interpret mode and its
XLA oracles, on the CPU, in float32.  The dropout hashes are held bit for
bit.  Inputs are numpy arrays from a seed, handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as JA
from paddle_tpu.ops.pallas import ffn as JF
from paddle_tpu_torch.ops.kernels import COUNTERS, build
from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.ops.kernels import ffn as TF

# f32 on both sides; the two only differ in summation order
FLASH_ATOL = 2e-5
FFN_ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the dropout hashes, bit for bit ---------------------------------------------

@pytest.mark.parametrize("seed,bh0,q0,k0,p", [
    (0, 0, 0, 0, 0.1), (12345, 3, 128, 256, 0.1), (-7, 0, 5, 9, 0.5),
    (2 ** 31 - 1, 11, 500, 7, 0.9)])
def test_keep_mask3_bit_for_bit(seed, bh0, q0, k0, p):
    want = np.asarray(JA._keep_mask3(jnp.int32(seed), bh0, q0, k0, 3, 16,
                                     24, p))
    got = TA._keep_mask3(seed, bh0, q0, k0, 3, 16, 24, p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,t0,f0,p", [
    (0, 0, 0, 0.1), (99, 512, 1024, 0.25), (-3, 7, 3, 0.6)])
def test_ffn_keep_bit_for_bit(seed, t0, f0, p):
    want = np.asarray(JF._ffn_keep(jnp.int32(seed), t0, f0, 32, 40, p))
    got = TF._ffn_keep(seed, t0, f0, 32, 40, p).numpy()
    np.testing.assert_array_equal(got, want)


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    for c in (0x9E3779B1, 0x846CA68B, 0xFFFFFFFF):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = TA._mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


# -- flash forward ----------------------------------------------------------------

def _qkv(seed, b, sq, sk, h, d):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, h, d), _rand(rng, b, sk, h, d),
            _rand(rng, b, sk, h, d))


def _key_bias(seed, b, sk):
    rng = np.random.default_rng(seed)
    lens = rng.integers(sk // 2, sk + 1, b)
    return np.where(np.arange(sk)[None, :] < lens[:, None], 0.0,
                    TA.DEFAULT_MASK_VALUE).astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(b=2, sq=128, sk=128, h=2, d=32, bias=True, causal=False, p=0.0),
    dict(b=1, sq=128, sk=128, h=2, d=64, bias=False, causal=True, p=0.0),
    dict(b=2, sq=72, sk=100, h=2, d=16, bias=True, causal=False, p=0.0),
    dict(b=1, sq=100, sk=136, h=2, d=16, bias=True, causal=True, p=0.0),
    dict(b=2, sq=128, sk=128, h=2, d=32, bias=True, causal=False, p=0.1),
    dict(b=1, sq=96, sk=96, h=3, d=16, bias=False, causal=True, p=0.1),
], ids=["bias", "causal", "ragged", "ragged-causal-offset", "dropout",
        "dropout-causal"])
def test_flash_reference_matches_pallas_interpret(case):
    q, k, v = _qkv(1, case["b"], case["sq"], case["sk"], case["h"],
                   case["d"])
    bias = _key_bias(2, case["b"], case["sk"]) if case["bias"] else None
    seed = 4242
    want = np.asarray(JA.flash_attention(
        q, k, v, key_bias=bias, is_causal=case["causal"],
        dropout_p=case["p"], dropout_seed=seed, interpret=True))
    got = TA.flash_attention(
        _t(q), _t(k), _t(v),
        key_bias=None if bias is None else _t(bias),
        is_causal=case["causal"], dropout_p=case["p"], dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_reference_matches_xla_attention(causal):
    q, k, v = _qkv(3, 2, 40, 40, 3, 16)
    bias = _key_bias(4, 2, 40)
    mask4 = bias[:, None, None, :]
    want = np.asarray(JA._xla_attention(q, k, v, mask=mask4,
                                        is_causal=causal))
    got = TA.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          mask=_t(mask4), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)
    dense = TA.dense_attention(_t(q), _t(k), _t(v), mask=_t(mask4),
                               is_causal=causal)
    np.testing.assert_allclose(dense.numpy(), want, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.1)])
def test_flash_lse_matches_pallas_forward(causal, p):
    """The log-sum-exp the training slice will need, against the Pallas
    forward on pre-padded (B*H, S, D) operands."""
    b, s, h, d = 2, 128, 2, 64
    q, k, v = _qkv(5, b, s, s, h, d)
    bias = _key_bias(6, b, s)
    merge = lambda x: np.ascontiguousarray(
        x.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    out_j, lse_j = JA._flash_forward(
        merge(q), merge(k), merge(v), bias[:, None, :],
        jnp.array([77], jnp.int32), h, is_causal=causal, dropout_p=p,
        block_q=128, block_k=128, interpret=True)
    out_t, lse_t = TA.flash_forward_reference(
        _t(q), _t(k), _t(v), _t(bias), 77, causal, 0, None, p)
    np.testing.assert_allclose(lse_t.numpy().reshape(b * h, s),
                               np.asarray(lse_j)[..., 0], atol=FLASH_ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(
        out_t.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d),
        np.asarray(out_j), atol=FLASH_ATOL, rtol=0)


def test_mask_forms_reduce_to_one_key_bias():
    q, k, v = _qkv(7, 2, 24, 24, 2, 16)
    keep = np.arange(24)[None, :] < np.array([[20], [13]])
    additive = np.where(keep, 0.0, TA.DEFAULT_MASK_VALUE).astype(np.float32)
    outs = [TA.scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=m)
            for m in (_t(keep[:, None, None, :]), _t(keep[:, None, :]),
                      _t(additive), _t(additive[:, None, None, :]))]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())


def test_per_query_mask_raises():
    q, k, v = _qkv(8, 1, 16, 16, 2, 16)
    mask = torch.ones((1, 1, 16, 16), dtype=torch.bool).tril()
    with pytest.raises(NotImplementedError):
        TA.scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=mask)


def test_fully_masked_row_is_uniform_not_nan():
    q, k, v = _qkv(9, 1, 8, 8, 1, 16)
    bias = np.full((1, 8), TA.DEFAULT_MASK_VALUE, np.float32)
    out, lse = TA.flash_forward_reference(_t(q), _t(k), _t(v), _t(bias))
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(out.numpy()[0, :, 0],
                               np.broadcast_to(v[0, :, 0].mean(0), (8, 16)),
                               atol=1e-6)


# -- fused FFN forward ----------------------------------------------------------

def _ffn_inputs(seed, t=128, h=128, f=256):
    rng = np.random.default_rng(seed)
    return (_rand(rng, t, h), _rand(rng, h, f, scale=h ** -0.5),
            _rand(rng, f, scale=0.1), _rand(rng, f, h, scale=f ** -0.5),
            _rand(rng, h, scale=0.1))


@pytest.mark.parametrize("activation,p", [
    ("gelu", 0.0), ("gelu_tanh", 0.0), ("relu", 0.0), ("gelu", 0.1)])
def test_ffn_reference_matches_pallas_interpret(activation, p):
    x, w1, b1, w2, b2 = _ffn_inputs(11)
    seed = 31337
    want = np.asarray(JF.fused_ffn(
        x, w1, b1, w2, b2, activation=activation, dropout_p=p,
        dropout_seed=jnp.array([seed], jnp.int32), interpret=True))
    got = TF.fused_ffn(*map(_t, (x, w1, b1, w2, b2)),
                       activation=activation, dropout_p=p,
                       dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), want, atol=FFN_ATOL, rtol=0)


def test_ffn_leading_dims_and_xla_arm():
    """(B, S, H) input through fused_ffn, against the JAX package's XLA
    arm (the path its CPU model takes)."""
    x, w1, b1, w2, b2 = _ffn_inputs(12, t=48, h=32, f=64)
    x3 = x.reshape(3, 16, 32)
    want = np.asarray(JF.fused_ffn(x3, w1, b1, w2, b2))
    got = TF.fused_ffn(*map(_t, (x3, w1, b1, w2, b2)))
    assert got.shape == (3, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=FFN_ATOL, rtol=0)


def test_erf_matches_jax_formula():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    np.testing.assert_allclose(TF._erf(_t(x)).numpy(),
                               np.asarray(JF._erf(x)), atol=1e-7, rtol=0)


# -- the CUDA wrappers on a CPU tensor ---------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    for c in COUNTERS.values():
        c.reset()
    q, k, v = _qkv(13, 1, 16, 16, 2, 16)
    TA.flash_forward(_t(q), _t(k), _t(v))
    x, w1, b1, w2, b2 = _ffn_inputs(14, t=16, h=16, f=32)
    TF.ffn_forward(*map(_t, (x, w1, b1, w2, b2)))
    assert {n: c.value for n, c in COUNTERS.items()} == {
        "flash_fwd": 0, "ffn_fwd": 0}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", _NoCudaPath)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


class _NoCudaPath(type(build.CSRC)):
    """A Path whose /usr/local/cuda/bin/nvcc never exists."""

    def exists(self, *a, **kw):
        if str(self).endswith("/bin/nvcc"):
            return False
        return super().exists(*a, **kw)


def test_kernel_sources_are_present():
    assert {p.stem for p in build.CSRC.glob("*.cu")} == {"flash_fwd",
                                                        "ffn_fwd"}


def test_launch_counter_loses_no_update_across_threads():
    """The engine's warm-up and dispatch threads can launch at once."""
    import sys
    import threading

    counter = build.LaunchCounter("stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.value == 16 * 2000
