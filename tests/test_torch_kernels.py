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
    """Named for what it once held: the dispatcher used to raise on a
    per-query mask.  Like paddle_tpu's, it now computes one outside the
    kernel (`dense_attention`, the counterpart of `_xla_attention`)."""
    q, k, v = _qkv(8, 1, 16, 16, 2, 16)
    mask = np.tril(np.ones((1, 1, 16, 16), bool))
    want = np.asarray(JA.scaled_dot_product_attention(q, k, v, mask=mask))
    got = TA.scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)


def _dense_mask(form, b, h, sq, sk):
    """A mask the flash kernel cannot express: per query (causal over
    (1, 1, Sq, Sk)), per head ((1, H, 1, Sk)) or full ((B, H, Sq, Sk)),
    as bool or as an additive f32 bias (0 / DEFAULT_MASK_VALUE, or, for
    the full float form, any real bias)."""
    rng = np.random.default_rng(13)
    shape, dtype = form.split("-")
    if shape == "query":
        keep = np.tril(np.ones((1, 1, sq, sk), bool), sk - sq)
    elif shape == "head":
        keep = rng.random((1, h, 1, sk)) > 0.4
        keep[..., 0] = True
    else:
        keep = rng.random((b, h, sq, sk)) > 0.3
        keep[..., 0] = True
        if dtype == "float":
            return (rng.standard_normal((b, h, sq, sk)) * 2).astype(
                np.float32)
    if dtype == "bool":
        return keep
    return np.where(keep, 0.0, TA.DEFAULT_MASK_VALUE).astype(np.float32)


DENSE_FORMS = ["query-bool", "query-float", "head-bool", "head-float",
               "full-bool", "full-float"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("form", DENSE_FORMS)
def test_dense_mask_matches_jax_dispatcher(form, causal):
    """Masks that vary per query or per head: the forward against
    paddle_tpu's dispatcher (which sends them to `_xla_attention`), at
    dropout 0, with and without is_causal on top."""
    b, sq, sk, h, d = 2, 24, 40, 3, 16
    q, k, v = _qkv(14, b, sq, sk, h, d)
    mask = _dense_mask(form, b, h, sq, sk)
    want = np.asarray(JA.scaled_dot_product_attention(q, k, v, mask=mask,
                                                      is_causal=causal))
    got = TA.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                          mask=_t(mask), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["query-bool", "head-float", "full-float",
                                  "full-bool"])
def test_dense_mask_gradients_match_jax(form):
    """d/dq, d/dk, d/dv of <out, g> through autograd against jax.grad of
    `_xla_attention` with the same mask."""
    import jax

    b, sq, sk, h, d = 2, 20, 20, 2, 16
    q, k, v = _qkv(15, b, sq, sk, h, d)
    ct = _rand(np.random.default_rng(16), b, sq, h, d)
    mask = _dense_mask(form, b, h, sq, sk)
    want = jax.grad(lambda a, b_, c: jnp.sum(
        JA._xla_attention(a, b_, c, mask=mask) * ct), argnums=(0, 1, 2))(
        q, k, v)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = TA.scaled_dot_product_attention(*leaves, mask=_t(mask))
    got = torch.autograd.grad((out * _t(ct)).sum(), leaves)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_dense_mask_dropout_scales_what_it_keeps():
    """At p > 0 the dense path keeps about 1 - p of the probabilities,
    zeroes the rest and scales the kept ones by 1 / (1 - p); the same
    seed draws the same bits, another seed others.  v holds one-hot key
    columns, so the output is the dropped probability matrix itself."""
    b, s, h, p = 2, 32, 2, 0.25
    rng = np.random.default_rng(17)
    q, k = _rand(rng, b, s, h, s), _rand(rng, b, s, h, s)
    v = np.broadcast_to(np.eye(s, dtype=np.float32)[None, :, None, :],
                        (b, s, h, s)).copy()
    mask = _t(_dense_mask("head-bool", b, h, s, s))
    run = lambda pp, seed: TA.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), mask=mask, dropout_p=pp,
        dropout_seed=seed).numpy()
    probs, dropped = run(0.0, None), run(p, 5)
    kept = dropped != 0
    np.testing.assert_allclose(dropped[kept], probs[kept] / (1 - p),
                               rtol=1e-6)
    assert abs(kept[probs != 0].mean() - (1 - p)) < 0.03
    np.testing.assert_array_equal(run(p, 5), dropped)
    assert not np.array_equal(run(p, 6) != 0, kept)


def test_key_padding_masks_still_reach_flash_attention(monkeypatch):
    """A key-padding mask (or none) runs through `flash_attention`; only
    the masks it cannot express reach `dense_attention`."""
    calls = []
    for name in ("flash_attention", "dense_attention"):
        real = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _r=real, _n=name, **kw: (
            calls.append(_n), _r(*a, **kw))[1])
    q, k, v = map(_t, _qkv(18, 2, 16, 16, 2, 16))
    pad = torch.arange(16)[None, :] < torch.tensor([[12], [16]])
    for m in (None, pad, pad[:, None, :], pad[:, None, None, :]):
        TA.scaled_dot_product_attention(q, k, v, mask=m)
    assert calls == ["flash_attention"] * 4
    TA.scaled_dot_product_attention(q, k, v, mask=torch.ones(
        1, 1, 16, 16, dtype=torch.bool).tril())
    assert calls[-1] == "dense_attention"


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
    """The kernel arm, `FusedFFNFunction` (on CPU tensors the kernels'
    plain versions), against the Pallas kernel in interpret mode."""
    x, w1, b1, w2, b2 = _ffn_inputs(11)
    seed = 31337
    want = np.asarray(JF.fused_ffn(
        x, w1, b1, w2, b2, activation=activation, dropout_p=p,
        dropout_seed=jnp.array([seed], jnp.int32), interpret=True))
    got = TF.FusedFFNFunction.apply(*map(_t, (x, w1, b1, w2, b2)),
                                    activation, p, seed)
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
    q, k, v = (_t(a).requires_grad_() for a in _qkv(13, 1, 16, 16, 2, 16))
    TA.flash_attention(q, k, v).sum().backward()
    x, w1, b1, w2, b2 = (_t(a).requires_grad_()
                         for a in _ffn_inputs(14, t=16, h=16, f=32))
    TF.FusedFFNFunction.apply(x, w1, b1, w2, b2, "gelu", 0.1, 3).sum() \
        .backward()
    TF.FFNLibraryFunction.apply(x, w1, b1, w2, b2, "gelu", 0.1, 3).sum() \
        .backward()
    pages = _t(np.random.RandomState(15).randn(4, 8, 2, 16).astype("f4"))
    TA.paged_attention(q[:, :1].detach(), pages, pages,
                       torch.tensor([[1, 2]], dtype=torch.int32),
                       torch.tensor([12], dtype=torch.int32))
    assert all(t.grad is not None for t in (q, k, v, x, w1, b1, w2, b2))
    assert {n: c.value for n, c in COUNTERS.items()} == {
        "flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
        "ffn_fwd": 0, "ffn_bwd_dw": 0, "ffn_bwd_dx": 0, "ragged_paged": 0,
        "probe_4d": 0, "probe_fold3d": 0, "probe_merged": 0,
        "ffn_act_fwd": 0, "ffn_act_bwd": 0}


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
    assert {p.stem for p in build.CSRC.glob("*.cu")} == {
        "flash_fwd", "flash_bwd", "ffn_fwd", "ffn_bwd", "ragged_paged",
        "probe4d", "ffn_act"}


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


# -- backward: the plain versions against the Pallas backward kernels ---------------

# f32 on both sides, differing only in summation order: attention
# gradients (up to ~5) sum 128 keys or queries (measured 1e-6); the FFN
# weight gradients (up to ~60) sum 256 tokens (measured 2.5e-5)
FLASH_BWD_ATOL = 1e-5
FFN_BWD_ATOL = 1e-4


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.0),
                                      (False, 0.1), (True, 0.1)])
def test_flash_backward_reference_matches_pallas_vjp(causal, p):
    """Block-multiple lengths (no padding inside the JAX shim) and a key
    padding bias that leaves every row some key; the same dropout seed on
    both sides, so the hash drops the same probabilities."""
    import jax

    b, s, h, d = 2, 128, 2, 32
    q, k, v = _qkv(21, b, s, s, h, d)
    g = _rand(np.random.default_rng(22), b, s, h, d)
    bias = _key_bias(23, b, s)
    seed = 9001
    _, vjp = jax.vjp(
        lambda q_, k_, v_: JA.flash_attention(
            q_, k_, v_, key_bias=bias, is_causal=causal, dropout_p=p,
            dropout_seed=seed, interpret=True), q, k, v)
    want = vjp(g)
    out, lse = TA.flash_forward_reference(_t(q), _t(k), _t(v), _t(bias),
                                          seed, causal, None, None, p)
    got = TA.flash_backward_reference(_t(q), _t(k), _t(v), _t(bias), seed,
                                      out, lse, _t(g), causal, None, None, p)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w),
                                   atol=FLASH_BWD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("activation,p", [
    ("gelu", 0.0), ("gelu_tanh", 0.0), ("relu", 0.0), ("gelu", 0.1),
    ("gelu_tanh", 0.1), ("relu", 0.1)])
def test_ffn_backward_reference_matches_pallas_interpret(activation, p):
    x, w1, b1, w2, b2 = _ffn_inputs(31, t=256, h=128, f=256)
    g = _rand(np.random.default_rng(32), 256, 128)
    seed = 4711
    want = JF._ffn_backward(x, w1, b1, w2, b2, jnp.array([seed], jnp.int32),
                            g, activation=activation, dropout_p=p,
                            block_t=128, block_f=128, interpret=True)
    got = TF.ffn_backward_reference(*map(_t, (x, w1, b1, w2, b2)), seed,
                                    _t(g), activation, p)
    for name, gt, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w),
                                   atol=FFN_BWD_ATOL, rtol=0, err_msg=name)


def test_act_grad_matches_jax_formula():
    """f32 formulas; XLA's and torch's tanh and cube differ in the last
    bits, which the derivative's (1 - t^2) * x amplifies to ~4e-6 at
    |x| near 3"""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    for act in ("gelu", "gelu_tanh", "relu"):
        np.testing.assert_allclose(TF._act_grad(_t(x), act).numpy(),
                                   np.asarray(JF._act_grad(x, act)),
                                   atol=1e-5, rtol=0, err_msg=act)


# -- the autograd Functions on the CPU against autograd through the plain forward --

# f32; the Functions' formulas vs autograd's chain through the same forward:
# summation order, and (gelu) the derivative of the A-S erf approximation
# against the exact Gaussian density the backward uses (both ~1e-7)
GRAD_ATOL = 2e-5


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.1)])
def test_flash_function_backward_matches_autograd(causal, p):
    b, s, h, d = 2, 40, 3, 16
    q, k, v = (_t(a).requires_grad_() for a in _qkv(41, b, s, s, h, d))
    bias = _t(_key_bias(42, b, s))
    g = _t(_rand(np.random.default_rng(43), b, s, h, d))
    out = TA.flash_attention(q, k, v, key_bias=bias, is_causal=causal,
                             dropout_p=p, dropout_seed=77)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref, _ = TA.flash_forward_reference(q, k, v, bias, 77, causal, None,
                                        None, p)
    want = torch.autograd.grad(ref, (q, k, v), g)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("activation,p", [("gelu", 0.0), ("relu", 0.1),
                                          ("gelu_tanh", 0.1)])
def test_ffn_function_backward_matches_autograd(activation, p):
    """`FusedFFNFunction`'s backward (the kernels' plain versions on CPU
    tensors) against autograd of the plain forward."""
    ts = [_t(a).requires_grad_() for a in _ffn_inputs(44, t=2 * 24, h=32,
                                                      f=64)]
    g = _t(_rand(np.random.default_rng(45), 48, 32))
    out = TF.FusedFFNFunction.apply(*ts, activation, p, 5)
    got = torch.autograd.grad(out, ts, g)
    ref = TF.ffn_forward_reference(ts[0], *ts[1:], activation, p, 5)
    want = torch.autograd.grad(ref, ts, g)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=0)
