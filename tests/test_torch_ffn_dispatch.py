"""The dispatch rules the port shares with paddle_tpu: `fused_ffn`'s two
arms (the kernels are opt-in, as `paddle_tpu/ops/pallas/ffn.py:372-516`
has it) and the attention dispatcher's coverage rule (`_flash_ok`).

The library arm (`FFNLibraryFunction`: products around the element pass
of csrc/ffn_act.cu, whose plain versions run here) is held against the
JAX package's non-kernel arm on the CPU, forward and gradients, with the
dropout masks bit for bit.  Tolerances: LIB (atol 1e-5, rtol 1e-5) is
f32 summation order over d_model 64 and d_ff 256; ACT_GRAD (1e-5): the
closed-form act' against autograd through the Abramowitz-Stegun erf,
whose derivative is not exactly the Gaussian pdf.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import ffn as JF
from paddle_tpu_torch import profiler
from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.ops.kernels import attention as TA
from paddle_tpu_torch.ops.kernels import ffn as TF

LIB = dict(atol=1e-5, rtol=1e-5)
ACT_GRAD = dict(atol=1e-5, rtol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ffn_inputs(seed, t=40, h=64, f=256):
    rng = np.random.default_rng(seed)
    return (_rand(rng, t, h), _rand(rng, h, f, scale=h ** -0.5),
            _rand(rng, f, scale=0.1), _rand(rng, f, h, scale=f ** -0.5),
            _rand(rng, h, scale=0.1))


@pytest.fixture
def counts():
    """Dispatch counters and launch counters at 0."""
    for name in ("ffn_dispatch_kernel", "ffn_dispatch_library",
                 "attention_dispatch_dense"):
        profiler.stat_reset(name)
    for c in COUNTERS.values():
        c.reset()
    return lambda name: profiler.get_int_stats().get(name, 0)


# -- the switch ---------------------------------------------------------------

def _disabled_in_child(env_value):
    env = dict(os.environ)
    env.pop("PADDLE_TPU_FUSED_FFN", None)
    if env_value is not None:
        env["PADDLE_TPU_FUSED_FFN"] = env_value
    out = subprocess.run(
        [sys.executable, "-c", "from paddle_tpu_torch.ops.kernels import "
         "ffn; print(ffn._FFN_DISABLED is None)"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip() == "True"


@pytest.mark.parametrize("value,opened", [(None, False), ("1", True),
                                          ("0", False)])
def test_variable_opens_the_kernel_arm_as_in_the_reference(value, opened):
    assert _disabled_in_child(value) is opened


def test_default_is_the_references():
    if os.environ.get("PADDLE_TPU_FUSED_FFN") == "1":
        pytest.skip("the variable opens both packages' kernel arms here")
    assert TF._FFN_DISABLED is not None and JF._FFN_DISABLED is not None
    assert TF._ffn_arm([torch.bfloat16] * 5, 768, 3072) == "library"


def test_enable_and_disable(monkeypatch):
    monkeypatch.setattr(TF, "_FFN_DISABLED", "closed")
    TF.enable_fused_ffn()
    assert TF._FFN_DISABLED is None
    assert TF._ffn_arm([torch.bfloat16] * 5, 768, 3072) == "kernel"
    TF.disable_fused_ffn("measured slower")
    assert TF._FFN_DISABLED == "measured slower"
    assert TF._ffn_arm([torch.bfloat16] * 5, 768, 3072) == "library"


@pytest.mark.parametrize("h,f,dtype,opened,arm", [
    (768, 3072, torch.bfloat16, True, "kernel"),
    (768, 3072, torch.bfloat16, False, "library"),
    (768, 3072, torch.float32, True, "library"),
    (64, 128, torch.bfloat16, True, "library"),   # BertConfig.tiny
    (64, 128, torch.float32, True, "library"),
    (128, 256, torch.bfloat16, True, "kernel"),
    (768, 3000, torch.bfloat16, True, "library"),  # d_ff not 64-column steps
    (1024, 4096, torch.float16, True, "library"),
])
def test_arm_rule(monkeypatch, h, f, dtype, opened, arm):
    monkeypatch.setattr(TF, "_FFN_DISABLED", None if opened else "closed")
    assert TF._ffn_arm([dtype] * 5, h, f) == arm
    # one operand of another dtype closes the kernel arm
    assert TF._ffn_arm([dtype] * 4 + [torch.float32], h, f) == "library"


@pytest.mark.parametrize("opened", [False, True])
def test_each_call_counts_its_arm(monkeypatch, counts, opened):
    monkeypatch.setattr(TF, "_FFN_DISABLED", None if opened else "closed")
    ts = [torch.from_numpy(a).to(torch.bfloat16)
          for a in _ffn_inputs(1, t=16, h=128, f=256)]
    TF.fused_ffn(*ts)
    TF.fused_ffn(ts[0].float(), *(a.float() for a in ts[1:]))
    assert counts("ffn_dispatch_kernel") == int(opened)
    assert counts("ffn_dispatch_library") == 2 - int(opened)
    assert all(c.value == 0 for c in COUNTERS.values())  # CPU: no launch


def test_no_arm_is_taken_after_a_failure(counts):
    """An activation neither arm computes raises in the arm the rule
    chose; the other arm is never tried."""
    ts = [torch.from_numpy(a) for a in _ffn_inputs(2, t=8, h=64, f=128)]
    with pytest.raises(NotImplementedError, match="swish"):
        TF.fused_ffn(*ts, activation="swish")
    assert counts("ffn_dispatch_library") == 1
    assert counts("ffn_dispatch_kernel") == 0


# -- the library arm against the reference's non-kernel arm -------------------

def _jax_xla_arm(x, w1, b1, w2, b2, g, activation, p, seed):
    def f(x, w1, b1, w2, b2):
        out = JF.fused_ffn(x, w1, b1, w2, b2, activation=activation,
                           dropout_p=p,
                           dropout_seed=jnp.array([seed], jnp.int32))
        return jnp.sum(out * g), out
    (_, out), grads = jax.value_and_grad(f, argnums=range(5), has_aux=True)(
        x, w1, b1, w2, b2)
    return np.asarray(out), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_library_arm_matches_the_references_xla_arm(activation, p, counts):
    x, w1, b1, w2, b2 = _ffn_inputs(3)
    x3 = x.reshape(2, 20, 64)
    g = _rand(np.random.default_rng(4), 2, 20, 64)
    seed = 2024
    want, want_grads = _jax_xla_arm(x3, w1, b1, w2, b2, g, activation, p,
                                    seed)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x3, w1, b1, w2, b2)]
    out = TF.fused_ffn(*ts, activation=activation, dropout_p=p,
                       dropout_seed=seed)
    got_grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert counts("ffn_dispatch_library") == 1
    np.testing.assert_allclose(out.detach().numpy(), want, **LIB)
    for name, got, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got_grads,
                            want_grads):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **LIB)


@pytest.mark.parametrize("seed,t,f", [(0, 40, 256), (7, 33, 100),
                                      (2 ** 31 - 1, 5, 3072)])
def test_element_pass_drops_the_references_mask_bit_for_bit(seed, t, f):
    """relu over positive pre: each value is 0 exactly where
    `_ffn_keep(seed, 0, 0, T, F, p)` drops it, in both passes."""
    p = 0.1
    pre = torch.full((t, f), 3.0)
    keep = np.asarray(JF._ffn_keep(jnp.array(seed, jnp.int32), 0, 0, t, f, p))
    h = TF.ffn_act_fwd(pre, torch.zeros(f), "relu", p, seed)
    dpre, h2 = TF.ffn_act_bwd(pre, torch.zeros(f), torch.ones(t, f), "relu",
                              p, seed)
    np.testing.assert_array_equal(h.numpy() != 0, keep)
    np.testing.assert_array_equal(dpre.numpy() != 0, keep)
    np.testing.assert_array_equal(h2.numpy(), h.numpy())
    np.testing.assert_allclose(h.numpy()[keep], 3.0 / (1.0 - p), rtol=1e-7)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_element_pass_backward_is_the_gradient_of_its_forward(activation, p):
    rng = np.random.default_rng(5)
    pre = torch.from_numpy(_rand(rng, 24, 96, scale=2.0)).requires_grad_()
    b1 = torch.from_numpy(_rand(rng, 96, scale=0.1))
    dh = torch.from_numpy(_rand(rng, 24, 96))
    h = TF.ffn_act_fwd(pre, b1, activation, p, 11)
    want = torch.autograd.grad(h, pre, dh)[0]
    dpre, h2 = TF.ffn_act_bwd(pre.detach(), b1, dh, activation, p, 11)
    np.testing.assert_array_equal(h2.numpy(), h.detach().numpy())
    np.testing.assert_allclose(dpre.numpy(), want.numpy(), **ACT_GRAD)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_library_arm_matches_the_kernels_plain_versions(activation, counts):
    """On the CPU both arms compute the same function (f32 here):
    `FFNLibraryFunction` against `FusedFFNFunction`, forward and
    gradients, each called itself; neither counts a dispatch."""
    ts = [torch.from_numpy(a).requires_grad_()
          for a in _ffn_inputs(6, t=32, h=128, f=256)]
    g = torch.from_numpy(_rand(np.random.default_rng(7), 32, 128))
    outs = []
    for fn in (TF.FFNLibraryFunction, TF.FusedFFNFunction):
        out = fn.apply(*ts, activation, 0.1, 9)
        outs.append([out.detach()] + list(torch.autograd.grad(out, ts, g)))
    for name, lib, ker in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                              *outs):
        np.testing.assert_allclose(lib.numpy(), ker.numpy(), err_msg=name,
                                   **LIB)
    assert counts("ffn_dispatch_kernel") == counts("ffn_dispatch_library") == 0


def test_element_pass_refuses_what_its_kernel_cannot_take():
    pre = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError):
        TF.ffn_act_fwd(pre, torch.zeros(8), "swish")
    with pytest.raises(NotImplementedError):
        TF.ffn_act_bwd(pre, torch.zeros(8), pre, "swish")


# -- the attention dispatcher's coverage rule ---------------------------------

@pytest.mark.parametrize("dtype,d,takes", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 128, True), (torch.float32, 64, False),
    (torch.float16, 64, False), (torch.bfloat16, 80, False),
    (torch.bfloat16, 256, False), (torch.float32, 48, False)])
def test_flash_coverage_rule(dtype, d, takes):
    assert TA._flash_takes([dtype] * 3, d) is takes
    assert TA._flash_takes([dtype, dtype, torch.float32], d) is False


def test_cpu_attention_keeps_the_plain_flash_path(monkeypatch, counts):
    """The coverage rule applies to CUDA tensors: on the CPU an f32 call
    still runs the flash kernels' plain version, and only a mask the
    kernels cannot express is sent to dense_attention (and counted)."""
    calls = []
    monkeypatch.setattr(TA, "flash_attention",
                        lambda *a, **k: calls.append("flash"))
    q = torch.zeros(1, 8, 2, 16)
    TA.scaled_dot_product_attention(q, q, q)
    assert calls == ["flash"] and counts("attention_dispatch_dense") == 0
    TA.scaled_dot_product_attention(q, q, q,
                                    mask=torch.ones(1, 2, 8, 8, dtype=bool))
    assert calls == ["flash"] and counts("attention_dispatch_dense") == 1
