"""PaddleGAN's CycleGAN (tests/torch_cyclegan_program.py, one program over
both packages' 2.x API) cut to ngf 8 with 2 residual blocks, ndf 8 with
2 layers, 32 x 32, on the CPU: the same weights (N(0, 0.02) from one
numpy stream) and images in paddle_tpu and the port.  On the crop form
of the upsampling, which both compute alike, the six generator losses
and every generator gradient, then the two discriminator losses and
every discriminator gradient, match.  The port's output_padding form
equals its crop form; the reference's output_padding form differs from
its crop form only in the last row and column, where it is zero (the
rule's zero-fill, ROADMAP queue 3).  Three of the port's train steps
move every parameter and lower the cycle loss.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): float32 forwards of ~20
convolutions, each renormalised by an instance norm.  Gradients back
through the same, whose float32 sums the packages order differently:
each element within GRAD_RTOL (1e-4) of itself plus GRAD_SCALE (1e-5)
of its tensor's largest element (an O(1) gradient moves by up to 7.5e-6,
which is 0.9 % of its smallest elements), plus ZERO (1e-5) for a bias
in front of an instance norm, whose exact gradient of 0 is rounding
noise of up to 1.3e-6 in both.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy

import paddle_tpu_torch as T

import torch_cyclegan_program as C

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_SCALE, ZERO = 1e-4, 1e-5, 1e-5
CFG = C.TINY


@pytest.fixture(autouse=True)
def _cpu_and_global_rngs():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    T.device._CURRENT[0] = old
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy())


def _grads(net):
    return {n: _np(p.grad) for n, p in net.named_parameters()
            if p.grad is not None}


def _one_step(P, nets, images):
    """The generators' losses and gradients, then the discriminators'
    on the fakes drawn through the image pools."""
    a, b = (P.to_tensor(x) for x in images)
    losses, fake_a, fake_b = C.generator_losses(P, nets, a, b, CFG)
    total = losses["idt_A"] + losses["idt_B"] + losses["G_A"] \
        + losses["G_B"] + losses["cycle_A"] + losses["cycle_B"]
    total.backward()
    g = {k: _grads(nets[k]) for k in ("G_A", "G_B")}
    for k in ("D_A", "D_B"):
        for p in nets[k].parameters():
            p.stop_gradient = False
    pool = C.pools(CFG)
    d_a = C.discriminator_loss(P, nets["D_A"], b, pool["B"].query(P, fake_b))
    d_b = C.discriminator_loss(P, nets["D_B"], a, pool["A"].query(P, fake_a))
    (d_a + d_b).backward()
    d = {k: _grads(nets[k]) for k in ("D_A", "D_B")}
    out = {k: float(_np(v)) for k, v in losses.items()}
    out.update(D_A=float(_np(d_a)), D_B=float(_np(d_b)))
    return out, g, d


def test_one_generator_and_discriminator_step_match_the_reference():
    images = C.images(CFG, seed=1)
    with Jdy.guard():
        want = _one_step(J, C.build(J, CFG, seed=3, upsample="crop"), images)
    got = _one_step(T, C.build(T, CFG, seed=3, upsample="crop"), images)
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, err_msg=k, **F32)
    for part in (1, 2):
        for net, grads in want[part].items():
            assert set(got[part][net]) == set(grads), net
            for n, g in grads.items():
                np.testing.assert_allclose(
                    got[part][net][n], g, rtol=GRAD_RTOL,
                    atol=GRAD_SCALE * float(np.abs(g).max()) + ZERO,
                    err_msg=f"{net} {n}")
    # the discriminators were frozen in the generators' step
    assert set(got[2]["D_A"]) == {n for n, _ in
                                  C.build(T, CFG)["D_A"].named_parameters()}


def test_the_port_output_padding_form_equals_its_crop_form():
    x = torch.from_numpy(C.images(CFG, seed=2)[0])
    nets = [C.build(T, CFG, seed=5, upsample=u)["G_A"]
            for u in ("output_padding", "crop")]
    with torch.no_grad():
        a, b = (n(x) for n in nets)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


@contextlib.contextmanager
def _both_upsamplings(P, w, bias):
    """A Conv2DTranspose(k 3, s 2, p 1, output_padding 1) and the crop
    form's conv (p 0), both with weight `w` and `bias`."""
    up = P.nn.Conv2DTranspose(w.shape[0], w.shape[1], 3, stride=2,
                              padding=1, output_padding=1)
    crop = C.classes(P)["CropUp"](w.shape[0], w.shape[1])
    state = {"weight": w, "bias": bias}
    up.set_state_dict(state)
    crop.conv.set_state_dict(state)
    yield up, crop


def test_the_reference_zero_fills_the_output_padding_row_and_column():
    """The reference's output_padding layer equals the scatter (its crop
    form) everywhere but the last row and column, which it leaves 0;
    the port's equals the scatter there too."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    w = (rng.randn(4, 3, 3, 3) * 0.5).astype(np.float32)
    bias = np.zeros(3, np.float32)
    with Jdy.guard(), _both_upsamplings(J, w, bias) as (up, crop):
        ref_up = _np(up(J.to_tensor(x)))
        ref_crop = _np(crop(J.to_tensor(x)))
    with _both_upsamplings(T, w, bias) as (up, crop):
        port_up = _np(up(torch.from_numpy(x)))
        port_crop = _np(crop(torch.from_numpy(x)))
    assert ref_up.shape == ref_crop.shape == port_up.shape == (1, 3, 10, 10)
    np.testing.assert_allclose(ref_up[..., :-1, :-1],
                               ref_crop[..., :-1, :-1], **F32)
    assert not ref_up[..., -1, :].any() and not ref_up[..., :, -1].any()
    assert np.abs(ref_crop[..., -1, :]).max() > 0.1
    np.testing.assert_allclose(port_up, port_crop, **F32)
    np.testing.assert_allclose(port_crop, ref_crop, **F32)


def test_three_port_steps_move_every_parameter_and_lower_the_cycle_loss():
    nets = C.build(T, CFG, seed=0)
    before = {k: [p.detach().clone() for p in n.parameters()]
              for k, n in nets.items()}
    opts, pool = C.optimizers(T, nets, CFG), C.pools(CFG)
    a, b = (torch.from_numpy(x) for x in C.images(CFG))
    cycle = []
    for _ in range(3):
        losses = C.train_step(T, nets, opts, pool, a, b, CFG)
        cycle.append(float(losses["cycle_A"] + losses["cycle_B"]))
    assert cycle[-1] < cycle[0]
    for k, n in nets.items():
        for p, p0 in zip(n.parameters(), before[k]):
            assert not torch.equal(p.detach(), p0), k
    assert len(pool["A"].images) == 3
