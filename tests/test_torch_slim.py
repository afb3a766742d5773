"""fluid.contrib.slim against paddle_tpu's on the CPU.

- QuantizationTransformPass: the rewritten Program's JSON equals the
  reference's (the same ops in the same places, the same names, the same
  persistable observer vars in the startup program) for a small conv
  and fc program under each weight and activation quantize type, and for
  the cut MobileNet-SSD (tests/torch_ssd_program.py, quant=True).
- The cut quantization-aware SSD program through both Executors, 3
  steps each from the reference's state.  Quantization is piecewise
  constant, so the packages' float32 rounding moves a few values across
  a level boundary, and a moved largest value moves its layer's abs-max
  scale and with it the whole layer's grid (measured on this CPU: 2 of
  819200 values one level apart at the second quantized input; the
  loss 0.017 %, 0.25 % and 0.11 % apart over the 3 steps; the observer
  scales of the batch norms on the 1x1 maps, which multiply what comes
  in, up to 9 % apart).  Held: the
  first quantized input to its last bit (its dequantization's product
  rounds in another order), the second's differing values one level
  apart in under 1e-3 of them, the losses within QAT_LOSS_RTOL (2e-2)
  and every observer scale within QAT_SCALE (relative 0.3), finite and
  positive.
- ImperativeQuantAware on a small Conv2D + Linear net, the reference's
  weights carried over: two calls' outputs (the moving-average observer
  moving between them) and the gradients of the input and of every
  parameter under the same cotangent, within F32 (one small net in
  float32, summation order only).
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.fluid as JF
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.jit import functional_state as j_state

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_state

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ssd_program as S  # noqa: E402
from test_torch_ssd import Pair, _rel  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
QAT_LOSS_RTOL = 2e-2
QAT_SCALE = 0.3


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


@contextlib.contextmanager
def _fresh_jax_stream():
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _small_net(fluid, **pass_kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 4, 8, 8], "float32")
        y = fluid.layers.conv2d(x, 4, 3, padding=1, groups=4)
        y = fluid.layers.conv2d(y, 6, 1, act="relu")
        z = fluid.layers.fc(y, 5)
        loss = fluid.layers.reduce_mean(z)
        fluid.contrib.slim.QuantizationTransformPass(**pass_kw).apply(
            main, startup)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup


@pytest.mark.parametrize("kw", [
    {}, {"weight_quantize_type": "channel_wise_abs_max"},
    {"activation_quantize_type": "abs_max", "weight_bits": 4},
    {"quantizable_op_type": ["conv2d"]}])
def test_transform_pass_rewrites_as_the_reference(kw):
    jm, js = _small_net(JF, **kw)
    tm, ts = _small_net(TF, **kw)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    quant = [op.type for op in tm.global_block().ops
             if op.type.startswith("fake_") and not op.type.endswith("_grad")]
    assert len(quant) == (2 if kw.get("quantizable_op_type") else 6)


def test_transform_pass_raises_as_the_reference():
    for pkg in (JF, TF):
        with pytest.raises(ValueError, match="weight_quantize_type"):
            pkg.contrib.slim.QuantizationTransformPass(
                weight_quantize_type="range_abs_max")


def test_qat_ssd_program_is_the_references():
    jm, js, _ = S.build(JF, S.SMALL, quant=True)
    tm, ts, _ = S.build(TF, S.SMALL, quant=True)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    types = [op.type for op in tm.global_block().ops]
    convs = sum(t in ("conv2d", "depthwise_conv2d") for t in types)
    # every convolution's weight, and each distinct input once
    assert types.count("fake_quantize_dequantize_abs_max") == convs


def test_qat_cut_program_in_both_executors_up_to_level_flips():
    """QAT's forward is piecewise constant: a value within float32
    rounding of a level boundary takes the other level in one package.
    On the first step the image's quantization is the reference's to
    its last bit and the next layer's differs in a few elements by
    exactly one level; over 3 steps (each from the reference's state)
    the losses and the observer scales stay within QAT_LOSS_RTOL and
    QAT_SCALE and every scale is finite and positive."""
    jm, js, jo = S.build(JF, S.SMALL, quant=True)
    pair = Pair(jm, js)
    feed = S.batch(S.SMALL)
    acts = [op for op in jm.global_block().ops if op.type ==
            "fake_quantize_dequantize_moving_average_abs_max"][:2]
    fetch = [jo["loss"].name] + [op.outputs[s][0] for op in acts
                                 for s in ("Out", "OutScale")]
    scales = [n for n in pair.jscope.local_var_names()
              if ".quant_scale" in n]
    assert len(scales) > 30
    losses = []
    for i in range(3):
        want, got = pair.step(feed, fetch)
        losses.append((float(want[0]), float(got[0])))
        np.testing.assert_allclose(got[0], want[0], rtol=QAT_LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(got[1], want[1], rtol=3e-7, atol=0)
            step = float(want[4].reshape(-1)[0]) / 127
            off = np.abs(got[3] - want[3]) > step / 2
            assert off.mean() < 1e-3
            np.testing.assert_allclose(np.abs(got[3] - want[3])[off], step,
                                       rtol=1e-3)
        for n in scales:
            w = np.asarray(pair.jscope.get(n))
            g = pair.tscope.get(n).numpy()
            assert np.isfinite(g).all() and (g > 0).all(), n
            assert _rel(g, w) <= QAT_SCALE, (i, n)
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]


class _Net:
    """Conv2D(3 -> 4, 3) + ReLU + Flatten + Linear(4 * 4 * 4 -> 5) in
    either package's nn."""

    def __init__(self, nn):
        self.layers = nn.Sequential(nn.Conv2D(3, 4, 3), nn.ReLU(),
                                    nn.Flatten(), nn.Linear(64, 5))


@pytest.mark.parametrize("w_type", ["abs_max", "channel_wise_abs_max"])
def test_imperative_quant_aware_as_the_reference(w_type):
    x = np.random.RandomState(0).randn(2, 3, 6, 6).astype(np.float32)
    ct = np.random.RandomState(1).randn(2, 5).astype(np.float32)
    with _fresh_jax_stream(), Jdy.guard():
        jnet = _Net(J.nn).layers
        state = {k: np.asarray(v) for k, v in j_state(jnet).items()}
        JF.contrib.slim.ImperativeQuantAware(
            weight_quantize_type=w_type).quantize(jnet)
        want = []
        for _ in range(2):
            jx = J.to_tensor(x, stop_gradient=False)
            out = jnet(jx)
            want.append(np.asarray(out.numpy()))
        J.sum(J.multiply(out, J.to_tensor(ct))).backward()
        jgrads = {"x": np.asarray(jx.grad.numpy())}
        jgrads.update({n: np.asarray(p.grad.numpy())
                       for n, p in jnet.named_parameters()})
    tnet = _Net(T.nn).layers
    load_jax_state(tnet, state)
    TF.contrib.slim.ImperativeQuantAware(
        weight_quantize_type=w_type).quantize(tnet)
    assert all(getattr(m, "_quantized", False) for m in (tnet[0], tnet[3]))
    for i in range(2):
        tx = torch.from_numpy(x).requires_grad_()
        out = tnet(tx)
        np.testing.assert_allclose(out.detach().numpy(), want[i],
                                   err_msg=f"call {i}", **F32)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jgrads["x"], **F32)
    for n, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], err_msg=n,
                                   **F32)
