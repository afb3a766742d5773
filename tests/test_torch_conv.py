"""The port's convolution, pooling and batch-norm functions and layers
against paddle_tpu.nn.functional on the CPU, in float32, on the same
numpy inputs.

Tolerances: CONV (atol 2e-5, rtol 1e-5) covers the other summation order
of a convolution's f32 products (at most 3 x 5 x 5 x 4 terms here);
pooling is exact arithmetic up to one f32 division (POOL: 1e-6); batch
norm's statistics differ by the variance formula (E[x^2] - E[x]^2 in
the reference, a two-pass variance in torch), BN: 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

CONV = dict(atol=2e-5, rtol=1e-5)
POOL = dict(atol=1e-6, rtol=1e-6)
BN = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*[None if a is None else P.to_tensor(a)
                           for a in arrays], **kw).numpy())


def _torch(fn, *arrays, **kw):
    return fn(*[None if a is None else torch.from_numpy(a)
                for a in arrays], **kw).numpy()


# -- conv2d -------------------------------------------------------------------

CONV_CASES = {
    "int": dict(padding=1),
    "pair": dict(padding=(1, 2)),
    "asymmetric": dict(padding=[0, 1, 2, 1]),
    "same-stride2": dict(padding="SAME", stride=2),
    "same-dilation2": dict(padding="SAME", dilation=2),
    "valid": dict(padding="VALID"),
    "stride2": dict(padding=1, stride=2),
    "dilation2": dict(padding=2, dilation=2),
    "groups2": dict(padding=1, groups=2),
    "stride-pair": dict(padding=0, stride=(2, 1)),
}


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case, data_format):
    kw = dict(CONV_CASES[case], data_format=data_format)
    groups = kw.get("groups", 1)
    x = _rand(1, 2, 4, 9, 10)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _rand(2, 6, 4 // groups, 3, 5) * 0.3
    b = _rand(3, 6)
    want = _jax(JF.conv2d, x, w, b, **kw)
    got = _torch(TF.conv2d, x, w, b, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CONV)


def test_conv2d_same_padding_is_xlas_rule():
    # total = max((ceil(H/s) - 1) s + (k - 1) d + 1 - H, 0); low = total // 2
    assert TF._same_pads(9, 3, 2, 1) == (1, 1)
    assert TF._same_pads(10, 3, 2, 1) == (0, 1)
    assert TF._same_pads(10, 3, 1, 2) == (2, 2)
    assert TF._same_pads(5, 1, 2, 1) == (0, 0)


# -- pooling ------------------------------------------------------------------

POOL_CASES = {
    "int": dict(kernel_size=3, stride=2, padding=1),
    "asymmetric": dict(kernel_size=3, stride=2, padding=[0, 1, 1, 0]),
    "same": dict(kernel_size=3, stride=2, padding="SAME"),
    "valid": dict(kernel_size=2, stride=None, padding="VALID"),
    "wide-pad": dict(kernel_size=2, stride=1, padding=[2, 2, 1, 1]),
}


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool2d_matches_reference(case, data_format):
    x = _rand(4, 2, 3, 9, 8)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(POOL_CASES[case], data_format=data_format)
    np.testing.assert_allclose(_torch(TF.max_pool2d, x, **kw),
                               _jax(JF.max_pool2d, x, **kw), **POOL)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool2d_matches_reference(case, exclusive):
    x = _rand(5, 2, 3, 9, 8)
    kw = dict(POOL_CASES[case], exclusive=exclusive)
    np.testing.assert_allclose(_torch(TF.avg_pool2d, x, **kw),
                               _jax(JF.avg_pool2d, x, **kw), **POOL)


def test_avg_pool2d_nhwc_matches_reference():
    x = np.ascontiguousarray(_rand(6, 2, 3, 9, 8).transpose(0, 2, 3, 1))
    kw = dict(kernel_size=3, stride=2, padding="SAME", data_format="NHWC")
    np.testing.assert_allclose(_torch(TF.avg_pool2d, x, **kw),
                               _jax(JF.avg_pool2d, x, **kw), **POOL)


@pytest.mark.parametrize("size,out", [(7, 3), (5, 7), (8, (1, 1)),
                                      (6, (4, 3))])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool2d_matches_reference(kind, size, out):
    x = _rand(7, 2, 3, size, size + 1)
    t_fn, j_fn = ((TF.adaptive_avg_pool2d, JF.adaptive_avg_pool2d)
                  if kind == "avg" else
                  (TF.adaptive_max_pool2d, JF.adaptive_max_pool2d))
    np.testing.assert_allclose(_torch(t_fn, x, output_size=out),
                               _jax(j_fn, x, output_size=out), **POOL)


def test_adaptive_avg_pool2d_nhwc_matches_reference():
    x = np.ascontiguousarray(_rand(8, 2, 3, 7, 7).transpose(0, 2, 3, 1))
    np.testing.assert_allclose(
        _torch(TF.adaptive_avg_pool2d, x, output_size=3, data_format="NHWC"),
        _jax(JF.adaptive_avg_pool2d, x, output_size=3, data_format="NHWC"),
        **POOL)


def test_ceil_mode_and_masks_raise():
    """paddle_tpu's pool2d lowering never reads ceil_mode (it floors);
    the port refuses it rather than differ silently."""
    x = torch.zeros(1, 1, 5, 5)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        TF.max_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        TF.avg_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="return_mask"):
        TF.max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        TN.MaxPool2D(2, ceil_mode=True)(x)


# -- batch_norm ---------------------------------------------------------------

def _bn_inputs(seed, shape, c):
    x = _rand(seed, *shape) * 2.0 + 0.5
    return (x, _rand(seed + 1, c) * 0.1, np.abs(_rand(seed + 2, c)) + 0.5,
            _rand(seed + 3, c), _rand(seed + 4, c))


def _bn_both(x, mean, var, w, b, **kw):
    """(port output, port mean, port var), (the same from the reference)."""
    tm, tv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    got = TF.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                        torch.from_numpy(b), **kw).numpy()
    jm, jv = P.to_tensor(mean.copy()), P.to_tensor(var.copy())
    want = np.asarray(JF.batch_norm(P.to_tensor(x), jm, jv, P.to_tensor(w),
                                    P.to_tensor(b), **kw).numpy())
    return (got, tm.numpy(), tv.numpy()), (want, np.asarray(jm.numpy()),
                                           np.asarray(jv.numpy()))


@pytest.mark.parametrize("shape,data_format", [
    ((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"), ((8, 3), "NCHW")])
def test_batch_norm_train_matches_reference(shape, data_format):
    c = shape[1] if data_format == "NCHW" else shape[-1]
    x, mean, var, w, b = _bn_inputs(10, shape, c)
    got, want = _bn_both(x, mean, var, w, b, training=True,
                         data_format=data_format)
    for g, wt, name in zip(got, want, ("y", "_mean", "_variance")):
        np.testing.assert_allclose(g, wt, err_msg=name, **BN)
    # the running statistics moved, by the biased batch variance
    axes = tuple(i for i in range(x.ndim) if i != x.shape.index(c))
    np.testing.assert_allclose(
        got[2], var * 0.9 + x.var(axis=axes) * 0.1, **BN)


@pytest.mark.parametrize("kw", [dict(training=False),
                                dict(training=True, use_global_stats=True),
                                dict(training=False, data_format="NHWC")])
def test_batch_norm_running_stats_path_matches_reference(kw):
    shape = (4, 5, 6, 3) if kw.get("data_format") == "NHWC" else (4, 3, 5, 6)
    x, mean, var, w, b = _bn_inputs(20, shape, 3)
    got, want = _bn_both(x, mean, var, w, b, **kw)
    for g, wt, name in zip(got, want, ("y", "_mean", "_variance")):
        np.testing.assert_allclose(g, wt, err_msg=name, **BN)
    np.testing.assert_array_equal(got[1], mean)  # no update
    np.testing.assert_array_equal(got[2], var)


# -- layers -------------------------------------------------------------------

def test_conv2d_layer_parameters_are_the_references():
    g = torch.Generator().manual_seed(0)
    conv = TN.Conv2D(6, 8, 3, groups=2, generator=g)
    assert dict((k, tuple(v.shape)) for k, v in conv.named_parameters()) == {
        "weight": (8, 3, 3, 3), "bias": (8,)}
    limit = np.sqrt(6.0 / (3 * 3 * 3))  # MSRA uniform, fan_in in/groups*k*k
    w = conv.weight.detach()
    assert limit >= float(w.abs().max()) > 0.9 * limit
    assert not conv.bias.any()
    assert [k for k, _ in TN.Conv2D(3, 4, 1, bias_attr=False)
            .named_parameters()] == ["weight"]


def test_msra_matches_the_reference_fan_in():
    g = torch.Generator().manual_seed(1)
    w = TI.MSRA()((64, 32), g)  # a (in, out) weight: fan_in = 64
    assert float(w.abs().max()) <= np.sqrt(6.0 / 64)
    w = TI.MSRA(uniform=False, fan_in=50)((4000,), g)
    assert abs(float(w.std()) - np.sqrt(2.0 / 50)) < 0.01


def test_batch_norm_layer_names_and_update():
    bn = TN.BatchNorm2D(3)
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    assert [k for k, _ in bn.named_buffers()] == ["_mean", "_variance"]
    x = torch.from_numpy(_rand(30, 4, 3, 5, 5) + 2.0)
    bn.train()
    bn(x)
    assert float(bn._mean.min()) > 0.1  # 0.9 * 0 + 0.1 * ~2
    bn.eval()
    m = bn._mean.clone()
    bn(x)
    assert torch.equal(bn._mean, m)


def test_small_layers():
    x = torch.from_numpy(_rand(31, 2, 3, 4, 5) * 8)
    assert TN.Flatten()(x).shape == (2, 60)
    assert TN.Flatten(0, 1)(x).shape == (6, 4, 5)
    y = TN.ReLU6()(x)
    assert float(y.min()) == 0.0 and float(y.max()) == 6.0
    seq = TN.Sequential(TN.ReLU(), TN.BatchNorm2D(3))
    assert [k for k, _ in seq.named_buffers()] == ["1._mean", "1._variance"]
    pools = [TN.MaxPool2D(2), TN.AvgPool2D(2, exclusive=False),
             TN.AdaptiveAvgPool2D(1), TN.AdaptiveMaxPool2D((2, 2))]
    assert [tuple(p(x).shape) for p in pools] == [
        (2, 3, 2, 2), (2, 3, 2, 2), (2, 3, 1, 1), (2, 3, 2, 2)]
