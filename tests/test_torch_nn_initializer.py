"""`nn.initializer`'s twelve names against paddle_tpu's on the CPU.

- The port has every name of the reference's `nn.initializer`.
- Each drawing initializer (XavierUniform / XavierNormal /
  XavierInitializer, KaimingUniform / KaimingNormal / MSRAInitializer,
  with and without a given fan) through `weight_attr` of nn.Linear,
  nn.Conv2D and nn.Conv2DTranspose in both packages: the draw's standard
  deviation against the one the reference's fans give, and the uniform
  draws' bound.  Sampling tolerance: over the 18432-32768 elements of
  each weight the sample standard deviation is within 1.5 % of the
  truth at 3 standard errors; STD_RTOL is 4 %, the mean within 4
  standard errors of 0, every uniform element inside the bound and the
  largest above 0.99 of it.
- Bilinear gives the reference's kernel exactly, Assign the given values.
- In a static program the names append the reference's startup ops (the
  same Program JSON).
"""

import json
import math

import numpy as np
import pytest

import paddle_tpu as J
from paddle_tpu import nn as JN

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import nn as TN

import paddle_tpu.fluid as JF

NAMES = ["Assign", "Bilinear", "Constant", "KaimingNormal", "KaimingUniform",
         "MSRAInitializer", "Normal", "TruncatedNormal", "Uniform",
         "XavierInitializer", "XavierNormal", "XavierUniform"]
STD_RTOL = 0.04

# (layer, its arguments, the weight's (fan_in, fan_out) by the reference's
# _fan_in_out: Paddle's (in, out) Linear weight; [out, in, k, k] Conv2D;
# [in, out, k, k] Conv2DTranspose, whose fans are taken the same way)
LAYERS = {
    "Linear": ((256, 128), (256, 128)),
    "Conv2D": ((32, 64, 3), (32 * 9, 64 * 9)),
    "Conv2DTranspose": ((64, 32, 3), (32 * 9, 64 * 9)),
}
# (name, kwargs, uniform?, std from (fan_in, fan_out))
DRAWS = [
    ("XavierUniform", {}, True, lambda i, o: math.sqrt(2.0 / (i + o))),
    ("XavierNormal", {}, False, lambda i, o: math.sqrt(2.0 / (i + o))),
    ("XavierInitializer", {}, True, lambda i, o: math.sqrt(2.0 / (i + o))),
    ("XavierUniform", dict(fan_in=100, fan_out=60), True,
     lambda i, o: math.sqrt(2.0 / 160)),
    ("KaimingUniform", {}, True, lambda i, o: math.sqrt(2.0 / i)),
    ("KaimingNormal", {}, False, lambda i, o: math.sqrt(2.0 / i)),
    ("MSRAInitializer", {}, True, lambda i, o: math.sqrt(2.0 / i)),
    ("KaimingNormal", dict(fan_in=50), False, lambda i, o: math.sqrt(0.04)),
]


def test_every_reference_name_is_in_the_port():
    assert set(NAMES) <= set(dir(JN.initializer))
    missing = [n for n in NAMES if not hasattr(TN.initializer, n)]
    assert not missing


def _weight(pkg, nn, layer, init):
    args, _ = LAYERS[layer]
    attr = pkg.ParamAttr(initializer=init)
    w = getattr(nn, layer)(*args, weight_attr=attr).weight
    return np.asarray(w.numpy() if hasattr(w, "numpy") else w,
                      np.float64)


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("case", range(len(DRAWS)),
                         ids=[f"{d[0]}{'-fan' if d[1] else ''}"
                              for d in DRAWS])
def test_draws_follow_the_reference_fans(case, layer):
    name, kw, uniform, std_of = DRAWS[case]
    want = std_of(*LAYERS[layer][1])
    for pkg, nn in ((J, JN), (T, TN)):
        w = _weight(pkg, nn, layer, getattr(nn.initializer, name)(**kw))
        n = w.size
        assert abs(w.std() / want - 1) < STD_RTOL, (pkg.__name__, w.std())
        assert abs(w.mean()) < 4 * want / math.sqrt(n)
        if uniform:
            bound = want * math.sqrt(3.0)
            assert np.abs(w).max() <= bound * (1 + 1e-6)
            assert np.abs(w).max() > 0.99 * bound


def test_bilinear_is_the_references_kernel():
    ws = [_weight(pkg, nn, "Conv2DTranspose", nn.initializer.Bilinear())
          for pkg, nn in ((J, JN), (T, TN))]
    assert ws[0].shape == (64, 32, 3, 3)
    np.testing.assert_array_equal(ws[1], ws[0])
    k = T.nn.Conv2DTranspose(2, 2, 4, weight_attr=T.ParamAttr(
        initializer=TN.initializer.Bilinear())).weight.detach().numpy()
    np.testing.assert_array_equal(k[1, 0], np.outer(
        [0.25, 0.75, 0.75, 0.25], [0.25, 0.75, 0.75, 0.25]))


def test_assign_gives_the_values():
    v = np.random.RandomState(0).randn(6, 4).astype("float32")
    for pkg, nn in ((J, JN), (T, TN)):
        w = nn.Linear(6, 4, weight_attr=pkg.ParamAttr(
            initializer=nn.initializer.Assign(v))).weight
        np.testing.assert_array_equal(
            np.asarray(w.numpy() if hasattr(w, "numpy") else w), v)
    with pytest.raises(ValueError):
        TN.Linear(4, 4, weight_attr=T.ParamAttr(
            initializer=TN.initializer.Assign(v)))


@pytest.mark.parametrize("name", ["XavierUniform", "KaimingNormal",
                                  "MSRAInitializer", "Bilinear"])
def test_static_programs_take_them_as_the_reference(name):
    progs = []
    for fluid, nn in ((JF, JN), (TF, TN)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 4, 8, 8], "float32")
            fluid.layers.conv2d(x, 4, 4, param_attr=fluid.ParamAttr(
                initializer=getattr(nn.initializer, name)()))
        progs.append(json.dumps(startup.to_dict(), sort_keys=True,
                                default=str))
    assert progs[1] == progs[0]
