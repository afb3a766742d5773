"""The Paddle-named Tensor methods and the rest of `fluid.dygraph` against
paddle_tpu on the CPU: each method the port adds to torch.Tensor (and
the three of math_op_patch) against the reference's eager Tensor on the
same seeded numpy inputs; plain torch code in the same process
unchanged; the 1.x layer classes of fluid/dygraph/nn.py against the
reference's at the same weights (forward, the inputs' and parameters'
gradients), its five 1.x LR classes step by step; `.pdparams` written by
`save_dygraph` loading in both packages; `trace_op`,
`Layer.create_variable` and the names the port leaves out.

Tolerances: F32 (rtol 1e-5, atol 1e-6), a few float32 operations whose
only difference is the order of summation; LR values to float rounding
(rtol 1e-12); everything else exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.jit import functional_state as j_state

import paddle_tpu_torch as T
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.fluid import dygraph as Tdy
from paddle_tpu_torch.fluid.dygraph import math_op_patch, varbase
from test_torch_nn_remainder import F32, _f, _fresh_jax_stream, _run_both


def _ref(x, stop_gradient=True):
    return J.to_tensor(x, stop_gradient=stop_gradient)


# -- the decision: which names, and plain torch unchanged --------------------------

def test_the_added_names_are_ones_torch_lacks():
    for name in list(varbase.METHODS) + list(math_op_patch.ADDED):
        assert not hasattr(torch._C.TensorBase, name), name
        assert getattr(torch.Tensor, name) is not None
    assert torch.Tensor.numpy is varbase.numpy
    varbase.install()  # idempotent
    math_op_patch.install()
    assert T.fluid.dygraph.Tensor is torch.Tensor \
        and T.fluid.dygraph.VarBase is torch.Tensor


def test_plain_torch_is_unchanged():
    """Code written for torch in the same process gets torch's answers:
    transpose of two dims, max over a dim as (values, indices), size()
    and shape as torch.Size, dtype a torch.dtype, matmul and unsqueeze of
    torch's arguments, and a CPU numpy() that shares memory."""
    x = torch.arange(6.0).reshape(2, 3)
    assert x.transpose(0, 1).shape == (3, 2)
    vals, idx = x.max(1)
    assert vals.tolist() == [2.0, 5.0] and idx.tolist() == [2, 2]
    assert isinstance(x.size(), torch.Size) and x.size() == (2, 3)
    assert isinstance(x.shape, torch.Size) and x.size(1) == 3
    assert x.dtype is torch.float32
    assert torch.equal(x.sum(1, True), torch.tensor([[3.0], [12.0]]))
    y = torch.ones(3, 2)
    assert torch.equal(x.matmul(y), torch.matmul(x, y))
    assert x.unsqueeze(1).shape == (2, 1, 3)
    assert x.unsqueeze(dim=-1).shape == (2, 3, 1)
    a = x.numpy()
    a[0, 0] = 7.0
    assert x[0, 0].item() == 7.0
    with pytest.raises(TypeError):
        x.transpose([1, 0])


def test_numpy_where_torch_would_raise():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = x * 3
    with pytest.raises(RuntimeError):
        varbase._TORCH_NUMPY(y)
    np.testing.assert_array_equal(y.numpy(), [3.0, 6.0])
    np.testing.assert_array_equal(y.numpy(force=True), [3.0, 6.0])
    with Jdy.guard():
        jy = _ref(np.array([1.0, 2.0], "float32"), False) * 3
        np.testing.assert_array_equal(jy.numpy(), y.numpy())


# -- each added method against the reference's Tensor -----------------------------

def test_astype_cast_place_persistable():
    a = _f(2, 3)
    t = torch.from_numpy(a)
    with Jdy.guard():
        j = _ref(a)
        for dt in ("float64", "int32", "float16"):
            np.testing.assert_array_equal(t.astype(dt).numpy(),
                                          j.astype(dt).numpy())
            np.testing.assert_array_equal(t.cast(dt).numpy(),
                                          j.cast(dt).numpy())
        assert t.place == j.place == "cpu:0"
        assert t.persistable is j.persistable is False
    t.persistable = True
    assert t.persistable is True
    assert T.nn.Linear(2, 2).weight.persistable is True


def test_stop_gradient_gradient_and_clear_gradient():
    a, w = _f(3), _f(3, seed=1)
    with Jdy.guard():
        jx = _ref(a, False)
        assert jx.stop_gradient is False and _ref(a).stop_gradient is True
        (jx * _ref(w)).sum().backward()
        want = jx.grad.numpy()
        jx.clear_gradient()
        assert jx.grad is None
    tx = torch.from_numpy(a.copy())
    assert tx.stop_gradient is True
    tx.stop_gradient = False
    assert tx.requires_grad and tx.stop_gradient is False
    assert tx.gradient() is None
    (tx * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.gradient(), want)
    tx.clear_gradient(set_to_zero=True)
    assert tx.grad is not None and not tx.grad.any()
    tx.clear_grad()
    assert tx.grad is None



@pytest.mark.parametrize("clear", ["tensor", "layer", "optimizer"])
def test_a_gradient_array_is_a_snapshot(clear):
    """An array `gradient()` gave keeps its values through a later
    backward's accumulation and `set_to_zero`, each way of clearing (the
    reference's is an immutable array, and set_to_zero rebinds zeros)."""
    lin = T.nn.Linear(3, 2)
    opt = T.optimizer.SGD(0.1, parameters=lin.parameters())
    x = torch.from_numpy(_f(4, 3))
    lin(x).sum().backward()
    w = lin.weight
    got = w.gradient()
    want = got.copy()
    lin(x).sum().backward()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(w.gradient(), 2 * want)
    if clear == "tensor":
        w.clear_gradient(set_to_zero=True)
    elif clear == "layer":
        lin.clear_gradients(set_to_zero=True)
    else:
        opt.clear_grad(set_to_zero=True)
    np.testing.assert_array_equal(got, want)
    assert w.grad is not None and not w.grad.any()
    assert not w.gradient().any()

def test_set_value():
    a, b = _f(2, 3), _f(2, 3, seed=1)
    t = torch.from_numpy(a.copy())
    t.set_value(b.astype("float64"))
    with Jdy.guard():
        j = _ref(a)
        j.set_value(b.astype("float64"))
        np.testing.assert_array_equal(t.numpy(), j.numpy())
        with pytest.raises(ValueError, match="shape mismatch"):
            j.set_value(np.zeros((3, 2)))
    assert t.dtype is torch.float32
    with pytest.raises(ValueError, match="shape mismatch"):
        t.set_value(np.zeros((3, 2)))
    p = T.nn.Linear(2, 2).weight
    p.set_value(np.ones((2, 2)))
    assert p.requires_grad and p.detach().eq(1).all()


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_with_transposes(tx, ty):
    a = _f(2, 4, 3) if tx else _f(2, 3, 4)
    b = _f(5, 4, seed=1) if ty else _f(4, 5, seed=1)
    with Jdy.guard():
        want = _ref(a).matmul(_ref(b), transpose_x=tx,
                              transpose_y=ty).numpy()
    got = torch.from_numpy(a).matmul(torch.from_numpy(b), transpose_x=tx,
                                     transpose_y=ty)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("axis", [0, [0, 2], [-1], [1, -1], (3, 0)])
def test_unsqueeze_and_scale(axis):
    a = _f(2, 3)
    with Jdy.guard():
        want = _ref(a).unsqueeze(axis).numpy()
        scaled = _ref(a).scale(2.5, -1.0).numpy()
    assert torch.from_numpy(a).unsqueeze(axis).shape == want.shape
    np.testing.assert_allclose(torch.from_numpy(a).scale(2.5, -1.0).numpy(),
                               scaled, **F32)


# -- the 1.x layer classes ------------------------------------------------------

# name -> (constructor args, kwargs, forward inputs, input gradients)
LAYERS_1X = {
    "Linear": ((3, 4), {"act": "tanh"}, (_f(2, 3),), (0,)),
    "Conv2D": ((2, 3, 3), {"padding": 1, "act": "relu"}, (_f(2, 2, 5, 5),),
               (0,)),
    "Conv2DTranspose": ((2, 3, 3), {"stride": 2, "padding": 1,
                                    "act": "sigmoid"}, (_f(1, 2, 3, 3),),
                        (0,)),
    "Conv3D": ((2, 3, 2), {"padding": [1, 0, 1], "act": "relu"},
               (_f(1, 2, 3, 4, 4),), (0,)),
    "Conv3DTranspose": ((2, 2, 2), {"stride": 2}, (_f(1, 2, 2, 3, 3),), (0,)),
    "BatchNorm": ((3,), {"act": "relu"}, (_f(4, 3, 2, 2),), (0,)),
    "Embedding": (([10, 4],), {"padding_idx": 2},
                  (np.array([[1, 2, 3], [9, 0, 2]]),), ()),
    "Flatten": ((), {"start_axis": 1, "stop_axis": 2}, (_f(2, 3, 4, 2),),
                (0,)),
    "PRelu": ((), {"mode": "all"}, (_f(2, 3, 4),), (0,)),
    "BilinearTensorProduct": ((3, 4, 2), {"act": "tanh"},
                              (_f(5, 3), _f(5, 4, seed=1)), (0, 1)),
    "Pool2D": ((2, "max", 2), {}, (_f(2, 3, 4, 4),), (0,)),
    "Pool2D_avg": ((3, "avg", 1), {"pool_padding": 1}, (_f(1, 2, 5, 5),),
                   (0,)),
}


@pytest.mark.parametrize("key", sorted(LAYERS_1X))
def test_1x_layer_matches_the_reference(key):
    name = key.split("_")[0]
    ctor, kw, inputs, grad = LAYERS_1X[key]
    with _fresh_jax_stream(), Jdy.guard():
        jl = getattr(Jdy, name)(*ctor, **kw)
        state = {k: np.asarray(v) for k, v in j_state(jl).items()}
    tl = getattr(Tdy, name)(*ctor, **kw)
    assert isinstance(tl, getattr(T.fluid.dygraph.nn, name))
    load_jax_state(tl, state)
    jp, tp = dict(jl.named_parameters()), dict(tl.named_parameters())
    assert set(jp) == set(tp)
    _run_both(jl, tl, inputs, {}, grad, F32, (jp, tp))


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_1x_dropout_is_test(impl):
    """At inference 1.x's downgrade_in_infer scales by 1 - p, the other
    mode passes x through."""
    x = _f(4, 5)
    with Jdy.guard():
        want = Jdy.Dropout(0.3, dropout_implementation=impl,
                           is_test=True)(_ref(x)).numpy()
    got = Tdy.Dropout(0.3, dropout_implementation=impl,
                      is_test=True)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_1x_layers_that_raise_in_both():
    """GRUUnit hands its default activation names to a rule that reads
    integer codes; PRelu with an alpha a channel reaches the prelu op's
    one-alpha form (ROADMAP queue 3 item 13); TreeConv is not carried;
    NCE takes only uniform sampling."""
    x, h = _f(2, 6), _f(2, 2)
    y = _f(2, 3, 4)
    with Jdy.guard(), pytest.raises(TypeError):
        Jdy.PRelu(mode="channel", channel=3)(_ref(y))
    with pytest.raises(RuntimeError):
        Tdy.PRelu(mode="channel", channel=3)(torch.from_numpy(y))
    with Jdy.guard(), pytest.raises(Exception) as want:
        Jdy.GRUUnit(6)(_ref(x), _ref(h))
    with pytest.raises(type(want.value)):
        Tdy.GRUUnit(6)(torch.from_numpy(x), torch.from_numpy(h))
    for D in (Jdy, Tdy):
        with pytest.raises(NotImplementedError, match="TreeConv"):
            D.TreeConv(4, 4)
        with pytest.raises(NotImplementedError, match="uniform"):
            D.NCE(10, 4, sampler="log_uniform")
    nce = Tdy.NCE(10, 4, num_neg_samples=3)
    assert nce.weight.shape == (10, 4) and nce.bias.shape == (10, 1)


@pytest.mark.parametrize("name,args,kw", [
    ("NaturalExpDecay", (0.5, 3, 0.4), {}),
    ("NaturalExpDecay", (0.5, 3, 0.4), {"staircase": True}),
    ("ExponentialDecay", (0.5, 2, 0.8), {"staircase": True}),
    ("InverseTimeDecay", (0.5, 4, 0.3), {}),
    ("CosineDecay", (0.5, 3, 5), {}),
    ("PiecewiseDecay", ([2, 5], [0.5, 0.1, 0.01]), {"begin": 1}),
    ("LinearLrWarmup", (0.5, 4, 0.0, 0.5), {}),
    ("StepDecay", (0.5, 3), {"gamma": 0.5}),
])
def test_1x_lr_classes_step_as_the_reference(name, args, kw):
    jl = getattr(Jdy, name)(*args, **kw)
    tl = getattr(Tdy, name)(*args, **kw)
    for _ in range(12):
        np.testing.assert_allclose(tl(), jl(), rtol=1e-12)
        jl.step()
        tl.step()


# -- save_dygraph / load_dygraph, trace_op, create_variable, the aliases ----------

def test_pdparams_load_in_both_packages(tmp_path):
    with _fresh_jax_stream(), Jdy.guard():
        jl = Jdy.Linear(3, 2)
        jstate = {k: np.asarray(v.numpy()) for k, v in
                  jl.state_dict().items()}
        Jdy.save_dygraph(jl.state_dict(), str(tmp_path / "ref"))
        jopt = J.optimizer.Adam(learning_rate=0.1,
                                parameters=jl.parameters())
    tl = Tdy.Linear(3, 2)
    port_w = tl.weight.numpy().copy()
    Tdy.save_dygraph(tl.state_dict(), str(tmp_path / "port"))
    topt = T.optimizer.Adam(learning_rate=0.1, parameters=tl.parameters())
    Tdy.save_dygraph(topt.state_dict(), str(tmp_path / "port"))
    assert (tmp_path / "port.pdparams").exists() \
        and (tmp_path / "port.pdopt").exists()
    params, opt = Tdy.load_dygraph(str(tmp_path / "ref"))
    assert opt is None and set(params) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(params[k], v)
    tl.set_state_dict(params)
    np.testing.assert_array_equal(tl.weight.numpy(), jstate["weight"])
    with Jdy.guard():
        jparams, jopt_state = Jdy.load_dygraph(str(tmp_path / "port"))
        jl.set_state_dict(jparams)
        np.testing.assert_array_equal(jl.weight.numpy(), port_w)
        assert "global_step" in jopt_state
        jopt.set_state_dict(jopt_state)
    assert Tdy.load_dygraph(str(tmp_path / "none")) == (None, None)


def test_trace_op_runs_one_rule():
    x = _f(2, 5)
    with Jdy.guard():
        want = Jdy.trace_op("scale", {"X": _ref(x)},
                            {"scale": 2.0, "bias": 1.0}).numpy()
        jtop = Jdy.trace_op("top_k_v2", {"X": _ref(x)}, {"k": 2})
    got = Tdy.trace_op("scale", {"X": torch.from_numpy(x)},
                       {"scale": 2.0, "bias": 1.0})
    np.testing.assert_allclose(got.numpy(), want, **F32)
    top = Tdy.trace_op("top_k_v2", {"X": torch.from_numpy(x)}, {"k": 2})
    np.testing.assert_array_equal(top["Out"][0].numpy(),
                                  jtop["Out"][0].numpy())
    assert isinstance(Tdy.trace_op("scale", {"X": torch.from_numpy(x)}, {},
                                   multi_out=True), dict)


def test_create_variable():
    """A [1] zero tensor with `persistable` set; the reference makes a
    float64 request float32 (its eager Tensor narrows numpy's float64),
    the port keeps the dtype asked for."""
    with Jdy.guard():
        want = J.nn.Layer().create_variable(persistable=True)
        want_np = want.numpy()
    got = T.nn.Layer().create_variable(persistable=True)
    np.testing.assert_array_equal(got.numpy(), want_np)
    assert got.numpy().dtype == want_np.dtype
    assert got.persistable is want.persistable is True
    assert T.nn.Layer().create_variable().persistable is False
    assert T.nn.Layer().create_variable(dtype="float64").dtype \
        is torch.float64


def test_the_aliases_and_the_names_left_out():
    """Every name of the reference's _NN_ALIASES resolves in the port, to
    the port's class of that name (amp_guard and AmpScaler to auto_cast
    and GradScaler); the jit names raise naming queue 1 item 12;
    prepare_context (with no job of several ranks: no group) gives the
    ParallelEnv of one rank, and DataParallel is the 2.x top level's."""
    for name in Jdy._NN_ALIASES:
        obj = getattr(Tdy, name)
        assert obj.__name__ == getattr(Jdy, name).__name__ \
            or name in ("InstanceNorm", "LinearLrWarmup",
                        "ReduceLROnPlateau"), name
    assert Tdy.amp_guard is T.amp.auto_cast
    assert Tdy.AmpScaler is T.amp.GradScaler
    assert Tdy.Linear is T.fluid.dygraph.nn.Linear
    for name in ("declarative", "dygraph_to_static_func", "set_code_level",
                 "set_verbosity", "TracedLayer", "TranslatedLayer",
                 "ProgramTranslator"):
        with pytest.raises(NotImplementedError, match="item 12"):
            getattr(Tdy, name)()
    env = Tdy.prepare_context()
    assert isinstance(env, Tdy.ParallelEnv)
    assert (env.rank, env.nranks) == (0, 1)
    assert Tdy.DataParallel is T.DataParallel
    assert Tdy.DataParallel.__name__ == Jdy.DataParallel.__name__
    assert Tdy.load is T.load and Tdy.save is T.save
    with Tdy.no_grad_():
        assert not torch.is_grad_enabled()
