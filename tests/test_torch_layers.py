"""The port's 2.x building blocks against paddle_tpu's on the CPU: `Layer`
(parameter names, `parameters()` order, `state_dict` keys, ParamAttr,
buffers, hooks), `.pdparams` both ways, the losses and their gradients,
`amp.auto_cast`'s cast points and `GradScaler`'s trajectory, tensor
creation, eager mode (`fluid.dygraph`) and the default device.

Tolerances: LOSS (rtol 1e-5, atol 1e-6) for float32 losses and their
input gradients, which only the order of float32 operations separates;
TOL32 (rtol 1e-4, atol 1e-5) for a model's logits through several
layers; BF16 (rtol 2^-7, atol 2^-7) for values computed in bfloat16,
where the two packages may round the same f32 sum differently by a unit
of bf16's last place.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as J
from paddle_tpu import amp as Jamp
from paddle_tpu import framework_io as JIO
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as T
from paddle_tpu_torch import amp as Tamp
from paddle_tpu_torch import device as Tdev
from paddle_tpu_torch import framework_io as TIO
from paddle_tpu_torch.fluid import dygraph as Tdy
from paddle_tpu_torch.fluid import framework as Tfw
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.fluid.param_attr import ParamAttr as TAttr
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as TM

LOSS = dict(rtol=1e-5, atol=1e-6)
TOL32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)


@pytest.fixture(autouse=True)
def _leave_global_rngs():
    """Leave numpy's and torch's global generators as each test found
    them: other files' tests in this process draw from them."""
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


@contextlib.contextmanager
def fresh_jax_stream():
    """paddle_tpu draws a layer's weights from one process-wide stream;
    draw from a fresh one and restore it (ROADMAP queue 3 item 6)."""
    saved = list(_jax_init._eager_seed)
    _jax_init._eager_seed[:] = [2023, 0]
    try:
        yield
    finally:
        _jax_init._eager_seed[:] = saved


@pytest.fixture
def on_cpu():
    """The port's default device set to the CPU, restored after."""
    saved = Tdev._CURRENT[0]
    Tdev.set_device("cpu")
    yield
    Tdev._CURRENT[0] = saved


def _pair(name):
    """(reference model, port model on the CPU) under fresh unique_name
    guards; the port's weights are the reference's."""
    build = {"lenet": (JM.LeNet, lambda: TM.LeNet(device="cpu")),
             "resnet18": (lambda: JM.resnet18(num_classes=10),
                          lambda: TM.resnet18(num_classes=10,
                                              device="cpu"))}[name]
    with fresh_jax_stream(), JU.guard():
        jm = build[0]()
    with TU.guard():
        tm = build[1]()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    missing, unexpected = tm.set_state_dict(state)
    assert missing == [] and unexpected == []
    return jm, tm


def _input(name, seed=0):
    rng = np.random.RandomState(seed)
    shape = (2, 1, 28, 28) if name == "lenet" else (2, 3, 64, 64)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
def test_names_order_and_keys_match(name):
    jm, tm = _pair(name)
    jp, tp = jm.parameters(), tm.parameters()
    assert [p.name for p in tp] == [p.name for p in jp]
    assert [tuple(p.shape) for p in tp] == [tuple(p.shape) for p in jp]
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert tm.full_name() == jm.full_name()


@pytest.mark.parametrize("name", ["lenet", "resnet18"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pdparams_load_both_ways(name, writer, tmp_path):
    """A .pdparams written by one package, loaded into the other's fresh
    model (other weights), gives the same eval logits."""
    jm, tm = _pair(name)
    path = str(tmp_path / "m.pdparams")
    with TU.guard():
        fresh_t = (TM.LeNet(device="cpu", seed=5) if name == "lenet"
                   else TM.resnet18(num_classes=10, device="cpu", seed=5))
    if writer == "reference":
        JIO.save(jm.state_dict(), path)
        assert fresh_t.set_state_dict(TIO.load(path)) == ([], [])
        tm = fresh_t
    else:
        TIO.save(tm.state_dict(), path)
        with fresh_jax_stream(), JU.guard():
            jm = JM.LeNet() if name == "lenet" else JM.resnet18(
                num_classes=10)
        jm.set_state_dict(JIO.load(path))
    x = _input(name)
    jm.eval()
    tm.eval()
    with Jdy.guard():
        want = jm(J.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL32)


def test_layer_api():
    with TU.guard():
        lin = T.nn.Linear(3, 2, weight_attr=TAttr(
            name="my_w", trainable=False, learning_rate=0.3,
            need_clip=False))
        other = T.nn.Linear(2, 2)
    with fresh_jax_stream(), JU.guard():
        JU.generate("linear")  # the reference's name for the second layer
        j_other = J.nn.Linear(2, 2)
    w = lin.weight
    assert w.name == "my_w" and not w.trainable and w.stop_gradient
    assert w.optimize_attr == {"learning_rate": 0.3} and not w.need_clip
    assert lin.bias.name == "linear_0.b_0" and lin.full_name() == "linear_0"
    assert [p.name for p in other.parameters()] == \
        [p.name for p in j_other.parameters()]
    w.trainable = True
    assert w.requires_grad
    # buffers: a non-persistable one stays out of state_dict
    lin.register_buffer("kept", np.ones(2, np.float32))
    lin.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert list(lin.state_dict()) == ["weight", "bias", "kept"]
    assert [n for n, _ in lin.named_buffers()] == ["kept", "scratch"]
    missing, unexpected = lin.set_state_dict(
        {"weight": np.ones((3, 2)), "extra": np.zeros(1)})
    assert missing == ["bias", "kept"] and unexpected == ["extra"]
    assert torch.equal(lin.weight.detach(), torch.ones(3, 2))
    with pytest.raises(ValueError):
        lin.set_state_dict({"bias": np.zeros(3)})
    # hooks
    seq = T.nn.Sequential(lin, T.nn.ReLU())
    pre = seq.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2,))
    post = seq.register_forward_post_hook(lambda layer, inp, out: out + 1)
    x = torch.ones(1, 3)
    assert torch.equal(seq(x), torch.relu(lin(x * 2)) + 1)
    pre.remove()
    post.remove()
    assert torch.equal(seq(x), torch.relu(lin(x)))
    assert seq.sublayers() == [lin, seq[1]]
    assert [n for n, _ in seq.named_sublayers(include_self=True)] == \
        ["", "0", "1"]
    seq(x).sum().backward()
    assert lin.weight.grad is not None
    seq.clear_gradients()
    assert lin.weight.grad is None
    seq.astype("bfloat16")
    assert lin.weight.dtype == torch.bfloat16 and isinstance(
        lin.weight, T.nn.Parameter)
    seq.to(dtype="float64")
    assert lin.bias.dtype == torch.float64 and lin.bias.name == \
        "linear_0.b_0"
    twin = copy.deepcopy(lin)
    assert twin.weight.name == "my_w" and twin.bias is not lin.bias
    assert torch.equal(twin.bias, lin.bias)


# -- losses -------------------------------------------------------------------

def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 5, (6, 1)).astype(np.int64)
    label[2, 0] = 3
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    return dict(
        logits=logits, label=label, probs=probs.astype(np.float32),
        soft=probs[::-1].copy().astype(np.float32),
        x=rng.randn(6, 5).astype(np.float32),
        y=rng.randn(6, 5).astype(np.float32),
        p=(1 / (1 + np.exp(-rng.randn(6, 5)))).astype(np.float32),
        t=rng.randint(0, 2, (6, 5)).astype(np.float32),
        w=rng.rand(5).astype(np.float32) + 0.5,
        pw=rng.rand(5).astype(np.float32) + 0.5,
        sign=np.sign(rng.randn(6, 5)).astype(np.float32))


LOSSES = {
    "ce_mean": lambda F, a: F.cross_entropy(a["logits"], a["label"]),
    "ce_sum_ignore": lambda F, a: F.cross_entropy(
        a["logits"], a["label"], ignore_index=3, reduction="sum"),
    "ce_weighted": lambda F, a: F.cross_entropy(a["logits"], a["label"],
                                                weight=a["w"]),
    "ce_none": lambda F, a: F.cross_entropy(a["logits"], a["label"],
                                            reduction="none"),
    "ce_soft": lambda F, a: F.cross_entropy(a["logits"], a["soft"],
                                            soft_label=True),
    "ce_probs": lambda F, a: F.cross_entropy(a["probs"], a["label"],
                                             use_softmax=False),
    "softmax_ce": lambda F, a: F.softmax_with_cross_entropy(
        a["logits"], a["label"]),
    "softmax": lambda F, a: F.softmax(a["logits"], axis=0),
    "log_softmax": lambda F, a: F.log_softmax(a["logits"]),
    "mse": lambda F, a: F.mse_loss(a["x"], a["y"]),
    "l1_sum": lambda F, a: F.l1_loss(a["x"], a["y"], reduction="sum"),
    "nll": lambda F, a: F.nll_loss(F.log_softmax(a["logits"]),
                                   a["label"][:, 0], weight=a["w"]),
    "bce": lambda F, a: F.binary_cross_entropy(a["p"], a["t"],
                                               weight=a["w"]),
    "bce_logits": lambda F, a: F.binary_cross_entropy_with_logits(
        a["x"], a["t"], pos_weight=a["pw"]),
    "kl_mean": lambda F, a: F.kl_div(a["x"], a["p"]),
    "kl_batchmean": lambda F, a: F.kl_div(a["x"], a["p"],
                                          reduction="batchmean"),
    "smooth_l1": lambda F, a: F.smooth_l1_loss(a["x"], a["y"], delta=0.7),
    "margin": lambda F, a: F.margin_ranking_loss(a["x"], a["y"],
                                                 a["sign"], margin=0.1),
}
DIFF = ("logits", "probs", "x", "p")


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient(name):
    a = _loss_inputs(1)
    with Jdy.guard():
        ja = {k: J.to_tensor(v, stop_gradient=k not in DIFF)
              for k, v in a.items()}
        jl = LOSSES[name](JF, ja)
        jl.sum().backward() if jl.ndim else jl.backward()
        want = jl.numpy()
        jgrads = {k: ja[k].grad for k in DIFF}
    ta = {k: torch.tensor(v, requires_grad=k in DIFF) for k, v in a.items()}
    tl = LOSSES[name](TF, ta)
    (tl.sum() if tl.ndim else tl).backward()
    np.testing.assert_allclose(tl.detach().numpy(), want, **LOSS)
    for k in DIFF:
        if jgrads[k] is None:
            assert ta[k].grad is None or not ta[k].grad.any(), k
        else:
            np.testing.assert_allclose(ta[k].grad.numpy(),
                                       jgrads[k].numpy(), **LOSS,
                                       err_msg=k)


@pytest.mark.parametrize("layer,args", [
    ("CrossEntropyLoss", ("logits", "label")), ("MSELoss", ("x", "y")),
    ("L1Loss", ("x", "y")), ("NLLLoss", ("logits", "label")),
    ("BCELoss", ("p", "t")), ("BCEWithLogitsLoss", ("x", "t")),
    ("KLDivLoss", ("x", "p")), ("SmoothL1Loss", ("x", "y")),
    ("MarginRankingLoss", ("x", "y", "sign"))])
def test_loss_layers(layer, args):
    a = _loss_inputs(2)
    if layer == "NLLLoss":
        a["logits"] = np.log(a["probs"])
        a["label"] = a["label"][:, 0]
    with Jdy.guard():
        want = getattr(J.nn, layer)()(*[J.to_tensor(a[k])
                                        for k in args]).numpy()
    got = getattr(T.nn, layer)()(*[torch.from_numpy(a[k]) for k in args])
    np.testing.assert_allclose(got.numpy(), want, **LOSS)


# -- amp ----------------------------------------------------------------------

def _dt(t):
    return str(t.dtype).replace("torch.", "") if isinstance(
        t, torch.Tensor) else str(t.dtype)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_cast_points(level):
    """The dtype each op's output takes under auto_cast, and its values
    within BF16: matmul_v2 and conv2d cast under O1, their bias adds and
    batch_norm do not; under O2 everything but the black list does."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    w = (rng.randn(4, 3, 3, 3) * 0.2).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    m = rng.randn(8, 5).astype(np.float32)
    mb = rng.randn(5).astype(np.float32)
    mean, var = np.zeros(4, np.float32), np.ones(4, np.float32)

    def ops(F, P, to):
        with P.auto_cast(True, level=level):
            conv = F.conv2d(to(x), to(w))
            conv_b = F.conv2d(to(x), to(w), to(b))
            lin = F.linear(to(x[:, 0, 0]), to(m))
            lin_b = F.linear(to(x[:, 0, 0]), to(m), to(mb))
            bn = F.batch_norm(conv, to(mean), to(var), to(b), to(b),
                              training=False)
            relu = F.relu(to(x))
            sm = F.softmax(to(x))
        return dict(conv=conv, conv_b=conv_b, lin=lin, lin_b=lin_b, bn=bn,
                    relu=relu, softmax=sm)

    with Jdy.guard():
        want = ops(JF, Jamp, J.to_tensor)
    got = ops(TF, Tamp, torch.from_numpy)
    for k in want:
        assert _dt(got[k]) == _dt(want[k]), k
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k].numpy(), np.float32),
                                   **BF16, err_msg=k)
    assert _dt(got["conv"]) == "bfloat16" and _dt(got["lin_b"]) == (
        "float32" if level == "O1" else "bfloat16")
    # outside the block nothing is cast
    assert TF.linear(torch.ones(1, 8), torch.ones(8, 2)).dtype == \
        torch.float32


def test_grad_scaler_trajectory():
    """Both scalers through the same run of finite and non-finite steps:
    the same scales, counters and parameters after each step, exactly."""
    with fresh_jax_stream(), JU.guard():
        jl = J.nn.Linear(3, 2)
    with TU.guard():
        tl = T.nn.Linear(3, 2)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    js, ts = Jamp.GradScaler(**kw), Tamp.GradScaler(**kw)
    jo = J.optimizer.SGD(0.5, parameters=jl.parameters())
    to = T.optimizer.SGD(0.5, parameters=tl.parameters())
    pattern = [False, True, True, False, False, False, True, False, True,
               True, True, False, False]
    for step, bad in enumerate(pattern):
        rng = np.random.RandomState(step)
        for jp, tp in zip(jl.parameters(), tl.parameters()):
            g = (rng.randn(*tp.shape) * js.get_loss_scaling()).astype(
                np.float32)
            if bad:
                g.flat[0] = np.inf if step % 2 else np.nan
            jp._grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g)
        js.step(jo)
        ts.step(to)
        assert ts.get_loss_scaling() == js.get_loss_scaling(), step
        assert ts.state_dict() == js.state_dict(), step
        for jp, tp in zip(jl.parameters(), tl.parameters()):
            np.testing.assert_array_equal(tp.detach().numpy(), jp.numpy())


# -- tensor creation, eager mode, the default device -------------------------

def test_tensor_creation(on_cpu):
    pairs = [
        (lambda P: P.to_tensor([1.5, 2.0]), None),
        (lambda P: P.to_tensor(np.arange(3, dtype=np.int64)), None),
        (lambda P: P.to_tensor([[1, 2]], dtype="float32"), None),
        (lambda P: P.zeros([2, 3]), None), (lambda P: P.ones([2], "int64"),
                                            None),
        (lambda P: P.full([2, 2], 7), None),
        (lambda P: P.arange(5), None), (lambda P: P.arange(1, 7, 2), None),
        (lambda P: P.linspace(0, 1, 5), None), (lambda P: P.eye(3, 2), None),
    ]
    for make, _ in pairs:
        with Jdy.guard():
            want = make(J).numpy()
        got = make(T)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
        assert got.numpy().dtype.kind == want.dtype.kind
    x = T.ones([2, 3])
    assert T.zeros_like(x).sum() == 0 and T.full_like(x, 2).sum() == 12
    assert T.ones_like(x, dtype="int64").dtype == torch.int64
    T.seed(5)
    a = (T.rand([3]), T.randn([3]), T.uniform([3], min=2, max=3),
         T.normal(1.0, 2.0, [3]), T.randint(0, 4, [5]), T.randperm(6))
    T.seed(5)
    b = (T.rand([3]), T.randn([3]), T.uniform([3], min=2, max=3),
         T.normal(1.0, 2.0, [3]), T.randint(0, 4, [5]), T.randperm(6))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert ((a[2] >= 2) & (a[2] < 3)).all() and a[4].max() < 4
    assert sorted(a[5].tolist()) == list(range(6))
    t = T.to_tensor([1.0], stop_gradient=False)
    assert t.requires_grad and t.is_leaf


def test_eager_mode_and_grad(on_cpu):
    assert not Tfw.in_dygraph_mode() and not T.in_dygraph_mode()
    net = TM.LeNet(device="cpu")
    assert T.Model(net)._adapter is not None
    with Tdy.guard():
        assert Tfw.in_dygraph_mode() and Tdy.enabled()
        assert T.Model(net)._adapter is None
        x = T.to_tensor(np.arange(3.0, dtype=np.float32),
                        stop_gradient=False)
        y = (x * x).sum()
        (g,) = T.grad(y, x, create_graph=True)
        assert torch.equal(g, 2 * x)
        with T.no_grad():
            assert not (x * 2).requires_grad
        with pytest.raises(RuntimeError, match="allow_unused"):
            T.grad((x * 2).sum(), [x, T.to_tensor([1.0],
                                                  stop_gradient=False)])
    assert not Tfw.in_dygraph_mode()
    T.disable_static()
    assert T.in_dygraph_mode()
    T.enable_static()
    assert not T.in_dygraph_mode()
    v = Tdy.to_variable(np.ones((2, 2)), dtype="float32")
    assert v.dtype == torch.float32 and v.device.type == "cpu"


def test_entry_points_default_to_cuda():
    """With no device set and no GPU, the entry points raise rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    saved = Tdev._CURRENT[0]
    Tdev._CURRENT[0] = None
    try:
        for make in (lambda: T.to_tensor([1.0]), lambda: T.zeros([2]),
                     lambda: TM.LeNet(), lambda: Tdy.to_variable([1.0]),
                     lambda: list(T.io.DataLoader(
                         T.io.TensorDataset([np.ones((2, 1))]),
                         batch_size=1))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
        assert TM.LeNet(device="cpu") is not None
        assert T.to_tensor([1.0], place="cpu").device.type == "cpu"
    finally:
        Tdev._CURRENT[0] = saved
