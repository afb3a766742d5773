"""hapi.Model in the port against paddle_tpu's on the CPU: LeNet through
`Model.fit` / `evaluate` / `predict` under both adapters (the static-mode
adapter outside `fluid.dygraph.guard()`, the dygraph one inside) at O0
and O1, with the EarlyStopping, ModelCheckpoint and LRScheduler
callbacks, an eval set, shuffle under `np.random.seed`, Adam over a
PiecewiseDecay with coupled L2 and a global-norm clip; checkpoints
loaded across the packages; and examples/quickstart_mnist.py's dygraph
and hapi modes through both.  The same weights (the reference's, carried
over by `set_state_dict`) and numpy data go into both.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): float32 losses, eval metrics
and predictions, which only the order of float32 operations separates.
CHANGE32 (1e-4): the relative L2 error of each parameter's change over
the fit at float32 (measured 5.0e-6).  Under O1 the dygraph adapter
casts only the convolutions and products (the reference's white list),
whose bf16 outputs agree to the bit here; the static-mode adapter runs
the whole forward, the loss included, in bf16, so its losses are
bf16 values: within BF16_LOSS (2 units in bf16's last place, 2^-6
relative), eval and predictions within 2^-6 relative; Adam normalises
each gradient element, so a one-unit bf16 difference in a gradient near
0 moves that element by a whole step: each parameter's change within
CHANGE_BF16 (0.1 in relative L2; measured 0.043).  One step's
gradients under the static-mode O1 are bf16 sums over up to B x H x W
terms, which the two packages accumulate differently: within GRAD_BF16
(0.1) of each tensor's largest entry (measured 0.049, a conv bias).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import initializer as _jax_init
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.hapi import callbacks as Jcb
from paddle_tpu.nn import functional as JF
from paddle_tpu.vision import models as JM

import paddle_tpu_torch as T
from paddle_tpu_torch.fluid import dygraph as Tdy
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.hapi import callbacks as Tcb
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as TM

F32 = dict(rtol=1e-5, atol=1e-6)
CHANGE32 = 1e-4
BF16_LOSS = dict(rtol=2 ** -6, atol=0)
BF16 = dict(rtol=2 ** -6, atol=2 ** -6)
CHANGE_BF16 = 0.1
GRAD_BF16 = 0.1
SIDES = {"j": (J, Jcb, JU, Jdy), "t": (T, Tcb, TU, Tdy)}


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


def dataset(pkg, shape, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, *shape).astype(np.float32)
    y = rng.randint(0, 10, (n, 1)).astype(np.int64)

    class Samples(pkg.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i]

    return Samples()


def recorder(cbm):
    class Losses(cbm.Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return Losses()


def run_fit(side, build, make_opt, adapter, amp, shape, n, batch, tmp,
            state=None):
    """Model.fit (2 epochs; EarlyStopping stops after the first eval),
    evaluate and predict in one package.  Returns the weights it began
    from, the losses, history, eval logs, predictions, the parameters
    after and the optimizer's last rate."""
    P, cbm, U, dy = SIDES[side]
    with (fresh_jax_stream() if side == "j" else contextlib.nullcontext()):
        with U.guard():
            net = build(side)
    if state is None:
        state = {k: np.asarray(v.numpy()) for k, v in
                 net.state_dict().items()}
    else:
        assert net.set_state_dict(state) == ([], [])
    if adapter == "dygraph":
        with dy.guard():
            model = P.Model(net)
    else:
        model = P.Model(net)
    opt = make_opt(P, net)
    model.prepare(opt, P.nn.CrossEntropyLoss(),
                  P.metric.Accuracy(topk=(1, 2)), amp_configs=amp)
    rec = recorder(cbm)
    callbacks = [rec, cbm.EarlyStopping(monitor="loss", patience=0,
                                        baseline=0.0),
                 cbm.ModelCheckpoint(1, str(tmp / side)),
                 cbm.LRScheduler(by_step=True, by_epoch=False)]
    np.random.seed(0)
    hist = model.fit(dataset(P, shape, n, 1),
                     eval_data=dataset(P, shape, batch, 2),
                     batch_size=batch, epochs=2, verbose=0,
                     callbacks=callbacks)
    ev = model.evaluate(dataset(P, shape, batch, 2), batch_size=batch,
                        verbose=0)
    (pred,) = model.predict(dataset(P, shape, batch, 2), batch_size=batch,
                            stack_outputs=True)
    after = {k: (v.numpy() if side == "j" else v.detach().float().numpy())
             for k, v in net.state_dict().items()}
    return dict(state=state, losses=rec.losses, hist=hist, ev=ev,
                pred=np.asarray(pred, np.float32), after=after,
                lr=opt.get_lr(), dir=tmp / side, net=net)


def change_errors(got, want):
    """Relative L2 error of each tensor's change over the fit."""
    out = {}
    for k, w in want["after"].items():
        d = w - want["state"][k]
        if np.linalg.norm(d) > 0:
            out[k] = float(np.linalg.norm(got["after"][k] - w)
                           / np.linalg.norm(d))
    return out


def _lenet(side):
    return JM.LeNet() if side == "j" else TM.LeNet(device="cpu")


def _adam(P, net):
    return P.optimizer.Adam(
        P.optimizer.lr.PiecewiseDecay([2], [1e-3, 5e-4]),
        parameters=net.parameters(), weight_decay=1e-4,
        grad_clip=P.optimizer.ClipGradByGlobalNorm(1.0))


CONFIGS = [("static", None), ("static", "O1"), ("dygraph", None),
           ("dygraph", "O1")]


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"{a}-{m or 'O0'}" for a, m in CONFIGS])
def lenet(request, tmp_path_factory):
    adapter, amp = request.param
    tmp = tmp_path_factory.mktemp(f"lenet_{adapter}_{amp}")
    j = run_fit("j", _lenet, _adam, adapter, amp, (1, 28, 28), 16, 8, tmp)
    t = run_fit("t", _lenet, _adam, adapter, amp, (1, 28, 28), 16, 8, tmp,
                j["state"])
    return adapter, amp, j, t


def test_fit_losses_and_callbacks(lenet):
    adapter, amp, j, t = lenet
    tol = BF16_LOSS if (adapter, amp) == ("static", "O1") else F32
    assert len(t["losses"]) == len(j["losses"]) == 2  # stopped early
    np.testing.assert_allclose(t["losses"], j["losses"], **tol)
    assert len(t["hist"]) == len(j["hist"]) == 1
    assert t["lr"] == j["lr"] == 5e-4  # stepped by step past 2
    assert sorted(os.listdir(t["dir"])) == sorted(os.listdir(j["dir"])) \
        == ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]


def test_fit_parameters(lenet):
    adapter, amp, j, t = lenet
    limit = CHANGE_BF16 if (adapter, amp) == ("static", "O1") else CHANGE32
    errs = change_errors(t, j)
    assert len(errs) == 10 and max(errs.values()) <= limit, errs


def test_evaluate_and_predict(lenet):
    adapter, amp, j, t = lenet
    tol = BF16 if (adapter, amp) == ("static", "O1") else F32
    assert set(t["ev"]) == {"acc_top1", "acc_top2", "loss"}
    np.testing.assert_allclose(t["ev"]["loss"], j["ev"]["loss"], **tol)
    np.testing.assert_allclose(t["pred"], j["pred"], **tol)
    # evaluate's accuracy is a recount of predict's logits
    labels = dataset(T, (1, 28, 28), 8, 2)
    y = np.array([labels[i][1][0] for i in range(8)])
    top = np.argsort(-t["pred"], axis=-1)[:, :2]
    assert t["ev"]["acc_top1"] == float((top[:, 0] == y).mean())
    assert t["ev"]["acc_top2"] == float((top == y[:, None]).any(-1).mean())


def test_checkpoints_load_across_packages(lenet):
    """The port's final ModelCheckpoint, loaded by the reference's Model
    (and the reference's by the port's), predicts as its writer does."""
    adapter, amp, j, t = lenet
    x = dataset(T, (1, 28, 28), 8, 2)
    xs = np.stack([x[i][0] for i in range(8)])
    for writer, reader in (("t", "j"), ("j", "t")):
        P, _, U, _ = SIDES[reader]
        with fresh_jax_stream(), U.guard():
            net = _lenet(reader)
        model = P.Model(net)
        model.prepare(_adam(P, net))
        model.load(str((j if writer == "j" else t)["dir"] / "final"))
        (got,) = model.predict_batch([xs])
        np.testing.assert_allclose(np.asarray(got),
                                   (j if writer == "j" else t)["pred"],
                                   **F32)
        sd = model._optimizer.state_dict()
        assert sd["global_step"] == 2
        assert sd["LR_Scheduler"]["last_epoch"] == 2


# -- examples/quickstart_mnist.py ---------------------------------------------

def _synthetic_batches(n_batches=40, batch=64, seed=0):
    r = np.random.RandomState(seed)
    for _ in range(n_batches):
        x = r.rand(batch, 1, 28, 28).astype("float32")
        y = r.randint(0, 10, (batch, 1)).astype("int64")
        yield x, y


def _quickstart_dygraph(side, state, steps=5):
    """run_dygraph's loop (its first `steps` batches), the port's line
    adapted: float(loss) for float(loss.numpy())."""
    P, _, U, dy = SIDES[side]
    F = JF if side == "j" else TF
    losses = []
    with dy.guard():
        with fresh_jax_stream(), U.guard():
            net = _lenet(side)
        net.set_state_dict(state)
        opt = P.optimizer.Adam(learning_rate=1e-3,
                               parameters=net.parameters())
        for i, (x, y) in enumerate(_synthetic_batches(steps)):
            kw = {} if side == "j" else {"place": "cpu"}
            logits = net(P.to_tensor(x, **kw))
            loss = F.cross_entropy(logits, P.to_tensor(y, **kw))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()) if side == "j"
                          else float(loss))
    return losses


def _quickstart_hapi(side, state):
    """run_hapi: Model(LeNet()).prepare(Adam, CrossEntropyLoss,
    Accuracy).fit(Samples(), batch_size=64, epochs=1)."""
    P, cbm, U, _ = SIDES[side]
    x = np.concatenate([b[0] for b in _synthetic_batches(8)])
    y = np.concatenate([b[1] for b in _synthetic_batches(8)])

    class Samples(P.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    with fresh_jax_stream(), U.guard():
        net = _lenet(side)
    net.set_state_dict(state)
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(learning_rate=1e-3,
                                   parameters=model.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    rec = recorder(cbm)
    np.random.seed(1)
    model.fit(Samples(), batch_size=64, epochs=1, verbose=0,
              callbacks=[rec])
    return rec.losses


@pytest.mark.parametrize("mode", ["dygraph", "hapi"])
def test_quickstart_modes(mode):
    with fresh_jax_stream(), JU.guard():
        state = {k: v.numpy() for k, v in JM.LeNet().state_dict().items()}
    run = _quickstart_dygraph if mode == "dygraph" else _quickstart_hapi
    want, got = run("j", state), run("t", state)
    assert len(got) == len(want) == (5 if mode == "dygraph" else 8)
    np.testing.assert_allclose(got, want, **F32)


def test_static_adapter_skips_a_non_finite_step():
    """O1 on the static-mode adapter: an inf in the batch makes the
    gradients non-finite, so neither package moves a parameter or the
    optimizer state, and both count the step."""
    out = {}
    for side in ("j", "t"):
        P, _, U, _ = SIDES[side]
        with fresh_jax_stream(), U.guard():
            net = _lenet(side)
        if side == "t":
            net.set_state_dict(out["j"][0])
        init = {k: np.array(v.numpy() if side == "j" else v.detach())
                for k, v in net.state_dict().items()}
        model = P.Model(net)
        opt = P.optimizer.Momentum(0.1, parameters=net.parameters())
        model.prepare(opt, P.nn.CrossEntropyLoss(), amp_configs="O1")
        x = np.ones((4, 1, 28, 28), np.float32)
        y = np.zeros((4, 1), np.int64)
        model.train_batch([x], [y])
        state = {k: np.array(v.numpy() if side == "j" else v.detach())
                 for k, v in net.state_dict().items()}
        vel = {k: np.array(v.numpy() if side == "j" else v)
               for k, v in opt.state_dict().items()
               if k not in ("global_step", "LR_Scheduler")}
        x[0, 0, 0, 0] = np.inf
        model.train_batch([x], [y])
        after = {k: np.array(v.numpy() if side == "j" else v.detach())
                 for k, v in net.state_dict().items()}
        assert all(np.array_equal(after[k], v) for k, v in state.items())
        sd = opt.state_dict()
        assert all(np.array_equal(np.asarray(
            sd[k].numpy() if side == "j" else sd[k]), v)
            for k, v in vel.items())
        assert sd["global_step"] == 2
        out[side] = (init, vel)
    # the one finite step's velocities (its gradients): bf16 sums over up
    # to B x H x W terms, within GRAD_BF16 of each tensor's largest entry
    for k, v in out["j"][1].items():
        assert np.abs(out["t"][1][k] - v).max() <= GRAD_BF16 * np.abs(v).max()
