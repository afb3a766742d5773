"""The port's recurrent layers (paddle_tpu_torch.nn.layer.rnn) against
paddle_tpu.nn on the CPU: the three cells, `RNN` and `BiRNN` over them,
and `LSTM` / `GRU` / `SimpleRNN` at 1-2 layers, forward and bidirect,
batch- and time-major, with and without initial states.  The reference's
weights (drawn from a fresh init stream) are carried over by name with
`convert.load_jax_state`; outputs, final states and the gradients of
the input, the initial states and every weight are compared for the
same cotangents.  The fused path (ATen's torch.lstm / gru / rnn_*) is
also held against the port's plain per-step loop, `plain_forward`.

Tolerances.  F32 (rtol 2e-5, atol 2e-6): float32 recurrences of up to 6
steps at hidden 8, which the packages sum in other orders (the fused
path adds the two gate products before the biases).  LOOP (rtol 1e-5,
atol 1e-6): the fused path against the plain loop in one package.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.jit import functional_state

import paddle_tpu_torch as T
from paddle_tpu_torch import convert
from paddle_tpu_torch.fluid import dygraph as Tdy
from paddle_tpu_torch.fluid import layers as Tlayers

from test_torch_hapi import fresh_jax_stream

F32 = dict(rtol=2e-5, atol=2e-6)
LOOP = dict(rtol=1e-5, atol=1e-6)
B, S, I, H = 3, 6, 5, 8


@pytest.fixture(autouse=True)
def _cpu_and_global_rngs():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    T.device._CURRENT[0] = old
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, **kw):
    """The reference's layer `name` and the port's, with the reference's
    weights."""
    with fresh_jax_stream():
        j = getattr(J.nn, name)(*args, **kw)
    t = getattr(T.nn, name)(*args, **kw)
    assert list(t.state_dict()) == list(j.state_dict())
    convert.load_jax_state(t, {k: np.asarray(v) for k, v in
                               functional_state(j).items()})
    return j, t


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _run_ref(layer, args):
    """Outputs and gradients (inputs, then parameters by name) of the
    reference layer under its eager tape, for cotangents of seed 7."""
    with Jdy.guard():
        jargs = [_tree(lambda a: J.to_tensor(a, stop_gradient=False), a)
                 for a in args]
        outs = _leaves(layer(*jargs))
        cts = [_f(*o.shape, seed=7 + i) for i, o in enumerate(outs)]
        loss = J.tensor.add_n([J.tensor.sum(J.tensor.multiply(
            o, J.to_tensor(c))) for o, c in zip(outs, cts)])
        loss.backward()
        grads = {f"in{i}": np.asarray(x.grad.numpy())
                 for i, x in enumerate(_leaves(jargs))}
        grads.update({n: np.asarray(p.grad.numpy())
                      for n, p in layer.named_parameters()})
        return [np.asarray(o.numpy()) for o in outs], grads


def _run_port(fn, layer, args):
    targs = [_tree(lambda a: torch.tensor(a, requires_grad=True), a)
             for a in args]
    outs = _leaves(fn(*targs))
    cts = [_f(*o.shape, seed=7 + i) for i, o in enumerate(outs)]
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)) \
        .backward()
    grads = {f"in{i}": x.grad.numpy() for i, x in enumerate(_leaves(targs))}
    grads.update({n: p.grad.numpy() for n, p in layer.named_parameters()})
    for p in layer.parameters():
        p.grad = None
    return [o.detach().numpy() for o in outs], grads


def _tree(f, a):
    if isinstance(a, (list, tuple)):
        return type(a)(_tree(f, x) for x in a)
    return f(a)


def _compare(got, want, tol):
    (go, gg), (wo, wg) = got, want
    assert len(go) == len(wo)
    for k, (g, w) in enumerate(zip(go, wo)):
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=f"output {k}", **tol)
    assert set(gg) == set(wg)
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], err_msg=k, **tol)


CELL_CASES = {
    "simple_tanh": ("SimpleRNNCell", (I, H), {}, False),
    "simple_relu": ("SimpleRNNCell", (I, H), {"activation": "relu"},
                    False),
    "lstm": ("LSTMCell", (I, H), {}, True),
    "gru": ("GRUCell", (I, H), {}, False),
}


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("name", sorted(CELL_CASES))
def test_cell_step(name, with_state):
    cls, args, kw, lstm = CELL_CASES[name]
    j, t = _pair(cls, *args, **kw)
    x = _f(B, I)
    inputs = [x]
    if with_state:
        inputs.append((_f(B, H, seed=1), _f(B, H, seed=2)) if lstm
                      else _f(B, H, seed=1))
    _compare(_run_port(t, t, inputs), _run_ref(j, inputs), F32)
    assert list(t.state_dict()) == ["weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"]


def test_get_initial_states_is_float32_on_the_batch_device():
    cell = T.nn.LSTMCell(I, H)
    ref = torch.zeros(4, I, dtype=torch.float64)
    h, c = cell.get_initial_states(ref, dtype="float64", init_value=0.5)
    assert h.dtype == c.dtype == torch.float32 and h.shape == (4, H)
    assert float(h[0, 0]) == 0.5
    with Jdy.guard():
        jh, _ = J.nn.LSTMCell(I, H).get_initial_states(
            J.to_tensor(np.zeros((4, I))), dtype="float64")
        assert str(jh.numpy().dtype) == "float32"


SCAN_CASES = [
    (mode, layers, direction, time_major, with_state)
    for mode in ("LSTM", "GRU", "SimpleRNN", "SimpleRNN_relu")
    for layers, direction in ((1, "forward"), (2, "bidirect"))
    for time_major in (False, True)
    for with_state in (False, True)
    if not (time_major and with_state and layers == 1)
]


def _scan_pair(mode, layers, direction, time_major):
    kw = dict(num_layers=layers, direction=direction, time_major=time_major)
    if mode == "SimpleRNN_relu":
        mode, kw["activation"] = "SimpleRNN", "relu"
    return _pair(mode, I, H, **kw)


def _scan_inputs(mode, layers, direction, time_major, with_state):
    x = _f(S, B, I) if time_major else _f(B, S, I)
    if not with_state:
        return [x]
    n = layers * (2 if direction == "bidirect" else 1)
    h0 = _f(n, B, H, seed=1)
    return [x, (h0, _f(n, B, H, seed=2)) if mode == "LSTM" else h0]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_scan_layer_matches_the_reference(case):
    mode, layers, direction, time_major, with_state = case
    j, t = _scan_pair(mode, layers, direction, time_major)
    inputs = _scan_inputs(mode, layers, direction, time_major, with_state)
    got = _run_port(t, t, inputs)
    _compare(got, _run_ref(j, inputs), F32)
    # the fused recurrence against the plain per-step loop
    loop = _run_port(lambda *a: t.plain_forward(*a), t, inputs)
    _compare(got, loop, LOOP)
    ndir = 2 if direction == "bidirect" else 1
    assert got[0][0].shape == ((S, B, ndir * H) if time_major
                               else (B, S, ndir * H))
    assert got[0][1].shape == (layers * ndir, B, H)


def test_scan_layer_state_dict_order_and_names():
    j, t = _pair("GRU", I, H, num_layers=2, direction="bidirectional")
    keys = [f"{w}_l{l}{r}" for l in (0, 1) for r in ("", "_reverse")
            for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    assert list(t.state_dict()) == list(j.state_dict()) == keys
    assert tuple(t.weight_ih_l1.shape) == (3 * H, 2 * H)
    assert all(p.name.startswith(t.full_name()) for p in t.parameters())


def test_pre_hooks_run_and_post_hooks_do_not():
    t = T.nn.LSTM(I, H)
    seen = []
    t.register_forward_pre_hook(lambda m, a: seen.append("pre"))
    t.register_forward_post_hook(lambda m, a, o: seen.append("post"))
    y, (h, c) = t(torch.from_numpy(_f(B, S, I)))
    assert seen == ["pre"] and y.shape == (B, S, H)
    y, h = T.nn.GRU(I, H)(torch.from_numpy(_f(B, S, I)))
    assert h.shape == (1, B, H)


def test_sequence_length_full_or_raise():
    t = T.nn.LSTM(I, H)
    x = torch.from_numpy(_f(B, S, I))
    y0, _ = t(x)
    y1, _ = t(x, sequence_length=torch.full((B,), S))
    np.testing.assert_array_equal(y0.detach().numpy(), y1.detach().numpy())
    with pytest.raises(NotImplementedError, match="sequence_length"):
        t(x, sequence_length=torch.tensor([S, S - 1, S]))
    cell = T.nn.RNN(T.nn.GRUCell(I, H))
    cell(x, sequence_length=[S] * B)
    with pytest.raises(NotImplementedError, match="sequence_length"):
        cell(x, sequence_length=[S, 2, S])
    # the reference reads no length: a shorter one changes nothing there
    with fresh_jax_stream(), Jdy.guard():
        j = J.nn.LSTM(I, H)
        a = j(J.to_tensor(_f(B, S, I)))[0].numpy()
        b = j(J.to_tensor(_f(B, S, I)),
              sequence_length=J.to_tensor(np.array([S, 1, 2])))[0].numpy()
    np.testing.assert_array_equal(a, b)


def test_dropout_between_layers_draws_a_fresh_mask_each_call():
    """The reference draws with a fixed key (the same mask every call);
    the port draws from its generator: the two calls differ, each
    matches the plain loop under the same scope seed, and eval mode
    drops nothing."""
    t = T.nn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = torch.from_numpy(_f(B, S, I))
    with T.nn.functional.rng_scope(3):
        a = t(x)[0]
        b = t(x)[0]
    with T.nn.functional.rng_scope(3):
        la = t.plain_forward(x)[0]
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.detach().numpy(), la.detach().numpy(),
                               **LOOP)
    t.eval()
    np.testing.assert_allclose(t(x)[0].detach().numpy(),
                               t.plain_forward(x)[0].detach().numpy(),
                               **LOOP)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_over_a_cell(reverse, time_major):
    with fresh_jax_stream():
        jcell = J.nn.LSTMCell(I, H)
        jr = J.nn.RNN(jcell, is_reverse=reverse, time_major=time_major)
    tcell = T.nn.LSTMCell(I, H)
    tr = T.nn.RNN(tcell, is_reverse=reverse, time_major=time_major)
    convert.load_jax_state(tr, {k: np.asarray(v) for k, v in
                                functional_state(jr).items()})
    x = _f(S, B, I) if time_major else _f(B, S, I)
    init = (_f(B, H, seed=1), _f(B, H, seed=2))
    _compare(_run_port(tr, tr, [x, init]), _run_ref(jr, [x, init]), F32)


def test_birnn():
    with fresh_jax_stream():
        jb = J.nn.BiRNN(J.nn.GRUCell(I, H), J.nn.GRUCell(I, H))
    tb = T.nn.BiRNN(T.nn.GRUCell(I, H), T.nn.GRUCell(I, H))
    assert list(tb.state_dict()) == list(jb.state_dict())
    convert.load_jax_state(tb, {k: np.asarray(v) for k, v in
                                functional_state(jb).items()})
    x = _f(B, S, I)
    _compare(_run_port(tb, tb, [x]), _run_ref(jb, [x]), F32)


def test_hapi_static_adapter_trains_an_lstm():
    """hapi's static-mode adapter runs the network through
    torch.func.functional_call, which substitutes attributes only: each
    weight is read by name at the call, so the masters get gradients and
    three steps match the reference's."""

    def net(P):
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lstm = P.nn.LSTM(I, H, num_layers=2,
                                      direction="bidirect")
                self.head = P.nn.Linear(2 * H, 3)

            def forward(self, x):
                y, (h, c) = self.lstm(x)
                return self.head(P.mean(y, axis=1))
        return Net()

    with fresh_jax_stream():
        jn = net(J)
    tn = net(T)
    state = {k: np.asarray(v.numpy()) for k, v in jn.state_dict().items()}
    assert tn.set_state_dict(state) == ([], [])
    x, y = _f(4, S, I), np.array([[0], [2], [1], [2]], np.int64)
    losses, after = {}, {}
    for side, P, n in (("j", J, jn), ("t", T, tn)):
        m = P.Model(n)
        m.prepare(P.optimizer.Adam(learning_rate=0.01,
                                   parameters=n.parameters()),
                  P.nn.CrossEntropyLoss())
        losses[side] = [m.train_batch([x], [y])[0][0] for _ in range(3)]
        after[side] = {k: np.asarray(v.numpy() if side == "j"
                                     else v.detach().numpy())
                       for k, v in n.state_dict().items()}
    np.testing.assert_allclose(losses["t"], losses["j"], rtol=1e-5)
    for k, w in after["j"].items():
        assert not np.array_equal(after["t"][k], state[k]), k
        np.testing.assert_allclose(after["t"][k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_aliases():
    assert Tdy.LSTMCell is T.nn.LSTMCell and Tdy.GRUCell is T.nn.GRUCell
    assert Tlayers.RNNCell is T.nn.RNNCellBase
    assert Tlayers.BeamSearchDecoder is T.nn.BeamSearchDecoder
    assert Tlayers.dynamic_decode is T.nn.dynamic_decode
    assert Tlayers.LSTMCell is T.nn.LSTMCell
    assert Tlayers.Decoder is T.nn.Decoder


def test_a_cuda_tensor_runs_the_fused_recurrence_or_raises(monkeypatch):
    """No fallback: the fused op is the only path of forward (a stand-in
    fused op that raises shows forward does not turn to the loop)."""
    from paddle_tpu_torch.nn.layer import rnn

    def boom(*a, **k):
        raise RuntimeError("fused recurrence unavailable")

    monkeypatch.setitem(rnn._FUSED, "LSTM", boom)
    with pytest.raises(RuntimeError, match="fused recurrence"):
        T.nn.LSTM(I, H)(torch.from_numpy(_f(B, S, I)))
