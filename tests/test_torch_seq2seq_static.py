"""The seq2seq-with-attention decode program in the 1.x static idiom
(tests/torch_seq2seq_static_program.py: embedding + dynamic_lstm, the
decoder cell written out, a While block over tensor arrays) at TINY on
the CPU: built by both packages (the same JSON), run by the reference's
Executor and the port's with the same numpy weights, greedy and beam;
the port's static greedy against its eager 2.x greedy over the same
model, its beam scores against the 2.x teacher-forced scores; the
weight map from the 2.x model (the encoder's states against nn.LSTM's);
the host reads of a decode.

Tolerances: F32 (rtol 1e-5, atol 1e-6) for the encoder's states and the
two Executors' beam scores (float32 sums in other orders); SCORE (rtol
1e-5, atol 1e-5) between a beam's running total and the teacher-forced
sum of the same clamped log-probabilities (up to 7 terms of about -4);
ids exactly.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fluid import unique_name as TU

import torch_seq2seq_program as S
import torch_seq2seq_static_program as SP

F32 = dict(rtol=1e-5, atol=1e-6)
SCORE = dict(rtol=1e-5, atol=1e-5)
CFG = S.TINY
BEAM = CFG["beam_size"]


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


@pytest.fixture(autouse=True)
def _cpu():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    yield
    T.device._CURRENT[0] = old


@pytest.fixture(scope="module")
def model():
    old = T.device._CURRENT[0]
    T.set_device("cpu")
    with TU.guard():
        m = S.build(T, CFG, seed=3)
    m.eval()
    T.device._CURRENT[0] = old
    return m


def _src(seed=1):
    src, src_len, *_ = S.batch(CFG, seed=seed)
    return src, src_len


def _weights(model):
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return {k: np.ascontiguousarray(v) for k, v in
            SP.program_weights(state, CFG).items()}


def _programs(build):
    with JU.guard():
        jm, _, jf = build(JF)
    with TU.guard():
        tm, _, tf = build(TF)
    assert json.dumps(jm.to_dict(), sort_keys=True) == \
        json.dumps(tm.to_dict(), sort_keys=True)
    return jm, tm, [v.name for v in tf]


def _run_ref(prog, weights, src, names):
    scope = JF.Scope()
    for n, v in weights.items():
        scope.set(n, v)
    out = JF.Executor().run(prog, feed={"src": src}, fetch_list=names,
                            scope=scope)
    return [np.asarray(o) for o in out]


def _run_port(prog_dict, weights, src, names):
    scope = TF.Scope()
    for n, v in weights.items():
        scope.set(n, torch.from_numpy(v))
    out = TF.Executor(TF.CPUPlace()).run(TF.Program.from_dict(prog_dict),
                                         feed={"src": src}, fetch_list=names,
                                         scope=scope)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("beam", [0, BEAM])
def test_both_executors_decode_alike(model, beam):
    """The same program and weights: the reference's Executor (one jit,
    `lax.while_loop`) and the port's (op by op) give the same ids, and
    scores within F32; each package's JSON runs in the other.  The loop
    runs to its capacity here (no source finishes at TINY), where the
    reference's `tensor_array_to_tensor` is exact."""
    src, _ = _src()
    jm, tm, names = _programs(lambda fl: SP.build(fl, CFG, *src.shape,
                                                  beam_size=beam))
    w = _weights(model)
    want = _run_ref(jm, w, src, names)
    got = _run_port(jm.to_dict(), w, src, names)
    cross = _run_ref(JF.Program.from_dict(tm.to_dict()), w, src, names)
    assert got[0].shape[1] == CFG["max_out_len"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(cross[0], want[0])
    if beam:
        np.testing.assert_allclose(got[1], want[1], **F32)


def test_static_greedy_equals_the_eager_greedy(model):
    src, src_len = _src()
    with TU.guard():
        main, _, fetch = SP.build(TF, CFG, *src.shape)
    scope = TF.Scope()
    SP.load_from_2x(scope, model, CFG)
    got = TF.Executor(TF.CPUPlace()).run(main, feed={"src": src},
                                         fetch_list=fetch, scope=scope)[0]
    want = S.greedy(T, model, torch.from_numpy(src),
                    torch.from_numpy(src_len), CFG["max_out_len"])
    np.testing.assert_array_equal(got, want)


def test_static_beam_scores_are_the_teacher_forced_scores(model):
    """Each returned beam (best first within its source) scores what a
    teacher-forced pass of the 2.x decoder cell over its ids scores."""
    src, src_len = _src(seed=2)
    with TU.guard():
        main, _, fetch = SP.build(TF, CFG, *src.shape, beam_size=BEAM)
    scope = TF.Scope()
    SP.load_from_2x(scope, model, CFG)
    ids, scores = TF.Executor(TF.CPUPlace()).run(
        main, feed={"src": src}, fetch_list=fetch, scope=scope)
    seqs, scores = SP.sentence_scores(ids, scores, BEAM)
    assert (np.diff(scores, axis=1) <= 0).all()
    forced = S.sequence_scores(T, model, torch.from_numpy(src),
                               torch.from_numpy(src_len), seqs)
    np.testing.assert_allclose(scores, forced, **SCORE)


def test_the_weight_map_gives_the_2x_encoder(model):
    """The encoder program with `program_weights` (the `lstm` op's
    i, f, c~, o are nn.LSTM's i, f, g, o; its Weight W_hh^T; the input
    projection W_ih^T; one bias, the sum) gives nn.LSTM's outputs and
    each layer's last h and c; any other gate order does not."""
    src, src_len = _src()
    with TU.guard():
        main, _, fetch = SP.build_encoder(TF, CFG, *src.shape)
    w = _weights(model)
    names = [v.name for v in fetch]
    got = _run_port(main.to_dict(), w, src, names)
    with torch.no_grad():
        enc, (h, c) = model.encoder(torch.from_numpy(src),
                                    torch.from_numpy(src_len))
    want = [enc.numpy()]
    for k in range(CFG["num_layers"]):
        want += [h[k].numpy(), c[k].numpy()]
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, **F32)
    assert SP.LSTM_GATE_ORDER == (0, 1, 2, 3)
    try:
        SP.LSTM_GATE_ORDER = (0, 2, 1, 3)
        swapped = _run_port(main.to_dict(), _weights(model), src, names)
    finally:
        SP.LSTM_GATE_ORDER = (0, 1, 2, 3)
    assert not np.allclose(swapped[0], want[0], **F32)


def test_a_decode_reads_the_host_once_a_step():
    """Greedy over 7 steps: 8 reads of the loop's condition (the last
    ends it) and 1 of the ids array's length."""
    src, _ = _src()
    with TU.guard():
        main, _, fetch = SP.build(TF, CFG, *src.shape)
    scope = TF.Scope()
    for n, v in _weights(S.build(T, CFG, seed=4)).items():
        scope.set(n, torch.from_numpy(v))
    before = profiler.get_int_stats().get("control_flow_host_reads", 0)
    out = TF.Executor(TF.CPUPlace()).run(main, feed={"src": src},
                                         fetch_list=fetch, scope=scope)[0]
    reads = profiler.get_int_stats()["control_flow_host_reads"] - before
    assert out.shape[1] == CFG["max_out_len"] == 7 and reads == 9
