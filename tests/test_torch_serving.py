"""The port's serving.Engine on the CPU: tiny BERT served through the
dynamic batcher and bucketed runner, every response held against the
JAX package's forward of the same rows; plus the bucketing helpers
against paddle_tpu's and the engine's admission and lifecycle rules."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import functional_call, functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.serving import bucketing as JBK
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.serving import (BucketedRunner, Engine, EngineConfig,
                                      EngineOverloaded, RequestCancelled,
                                      bucket_for, bucket_ladder,
                                      input_signature, latency_stats,
                                      pad_batch)

# f32 on both sides through two encoder layers
ATOL = RTOL = 1e-4
SEQ = 16
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def served():
    """(jax BertModel, its state, port fn serving the same weights)."""
    paddle.seed(21)
    jm = JB.BertModel(JB.BertConfig.tiny(**NO_DROP))
    jm.eval()
    state = {k: np.asarray(v) for k, v in functional_state(jm).items()}
    tm = load_jax_state(TB.BertModel(TB.BertConfig.tiny(**NO_DROP),
                                     device="cpu"), state).eval()

    def fn(input_ids, token_type_ids, attention_mask):
        am = (attention_mask != 0)[:, None, None, :]
        return tm(input_ids, token_type_ids, attention_mask=am)

    return jm, state, fn


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    cfg = JB.BertConfig.tiny()
    out = []
    for i in range(n):
        rows = int(rng.integers(1, 6))
        b = JB.fake_batch(cfg, rows, SEQ, seed=seed * 100 + i)
        out.append([b["input_ids"], b["token_type_ids"],
                    b["attention_mask"]])
    return out


def _jax_forward(jm, state, ids, types, am):
    (enc, pooled), _ = functional_call(
        jm, state, ids, types, attention_mask=(am != 0)[:, None, None, :])
    return np.asarray(enc), np.asarray(pooled)


def test_engine_serves_tiny_bert_like_jax(served):
    jm, state, fn = served
    reqs = _requests(12, seed=1)
    profiler.stat_reset()
    with Engine(fn, EngineConfig(max_batch_size=8, max_queue_delay_ms=5,
                                 device="cpu")) as eng:
        resps = [None] * len(reqs)

        def client(lo):
            for i in range(lo, len(reqs), 3):
                resps[i] = eng.submit(reqs[i])

        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [r.result(timeout=60) for r in resps]
    # rows are independent: one JAX forward of every request's rows
    all_enc, all_pooled = _jax_forward(
        jm, state, *[np.concatenate(cols) for cols in zip(*reqs)])
    lo = 0
    for req, (enc, pooled) in zip(reqs, results):
        hi = lo + req[0].shape[0]
        assert enc.shape == (hi - lo, SEQ, 64)
        np.testing.assert_allclose(enc, all_enc[lo:hi], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(pooled, all_pooled[lo:hi], atol=ATOL,
                                   rtol=RTOL)
        lo = hi
    stats = profiler.get_int_stats()
    assert stats["serving_completed_total"] == len(reqs)
    assert stats["serving_batch_rows_total"] == sum(r[0].shape[0]
                                                    for r in reqs)
    assert 1 <= stats["serving_batches_total"] <= len(reqs)
    assert stats["serving_trace_count"] == 1  # one bucket, one signature
    assert latency_stats()["count"] >= len(reqs)
    assert all(c.value == 0 for c in COUNTERS.values())  # CPU: no kernel


def test_oversize_request_is_chunked_through_the_top_bucket(served):
    jm, state, fn = served
    b = JB.fake_batch(JB.BertConfig.tiny(), 11, SEQ, seed=5)
    req = [b["input_ids"], b["token_type_ids"], b["attention_mask"]]
    with Engine(fn, EngineConfig(max_batch_size=4, device="cpu")) as eng:
        enc, pooled = eng.infer(req, timeout=60)
    want_enc, want_pooled = _jax_forward(jm, state, *req)
    np.testing.assert_allclose(enc, want_enc, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled, want_pooled, atol=ATOL, rtol=RTOL)


def test_bf16_outputs_come_back_as_float32():
    fn = lambda x: (x * 2).to(torch.bfloat16)
    with Engine(fn, EngineConfig(max_batch_size=4, device="cpu")) as eng:
        (out,) = eng.infer([np.ones((3, 5), np.float32)], timeout=30)
    assert out.dtype == np.float32 and out.shape == (3, 5)
    np.testing.assert_array_equal(out, 2.0)


# -- bucketing, against the JAX package's helpers ---------------------------

@pytest.mark.parametrize("max_batch,min_bucket", [(32, 8), (12, 4), (1, 8)])
def test_bucket_ladder_matches_jax(max_batch, min_bucket):
    assert bucket_ladder(max_batch, min_bucket) == \
        JBK.bucket_ladder(max_batch, min_bucket)
    ladder = bucket_ladder(max_batch, min_bucket)
    for n in range(1, max_batch + 3):
        assert bucket_for(n, ladder) == JBK.bucket_for(n, ladder)


def test_pad_batch_and_signature_match_jax():
    a = np.arange(12, dtype=np.int64).reshape(3, 4)
    np.testing.assert_array_equal(pad_batch(a, 8), JBK.pad_batch(a, 8))
    assert pad_batch(a, 3) is a
    with pytest.raises(ValueError):
        pad_batch(a, 2)
    inputs = [a, np.zeros((3, 2, 5), np.float32)]
    assert input_signature(inputs) == JBK.input_signature(inputs)


def test_runner_pads_slices_and_warms_each_bucket_once():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x + 1, torch.tensor(7.0)

    r = BucketedRunner(fn, [4, 8], device="cpu")
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert not r.is_compiled([x])
    out, scalar = r.run([x])
    assert r.is_compiled([x]) and r.trace_count == 1
    np.testing.assert_array_equal(out.numpy(), x + 1)
    assert scalar.item() == 7.0
    r.run([x[:2]])  # same bucket: no new warm-up
    assert calls == [4, 4, 4] and r.trace_count == 1


# -- admission and lifecycle ------------------------------------------------

def test_admission_rejects_at_the_queue_bound():
    eng = Engine(lambda x: x, EngineConfig(max_queue=2, device="cpu"),
                 start=False)
    eng.submit([np.zeros((1, 2))])
    eng.submit([np.zeros((1, 2))])
    with pytest.raises(EngineOverloaded) as e:
        eng.submit([np.zeros((1, 2))])
    assert e.value.resource == "queue" and e.value.bound == 2
    eng.shutdown(drain=False)


def test_cancel_and_no_drain_shutdown():
    eng = Engine(lambda x: x, EngineConfig(device="cpu"), start=False)
    r1 = eng.submit([np.zeros((1, 2))])
    r2 = eng.submit([np.zeros((1, 2))])
    assert r1.cancel()
    eng.shutdown(drain=False)
    for r in (r1, r2):
        with pytest.raises(RequestCancelled):
            r.result(timeout=1)


def test_scalar_inputs_are_refused():
    with Engine(lambda x: x, EngineConfig(device="cpu")) as eng:
        with pytest.raises(ValueError, match="leading batch dim"):
            eng.submit([np.float32(1.0)])


def test_model_errors_fail_their_batch_only():
    def fn(x):
        if float(x[0, 0]) < 0:
            raise ValueError("bad row")
        return x

    with Engine(fn, EngineConfig(max_batch_size=1, device="cpu")) as eng:
        bad = eng.submit([np.full((1, 2), -1.0, np.float32)])
        good = eng.submit([np.ones((1, 2), np.float32)])
        with pytest.raises(ValueError, match="bad row"):
            bad.result(timeout=30)
        np.testing.assert_array_equal(good.result(timeout=30)[0], 1.0)


def test_engine_without_cuda_and_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-device rule cannot fail")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(lambda x: x)
