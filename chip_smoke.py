"""Drive paddle_tpu_torch on one NVIDIA GPU: build the hand-written
kernels, hold each against its plain PyTorch version at BERT-base shapes,
serve BERT-base through serving.Engine, take BERT-base pretraining steps,
and check what comes out.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):
  1. card     nvidia-smi name and power limit
  2. build    nvcc for sm_90a, every csrc/*.cu in parallel
  3. kernels  each kernel (flash forward, dkv and dq backward; FFN
              forward, dW and dx backward) vs its plain version on the
              card at the path's shapes (stated tolerances), timed beside
              its plain version, a PyTorch library call computing the
              same function, and its bound
  4. slice    BertModel(BertConfig.base()) in bf16 with seeded weights,
              served through serving.Engine(max_batch_size=32) to
              requests of 1-16 rows at S=512 from several client threads;
              every response finite and equal to a direct forward of the
              same rows; each forward kernel launched 12 times per call
  5. train    build_pretrain_step on BertForPretraining(BertConfig.base())
              (fp32 masters, bf16 forward, dropout 0.1, AdamW lr 1e-4) at
              B=32, S=512, 76 masked positions: 1 warm-up and 5 timed
              steps on one batch; finite falling loss, finite moments (no
              NaN gradient), each of the six kernels launched 12 times a
              step; step ms, tokens/s, MFU, kernel shares, peak memory
  6. profile  one more train step under torch.profiler: device time by
              kernel and the device's idle share
  7. check    the same model at base width, 2 layers, on the card (bf16)
              against the plain path on the CPU (f32)

The last two lines of stdout are a {"kernels": [...]} summary and the
{"ok": true, "device": {...}} result.  Needs CUDA; imports nothing of JAX
and nothing of the JAX package.  TF32 is off for matmuls and cuDNN, so
every float32 product in the plain versions is a full float32 product.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import COUNTERS, build
from paddle_tpu_torch.ops.kernels import attention as A
from paddle_tpu_torch.ops.kernels import ffn as F
from paddle_tpu_torch.serving import (Engine, EngineConfig, latency_stats,
                                      mean_occupancy, reset_latency)

# published H100 SXM peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# bf16 outputs: kernel and plain version round the same f32 math to bf16
# after different summation orders (and the kernel rounds p to bf16 against
# the running max, the plain version against the final max): two bf16
# units in the last place
BF16_TOL = dict(atol=2 ** -6, rtol=2 ** -6)
# f32 log-sum-exp: summation order only
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# bf16 gradients are sums of products of bf16 tiles (p~, dS, h, dpre)
# whose f32 inputs differ in summation order, so a tile element may round
# the other way; a flip moves a sum by one bf16 unit of a TERM, and terms
# scale with the gradient's largest entries, not with an entry that
# cancels to near 0.  Each element within 2^-6 of the largest |entry|
# plus 2^-6 relative; the mean error within 2^-7 of the mean |entry|.
# GRAD_FLOOR: a gradient that is 0 in exact arithmetic (one key: dS =
# p (dP - delta) cancels) keeps the f32 rounding of dP - delta
GRAD_FRAC = 2 ** -6
GRAD_FLOOR = 2 ** -16
# served response vs a direct forward of the same rows: the kernels are
# row-independent, but cuBLAS may pick other GEMM kernels for other batch
# sizes, and bf16 rounding differences then travel through 12 layers
SERVE_MAX_ABS = 0.25
SERVE_MEAN_ABS = 0.01
# bf16 on the card vs f32 on the CPU, 2 layers at base width
REF_MAX_ABS = 0.15
REF_MEAN_ABS = 0.02

SEQ = 512
LAYERS = 12  # BertConfig.base(): one launch of each kernel per layer
TRAIN_LR = 1e-4
FORWARD_KERNELS = ("flash_fwd", "ffn_fwd")
FAILURES = []


def log(*a):
    print(*a, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            log(f"== {name}")
            try:
                out = fn(*a, **kw)
                log(f"-- {name} ok in {time.perf_counter() - t0:.1f} s")
                return out
            except Exception:  # noqa: BLE001 - reported, then exit 1
                FAILURES.append(name)
                log(f"-- {name} FAILED\n{traceback.format_exc()}")
                return None
        return run
    return wrap


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def close(got, want, atol, rtol):
    """(ok, max abs err) of |got - want| <= atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def close_grad(got, want):
    """(ok, max abs err) under the GRAD_FRAC rule above."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = (bool(torch.isfinite(got).all())
          and bool((err <= GRAD_FRAC * float(want.abs().max())
                    + GRAD_FRAC * want.abs() + GRAD_FLOOR).all())
          and float(err.mean()) <= GRAD_FRAC / 2 * float(want.abs().mean())
          + GRAD_FLOOR)
    return ok, float(err.max())


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


@phase("card")
def card():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


@phase("build")
def build_kernels():
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        f"{ {k: round(v, 1) for k, v in built.items()} }")
    for stem, text in build.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"ptxas {stem}: " + " | ".join(regs[:8]))


def _rand(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(
        "cuda", torch.bfloat16)


def _padding_bias(g, b, s):
    lens = torch.randint(s // 2, s + 1, (b,), generator=g)
    bias = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                       A.DEFAULT_MASK_VALUE)
    return bias.to("cuda", torch.float32)


@phase("kernels")
def kernels():
    g = torch.Generator().manual_seed(0)
    rows = []

    # -- flash forward ------------------------------------------------------
    h, d = 12, 64
    cases = [  # (B, S, causal, dropout_p)
        (8, SEQ, False, 0.0), (2, SEQ, True, 0.1), (2, 200, False, 0.0),
        (32, SEQ, False, 0.0)]
    worst = 0.0
    for b, s, causal, p in cases:
        q, k, v = (_rand(g, b, s, h, d) for _ in range(3))
        bias = _padding_bias(g, b, s)
        out, lse = A.flash_forward(q, k, v, bias, 1234, causal, None, None,
                                   p)
        torch.cuda.synchronize()
        ref_out, ref_lse = A.flash_forward_reference(q, k, v, bias, 1234,
                                                     causal, None, None, p)
        ok_o, err_o = close(out, ref_out, **BF16_TOL)
        ok_l, err_l = close(lse, ref_lse, **LSE_TOL)
        worst = max(worst, err_o)
        log(f"flash_fwd B={b} S={s} causal={causal} p={p}: O err {err_o:.3g}"
            f" LSE err {err_l:.3g} {'ok' if ok_o and ok_l else 'MISMATCH'}")
        if not (ok_o and ok_l):
            raise AssertionError(f"flash_fwd disagrees with its plain "
                                 f"version at B={b} S={s}")
    # timing at the top bucket's shape (B=32, S=512), padding bias on
    ms = time_ms(lambda: A.flash_forward(q, k, v, bias))
    plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, bias),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    keep = (bias == 0)[:, None, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=keep))
    b, s = q.shape[0], q.shape[1]
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2 + b * s * 4 + b * h * s * 4
    bound_ms, bound_by = bound(flops, nbytes)
    rows.append(dict(
        name="flash_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd.cu",
        replaces="paddle_tpu/ops/pallas/attention.py:120",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        shape=f"q/k/v ({b},{s},{h},{d}) bf16, key-padding bias",
        flops=flops, bytes=nbytes, tolerance=BF16_TOL))
    del q, k, v, qt, kt, vt, out, ref_out

    # -- FFN forward ----------------------------------------------------------
    hid, ff = 768, 3072
    worst = 0.0
    for t, p, act in [(8 * SEQ, 0.0, "gelu"), (8 * SEQ, 0.1, "gelu"),
                      (1000, 0.0, "relu"), (32 * SEQ, 0.0, "gelu")]:
        x = _rand(g, t, hid)
        w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
        w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
        out = F.ffn_forward(x, w1, b1, w2, b2, act, p, 99)
        torch.cuda.synchronize()
        ref = F.ffn_forward_reference(x, w1, b1, w2, b2, act, p, 99)
        ok, err = close(out, ref, **BF16_TOL)
        worst = max(worst, err)
        log(f"ffn_fwd T={t} act={act} p={p}: err {err:.3g} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"ffn_fwd disagrees with its plain version "
                                 f"at T={t}")
    ms = time_ms(lambda: F.ffn_forward(x, w1, b1, w2, b2))
    plain_ms = time_ms(lambda: F.ffn_forward_reference(x, w1, b1, w2, b2),
                       iters=3, warmup=1)
    library_ms = time_ms(lambda: torch.addmm(
        b2, torch.nn.functional.gelu(torch.addmm(b1, x, w1)), w2))
    t = x.shape[0]
    flops = 4 * t * hid * ff
    nbytes = (2 * t * hid + 2 * hid * ff + ff + hid) * 2
    bound_ms, bound_by = bound(flops, nbytes)
    rows.append(dict(
        name="ffn_fwd", route="cuda", source="paddle_tpu_torch/csrc/ffn_fwd.cu",
        replaces="paddle_tpu/ops/pallas/ffn.py:134", max_abs_err=worst,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms,
        shape=f"x ({t},{hid}) W1 ({hid},{ff}) W2 ({ff},{hid}) bf16, gelu",
        flops=flops, bytes=nbytes, tolerance=BF16_TOL))
    del x, w1, b1, w2, b2, out, ref
    torch.cuda.empty_cache()
    rows += _flash_backward_rows(g)
    torch.cuda.empty_cache()
    rows += _ffn_backward_rows(g)
    torch.cuda.empty_cache()
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}) at {r['shape']}")
    return rows


def _flash_backward_rows(g):
    """The dkv and dq kernels against their plain version (which computes
    dq, dk and dv together), then timed at the path's shape: B=32, S=512,
    12 heads of 64, key padding, attention dropout 0.1."""
    h, d, seed = 12, 64, 4321
    worst = {"dkv": 0.0, "dq": 0.0}
    for b, s, causal, p in [(8, SEQ, False, 0.1), (2, SEQ, True, 0.1),
                            (2, 200, False, 0.0), (32, SEQ, False, 0.1)]:
        q, k, v, gr = (_rand(g, b, s, h, d) for _ in range(4))
        bias = _padding_bias(g, b, s)
        out, lse = A.flash_forward(q, k, v, bias, seed, causal, None, None,
                                   p)
        dq, dk, dv = A.flash_backward(q, k, v, bias, seed, out, lse, gr,
                                      causal, None, None, p)
        torch.cuda.synchronize()
        rq, rk, rv = A.flash_backward_reference(q, k, v, bias, seed, out,
                                                lse, gr, causal, None, None,
                                                p)
        checks = {"dq": close_grad(dq, rq), "dk": close_grad(dk, rk),
                  "dv": close_grad(dv, rv)}
        worst["dq"] = max(worst["dq"], checks["dq"][1])
        worst["dkv"] = max(worst["dkv"], checks["dk"][1], checks["dv"][1])
        ok = all(c[0] for c in checks.values())
        log(f"flash_bwd B={b} S={s} causal={causal} p={p}: "
            + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
            + (" ok" if ok else " MISMATCH"))
        if not ok:
            raise AssertionError(f"flash_bwd disagrees with its plain "
                                 f"version at B={b} S={s}")
        del dq, dk, dv, rq, rk, rv
    # timing at the last case's shape (B=32, S=512, p=0.1)
    scale = d ** -0.5
    _, launch_dkv, launch_dq = A._flash_bwd_launchers(
        q, k, v, bias, seed, out, lse, gr, False, 0, scale, 0.1)
    dkv_ms, dq_ms = time_ms(launch_dkv), time_ms(launch_dq)
    plain_ms = time_ms(lambda: A.flash_backward_reference(
        q, k, v, bias, seed, out, lse, gr, False, 0, scale, 0.1), iters=2,
        warmup=1)
    # the library yardstick: SDPA's backward with a bool key mask (no
    # dropout), as (forward + backward) - forward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = gr.transpose(1, 2)
    keep = (bias == 0)[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep)
    fwd_ms = time_ms(sdpa)
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt))
    library_ms = both_ms - fwd_ms
    b, s = q.shape[0], q.shape[1]
    qkv_bytes = b * s * h * d * 2
    rows_bytes = 2 * b * h * s * 4 + b * s * 4  # lse, delta; key bias
    product = 2 * b * h * s * s * d
    rows = []
    for name, ms, n_products, n_out, err, line in (
            ("flash_bwd_dkv", dkv_ms, 4, 2, worst["dkv"], "263"),
            ("flash_bwd_dq", dq_ms, 3, 1, worst["dq"], "331")):
        flops = n_products * product
        nbytes = (4 + n_out) * qkv_bytes + rows_bytes
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/attention.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            plain_and_library_cover="dq, dk and dv together",
            shape=f"q/k/v/g ({b},{s},{h},{d}) bf16, key-padding bias, "
                  f"dropout 0.1", flops=flops, bytes=nbytes,
            tolerance=f"GRAD_FRAC {GRAD_FRAC}"))
    return rows


def _ffn_backward_rows(g):
    """The dW and dx kernels against their plain version (which computes
    every gradient together), then timed at the path's shape: 32 x 512
    tokens, d_model 768, d_ff 3072, gelu, hidden dropout 0.1."""
    hid, ff, seed = 768, 3072, 99
    worst = {"dw": 0.0, "dx": 0.0}
    for t, p, act in [(8 * SEQ, 0.1, "gelu"), (1000, 0.0, "relu"),
                      (32 * SEQ, 0.1, "gelu")]:
        x, gr = _rand(g, t, hid), _rand(g, t, hid)
        w1, b1 = _rand(g, hid, ff, scale=0.03), _rand(g, ff, scale=0.1)
        w2, b2 = _rand(g, ff, hid, scale=0.03), _rand(g, hid, scale=0.1)
        got = F.ffn_backward(x, w1, b1, w2, b2, seed, gr, act, p)
        torch.cuda.synchronize()
        want = F.ffn_backward_reference(x, w1, b1, w2, b2, seed, gr, act, p)
        checks = {n: close_grad(a, w) for n, a, w in
                  zip(("dx", "dw1", "db1", "dw2", "db2"), got, want)}
        worst["dx"] = max(worst["dx"], checks["dx"][1])
        worst["dw"] = max(worst["dw"], *(checks[n][1]
                                         for n in ("dw1", "db1", "dw2")))
        ok = all(c[0] for c in checks.values())
        log(f"ffn_bwd T={t} act={act} p={p}: "
            + " ".join(f"{n} err {c[1]:.3g}" for n, c in checks.items())
            + (" ok" if ok else " MISMATCH"))
        if not ok:
            raise AssertionError(f"ffn_bwd disagrees with its plain version "
                                 f"at T={t}")
        del got, want
    _, launch_dw, launch_dx = F._ffn_bwd_launchers(
        x, w1, b1, w2, b2, seed, gr, "gelu", 0.1)
    dw_ms, dx_ms = time_ms(launch_dw), time_ms(launch_dx)
    plain_ms = time_ms(lambda: F.ffn_backward_reference(
        x, w1, b1, w2, b2, seed, gr, "gelu", 0.1), iters=2, warmup=1)
    # the library yardstick: the cuBLAS addmm -> gelu -> addmm arm's
    # backward (no dropout), as (forward + backward) - forward
    leaves = [a.detach().requires_grad_() for a in (x, w1, b1, w2, b2)]
    arm = lambda: torch.addmm(leaves[4], torch.nn.functional.gelu(
        torch.addmm(leaves[2], leaves[0], leaves[1])), leaves[3])
    fwd_ms = time_ms(arm)
    both_ms = time_ms(lambda: torch.autograd.grad(arm(), leaves, gr))
    library_ms = both_ms - fwd_ms
    t = x.shape[0]
    product = 2 * t * hid * ff
    act_bytes = t * hid * 2          # x, g or dx
    weight_bytes = hid * ff * 2      # w1, w2, dw1 or dw2
    rows = []
    for name, ms, n_products, nbytes, err, line in (
            ("ffn_bwd_dw", dw_ms, 4,
             2 * act_bytes + 4 * weight_bytes + 2 * ff * 2, worst["dw"],
             "192"),
            ("ffn_bwd_dx", dx_ms, 3,
             3 * act_bytes + 2 * weight_bytes + ff * 2, worst["dx"],
             "231")):
        flops = n_products * product
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append(dict(
            name=name, route="cuda", source="paddle_tpu_torch/csrc/ffn_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/ffn.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            plain_and_library_cover="dx, dW1, db1, dW2 and db2 together",
            shape=f"x/g ({t},{hid}) W1 ({hid},{ff}) W2 ({ff},{hid}) bf16, "
                  f"gelu, dropout 0.1", flops=flops, bytes=nbytes,
            tolerance=f"GRAD_FRAC {GRAD_FRAC}"))
    return rows


def _request_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        rows = int(rng.integers(1, 17))
        fb = bert.fake_batch(cfg, rows, SEQ, seed=seed * 1000 + i)
        reqs.append([fb["input_ids"], fb["token_type_ids"],
                     fb["attention_mask"]])
    return reqs


@phase("slice")
def serve_slice(kernel_ms):
    cfg = bert.BertConfig.base()
    t0 = time.perf_counter()
    model = bert.BertModel(cfg, dtype=torch.bfloat16, seed=0).eval()
    log(f"BertModel(base) on {next(model.parameters()).device}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    calls = [0]
    calls_lock = threading.Lock()  # the warm-up and dispatch threads

    def fn(input_ids, token_type_ids, attention_mask):
        with calls_lock:
            calls[0] += 1
        am = (attention_mask != 0)[:, None, None, :]
        return model(input_ids, token_type_ids, attention_mask=am)

    reqs = _request_batches(cfg, 40, seed=7)
    resps = [None] * len(reqs)
    n_clients = 4

    def client(lo):
        for i in range(lo, len(reqs), n_clients):
            resps[i] = engine.submit(reqs[i])
            time.sleep(0.002)

    profiler.stat_reset()
    profiler.time_reset()
    reset_latency()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    t0 = time.perf_counter()
    engine = Engine(fn, EngineConfig(max_batch_size=32,
                                     max_queue_delay_ms=5.0, max_queue=64,
                                     max_in_flight=2))
    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [r.result(timeout=300) for r in resps]
    engine.shutdown(drain=True)
    wall = time.perf_counter() - t0
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    stats = profiler.get_int_stats()
    times = profiler.get_time_stats()
    lat = latency_stats()
    rows_total = sum(r[0].shape[0] for r in reqs)
    log(f"served {len(reqs)} requests, {rows_total} rows x {SEQ} tokens in "
        f"{wall:.2f} s ({rows_total * SEQ / wall:.0f} tokens/s, host clock)")
    log(f"request latency ms: p50 {lat['p50_ms']:.1f} p99 {lat['p99_ms']:.1f}"
        f" max {lat['max_ms']:.1f}")
    log(f"batches {stats['serving_batches_total']}, mean occupancy "
        f"{mean_occupancy(stats):.2f} requests / "
        f"{stats['serving_batch_rows_total'] / stats['serving_batches_total']:.1f}"
        f" rows per batch, pad rows {stats.get('serving_pad_rows_total', 0)}, "
        f"warm-ups {stats.get('serving_trace_count', 0)}, model calls {calls[0]}")
    log("serving_* int stats: " + json.dumps(
        {k: v for k, v in sorted(stats.items()) if k.startswith("serving")}))
    log("serving_* times ms: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(times.items())}))
    log(f"kernel launches on the main path: {launches}")
    expect_calls = stats["serving_batches_total"] + stats.get(
        "serving_trace_count", 0)
    if calls[0] != expect_calls:
        raise AssertionError(f"model calls {calls[0]} != batches + warm-ups "
                             f"{expect_calls}")
    for name, n in launches.items():
        want = cfg.num_hidden_layers * calls[0] \
            if name in FORWARD_KERNELS else 0  # serving runs no backward
        if n != want or (name in FORWARD_KERNELS and n == 0):
            raise AssertionError(
                f"{name}: {n} launches for {calls[0]} model calls (want "
                f"{want})")

    # every response finite, and equal to a direct forward of its rows
    worst_max, worst_mean = 0.0, 0.0
    with torch.inference_mode():
        for req, (enc, pooled) in zip(reqs, results):
            r = req[0].shape[0]
            if enc.shape != (r, SEQ, cfg.hidden_size) or \
                    pooled.shape != (r, cfg.hidden_size):
                raise AssertionError(f"bad response shapes {enc.shape} "
                                     f"{pooled.shape}")
            if not (np.isfinite(enc).all() and np.isfinite(pooled).all()):
                raise AssertionError("non-finite response")
            d_enc, d_pooled = fn(*[torch.from_numpy(a).cuda() for a in req])
            for got, want in ((enc, d_enc), (pooled, d_pooled)):
                err = np.abs(got - want.float().cpu().numpy())
                worst_max = max(worst_max, float(err.max()))
                worst_mean = max(worst_mean, float(err.mean()))
    log(f"responses vs direct forward: max abs {worst_max:.4g} (limit "
        f"{SERVE_MAX_ABS}), worst mean abs {worst_mean:.4g} (limit "
        f"{SERVE_MEAN_ABS})")
    if worst_max > SERVE_MAX_ABS or worst_mean > SERVE_MEAN_ABS:
        raise AssertionError("served responses disagree with the direct "
                             "forward")

    # where the time of one top-bucket batch goes: the direct forward of
    # 32 rows against the two kernels' times at that shape (phase 3)
    batch = [torch.from_numpy(np.concatenate(cols)[:32]).cuda()
             for cols in zip(*reqs)]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: fn(*batch), iters=5, warmup=1)
    log(f"forward B=32 S={SEQ}: {fwd_ms:.3f} ms")
    for name in FORWARD_KERNELS:
        ms = (kernel_ms or {}).get(name, float("nan"))
        share = cfg.num_hidden_layers * ms / fwd_ms
        log(f"  {name}: {cfg.num_hidden_layers} x {ms:.4f} ms = "
            f"{100 * share:.1f}% of the forward")
    return launches


@phase("train")
def train(kernel_ms):
    cfg = bert.BertConfig.base()
    batch_size, n_masked, steps = 32, 76, 5
    t0 = time.perf_counter()
    model = bert.BertForPretraining(cfg, seed=0)  # f32, train() mode
    step, state = bert.build_pretrain_step(model)  # bf16 over f32 masters
    fb = bert.fake_batch(cfg, batch_size, SEQ, num_masked=n_masked, seed=11)
    batch = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    log(f"BertForPretraining(base) + state built in "
        f"{time.perf_counter() - t0:.1f} s; dropout "
        f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
        f"B={batch_size} S={SEQ} masked={n_masked} lr={TRAIN_LR}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS.values():
        c.reset()
    # -- the main path: counters at 0 before, read right after --------------
    losses = []
    t0 = time.perf_counter()
    state, loss = step(state, batch, TRAIN_LR)  # warm-up
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    for _ in range(steps):
        state, loss = step(state, batch, TRAIN_LR)
        losses.append(loss)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {n: c.value for n, c in COUNTERS.items()}
    # ------------------------------------------------------------------------
    step_ms = e0.elapsed_time(e1) / steps
    losses = [float(x) for x in losses]
    log(f"losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("train losses are not finite and falling")
    if not all(bool(torch.isfinite(m).all()) for m in state["m"].values()):
        raise AssertionError("a gradient holds a NaN or inf (moment m)")
    log(f"kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n != LAYERS * (steps + 1):
            raise AssertionError(f"{name}: {n} launches in {steps + 1} steps"
                                 f" (want {LAYERS} per step)")
    flops = bert.bert_step_flops(cfg, batch_size, SEQ, n_masked)
    mem = torch.cuda.max_memory_allocated()
    summary = dict(step_ms=step_ms, host_step_ms=host_ms,
                   warmup_step_s=warm_s,
                   tokens_per_s=batch_size * SEQ / (step_ms / 1e3),
                   step_flops=flops,
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   max_memory_allocated_bytes=mem, losses=losses)
    log(f"train step B={batch_size} S={SEQ}: {step_ms:.3f} ms (CUDA events;"
        f" host clock {host_ms:.3f} ms), {summary['tokens_per_s']:.0f} "
        f"tokens/s, MFU {100 * summary['mfu']:.2f}% of 989 TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP a step), warm-up step {warm_s:.2f} s, "
        f"max_memory_allocated {mem / 2 ** 30:.2f} GiB")
    total = 0.0
    for name, ms in (kernel_ms or {}).items():
        share = LAYERS * ms / step_ms
        total += share
        log(f"  {name}: {LAYERS} x {ms:.4f} ms = {100 * share:.1f}% of the "
            f"step")
    log(f"  the six kernels: {100 * total:.1f}%; everything else "
        f"{100 * (1 - total):.1f}% by difference")
    log("train summary: " + json.dumps(summary))
    return launches, (step, state, batch)


@phase("profile")
def profile(run):
    """One more train step under torch.profiler: device time by kernel
    name, the device's busy and idle share of the step."""
    step, state, batch = run
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: an operator's row repeats its kernels' device time
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    log(f"profiled step: {wall_ms:.3f} ms host clock, device busy "
        f"{busy:.3f} ms in {len(kernels)} kernel names (idle "
        f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%)")
    for key, ms, count in kernels[:25]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count:<4d} {key[:90]}")


@phase("check")
def reference_check():
    cfg = bert.BertConfig.base(num_hidden_layers=2)
    gpu = bert.BertModel(cfg, dtype=torch.bfloat16, seed=1).eval()
    cpu = bert.BertModel(cfg, device="cpu", seed=1).eval()
    fb = bert.fake_batch(cfg, 2, 128, seed=3)
    am = (fb["attention_mask"] != 0)[:, None, None, :]
    args = [torch.from_numpy(a) for a in (fb["input_ids"],
                                          fb["token_type_ids"], am)]
    with torch.inference_mode():
        g_enc, g_pooled = gpu(args[0].cuda(), args[1].cuda(),
                              attention_mask=args[2].cuda())
        c_enc, c_pooled = cpu(args[0], args[1], attention_mask=args[2])
    for name, g, c in (("encoded", g_enc, c_enc), ("pooled", g_pooled,
                                                   c_pooled)):
        err = (g.float().cpu() - c).abs()
        log(f"{name}: card bf16 vs CPU f32 max abs {float(err.max()):.4g} "
            f"mean abs {float(err.mean()):.4g}")
        if not torch.isfinite(g).all() or float(err.max()) > REF_MAX_ABS \
                or float(err.mean()) > REF_MEAN_ABS:
            raise AssertionError(f"{name} disagrees with the CPU reference")


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card()
    if FAILURES:
        sys.exit(1)
    build_kernels()
    rows = kernels()
    kernel_ms = {r["name"]: r["ms"] for r in rows or []}
    served = serve_slice(kernel_ms)
    trained = train(kernel_ms)
    if trained is not None:
        profile(trained[1])
    reference_check()
    if FAILURES or rows is None or served is None or trained is None:
        log(f"FAILED phases: {FAILURES}")
        sys.exit(1)
    for r in rows:
        # this slice's main path is the train step; the serving path's
        # counts stand beside it
        r["launches"] = trained[0][r["name"]]
        r["launches_by_path"] = {"serving": served[r["name"]],
                                 "train": trained[0][r["name"]]}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
