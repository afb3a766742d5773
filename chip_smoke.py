"""Drive paddle_tpu_torch on one NVIDIA GPU: build the hand-written
kernels, hold each against its plain PyTorch version at BERT-base shapes,
serve BERT-base through serving.Engine, and check what comes out.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result):
  1. card     nvidia-smi name and power limit
  2. build    nvcc for sm_90a, every csrc/*.cu in parallel
  3. kernels  each kernel vs its plain version on the card (stated
              tolerances), timed beside its plain version, a PyTorch
              library call computing the same function, and its bound
  4. slice    BertModel(BertConfig.base()) in bf16 with seeded weights,
              served through serving.Engine(max_batch_size=32) to
              requests of 1-16 rows at S=512 from several client threads;
              every response finite and equal to a direct forward of the
              same rows; each kernel launched 12 times per model call
  5. check    the same model at base width, 2 layers, on the card (bf16)
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
# served response vs a direct forward of the same rows: the kernels are
# row-independent, but cuBLAS may pick other GEMM kernels for other batch
# sizes, and bf16 rounding differences then travel through 12 layers
SERVE_MAX_ABS = 0.25
SERVE_MEAN_ABS = 0.01
# bf16 on the card vs f32 on the CPU, 2 layers at base width
REF_MAX_ABS = 0.15
REF_MEAN_ABS = 0.02

SEQ = 512
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
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"{r['bound_by']}) at {r['shape']}")
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
        if n == 0 or n != cfg.num_hidden_layers * calls[0]:
            raise AssertionError(
                f"{name}: {n} launches for {calls[0]} model calls (want "
                f"{cfg.num_hidden_layers} per call)")

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
    for name, ms in (kernel_ms or {}).items():
        share = cfg.num_hidden_layers * ms / fwd_ms
        log(f"  {name}: {cfg.num_hidden_layers} x {ms:.4f} ms = "
            f"{100 * share:.1f}% of the forward")
    return launches


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
    launches = serve_slice({r["name"]: r["ms"] for r in rows or []})
    reference_check()
    if FAILURES or rows is None or launches is None:
        log(f"FAILED phases: {FAILURES}")
        sys.exit(1)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
