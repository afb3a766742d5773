"""The inference C ABI of the port (`csrc/c_api.cc`,
`inference/c_bridge.py`, `core_native.build_c_api`) and its native queue
(`core_native.BlockingQueue`) against paddle_tpu's on the CPU.

- g++ builds `libpaddle_tpu_torch_c.so` into paddle_tpu_torch/_build/,
  one library without libpython and one with it, each cached under its
  own key.
- LeNet is exported by both packages with the same weights (the port's
  carried over by convert.load_jax_state), and a 2-layer, 64-wide
  nn.TransformerEncoder by the port (f32 in and out, its plain kernels on
  the CPU).  One ctypes host in a clean subprocess (no torch and no port
  module loaded before PT_NewPredictor) serves both through PT_*: its
  outputs equal the port's in-process Predictor.run exactly, and LeNet's
  is within REF_TOL of the reference's Predictor (the two packages'
  float32 convolutions sum in other orders; measured ~1e-6).  The -2
  contract and a bad prefix (NULL, the error text) hold there.
- The reference's pure-C host, examples/c_inference/predictor_demo.c, is
  compiled unchanged against the port's library and run once: its
  printed logits (6 decimals) within DEMO_TOL of the port's Predictor.
- run_f32 refuses a model whose input is not float32.
- BlockingQueue passes the reference's FIFO, close and backpressure
  tests (tests/test_io.py:20-75), on both packages' queues.
"""

import ctypes
import json
import os
import site
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu.core_native as JN
from paddle_tpu import inference as JI
from paddle_tpu.jit import functional_state
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as T
from paddle_tpu_torch import core_native as TN
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.inference import c_bridge
from paddle_tpu_torch.vision.models import LeNet as TLeNet

ROOT = Path(__file__).resolve().parents[1]
REF_TOL = dict(rtol=1e-5, atol=1e-5)
DEMO_TOL = dict(rtol=0, atol=1e-5)

# the ctypes host: argv = library, then (prefix, input .npy, output .npy)
# triples; prints one JSON line
_HOST = r"""
import ctypes, json, sys
import numpy as np

so, jobs = sys.argv[1], sys.argv[2:]
lib = ctypes.CDLL(so)
lib.PT_GetLastError.restype = ctypes.c_char_p
lib.PT_Init.argtypes = [ctypes.c_char_p]
lib.PT_NewPredictor.restype = ctypes.c_void_p
lib.PT_NewPredictor.argtypes = [ctypes.c_char_p]
F32P = ctypes.POINTER(ctypes.c_float)
I64P = ctypes.POINTER(ctypes.c_int64)
lib.PT_PredictorRun.argtypes = [
    ctypes.c_void_p, F32P, I64P, ctypes.c_int, F32P, ctypes.c_int64, I64P,
    I64P, ctypes.POINTER(ctypes.c_int)]
lib.PT_DeletePredictor.argtypes = [ctypes.c_void_p]
clean = not any(m == "torch" or m.startswith(("torch.", "paddle_tpu"))
                for m in sys.modules)
assert lib.PT_Init(b"") == 0, lib.PT_GetLastError()
report = {"clean": clean, "small": []}
for k in range(0, len(jobs), 3):
    prefix, inp, outp = jobs[k:k + 3]
    h = lib.PT_NewPredictor(prefix.encode())
    assert h, lib.PT_GetLastError()
    x = np.ascontiguousarray(np.load(inp), np.float32)
    shape = (ctypes.c_int64 * x.ndim)(*x.shape)
    count, ondim = ctypes.c_int64(), ctypes.c_int()
    oshape = (ctypes.c_int64 * 8)()

    def run(buf):
        return lib.PT_PredictorRun(
            h, x.ctypes.data_as(F32P), shape, x.ndim,
            buf.ctypes.data_as(F32P), buf.size, ctypes.byref(count),
            oshape, ctypes.byref(ondim))

    out = np.zeros(1 << 16, np.float32)
    assert run(out) == 0, lib.PT_GetLastError()
    np.save(outp, out[:count.value].reshape(
        [oshape[i] for i in range(ondim.value)]))
    tiny = np.zeros(2, np.float32)
    report["small"].append([run(tiny), count.value])
    lib.PT_DeletePredictor(h)
report["bad_prefix_null"] = lib.PT_NewPredictor(b"/nonexistent/m") is None
report["bad_prefix_error"] = lib.PT_GetLastError().decode()
from paddle_tpu_torch.ops.kernels import COUNTERS
report["launches"] = {n: c.value for n, c in COUNTERS.items()}
print(json.dumps(report))
"""


def _env():
    """The repo and this interpreter's site-packages on PYTHONPATH: an
    embedded interpreter starts from libpython's prefix, not a venv's."""
    old = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + site.getsitepackages() + ([old] if old else [])))


class _EncoderF32(torch.nn.Module):
    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, x):
        return self.encoder(x.float()).float()


@pytest.fixture(scope="module")
def libs():
    return TN.build_c_api(), TN.build_c_api(embed=True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """LeNet in both packages with the same weights, the port's encoder;
    each exported, with its input and the in-process outputs."""
    d = tmp_path_factory.mktemp("capi")
    jnet = JLeNet(num_classes=10)
    tnet = load_jax_state(TLeNet(num_classes=10, device="cpu"), {
        k: np.asarray(v) for k, v in functional_state(jnet).items()})
    x = np.random.RandomState(0).uniform(-1, 1, (1, 1, 28, 28)).astype(
        np.float32)
    spec = [([1, 1, 28, 28], "float32")]
    jp = JI.save_inference_model(str(d / "j_lenet"), jnet, spec)
    tp = TI.save_inference_model(str(d / "t_lenet"), tnet, spec)
    layer = T.nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0)
    enc = _EncoderF32(T.nn.TransformerEncoder(layer, 2)).eval()
    xe = np.random.RandomState(1).standard_normal((2, 8, 64)).astype(
        np.float32)
    ep = TI.save_inference_model(str(d / "t_encoder"), enc, [xe])
    out = dict(dir=d, x=x, xe=xe, j_lenet=jp, t_lenet=tp, encoder=ep)
    out["want_j"] = JI.Predictor(JI.Config(jp)).run([x])[0]
    out["want_t"] = TI.Predictor(TI.Config(tp, device="cpu")).run([x])[0]
    out["want_e"] = TI.Predictor(TI.Config(ep, device="cpu")).run([xe])[0]
    return out


def test_the_library_builds_into_the_ports_build_dir(libs):
    plain, embed = libs
    for so in libs:
        assert Path(so).name == "libpaddle_tpu_torch_c.so"
        assert Path(so).parent.parent == ROOT / "paddle_tpu_torch" / "_build"
    assert plain != embed  # the link flags are part of the key
    assert TN.build_c_api() == plain and TN.build_c_api(embed=True) == embed
    needed = subprocess.run(["ldd", embed], capture_output=True, text=True)
    assert "libpython" in needed.stdout
    assert "libpython" not in subprocess.run(
        ["ldd", plain], capture_output=True, text=True).stdout


def test_a_ctypes_host_serves_both_models_in_a_clean_process(libs, models):
    d = models["dir"]
    np.save(d / "x.npy", models["x"])
    np.save(d / "xe.npy", models["xe"])
    r = subprocess.run(
        [sys.executable, "-c", _HOST, libs[0],
         models["t_lenet"], str(d / "x.npy"), str(d / "y.npy"),
         models["encoder"], str(d / "xe.npy"), str(d / "ye.npy")],
        capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep["clean"]
    got, got_e = np.load(d / "y.npy"), np.load(d / "ye.npy")
    # exact: the same export, the same plain kernels, the same process
    # kind; the ABI only copies
    assert got.shape == models["want_t"].shape
    assert np.array_equal(got, models["want_t"])
    assert np.array_equal(got_e, models["want_e"])
    np.testing.assert_allclose(got, models["want_j"], **REF_TOL)
    assert rep["small"] == [[-2, got.size], [-2, got_e.size]]
    assert rep["bad_prefix_null"]
    assert "/nonexistent/m" in rep["bad_prefix_error"]
    assert set(rep["launches"].values()) == {0}  # the CPU: plain versions


def test_the_references_pure_c_host_runs_against_the_ports_library(
        libs, models, tmp_path):
    embed = libs[1]
    exe = str(tmp_path / "predictor_demo")
    demo = ROOT / "examples" / "c_inference" / "predictor_demo.c"
    libdir = os.path.dirname(embed)
    cc = subprocess.run(
        ["gcc", "-O2", str(demo), "-o", exe, f"-L{libdir}",
         "-lpaddle_tpu_torch_c", f"-Wl,-rpath,{libdir}",
         f"-L{sysconfig.get_config_var('LIBDIR')}",
         f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-ldl", "-lm"],
        capture_output=True, text=True)
    assert cc.returncode == 0, cc.stderr[-2000:]
    inp = str(tmp_path / "x.f32")
    models["x"].tofile(inp)
    r = subprocess.run([exe, str(ROOT), models["t_lenet"], inp],
                       capture_output=True, text=True, timeout=300,
                       env=_env())
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-2000:])
    got = np.asarray([float(ln.split("=")[1]) for ln in r.stdout.splitlines()
                      if ln.startswith("out[")], np.float32)
    np.testing.assert_allclose(got, models["want_t"].reshape(-1), **DEMO_TOL)
    np.testing.assert_allclose(got, models["want_j"].reshape(-1), **DEMO_TOL)


def test_run_f32_in_process_and_its_refusal(models, tmp_path):
    pred = c_bridge.new_predictor(models["t_lenet"])
    assert pred.device.type == "cpu"  # the export's device
    x = np.ascontiguousarray(models["x"])
    out, shape = c_bridge.run_f32(pred, x.ctypes.data, list(x.shape))
    assert shape == [1, 10] and out.dtype == np.float32
    assert np.array_equal(out, models["want_t"])

    class Ids(torch.nn.Module):
        def forward(self, ids):
            return ids.float() * 2.0

    prefix = TI.save_inference_model(str(tmp_path / "ids"), Ids(),
                                     [([2, 3], "int64")])
    ids = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="one float32 input"):
        c_bridge.run_f32(c_bridge.new_predictor(prefix), ids.ctypes.data,
                         [2, 3])


# -- BlockingQueue: tests/test_io.py:20-75 on both queues ---------------------

QUEUES = {"reference": JN, "port": TN}


@pytest.mark.parametrize("side", sorted(QUEUES))
def test_queue_available_and_fifo(side):
    N = QUEUES[side]
    assert N.native_available()
    q = N.BlockingQueue(8)
    for i in range(5):
        q.push({"i": i, "a": np.arange(4) + i})
    assert q.size() == 5 and q.capacity == 8
    got = [q.pop() for _ in range(5)]
    assert [g["i"] for g in got] == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(got[3]["a"], np.arange(4) + 3)
    with pytest.raises(TimeoutError):
        q.pop(timeout=0.05)
    q.close()
    assert not q.push(1)
    with pytest.raises(StopIteration):
        q.pop()


@pytest.mark.parametrize("side", sorted(QUEUES))
def test_queue_close_unblocks_consumer(side):
    q = QUEUES[side].BlockingQueue(2)
    done = []

    def consumer():
        try:
            q.pop()
        except StopIteration:
            done.append(1)

    t = threading.Thread(target=consumer)
    t.start()
    q.close()
    t.join(timeout=5)
    assert not t.is_alive() and done == [1]


@pytest.mark.parametrize("side", sorted(QUEUES))
def test_queue_capacity_backpressure(side):
    q = QUEUES[side].BlockingQueue(2)
    q.push(1)
    q.push(2)
    flag = []

    def pusher():
        q.push(3)
        flag.append(1)

    t = threading.Thread(target=pusher, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not flag  # blocked at capacity
    assert q.pop() == 1
    t.join(timeout=5)
    assert not t.is_alive() and flag
    assert [q.pop(), q.pop()] == [2, 3]
