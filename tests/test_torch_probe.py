"""The layout probe's plain versions (paddle_tpu_torch.ops.kernels.probe)
against the JAX tool tools/kernel4d_probe.py on the CPU: the (B, S, H, D)
and (B, S, H*D) versions against its Pallas kernels in interpret mode,
the merged (B*H, S, D) version against its `reference` (its `kernel3` is
a closure of `main` that runs only on a TPU) and against the 4D interpret
kernel, and the port's tool run on the CPU.  Inputs are bf16 values made
with numpy from a seed and handed to both packages."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.kernels import COUNTERS
from paddle_tpu_torch.ops.kernels import probe as P
from paddle_tpu_torch.tools import kernel4d_probe as K4

# bf16 outputs on both sides from the same f32 math in other summation
# orders: a P element may round the other way (measured here: 2.4e-4 or
# less)
TOL = 1e-3
SHAPES = [((2, 128, 2, 64), 64), ((2, 128, 3, 64), 128), ((1, 256, 2, 32),
                                                          128)]
IDS = ["B2S128H2D64-bq64", "B2S128H3D64-bq128", "B1S256H2D32-bq128"]


def _jax_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "kernel4d_probe.py"
    spec = importlib.util.spec_from_file_location("jax_kernel4d_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _jax_tool()


def _qkv(shape, seed):
    """q, k, v as bf16 torch tensors and the same values as jnp bf16."""
    rng = np.random.RandomState(seed)
    ts = [torch.from_numpy(rng.randn(*shape) * 0.3).to(torch.bfloat16)
          for _ in range(3)]
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]
    return ts, js


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=IDS)
def test_4d_plain_matches_the_interpret_kernel(shape, block_q):
    (q, k, v), (jq, jk, jv) = _qkv(shape, 1)
    want = JT.build(*shape, block_q, interpret=True)(jq, jk, jv)
    got = P.probe_4d_reference(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=IDS)
def test_fold3d_plain_matches_the_interpret_kernel(shape, block_q):
    b, s, h, d = shape
    (q, k, v), (jq, jk, jv) = _qkv(shape, 2)
    to3 = lambda x: x.reshape(b, s, h * d)
    want = JT.build_fold3d(*shape, block_q, interpret=True)(
        to3(jq), to3(jk), to3(jv))
    got = P.probe_fold3d_reference(to3(q), to3(k), to3(v), h)
    assert got.shape == (b, s, h * d)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=IDS)
def test_merged_plain_matches_the_reference_and_the_4d_kernel(shape,
                                                              block_q):
    """kernel3's function on pre-merged (B*H, S, D), through merge and
    unmerge, against the JAX tool's `reference` and its 4D kernel."""
    b, s, h, d = shape
    (q, k, v), (jq, jk, jv) = _qkv(shape, 3)
    got = P.unmerge_heads(P.probe_merged_reference(
        P.merge_heads(q), P.merge_heads(k), P.merge_heads(v)), h)
    assert _max_err(got, JT.reference(jq, jk, jv)) <= TOL
    assert _max_err(got, JT.build(*shape, block_q, interpret=True)(
        jq, jk, jv)) <= TOL


@pytest.mark.parametrize("shape,block_q", SHAPES, ids=IDS)
def test_the_three_plain_versions_agree_bit_for_bit(shape, block_q):
    b, s, h, d = shape
    (q, k, v), _ = _qkv(shape, 4)
    o4 = P.probe_4d_reference(q, k, v)
    o3 = P.probe_fold3d_reference(*(x.reshape(b, s, h * d)
                                    for x in (q, k, v)), h)
    om = P.probe_merged_reference(P.merge_heads(q), P.merge_heads(k),
                                  P.merge_heads(v))
    assert torch.equal(o4, o3.view(b, s, h, d))
    assert torch.equal(o4, P.unmerge_heads(om, h))


def test_the_interpret_kernels_agree_bit_for_bit():
    """What the card's check repeats: the 4D and fold3d layouts of the
    same bytes give the same bits (here in the JAX tool's interpret
    mode)."""
    shape = (2, 128, 3, 64)
    b, s, h, d = shape
    _, (jq, jk, jv) = _qkv(shape, 5)
    o4 = JT.build(*shape, 64, interpret=True)(jq, jk, jv)
    to3 = lambda x: x.reshape(b, s, h * d)
    o3 = JT.build_fold3d(*shape, 64, interpret=True)(to3(jq), to3(jk),
                                                      to3(jv))
    np.testing.assert_array_equal(_np(o4), _np(o3.reshape(shape)))


def test_probe_normalises_before_the_cast():
    """P = bf16(p / l): with v = identity columns, each output row is that
    row's bf16 probabilities; flash_forward's bf16(p) v / l differs."""
    s = 64
    rng = np.random.RandomState(6)
    q, k = (torch.from_numpy(rng.randn(1, s, 1, s)).to(torch.bfloat16)
            for _ in range(2))
    v = torch.eye(s, dtype=torch.bfloat16)[None, :, None]
    out = P.probe_4d_reference(q, k, v)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / s ** 0.5
    probs = torch.softmax(sc, -1).to(torch.bfloat16)
    assert torch.equal(out[0, :, 0], probs[0, 0])


def test_the_tools_reference_matches_the_jax_reference():
    shape = (2, 128, 2, 64)
    (q, k, v), (jq, jk, jv) = _qkv(shape, 7)
    assert _max_err(K4.reference(q, k, v), JT.reference(jq, jk, jv)) <= TOL


def test_the_tool_makes_the_jax_tools_inputs():
    q, k, v = K4.inputs(2, 16, 2, 32, "cpu")
    r = np.random.RandomState(0)
    for got in (q, k, v):
        want = jnp.asarray(r.randn(2, 16, 2, 32) * 0.3, jnp.bfloat16)
        np.testing.assert_array_equal(_np(got), _np(want))


def test_the_tool_runs_the_plain_versions_on_the_cpu():
    for c in COUNTERS.values():
        c.reset()
    out = K4.run(2, 128, 2, 64, device="cpu")
    assert out["mode"] == "cpu-plain" and out["ok"] is True
    assert all(0 < out[f"max_err_{a}"] <= TOL for a in ("4d", "fold3d",
                                                         "merged"))
    assert all(c.value == 0 for c in COUNTERS.values())


def test_the_tool_main_prints_one_json_line(capsys, monkeypatch):
    real = K4.run
    monkeypatch.setattr(K4, "run", lambda device=None: real(
        2, 64, 2, 32, device=device))
    assert K4.main(["--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["ok"] is True


def test_cpu_tensors_take_the_plain_versions_without_launching():
    for c in COUNTERS.values():
        c.reset()
    (q, k, v), _ = _qkv((1, 64, 2, 32), 8)
    assert torch.equal(P.probe_4d(q, k, v), P.probe_4d_reference(q, k, v))
    q3, k3, v3 = (x.reshape(1, 64, 64) for x in (q, k, v))
    assert torch.equal(P.probe_fold3d(q3, k3, v3, 2),
                       P.probe_fold3d_reference(q3, k3, v3, 2))
    qm, km, vm = (P.merge_heads(x) for x in (q, k, v))
    assert torch.equal(P.probe_merged(qm, km, vm),
                       P.probe_merged_reference(qm, km, vm))
    assert [COUNTERS[n].value for n in ("probe_4d", "probe_fold3d",
                                        "probe_merged")] == [0, 0, 0]


def test_merge_and_unmerge_invert_each_other():
    x = torch.arange(2 * 5 * 3 * 4, dtype=torch.float32).view(2, 5, 3, 4)
    m = P.merge_heads(x)
    assert m.shape == (6, 5, 4) and torch.equal(m[4], x[1, :, 1])
    assert torch.equal(P.unmerge_heads(m, 3), x)
