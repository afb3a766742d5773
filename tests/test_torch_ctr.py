"""PaddleRec's CTR-DNN (tests/torch_ctr_program.py, SMALL) trained by
train_from_dataset in both packages on the CPU.

- `build` gives the reference's Program JSON in the port.
- The same MultiSlot files (3 of 40 lines, written by the port's
  MultiSlotDataGenerator) through an InMemoryDataset shuffled from one
  seed, 4 steps at B=32, from the reference's startup values carried
  into the port with convert.load_jax_scope; the port's program through
  CompiledProgram, the reference's plain.  Held: each step's loss within
  LOSS_RTOL; the parameters' updates, and Adam's moments, as one vector
  each within UPDATE (Adam's first steps are sign-like: an element whose
  gradient is within rounding of 0 may step either way, and its update
  is lr either way); the AUC histograms equal, the AUC within LOSS_RTOL.
  Measured on the CPU: losses 8.8e-8, updates 8.4e-6, moments 1.1e-7,
  AUC equal.
- The port's CompiledProgram gives the plain Executor.run's bits.
- save_inference_model of [predict, auc] by either package, then
  load_inference_model and infer_from_dataset by the other over a file:
  every batch's predictions within F32, the histograms accumulated from
  the trained ones equal.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ctr_program as C  # noqa: E402

CFG = C.SMALL
SEED = 7
LOSS_RTOL = 1e-5
UPDATE = 1e-3
F32 = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    """The reference's Executor keeps compiled steps in a cache that
    every pytest worker shares; these runs stay out of it."""
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-12)


def _jstate(scope):
    return {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}


def _tstate(scope):
    return {n: scope.get(n).numpy() for n in scope.local_var_names()}


def _train(fluid, exe, program, out, files, scope):
    """One shuffled pass: (each step's loss, the last AUC)."""
    losses = []
    ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, CFG,
                   threads=2, seed=SEED)
    last = exe.train_from_dataset(
        program, ds, scope=scope, fetch_list=[out["loss"], out["auc"]],
        step_callback=lambda step, k, outs: losses.append(
            float(np.asarray(outs[0]))))
    return losses, float(last[1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctr")
    files = C.write_files(str(d / "train"), CFG, 3, 40)
    held = C.write_files(str(d / "test"), CFG, 1, 40, seed=100)
    jmain, jstart, jout = C.build(JF, CFG)
    tmain, tstart, tout = C.build(TF, CFG)
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(jstart, scope=jscope)
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(tstart, scope=tscope)
    load_jax_scope(tscope, _jstate(jscope))
    before = _tstate(tscope)
    compiled = TF.CompiledProgram(tmain).with_data_parallel(
        loss_name=tout["loss"].name)
    want = _train(JF, jexe, jmain, jout, files, jscope)
    got = _train(TF, texe, compiled, tout, files, tscope)
    return dict(d=d, files=files, held=held, jmain=jmain, jout=jout,
                jexe=jexe, jscope=jscope, tmain=tmain, tout=tout,
                texe=texe, tscope=tscope, before=before, want=want, got=got)


def test_the_program_is_the_references(run):
    assert json.dumps(run["tmain"].to_dict(), sort_keys=True,
                      default=str) == json.dumps(run["jmain"].to_dict(),
                                                 sort_keys=True, default=str)


def test_losses_and_auc_match_the_reference(run):
    (jl, jauc), (tl, tauc) = run["want"], run["got"]
    assert len(tl) == len(jl) == 4  # 120 samples at B=32
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tauc, jauc, rtol=LOSS_RTOL)
    assert np.isfinite(tl).all()


def test_updates_moments_and_histograms_match_the_reference(run):
    want, got, before = _jstate(run["jscope"]), _tstate(run["tscope"]), \
        run["before"]
    assert set(want) == set(got)
    params = [n for n in sorted(got) if not any(
        k in n for k in ("moment", "beta", "learning_rate", "stat_"))]
    moments = [n for n in sorted(got) if "moment" in n]
    assert "SparseFeatFactors" in params and len(moments) == 2 * len(params)
    upd = lambda s, names: np.concatenate(  # noqa: E731
        [(s[n] - before[n]).ravel() for n in names])
    assert _rel(upd(got, params), upd(want, params)) < UPDATE
    cat = lambda s, names: np.concatenate(  # noqa: E731
        [s[n].ravel() for n in names])
    assert _rel(cat(got, moments), cat(want, moments)) < UPDATE
    for n in (run["tout"]["stat_pos"].name, run["tout"]["stat_neg"].name):
        np.testing.assert_array_equal(got[n], want[n])
        assert got[n].sum() > 0


def test_compiled_program_gives_the_plain_runs_bits(run):
    ds = C.dataset(TF, "InMemoryDataset", run["tout"]["feeds"],
                   run["files"][:1], CFG)
    batch = next(ds.batch_iter())
    loss = run["tout"]["loss"]
    outs = []
    for compiled in (False, True):
        scope, exe = TF.Scope(), TF.Executor(TF.CPUPlace())
        exe.run(C.build(TF, CFG)[1], scope=scope)
        load_jax_scope(scope, run["before"])
        prog = TF.CompiledProgram(run["tmain"]).with_data_parallel(
            loss_name=loss.name) if compiled else run["tmain"]
        losses = [exe.run(prog, feed=batch, fetch_list=[loss],
                          scope=scope)[0] for _ in range(2)]
        outs.append((losses, _tstate(scope)))
    (pl, ps), (cl, cs) = outs
    np.testing.assert_array_equal(cl, pl)
    for n in ps:
        np.testing.assert_array_equal(cs[n], ps[n], err_msg=n)


def _infer(fluid, exe, dirname, held, scope):
    """load_inference_model into `scope`, then infer_from_dataset over
    `held`: (each batch's predictions, the histograms after)."""
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
    block = prog.global_block()
    ds = C.dataset(fluid, "QueueDataset", [block.var(n) for n in feeds],
                   held, CFG)
    preds = []
    # the reference's infer_from_dataset is its train_from_dataset without
    # the loop's last arguments
    loop = exe.infer_from_dataset if fluid is TF else exe.train_from_dataset
    loop(prog, ds, scope=scope, fetch_list=fetches,
         step_callback=lambda s, k, outs: preds.append(np.asarray(outs[0])))
    stats = [n for n in scope.local_var_names() if ".stat_" in n]
    return preds, {n: np.asarray(scope.get(n)) if fluid is JF
                   else scope.get(n).numpy() for n in sorted(stats)}


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_an_inference_model_runs_in_the_other_package(run, saver, tmp_path):
    dirname = str(tmp_path / "model")
    out = run["tout"] if saver == "port" else run["jout"]
    names = C.feed_names()
    targets = [out["predict"], out["auc"]]
    if saver == "port":
        with TF.scope_guard(run["tscope"]):
            TF.io.save_inference_model(dirname, names, targets, run["texe"],
                                       run["tmain"])
    else:
        with JF.scope_guard(run["jscope"]):
            JF.io.save_inference_model(dirname, names, targets, run["jexe"],
                                       run["jmain"])
    meta = json.loads((tmp_path / "model" / "meta.json").read_text())
    assert meta["format"] == "paddle_tpu.inference.v1"
    tp, ts = _infer(TF, TF.Executor(TF.CPUPlace()), dirname, run["held"],
                    TF.Scope())
    jp, js = _infer(JF, JF.Executor(), dirname, run["held"], JF.Scope())
    assert len(tp) == len(jp) == 2
    for g, w in zip(tp, jp):
        np.testing.assert_allclose(g, w, **F32)
    assert list(ts) == list(js) and len(ts) == 2
    for n in ts:
        np.testing.assert_array_equal(ts[n], js[n])
    trained = _tstate(run["tscope"])
    for n in ts:  # accumulated from the trained histograms: 40 more rows
        assert ts[n].sum() > trained[n].sum()
    assert sum(ts[n].sum() - trained[n].sum() for n in ts) == 40
