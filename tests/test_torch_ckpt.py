"""paddle_tpu_torch.ckpt against paddle_tpu.ckpt on the CPU.

- Checkpoints cross both ways bit for bit (float32, bfloat16, int64, a
  name with '/'), through write_state / read_state and through
  CheckpointManager.
- The commit protocol, the async writer and the io.checkpoint surface,
  as cases after the reference's tests/test_checkpoint.py: torn, tmp and
  partial dirs skipped, a corrupt
  manifest skipped, retention, a topology mismatch refused, the write
  overlapping the caller, backpressure, writer errors on wait() and on
  the next submit.
- train_from_dataset's auto-checkpoint on PaddleRec's CTR-DNN
  (tests/torch_ctr_program.py at SMALL, one shuffled pass of 4 steps at
  B=32 over 128 lines), both packages from the port's startup values
  (its startup program is seeded): a port run
  preempted in-process (an exception from step_callback) and resumed in
  a fresh Executor and Scope gives the uninterrupted port run's losses
  and final state bit for bit; the uninterrupted port run's losses are
  within LOSS_RTOL of the reference's in-process run of the same program
  JSON (float32 sums in other orders: tests/test_torch_ctr.py measured
  8.8e-8), with the same manifest `meta`; the port resumes a checkpoint
  the reference's train_from_dataset wrote, its remaining losses within
  LOSS_RTOL of the reference's.  The oracle is the reference's
  in-process loop, not its subprocess preempt-and-resume test
  (test_auto_checkpoint), which fails in the full suite (ROADMAP queue 3
  item 2).
- A worker process (tests/torch_ckpt_worker.py, the same job configured
  by the PADDLE_CKPT_* environment) SIGKILLed at a step boundary and
  restarted gives the uninterrupted port run's losses bit for bit.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
from paddle_tpu import ckpt as JC
from paddle_tpu.fluid import flags as jax_flags

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import ckpt as TC
from paddle_tpu_torch import profiler
from paddle_tpu_torch.ckpt import (CheckpointError, CheckpointManager,
                                   MANIFEST_FILE, WriterPool,
                                   latest_checkpoint, list_checkpoints)
from paddle_tpu_torch.fluid import flags as TFL

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_ctr_program as C  # noqa: E402

CFG = C.SMALL
SEED = 7
LOSS_RTOL = 1e-5
META = ("feed_epoch", "step_in_epoch", "executor_step", "feed_seed")


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    """The reference's Executor keeps compiled steps in a cache that every
    pytest worker shares; these runs stay out of it."""
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _state(seed=0, n=4):
    rng = np.random.RandomState(seed)
    out = {f"w_{i}": rng.randn(8, 4).astype("float32") for i in range(n)}
    out["scoped/name"] = rng.randn(3).astype("float32")
    out["step_count"] = np.arange(3, dtype=np.int64)
    out["bf"] = rng.randn(5).astype(np.float32).astype(ml_dtypes.bfloat16)
    return out


def _port(state):
    """The state as the port's tensors (bfloat16 as torch.bfloat16)."""
    out = {}
    for k, v in state.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _bits(v):
    """A value's raw bytes and dtype name, either package's."""
    if isinstance(v, torch.Tensor):
        name = str(v.dtype).replace("torch.", "")
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
        return name, v.numpy().tobytes()
    return str(v.dtype), np.ascontiguousarray(v).tobytes()


def _same_bits(got, want):
    assert set(got) == set(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


@pytest.mark.parametrize("way", ["write_state", "manager"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path, writer, way):
    state = _state()
    path = str(tmp_path / "ck")
    if writer == "reference":
        if way == "write_state":
            JC.write_state(path, state, meta={"k": 1})
        else:
            path = JC.CheckpointManager(path).save(state, 3, {"k": 1})
        got, manifest = TC.read_state(path)
        want = state
    else:
        if way == "write_state":
            TC.write_state(path, _port(state), meta={"k": 1})
        else:
            path = TC.CheckpointManager(path).save(_port(state), 3,
                                                   {"k": 1})
        got, manifest = JC.read_state(path)
        want = state
    _same_bits(got, want)
    assert manifest["meta"] == {"k": 1}
    assert manifest["format"] == "paddle_tpu.ckpt.v1"
    assert manifest["vars"]["bf"]["dtype"] == "bfloat16"


# -- the commit protocol (after tests/test_checkpoint.py) ---------------------

def _torn(tmp_path, m):
    good = m.save(_port(_state()), step=1)
    half = tmp_path / "ckpt-00000002"
    half.mkdir()
    (half / "shard_00000.npz").write_bytes(b"torn")
    assert latest_checkpoint(str(tmp_path)) == good
    with pytest.raises(CheckpointError, match="not a committed"):
        m.restore(str(half))


def _partial(tmp_path, m):
    path = m.save(_port(_state()), step=3)
    os.remove(os.path.join(path, "shard_00000.npz"))
    assert latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(CheckpointError, match="partial"):
        m.restore(path)


def _corrupt_manifest(tmp_path, m):
    old = m.save(_port(_state()), step=1)
    newer = m.save(_port(_state(seed=1)), step=2)
    with open(os.path.join(newer, MANIFEST_FILE), "w") as f:
        f.write("{ torn json")
    assert latest_checkpoint(str(tmp_path)) == old


def _retention(tmp_path, m):
    stale = tmp_path / ".tmp-ckpt-00000001"
    stale.mkdir()
    (stale / "shard_00000.npz").write_bytes(b"dead")
    m.keep = 2
    for step in (2, 3, 4, 5):
        m.save(_port(_state()), step=step)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000004",
                                            "ckpt-00000005"]


def _topology(tmp_path, m):
    path = m.save(_port(_state()), step=1)
    mf = os.path.join(path, MANIFEST_FILE)
    manifest = json.loads(Path(mf).read_text())
    manifest["process_count"] = 2
    Path(mf).write_text(json.dumps(manifest))
    with pytest.raises(CheckpointError, match="topology mismatch"):
        m.restore()
    loose, _ = m.restore(strict_topology=False)
    _same_bits(loose, _port(_state()))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        CheckpointManager(str(tmp_path), process_index=0, process_count=2)


def _roundtrip(tmp_path, m):
    path = m.save(_port(_state()), step=5, meta={"feed_epoch": 1})
    assert sorted(os.listdir(path)) == [MANIFEST_FILE, "shard_00000.npz"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    back, manifest = m.restore()
    assert manifest["meta"] == {"feed_epoch": 1}
    assert manifest["process_count"] == 1
    _same_bits(back, _port(_state()))


@pytest.mark.parametrize("case", [_roundtrip, _torn, _partial,
                                  _corrupt_manifest, _retention, _topology],
                         ids=lambda f: f.__name__.strip("_"))
def test_commit_protocol(tmp_path, case):
    case(tmp_path, CheckpointManager(str(tmp_path), keep=3))


# -- the async writer ----------------------------------------------------------

def _slow(monkeypatch, seconds):
    orig = CheckpointManager._write_job

    def slow(self, *a, **kw):
        time.sleep(seconds)
        return orig(self, *a, **kw)

    monkeypatch.setattr(CheckpointManager, "_write_job", slow)


def _boom(monkeypatch):
    def boom(self, *a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(CheckpointManager, "_write_job", boom)


def test_save_async_returns_before_the_write(tmp_path, monkeypatch):
    _slow(monkeypatch, 0.3)
    m = CheckpointManager(str(tmp_path), max_in_flight=2)
    t0 = time.perf_counter()
    m.save_async(_port(_state()), step=1)
    assert time.perf_counter() - t0 < 0.15
    assert m.in_flight >= 1
    m.wait()
    assert latest_checkpoint(str(tmp_path)) is not None


def test_backpressure_bounds_the_snapshots_in_flight(tmp_path, monkeypatch):
    _slow(monkeypatch, 0.25)
    m = CheckpointManager(str(tmp_path), max_in_flight=1)
    m.save_async(_port(_state()), step=1)
    t0 = time.perf_counter()
    m.save_async(_port(_state()), step=2)  # waits for the slot
    assert time.perf_counter() - t0 > 0.1
    assert m.in_flight <= 1
    m.wait()
    assert len(list_checkpoints(str(tmp_path))) == 2


@pytest.mark.parametrize("surfaces", ["wait", "next_save"])
def test_a_writer_error_surfaces(tmp_path, monkeypatch, surfaces):
    _boom(monkeypatch)
    m = CheckpointManager(str(tmp_path))
    m.save_async(_port(_state()), step=1)
    if surfaces == "wait":
        with pytest.raises(OSError, match="disk on fire"):
            m.wait()
        m.wait()  # cleared once raised
    else:
        while m.in_flight:
            time.sleep(0.01)
        with pytest.raises(OSError, match="disk on fire"):
            m.save_async(_port(_state()), step=2)


def test_the_pool_gauges_its_in_flight_jobs():
    pool, gate = WriterPool(max_in_flight=2), []

    def job():
        while not gate:
            time.sleep(0.005)

    pool.submit(job)
    pool.submit(job)
    assert pool.in_flight == 2
    gate.append(1)
    pool.close()
    assert profiler.get_int_stats()["ckpt_inflight_max"] >= 2


def test_a_snapshot_is_a_copy(tmp_path):
    """An in-place update after save_async does not reach the file."""
    w = torch.arange(4.0)
    m = CheckpointManager(str(tmp_path))
    m.save_async({"w": w}, step=1)
    w.mul_(0)
    m.wait()
    np.testing.assert_array_equal(TC.read_state(str(tmp_path))[0]["w"],
                                  np.arange(4.0))


# -- io.checkpoint --------------------------------------------------------------

def test_io_checkpoint(tmp_path):
    from paddle_tpu.io.checkpoint import load_state as jload
    from paddle_tpu_torch.io.checkpoint import (AsyncSaver, load_state,
                                                save_state)

    p = str(tmp_path / "state")
    save_state({"a/b": torch.ones(2, 2), "c": np.float32(3)}, p)
    assert os.path.isfile(os.path.join(p, MANIFEST_FILE))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp-")]
    back = load_state(p, target={"a/b": torch.zeros(2, 2,
                                                    dtype=torch.float64)})
    assert back["a/b"].dtype == torch.float64 and float(back["c"]) == 3.0
    np.testing.assert_array_equal(jload(p)["a/b"], np.ones((2, 2)))
    with pytest.raises(ValueError, match="empty state"):
        save_state({"a": None}, str(tmp_path / "s"))
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    saver = AsyncSaver()
    saver.save({"a": torch.ones(3)}, str(blocker / "child" / "state"))
    with pytest.raises(Exception):
        saver.wait()
    saver.wait()  # cleared once raised
    w = torch.arange(4.0)
    saver.save({"w": w}, str(tmp_path / "ck"))
    w.zero_()
    saver.wait()
    np.testing.assert_array_equal(load_state(str(tmp_path / "ck"))["w"],
                                  np.arange(4.0))


# -- the feed pipeline's resume hooks -------------------------------------------

def test_the_feed_pipeline_skips_consumed_batches_and_counts_epochs():
    from paddle_tpu_torch.dataset.feed_pipeline import FeedPipeline

    src = [{"x": np.full((2,), i, "float32")} for i in range(8)]
    got = [int(b["x"][0]) for b in FeedPipeline(lambda f: f, iter(src),
                                                depth=2, skip_batches=3)]
    assert got == [3, 4, 5, 6, 7]

    class Source:
        def batch_iter(self):
            return iter(src)

    s = Source()
    for epoch in (0, 1):
        list(FeedPipeline(lambda f: f, s))
        assert s._feed_epoch == epoch
    list(FeedPipeline(lambda f: f, s, epoch=7))
    assert s._feed_epoch == 7


# -- the flags ----------------------------------------------------------------------

CKPT_FLAGS = {"ckpt_dir": "/tmp/ck", "ckpt_every_steps": 5,
              "ckpt_every_secs": 2.5, "ckpt_keep": 1,
              "ckpt_max_in_flight": 4, "ckpt_resume": False}


@pytest.mark.parametrize("name", sorted(CKPT_FLAGS))
def test_a_ckpt_flag_takes_a_value(name):
    default = TFL.get_flags(name)
    assert default == jax_flags.get_flags(name)
    try:
        TFL.set_flags({f"FLAGS_{name}": CKPT_FLAGS[name]})
        assert TFL.get_flags(name) == CKPT_FLAGS[name]
    finally:
        TFL.set_flags({f"FLAGS_{name}": default})


# -- train_from_dataset's auto-checkpoint on CTR-DNN -----------------------------

def _run(fluid, start, files, ckpt, preempt_at=None, every=1):
    """One fresh 'process' of `fluid`: program, Executor and Scope holding
    `start` (no startup run: both executors count from step 0), one
    shuffled pass with auto-checkpoints into `ckpt`, stopped
    by an exception from step_callback after step_in_epoch `preempt_at`.
    Returns (losses by step_in_epoch, the final scope)."""
    main, _, out = C.build(fluid, CFG)
    if fluid is TF:
        exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
        for n, v in start.items():
            scope.set(n, torch.from_numpy(v.copy()))
    else:
        exe, scope = JF.Executor(), JF.Scope()
        for n, v in start.items():
            scope.set(n, v)
    losses = {}

    def cb(step, k, outs):
        losses[k] = np.asarray(outs[0]).copy()
        if k == preempt_at:
            raise KeyboardInterrupt("preempted")

    ds = C.dataset(fluid, "InMemoryDataset", out["feeds"], files, CFG,
                   threads=2, seed=SEED)
    try:
        exe.train_from_dataset(main, ds, scope=scope,
                               fetch_list=[out["loss"]], checkpoint_dir=ckpt,
                               checkpoint_every_steps=every,
                               checkpoint_keep=10, step_callback=cb)
    except KeyboardInterrupt:
        pass
    return losses, scope


def _meta(path):
    return {k: json.loads(Path(path, MANIFEST_FILE).read_text())["meta"][k]
            for k in META}


@pytest.fixture(scope="module")
def ctr(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctr_ckpt")
    files = C.write_files(str(d / "train"), CFG, 4, 32)
    _, startup, _ = C.build(TF, CFG)
    scope = TF.Scope()
    TF.Executor(TF.CPUPlace()).run(startup, scope=scope)
    start = {n: scope.get(n).numpy() for n in scope.local_var_names()}
    ref, _ = _run(JF, start, files, str(d / "ref"))
    whole, wscope = _run(TF, start, files, str(d / "whole"))
    part, _ = _run(TF, start, files, str(d / "cut"), preempt_at=2)
    rest, rscope = _run(TF, start, files, str(d / "cut"))
    return dict(d=d, files=files, start=start, ref=ref, whole=whole,
                wscope=wscope, part=part, rest=rest, rscope=rscope)


def test_a_preempted_run_resumes_to_the_uninterrupted_bits(ctr):
    assert sorted(ctr["whole"]) == [1, 2, 3, 4]
    assert sorted(ctr["part"]) == [1, 2] and sorted(ctr["rest"]) == [3, 4]
    for k in (1, 2):
        np.testing.assert_array_equal(ctr["part"][k], ctr["whole"][k])
    for k in (3, 4):
        np.testing.assert_array_equal(ctr["rest"][k], ctr["whole"][k])
    w, r = ctr["wscope"], ctr["rscope"]
    assert sorted(w.local_var_names()) == sorted(r.local_var_names())
    for n in w.local_var_names():
        assert torch.equal(w.get(n), r.get(n)), n
    assert profiler.get_int_stats().get("feed_skipped_batches", 0) >= 2


def test_the_uninterrupted_run_is_the_references(ctr):
    assert sorted(ctr["ref"]) == sorted(ctr["whole"])
    for k in ctr["ref"]:
        np.testing.assert_allclose(ctr["whole"][k], ctr["ref"][k],
                                   rtol=LOSS_RTOL)
    ours, theirs = (list_checkpoints(str(ctr["d"] / w))
                    for w in ("whole", "ref"))
    assert len(ours) == len(theirs) == 4
    for (_, a), (_, b) in zip(ours, theirs):
        assert _meta(a) == _meta(b)


def test_the_port_resumes_a_reference_checkpoint(ctr, tmp_path):
    """The reference's checkpoint after step 2, alone in a root: the port
    resumes at step 3."""
    theirs = list_checkpoints(str(ctr["d"] / "ref"))
    after2 = next(p for _, p in theirs if _meta(p)["step_in_epoch"] == 2)
    shutil.copytree(after2, tmp_path / "root" / os.path.basename(after2))
    with pytest.warns(UserWarning, match="different flags"):
        rest, _ = _run(TF, ctr["start"], ctr["files"], str(tmp_path / "root"))
    assert sorted(rest) == [3, 4]
    for k in (3, 4):
        np.testing.assert_allclose(rest[k], ctr["ref"][k], rtol=LOSS_RTOL)


def test_checkpointing_in_the_dataset_loop_writes_the_reference_layout(ctr):
    path = latest_checkpoint(str(ctr["d"] / "whole"))
    manifest = json.loads(Path(path, MANIFEST_FILE).read_text())
    assert manifest["meta"]["step_in_epoch"] == 4
    assert manifest["meta"]["feed_seed"] == SEED
    assert "SparseFeatFactors" in manifest["vars"]
    state, _ = JC.read_state(path)
    for n, v in state.items():
        want = ctr["wscope"].get(n)
        np.testing.assert_array_equal(v, want.numpy(), err_msg=n)


# -- SIGKILL at a step boundary -----------------------------------------------------

def _worker(out, data, ck, kill_at=None):
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), DATA_DIR=data,
               PADDLE_CKPT_DIR=ck, PADDLE_CKPT_EVERY_STEPS="1",
               KILL_AT_STEP=str(-1 if kill_at is None else kill_at))
    return subprocess.run([sys.executable, str(HERE / "torch_ckpt_worker.py"),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)


def _trajectory(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        step, loss = line.split()
        out[int(step)] = loss  # a replayed step overwrites
    return out


def test_a_sigkilled_worker_resumes_to_the_uninterrupted_losses(ctr,
                                                                tmp_path):
    want = [f"{float(ctr['whole'][k]):.9g}" for k in sorted(ctr["whole"])]
    log, ck = tmp_path / "t.txt", str(tmp_path / "ck")
    rc = _worker(log, str(ctr["d"] / "train"), ck, kill_at=3)
    assert rc.returncode == -signal.SIGKILL, rc.stderr
    assert len(_trajectory(log)) == 2 and latest_checkpoint(ck) is not None
    rc = _worker(log, str(ctr["d"] / "train"), ck)
    assert rc.returncode == 0, rc.stdout + rc.stderr
    got = _trajectory(log)
    assert [got[s] for s in sorted(got)] == want
