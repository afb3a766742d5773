"""The dataset path (fluid.incubate.data_generator, fluid.dataset,
dataset.feed_pipeline, the Executor's dataset loops and its NaN monitor)
against paddle_tpu's on the CPU, after the reference's own oracles in
tests/test_dataset_trainer.py, test_feed_pipeline.py and
test_async_executor.py.

- The data generators write the reference's bytes for the same records
  and refuse the same malformed ones.
- MultiSlot files parse to the reference's batches; InMemoryDataset's
  global shuffle (threads 2, one seed) gives the reference's order;
  QueueDataset with one thread streams InMemoryDataset's unshuffled
  order; epoch_order and shard_plan are the reference's.
- One process: a shard over more than one host raises, naming ROADMAP
  queue 1 item 10; set_pipe_command raises in both.
- DeviceRing: backpressure bounds the ring at its depth, the waits are
  accounted, close releases a blocked producer, and FeedPipeline
  forwards an upstream error to the consumer.
- train_from_dataset trains (the loss falls over epochs), returns the
  last fetches, prints at print_period with debug, runs a FetchHandler,
  and raises on checkpointing (ROADMAP queue 1 item 11).
- FLAGS_check_nan_inf: the reference's two cases (a NaN raises at the
  next sync, the executor is usable after; no sync a step with the flag
  on), and a planted NaN in a dataset pass raises in both, naming the
  same variable.
"""

import io
import threading
import time

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.fluid as JF
from paddle_tpu.dataset import feed_pipeline as JP
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid.incubate import data_generator as JG

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import profiler
from paddle_tpu_torch.dataset import feed_pipeline as TP
from paddle_tpu_torch.fluid.incubate import data_generator as TG

PAIRS = ((JF, lambda: JF.Executor()), (TF, lambda: TF.Executor(
    TF.CPUPlace())))


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _write(path, rows, seed, nan_row=None):
    """Lines of an 8-wide x slot and a 1-wide y slot, y = x @ W."""
    rng = np.random.RandomState(seed)
    w = np.arange(1, 9, dtype="float32") / 10.0
    with open(path, "w") as f:
        for i in range(rows):
            x = rng.randn(8).astype("float32")
            y = float(x @ w)
            xs = ["nan" if i == nan_row and j == 0 else f"{v:.6f}"
                  for j, v in enumerate(x)]
            f.write("8 " + " ".join(xs) + f" 1 {y:.6f}\n")
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slots")
    return [_write(str(d / f"part-{i}.txt"), 40, i) for i in range(3)]


def _program(fluid, lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 8], "float32")
        y = fluid.data("y", [-1, 1], "float32")
        loss = fluid.layers.reduce_mean(fluid.layers.loss.square_error_cost(
            fluid.layers.fc(x, 1), y))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, x, y, loss


def _dataset(fluid, kind, x, y, files, batch=16, threads=1):
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_use_var([x, y])
    ds.set_filelist(files)
    ds.set_thread(threads)
    return ds


# -- the data generators -----------------------------------------------------

class _Typed:
    def generate_sample(self, line):
        def it():
            yield [("words", [1926, 8, 17]), ("score", [0.5, 2.0])]
            yield [("words", [3]), ("score", [1])]
        return it


class _Strings:
    def generate_sample(self, line):
        def it():
            yield [("words", ["1926", "08", "17"]), ("label", ["1"])]
        return it


@pytest.mark.parametrize("kind", ["typed", "strings"])
def test_the_generators_write_the_references_bytes(kind):
    outs = []
    for G in (JG, TG):
        base = G.MultiSlotDataGenerator if kind == "typed" \
            else G.MultiSlotStringDataGenerator
        mixin = _Typed if kind == "typed" else _Strings
        gen = type("Gen", (mixin, base), {})()
        gen.set_batch(1)
        out = io.StringIO()
        gen._run([None, None], out)
        outs.append(out.getvalue())
    assert outs[1] == outs[0] and outs[0]


@pytest.mark.parametrize("record", [
    [("z", [1, 2]), ("y", [0.5])], [("x", [1, 2])],
    [("x", ["nope"]), ("y", [0.5])], [("x", []), ("y", [0.5])], "x 1"])
def test_the_typed_generator_refuses_as_the_reference(record):
    for G in (JG, TG):
        g = G.MultiSlotDataGenerator()
        g._gen_str([("x", [1, 2]), ("y", [0.5])])
        with pytest.raises(ValueError):
            g._gen_str(record)


# -- parsing, shuffling, sharding ----------------------------------------------

def _batches(fluid, kind, files, threads=1, seed=None):
    main, startup, x, y, _ = _program(fluid)
    ds = _dataset(fluid, kind, x, y, files, threads=threads)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 120
        if seed is not None:
            ds.set_shuffle_seed(seed)
            ds.global_shuffle()
    return [(b["x"], b["y"]) for b in ds.batch_iter()]


@pytest.mark.parametrize("threads,seed", [(1, None), (2, 3), (3, 11)])
def test_batches_and_shuffle_order_are_the_references(files, threads, seed):
    want = _batches(JF, "InMemoryDataset", files, threads, seed)
    got = _batches(TF, "InMemoryDataset", files, threads, seed)
    assert len(got) == len(want) == 8
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_queue_dataset_streams_the_unshuffled_order(files):
    got = _batches(TF, "QueueDataset", files)
    want = _batches(JF, "QueueDataset", files)
    mem = _batches(TF, "InMemoryDataset", files)
    for a, b, c in zip(got, want, mem):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[0], c[0])


@pytest.mark.parametrize("n,count,epoch,seed", [
    (0, 2, 0, 0), (5, 1, 3, 7), (12, 3, 1, 7), (37, 5, 2, 1), (3, 8, 0, 0)])
def test_shard_plans_are_the_references(n, count, epoch, seed):
    assert TP.epoch_order(n, seed, epoch) == JP.epoch_order(n, seed, epoch)
    for i in range(count):
        assert TP.shard_plan(n, i, count, epoch, seed) == \
            JP.shard_plan(n, i, count, epoch, seed)
    with pytest.raises(ValueError):
        TP.shard_plan(4, 5, 2)


def test_more_than_one_host_raises(files):
    main, startup, x, y, _ = _program(TF)
    ds = _dataset(TF, "InMemoryDataset", x, y, files)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ds.load_into_memory(shard_by_host=True, process_index=0,
                            process_count=2)
    ds.load_into_memory(shard_by_host=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        next(ds.batch_iter(shard=(0, 2)))
    q = _dataset(TF, "QueueDataset", x, y, files)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        next(q.batch_iter(shard=(1, 2)))
    assert TP.host_topology() == (0, 1)
    for fluid in (JF, TF):
        with pytest.raises(NotImplementedError):
            fluid.DatasetFactory().create_dataset().set_pipe_command("cat")
    ds.release_memory()
    assert ds.get_memory_data_size() == 0


# -- the ring --------------------------------------------------------------

def test_backpressure_bounds_the_ring_and_counts_the_waits():
    profiler.time_reset()
    ring = TP.DeviceRing(depth=2)
    seen = []

    def produce():
        for i in range(6):
            ring.put(i)
            seen.append(len(ring))
        ring.put_end()

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.3)  # the producer fills the ring and blocks
    assert len(ring) == 2 and t.is_alive()
    got = []
    while True:
        item = ring.get()
        if item is TP.DeviceRing._END:
            break
        got.append(item)
    t.join(5)
    assert got == list(range(6)) and max(seen) <= 2
    assert ring.max_occupancy == 2 and ring.total_put == 6
    times = profiler.get_time_stats()
    assert times["ring_full_wait_ms"] > 100
    assert profiler.get_int_stats()["ring_occupancy_max"] == 2
    assert TP.attribute_stall(times) in ("compute-bound", "parser-bound",
                                         "transfer-bound")


def test_close_releases_a_blocked_producer():
    ring = TP.DeviceRing(depth=1)
    ring.put("a")
    result = []
    t = threading.Thread(target=lambda: result.append(ring.put("b")))
    t.start()
    time.sleep(0.2)
    ring.close()
    t.join(5)
    assert result == [False] and ring.get() is TP.DeviceRing._END


def test_the_pipeline_forwards_an_upstream_error():
    def source():
        yield {"x": 1}
        raise KeyError("parser failed")

    pipe = TP.FeedPipeline(lambda f: f, source(), depth=2)
    it = iter(pipe)
    assert next(it) == {"x": 1}
    with pytest.raises(KeyError, match="parser failed"):
        next(it)
    report = pipe.feed_report()
    assert report["hosts"] == 1 and report["prefetch_depth"] == 2


# -- the loops ---------------------------------------------------------------

def test_train_from_dataset_trains_through_both_loaders(files):
    main, startup, x, y, loss = _program(TF)
    exe = TF.Executor(TF.CPUPlace())
    exe.run(startup)
    ds = _dataset(TF, "InMemoryDataset", x, y, files, threads=2)
    ds.load_into_memory()
    ds.global_shuffle()
    compiled = TF.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    firsts, steps = [], []
    for epoch in range(4):
        out = exe.train_from_dataset(
            compiled, ds, fetch_list=[loss],
            step_callback=lambda s, k, o: steps.append(k))
        firsts.append(float(out[0]))
    assert firsts[-1] < firsts[0] / 10
    assert steps == list(range(1, 9)) * 4
    q = _dataset(TF, "QueueDataset", x, y, files, batch=8, threads=2)
    out = exe.train_from_dataset(main, q, fetch_list=[loss])
    assert np.isfinite(out[0]) and float(out[0]) < firsts[0]
    assert profiler.get_int_stats()["prefetch_depth"] == 2


def test_debug_prints_every_print_period(files, capsys):
    main, startup, x, y, loss = _program(TF)
    exe = TF.Executor(TF.CPUPlace())
    exe.run(startup)
    ds = _dataset(TF, "QueueDataset", x, y, files)
    exe.train_from_dataset(main, ds, fetch_list=[loss], debug=True,
                           print_period=4)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train_from_dataset]")]
    assert [ln.split(":")[0] for ln in lines] == [
        "[train_from_dataset] step 4", "[train_from_dataset] step 8"]


def test_a_fetch_handler_sees_the_scope():
    main, startup, x, y, loss = _program(TF)
    scope = TF.Scope()
    TF.Executor(TF.CPUPlace()).run(startup, scope=scope)
    seen = []

    class Handler(TF.executor.FetchHandler):
        def handler(self, res):
            seen.append(res)

    w = main.global_block().all_parameters()[0].name
    mon = TF.executor.FetchHandlerMonitor(
        scope, Handler(var_dict={"w": w}, period_secs=0.01))
    mon.start()
    time.sleep(0.2)
    mon.stop()
    assert seen and np.array_equal(seen[-1]["w"], scope.get(w).numpy())


def test_checkpointing_raises(files, tmp_path):
    """Checkpointing runs (tests/test_torch_ckpt.py holds it against the
    reference): the loop commits checkpoints; what raises is a resume
    from a checkpoint written by two processes."""
    import json

    from paddle_tpu_torch import ckpt

    main, startup, x, y, loss = _program(TF)
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    exe.run(startup, scope=scope)
    root = str(tmp_path / "ck")
    exe.train_from_dataset(main, _dataset(TF, "QueueDataset", x, y, files),
                           scope=scope, checkpoint_dir=root,
                           checkpoint_every_steps=2)
    newest = ckpt.latest_checkpoint(root)
    manifest = json.loads((tmp_path / "ck" / newest.split("/")[-1]
                           / ckpt.MANIFEST_FILE).read_text())
    assert manifest["meta"]["step_in_epoch"] == 8  # 120 lines at B=16
    manifest["process_count"] = 2
    (tmp_path / "ck" / newest.split("/")[-1] / ckpt.MANIFEST_FILE) \
        .write_text(json.dumps(manifest))
    with pytest.raises(ckpt.CheckpointError, match="topology mismatch"):
        exe.train_from_dataset(main, _dataset(TF, "QueueDataset", x, y,
                                              files), scope=scope,
                               checkpoint_dir=root)


# -- the NaN monitor ----------------------------------------------------------

@pytest.fixture
def nan_flag():
    for pkg in (J, T):
        pkg.set_flags({"FLAGS_check_nan_inf": True})
    try:
        yield
    finally:
        for pkg in (J, T):
            pkg.set_flags({"FLAGS_check_nan_inf": False})


def _scaled(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [-1, 4], "float32")
        loss = fluid.layers.reduce_mean(fluid.layers.scale(x, 2.0))
    return main, loss


@pytest.mark.parametrize("fluid,make", PAIRS, ids=["reference", "port"])
def test_a_nan_raises_at_the_next_sync(fluid, make, nan_flag):
    main, loss = _scaled(fluid)
    exe = make()
    x = np.ones((2, 4), "float32")
    exe.run(main, feed={"x": x}, fetch_list=[loss], return_numpy=False)
    exe.sync()
    bad = x.copy()
    bad[0, 0] = np.nan
    exe.run(main, feed={"x": bad}, fetch_list=[loss], return_numpy=False)
    with pytest.raises(RuntimeError, match="NaN/Inf detected in variable"):
        exe.sync()
    exe.run(main, feed={"x": x}, fetch_list=[loss], return_numpy=False)
    exe.sync()


def test_the_monitor_adds_no_sync_a_step(nan_flag):
    main, loss = _scaled(TF)
    exe = TF.Executor(TF.CPUPlace())
    x = np.ones((2, 4), "float32")
    exe.run(main, feed={"x": x}, fetch_list=[loss], return_numpy=False)
    profiler.stat_reset("executor_sync_count")
    for _ in range(5):
        exe.run(main, feed={"x": x}, fetch_list=[loss], return_numpy=False)
    assert profiler.get_int_stats().get("executor_sync_count", 0) == 0
    exe.sync()


def test_a_planted_nan_in_a_pass_names_the_references_variable(
        tmp_path, nan_flag):
    path = _write(str(tmp_path / "nan.txt"), 40, 5, nan_row=20)
    names = []
    for fluid, make in PAIRS:
        main, startup, x, y, loss = _program(fluid)
        exe = make()
        exe.run(startup)
        ds = _dataset(fluid, "QueueDataset", x, y, [path], batch=8)
        with pytest.raises(RuntimeError, match="NaN/Inf detected") as e:
            exe.train_from_dataset(main, ds, fetch_list=[loss])
        names.append(str(e.value).split("variable ")[1].split()[0])
    assert names[1] == names[0]
