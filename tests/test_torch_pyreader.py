"""`io.DataLoader.from_generator` and `io.PyReader` (also under
`fluid.io`) against paddle_tpu.io's on the CPU.

- Each set_* / decorate_* form, with return_list both ways, gives the
  reference's batches: the same count, order, column order (or feed
  names) and dtypes, and equal values (exact: both collate with
  np.stack).  The port's batches come as numpy arrays, the reference's,
  with `use_double_buffer` on or off (not read, as in the reference).
- A batch generator's tensors reach the consumer as the same objects:
  the producer thread hands them over without a copy.
- The reference's refusals hold in both: PyReader(iterable=False), a
  loader with no generator, a column count that differs from feed_list.
- The port's `capacity` bounds its producer thread; an exception in the
  generator reaches the consumer; leaving early stops the producer.
- BASELINE configs[0]: models/mnist.py's static program takes 3 Adam
  steps through a PyReader in each package from the reference's startup
  values (convert.load_jax_scope), fed by paddle.batch over
  paddle.reader.shuffle (the same random.seed): each loss within
  LOSS_TOL of the reference's (float32 through the same conv / batch
  norm / fc graph; measured ~1e-7).
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu.fluid as JF
import paddle_tpu.io as JIO
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.models import mnist as JM

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
import paddle_tpu_torch.io as TIO
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.models import mnist as TM

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
FEEDS = ["x", "y"]


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def samples(n=11):
    def r():
        rng = np.random.RandomState(3)
        for i in range(n):
            yield (rng.randn(2, 3).astype(np.float32), np.int64(i))
    return r


def sample_lists():
    return J.batch(samples(), 4)


def batches():
    def r():
        for b in sample_lists()():
            yield [np.stack([s[0] for s in b]), np.stack(
                [np.array([s[1]]) for s in b])]
    return r


# form -> (configure(loader) for from_generator, decorate(reader) for PyReader)
FORMS = {
    "sample": (lambda L, **p: L.set_sample_generator(samples(), 4, **p),
               lambda R, **p: R.decorate_sample_generator(samples(), 4,
                                                          **p)),
    "sample_keep_last": (
        lambda L, **p: L.set_sample_generator(samples(), 4, drop_last=False,
                                              **p),
        lambda R, **p: R.decorate_sample_generator(samples(), 4,
                                                   drop_last=False, **p)),
    "sample_list": (lambda L, **p: L.set_sample_list_generator(
        sample_lists(), **p), lambda R, **p: R.decorate_sample_list_generator(
        sample_lists(), **p)),
    "batch": (lambda L, **p: L.set_batch_generator(batches(), **p),
              lambda R, **p: R.decorate_batch_generator(batches(), **p)),
}


def _columns(batch, return_list):
    return list(batch) if return_list else [batch[k] for k in FEEDS]


def _same(got, want, return_list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if not return_list:
            assert isinstance(g, dict) and list(g) == list(w) == FEEDS
        for gc, wc in zip(_columns(g, return_list), _columns(w, return_list)):
            assert isinstance(gc, np.ndarray)
            assert gc.dtype == np.asarray(wc).dtype
            assert np.array_equal(gc, np.asarray(wc))


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("return_list", [True, False])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_from_generator_gives_the_references_batches(form, return_list,
                                                     double_buffer):
    configure = FORMS[form][0]
    want = list(configure(JIO.DataLoader.from_generator(
        feed_list=FEEDS, capacity=4, return_list=return_list)))
    loader = TIO.DataLoader.from_generator(
        feed_list=FEEDS, capacity=4, return_list=return_list,
        use_double_buffer=double_buffer)
    got = list(configure(loader, places="cpu"))
    _same(got, want, return_list)
    assert list(loader()) and len(list(loader)) == len(want)  # re-iterable


@pytest.mark.parametrize("return_list", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_pyreader_gives_the_references_batches(form, return_list):
    decorate = FORMS[form][1]
    jr = JIO.PyReader(feed_list=FEEDS, capacity=4, return_list=return_list)
    decorate(jr)
    tr = TF.io.PyReader(feed_list=FEEDS, capacity=4, return_list=return_list)
    decorate(tr, places=TF.CPUPlace())
    _same(list(tr()), list(jr), return_list)


@pytest.mark.parametrize("kind", ["from_generator", "pyreader"])
def test_a_batch_generators_tensors_arrive_as_the_same_objects(kind):
    made = [[torch.randn(4, 3), torch.arange(4).reshape(4, 1)]
            for _ in range(5)]

    def gen():
        yield from made

    if kind == "pyreader":
        loader = TIO.PyReader(feed_list=FEEDS, capacity=2, return_list=True)
        loader.decorate_batch_generator(gen, places=TF.CPUPlace())
    else:
        loader = TIO.DataLoader.from_generator(feed_list=FEEDS, capacity=2)
        loader.set_batch_generator(gen, places="cpu")
    got = list(loader)
    assert len(got) == len(made)
    for g, m in zip(got, made):
        assert len(g) == len(m) and all(a is b for a, b in zip(g, m))


def test_the_references_refusals_hold_in_both():
    for IO in (JIO, TIO):
        with pytest.raises(NotImplementedError, match="iterable=False"):
            IO.PyReader(feed_list=FEEDS, iterable=False)
        with pytest.raises(RuntimeError, match="no generator set"):
            list(IO.DataLoader.from_generator(feed_list=FEEDS))
        loader = IO.DataLoader.from_generator(feed_list=["x"],
                                              return_list=False)
        loader.set_sample_generator(samples(), 4, places="cpu")
        with pytest.raises(ValueError, match="silent zip"):
            list(loader)
    assert TF.io.PyReader is TIO.PyReader
    assert TF.io.DataLoader is TIO.DataLoader


def test_capacity_bounds_the_producer_and_errors_reach_the_consumer():
    made = []

    def gen():
        for i in range(100):
            made.append(i)
            yield [np.full(2, i)]

    loader = TIO.DataLoader.from_generator(capacity=3)
    loader.set_batch_generator(gen)
    it = iter(loader)
    assert int(next(it)[0][0]) == 0
    time.sleep(0.3)
    # one consumed, `capacity` queued, one made and waiting to be pushed
    assert len(made) <= 1 + 3 + 1
    before = threading.active_count()
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() >= before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() < before
    assert len(made) <= 6

    def bad():
        yield [np.zeros(2)]
        raise IOError("disk gone")

    loader.set_batch_generator(bad)
    with pytest.raises(IOError, match="disk gone"):
        list(loader)


# -- configs[0]: MNIST through PyReader in both packages ---------------------

def _mnist_reader(n=192):
    rng = np.random.RandomState(7)
    images = rng.rand(n, 784).astype(np.float32) * 2 - 1
    labels = rng.randint(0, 10, n)

    def samples():
        for i in range(n):
            yield images[i], int(labels[i])

    def chw(s):
        return s[0].reshape(1, 28, 28), np.array([s[1]], np.int64)

    return lambda P: P.batch(P.reader.shuffle(P.reader.map_readers(
        chw, samples), 64), 32, drop_last=True)


def test_mnist_takes_the_references_adam_steps_through_pyreader():
    make = _mnist_reader()
    with JF.unique_name.guard():
        jmain, jstart, _, jfetch = JM.build_train_program()
    jexe, jscope = JF.Executor(), JF.Scope()
    jexe.run(jstart, scope=jscope)
    with TF.unique_name.guard():
        tmain, tstart, _, tfetch = TM.build_train_program()
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    texe.run(tstart, scope=tscope)
    load_jax_scope(tscope, {n: np.asarray(jscope.get(n))
                            for n in jscope.local_var_names()})
    losses = {}
    for side, P, main, exe, scope, fetch in (
            ("reference", J, jmain, jexe, jscope, jfetch),
            ("port", T, tmain, texe, tscope, tfetch)):
        gb = main.global_block()
        feeds = [gb.var("img"), gb.var("label")]
        if side == "port":
            rd = TF.io.PyReader(feed_list=feeds, capacity=4)
            rd.decorate_sample_list_generator(make(P), places=TF.CPUPlace())
        else:
            rd = JIO.PyReader(feed_list=feeds, capacity=4)
            rd.decorate_sample_list_generator(make(P))
        random.seed(11)
        out = []
        for step, feed in enumerate(rd):
            if step == 3:
                break
            out.append(float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[fetch[0]], scope=scope)[0])))
        losses[side] = out
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["reference"],
                               **LOSS_TOL)
