"""The reader decorators (`paddle_tpu_torch.reader`), `batch` and
`fluid.contrib.reader.distributed_batch_reader` against paddle_tpu's on
the CPU.

- Each decorator gives the reference's samples, in the reference's order,
  from the same source readers; `shuffle` under the same `random.seed`
  (both draw from Python's `random`).  Where the reference interleaves
  threads without an order (xmap_readers with order=False,
  multiprocess_reader), the samples are compared as multisets.
- `device_buffered` on the CPU gives the reference's values as tensors.
- The early-stop and exception cases of tests/test_reader.py:73-117 hold
  in both packages (each parametrized over the two modules).
- The exact comparisons need no tolerance: every sample is a Python
  number or an integer array.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu import reader as JR
from paddle_tpu.fluid.contrib.reader import (
    distributed_batch_reader as j_distributed)

import paddle_tpu_torch as T
from paddle_tpu_torch import reader as TR
from paddle_tpu_torch.fluid.contrib.reader import (
    distributed_batch_reader as t_distributed)

READERS = {"reference": JR, "port": TR}


def make_reader(n):
    def r():
        return iter(range(n))
    return r


def arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    data = [(rng.randint(0, 100, (3,)), int(rng.randint(0, 10)))
            for _ in range(n)]

    def r():
        return iter(data)
    return r


def _eq(a, b):
    """Structural equality of samples (arrays compared element-wise)."""
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _eq(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


# each case: (name, build(R) -> reader creator); R is either module
CASES = {
    "cache": lambda R: R.cache(arrays(7)),
    "map_readers": lambda R: R.map_readers(lambda a, b: (a[0] * 2, b),
                                           arrays(6), make_reader(6)),
    "shuffle": lambda R: R.shuffle(make_reader(50), 16),
    "shuffle_arrays": lambda R: R.shuffle(arrays(40), 7),
    "shard": lambda R: R.shard(make_reader(20), num_shards=3, shard_id=1),
    "shard_one_host": lambda R: R.shard(make_reader(9)),
    "chain": lambda R: R.chain(make_reader(3), arrays(2), make_reader(2)),
    "compose": lambda R: R.compose(arrays(5), make_reader(5)),
    "compose_unchecked": lambda R: R.compose(make_reader(2), make_reader(5),
                                             check_alignment=False),
    "buffered": lambda R: R.buffered(arrays(30), 4),
    "firstn": lambda R: R.firstn(arrays(30), 11),
    "xmap_ordered": lambda R: R.xmap_readers(lambda s: (s[0] + 1, s[1]),
                                             arrays(40), 4, 8, order=True),
    "shuffle_of_map": lambda R: R.shuffle(R.map_readers(
        lambda s: s[1], arrays(64)), 10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_decorator_gives_the_references_samples(name):
    out = {}
    for side, R in READERS.items():
        random.seed(17)
        out[side] = list(CASES[name](R)())
    assert _eq(out["port"], out["reference"]), name


def _key(s):
    return repr(s if not isinstance(s, tuple) else tuple(
        np.asarray(x).tolist() for x in s))


@pytest.mark.parametrize("name", ["xmap_unordered", "multiprocess"])
def test_an_unordered_decorator_gives_the_references_multiset(name):
    build = {
        "xmap_unordered": lambda R: R.xmap_readers(
            lambda s: (s[0] * 3, s[1]), arrays(40), 4, 8, order=False),
        "multiprocess": lambda R: R.multiprocess_reader(
            [arrays(15, 1), arrays(10, 2)], queue_size=4)}[name]
    got = {side: sorted(map(_key, build(R)())) for side, R in
           READERS.items()}
    assert got["port"] == got["reference"]


def test_compose_misaligned_raises_in_both():
    for R in READERS.values():
        with pytest.raises(ValueError, match="different lengths"):
            list(R.compose(make_reader(2), make_reader(3))())


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_gives_the_references_batches(drop_last):
    want = list(J.batch(arrays(23), 5, drop_last=drop_last)())
    got = list(T.batch(arrays(23), 5, drop_last=drop_last)())
    assert _eq(got, want)
    assert len(got) == (4 if drop_last else 5)
    with pytest.raises(ValueError):
        T.batch(arrays(3), 0)


@pytest.mark.parametrize("trainers,trainer_id", [(1, 0), (3, 0), (3, 2)])
def test_distributed_batch_reader_keeps_the_references_batches(
        monkeypatch, trainers, trainer_id):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(trainers))
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(trainer_id))
    batches = T.batch(arrays(40), 4)
    want = list(j_distributed(batches)())
    got = list(t_distributed(batches)())
    assert _eq(got, want)
    assert len(got) == len(range(trainer_id, 10, trainers))


def test_device_buffered_stages_the_references_values_on_the_device():
    src = arrays(12)
    want = list(JR.firstn(src, 12)())
    got = list(TR.device_buffered(src, size=3, device="cpu")())
    assert len(got) == len(want)
    for (ga, gb), (wa, wb) in zip(got, want):
        assert isinstance(ga, torch.Tensor) and ga.device.type == "cpu"
        assert np.array_equal(ga.numpy(), wa) and int(gb) == wb


# -- tests/test_reader.py:73-117, in both packages ---------------------------

@pytest.mark.parametrize("side", sorted(READERS))
def test_exceptions_propagate_not_swallowed(side):
    R = READERS[side]

    def bad():
        yield 1
        raise IOError("disk gone")

    with pytest.raises(IOError, match="disk gone"):
        list(R.buffered(lambda: bad(), 4)())
    with pytest.raises(IOError, match="disk gone"):
        list(R.xmap_readers(lambda x: x, lambda: bad(), 2, 4)())
    with pytest.raises(IOError, match="disk gone"):
        list(R.multiprocess_reader([lambda: bad()])())

    def boom(x):
        if x == 5:
            raise ValueError("mapper died")
        return x

    with pytest.raises(ValueError, match="mapper died"):
        list(R.xmap_readers(boom, make_reader(10), 2, 4, order=True)())


@pytest.mark.parametrize("side", sorted(READERS))
def test_compose_allows_none_samples(side):
    def with_none():
        return iter([None, 1])

    out = list(READERS[side].compose(with_none, make_reader(2))())
    assert out == [(None, 0), (1, 1)]


@pytest.mark.parametrize("side", sorted(READERS))
def test_early_stop_releases_the_threads(side):
    R = READERS[side]
    before = threading.active_count()
    for _ in range(3):
        got = list(R.firstn(R.buffered(make_reader(10000), 4), 3)())
        assert got == [0, 1, 2]
        got = list(R.firstn(
            R.xmap_readers(lambda x: x, make_reader(100000), 2, 4), 3)())
        assert len(got) == 3
        got = list(R.firstn(
            R.multiprocess_reader([make_reader(100000)], queue_size=4),
            3)())
        assert got == [0, 1, 2]
    deadline = time.monotonic() + 5
    while threading.active_count() > before + 2 and \
            time.monotonic() < deadline:
        time.sleep(0.05)  # fill threads notice the stop flag
    assert threading.active_count() <= before + 2
