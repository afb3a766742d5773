"""The port's `paddle.io` and `paddle.metric` against paddle_tpu's on the
CPU, exactly: the same batches in the same order from the same dataset
with 0 and 2 process workers (and 2 threads), with shuffle under
`np.random.seed`, from an IterableDataset, through shared memory, and
from DistributedBatchSampler at num_replicas=2; the four metrics on the
same seeded numpy inputs.

The reference's process workers hand batches over in the order they
arrive; the port reads its workers in turn, which gives the sampler's
order (the order of 0 workers, one the reference can also produce).  So
the port's worker batches are held to the reference's 0-worker batches
in order, and to its 2-worker batches as a set.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric

import paddle_tpu_torch.io as tio
import paddle_tpu_torch.metric as tmetric


@pytest.fixture(autouse=True)
def _leave_global_rngs():
    """Leave numpy's and torch's global generators as each test found
    them: other files' tests in this process draw from them."""
    np_state, torch_state = np.random.get_state(), torch.get_rng_state()
    yield
    np.random.set_state(np_state)
    torch.set_rng_state(torch_state)


def _dataset(pkg, n=23):
    class Pairs(pkg.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return (rng.randn(3, 4).astype(np.float32),
                    np.array([i % 5], np.int64))

    return Pairs()


def _iterable(pkg, n=11):
    class Stream(pkg.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.full((2,), i, np.float32), np.array([i], np.int64)

    return Stream()


def _batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def _key(batch):
    return tuple(batch[1].ravel().tolist())


def _loaders(kw_j, kw_t, seed=3, n=23):
    np.random.seed(seed)
    want = _batches(jio.DataLoader(_dataset(jio, n), use_buffer_reader=False,
                                   **kw_j))
    np.random.seed(seed)
    got = _batches(tio.DataLoader(_dataset(tio, n), use_buffer_reader=False,
                                  **kw_t))
    return want, got


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_zero_workers(shuffle, drop_last):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last)
    want, got = _loaders(kw, kw)
    _same(want, got)


def _own_collate(batch):
    return tio.default_collate_fn(batch)


@pytest.mark.parametrize("ring,processes",
                         [(False, True), (True, True), (False, False)],
                         ids=["processes", "shared_memory", "threads"])
def test_two_workers(ring, processes):
    """Process workers with the default collate send their batches
    through the ring, with another collate through their queues."""
    kw = dict(batch_size=4, shuffle=True)
    port = dict(kw, num_workers=2, use_process_workers=processes)
    if not ring:
        port["collate_fn"] = _own_collate
    want0, got = _loaders(kw, port)
    _same(want0, got)
    want2, _ = _loaders(dict(kw, num_workers=2), kw)
    assert sorted(map(_key, want2)) == sorted(map(_key, got))
    _same(sorted(want2, key=_key), sorted(got, key=_key))


def test_iterable_dataset():
    want = _batches(jio.DataLoader(_iterable(jio), batch_size=3,
                                   use_buffer_reader=False))
    got = _batches(tio.DataLoader(_iterable(tio), batch_size=3,
                                  use_buffer_reader=False))
    _same(want, got)
    want2 = _batches(jio.DataLoader(_iterable(jio), batch_size=3,
                                    num_workers=2, use_buffer_reader=False))
    got2 = _batches(tio.DataLoader(_iterable(tio), batch_size=3,
                                   num_workers=2, use_buffer_reader=False))
    _same(sorted(want2, key=_key), sorted(got2, key=_key))
    # the port reads its two workers in turn
    assert [_key(b) for b in got2] == [(0, 2, 4), (1, 3, 5), (6, 8, 10),
                                      (7, 9)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler(shuffle, drop_last):
    for rank in range(2):
        js = jio.DistributedBatchSampler(_dataset(jio), 3, num_replicas=2,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        ts = tio.DistributedBatchSampler(_dataset(tio), 3, num_replicas=2,
                                         rank=rank, shuffle=shuffle,
                                         drop_last=drop_last)
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js) and len(ts) == len(js)
        want = _batches(jio.DataLoader(_dataset(jio), batch_sampler=js,
                                       use_buffer_reader=False))
        got = _batches(tio.DataLoader(_dataset(tio), batch_sampler=ts,
                                      use_buffer_reader=False))
        _same(want, got)


def test_samplers_and_collate():
    np.random.seed(7)
    want = list(jio.RandomSampler(range(10), replacement=True,
                                  num_samples=6))
    np.random.seed(7)
    assert list(tio.RandomSampler(range(10), replacement=True,
                                  num_samples=6)) == want
    np.random.seed(7)
    want = list(jio.WeightedRandomSampler([1, 2, 3, 4], 5))
    np.random.seed(7)
    assert list(tio.WeightedRandomSampler([1, 2, 3, 4], 5)) == want
    sample = [{"a": np.ones(2), "b": (np.zeros(1), 3)}] * 2
    j, t = jio.default_collate_fn(sample), tio.default_collate_fn(sample)
    assert np.array_equal(j["a"], t["a"])
    assert all(np.array_equal(u, v) for u, v in zip(j["b"], t["b"]))
    ds = tio.TensorDataset([torch.arange(4), np.arange(4) * 2])
    assert [int(v) for v in ds[3]] == [3, 6] and len(ds) == 4
    cd = tio.ComposeDataset([ds, ds])
    assert len(cd[1]) == 4
    assert [v for v in tio.ChainDataset([[1, 2], [3]])] == [1, 2, 3]
    assert len(tio.Subset(ds, [0, 2])) == 2
    parts = tio.random_split(ds, [3, 1])
    assert sorted(parts[0].indices + parts[1].indices) == [0, 1, 2, 3]


def test_buffer_reader_on_the_cpu_gives_tensors():
    np.random.seed(3)
    want = _batches(jio.DataLoader(_dataset(jio), batch_size=4,
                                   shuffle=True, use_buffer_reader=False))
    np.random.seed(3)
    got = list(tio.DataLoader(_dataset(tio), batch_size=4, shuffle=True,
                              num_workers=2, places="cpu"))
    assert all(isinstance(a, torch.Tensor) for b in got for a in b)
    _same(want, [tuple(a.numpy() for a in b) for b in got])


class _Failing(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample 5")
        return np.zeros(2, np.float32)


class _WhoAmI(tio.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([i, -1 if info is None else info.id])


def test_worker_errors_and_info():
    with pytest.raises(RuntimeError, match="bad sample 5"):
        list(tio.DataLoader(_Failing(), batch_size=2, num_workers=2,
                            use_buffer_reader=False))
    got = [b.tolist() for b in tio.DataLoader(
        _WhoAmI(), batch_size=1, num_workers=2, use_buffer_reader=False)]
    assert got == [[[0, 0]], [[1, 1]], [[2, 0]], [[3, 1]]]
    assert tio.get_worker_info() is None


def test_shared_ring_early_exit_and_epochs():
    """The ring is made once and kept: loaders left early, then whole
    epochs, give the sampler's batches.  An iteration left early and
    still open keeps its ring, and whole epochs beside it take a new
    one (sharing it, its workers would write into the new epochs'
    slots).  A batch too big for its slot (the ring is sized from one
    sample) comes through the queue."""
    loader = tio.DataLoader(_dataset(tio, 40), batch_size=2, num_workers=3,
                            use_buffer_reader=False)
    for stop in range(3):
        for j, _ in enumerate(loader):
            if j == stop:
                break
    ring = loader._ring
    want = _batches(tio.DataLoader(_dataset(tio, 40), batch_size=2,
                                   use_buffer_reader=False))
    for _ in range(2):
        _same(want, _batches(loader))
    assert loader._ring is ring and not ring.busy
    held = iter(loader)
    next(held)
    assert ring.busy
    for _ in range(2):
        _same(want, _batches(loader))
    assert loader._ring is not ring
    held.close()
    assert not ring.busy and not loader._ring.busy

    class Growing(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return np.full((i + 1,), i, np.float32)

    got = [b.tolist() for b in tio.DataLoader(
        Growing(), batch_size=1, num_workers=2, use_buffer_reader=False)]
    assert got == [[[float(i)] * (i + 1)] for i in range(6)]


# -- metrics ------------------------------------------------------------------

def _logits(seed, n=64, c=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, c).astype(np.float32),
            rng.randint(0, c, (n, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [1, (1, 5), (2, 3)])
def test_accuracy(topk):
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _logits(seed)
        jc = jm.compute(pred, label)
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        assert np.array_equal(np.asarray(jc), tc)
        jr, tr = jm.update(jc), tm.update(tc)
        assert np.array_equal(np.asarray(jr), np.asarray(tr))
        assert jm.accumulate() == tm.accumulate()
    assert jm.name() == tm.name()
    tm.reset()
    assert tm.accumulate() == (0.0 if isinstance(topk, int) else
                               [0.0] * len(topk))


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics(name):
    jm, tm = getattr(jmetric, name)(), getattr(tmetric, name)()
    for seed in range(3):
        rng = np.random.RandomState(seed)
        preds = rng.rand(50, 1).astype(np.float32)
        if name == "Auc":
            preds = np.concatenate([1 - preds, preds], axis=1)
        labels = rng.randint(0, 2, (50, 1)).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
        assert jm.accumulate() == tm.accumulate()
    assert jm.name() == tm.name()
