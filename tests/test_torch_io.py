"""The port's datasets, samplers and DataLoader against the JAX
package's, on the CPU.

The index streams must be the JAX package's exactly (both draw from a
per-instance numpy ``RandomState``): sampler orders over several epochs,
``random_split``, batches of a seeded DataLoader, and the resume cursor
(``state_dict`` after k batches, mid-epoch and at the epoch boundary)
with the batches a resumed loader then yields. Values are integers or
exact copies: compared for equality.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io import DataLoader as JaxDataLoader
from paddle_tpu_torch import io

N = 23


def _data():
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    y = np.arange(N, dtype=np.int64) * 10
    return x, y


def _epochs(sampler, n=3):
    return [list(sampler) for _ in range(n)]


SAMPLERS = {
    "random": (lambda m: m.RandomSampler(range(N), seed=7)),
    "random_replacement": (lambda m: m.RandomSampler(
        range(N), replacement=True, num_samples=31, seed=3)),
    "random_num_samples": (lambda m: m.RandomSampler(range(N),
                                                     num_samples=9, seed=5)),
    "random_generator_int": (lambda m: m.RandomSampler(range(N),
                                                       generator=11)),
    "weighted": (lambda m: m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), num_samples=40, seed=2)),
    "weighted_no_replacement": (lambda m: m.WeightedRandomSampler(
        np.linspace(0.1, 2.0, N), num_samples=10, replacement=False,
        seed=2)),
    "subset_random": (lambda m: m.SubsetRandomSampler(
        [3, 1, 4, 15, 9, 2, 6], seed=8)),
    "sequence": (lambda m: m.SequenceSampler(range(N))),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_orders_match_jax(name):
    make = SAMPLERS[name]
    assert _epochs(make(io)) == _epochs(make(paddle.io))


@pytest.mark.parametrize("name", ["random", "weighted", "subset_random"])
def test_sampler_state_is_the_epoch_start(name):
    make = SAMPLERS[name]
    s = make(io)
    it = iter(s)
    first = [next(it) for _ in range(4)]
    state = s.state_dict()
    # the JAX sampler's state at the same point is the same json-able list
    j = make(paddle.io)
    jit = iter(j)
    for _ in range(4):
        next(jit)
    assert state == j.state_dict()
    rest = list(it)
    s2 = make(io)
    s2.load_state_dict(state)
    assert list(s2) == first + rest


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    for rank in range(3):
        kw = dict(batch_size=4, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        t = io.DistributedBatchSampler(list(range(N)), **kw)
        j = paddle.io.DistributedBatchSampler(list(range(N)), **kw)
        assert len(t) == len(j)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
        assert t.state_dict() == j.state_dict()


def test_distributed_batch_sampler_needs_replicas_and_rank():
    with pytest.raises(ValueError, match="num_replicas and rank"):
        io.DistributedBatchSampler(list(range(N)), batch_size=2)
    with pytest.raises(ValueError, match="rank 3"):
        io.DistributedBatchSampler(list(range(N)), batch_size=2,
                                   num_replicas=3, rank=3)


@pytest.mark.parametrize("lengths", [[10, 8, 5], [0.5, 0.3, 0.2]])
def test_random_split_matches_jax(lengths):
    t = io.random_split(list(range(N)), lengths, generator=4)
    j = paddle.io.random_split(list(range(N)), lengths, generator=4)
    assert [s.indices for s in t] == [s.indices for s in j]
    # a torch.Generator seeds through its initial_seed()
    g = torch.Generator().manual_seed(4)
    assert [s.indices for s in io.random_split(list(range(N)), lengths,
                                               generator=g)] == [
        s.indices for s in t]


def test_datasets_compose_concat_chain_subset():
    x, y = _data()
    a = io.TensorDataset([x, y])
    b = io.TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    assert len(a) == N and np.array_equal(a[3][0], x[3])
    assert torch.equal(b[4][1], torch.tensor(40))
    comp = io.ComposeDataset([a, io.TensorDataset([y])])
    assert len(comp[2]) == 3 and comp[2][2] == y[2]
    cat = io.ConcatDataset([a, io.Subset(a, [0, 1])])
    assert len(cat) == N + 2 and np.array_equal(cat[N + 1][0], x[1])
    assert np.array_equal(cat[-1][0], x[1])

    class Stream(io.IterableDataset):
        def __init__(self, k):
            self.k = k

        def __iter__(self):
            return iter(range(self.k))

    assert list(iter(io.ChainDataset([Stream(2), Stream(3)]))) == [
        0, 1, 0, 1, 2]
    with pytest.raises(ValueError):
        io.TensorDataset([x, y[:3]])


def _jax_batches(loader):
    return [tuple(np.asarray(t.numpy()) for t in b) for b in loader]


def _port_batches(loader):
    return [tuple(t.numpy() for t in b) for b in loader]


def _loaders(num_workers=0, drop_last=False, seed=9):
    x, y = _data()
    t = io.DataLoader(
        io.TensorDataset([x, y]),
        batch_sampler=io.BatchSampler(
            sampler=io.RandomSampler(range(N), seed=seed), batch_size=4,
            drop_last=drop_last),
        num_workers=num_workers, device="cpu")
    j = JaxDataLoader(
        paddle.io.TensorDataset([x, y]),
        batch_sampler=paddle.io.BatchSampler(
            sampler=paddle.io.RandomSampler(range(N), seed=seed),
            batch_size=4, drop_last=drop_last))
    return t, j


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_batches_match_jax_over_epochs(num_workers, drop_last):
    t, j = _loaders(num_workers, drop_last)
    for _ in range(3):
        _assert_same(_port_batches(t), _jax_batches(j))


@pytest.mark.parametrize("cut", [0, 3, 6])
def test_dataloader_resume_cursor_matches_jax(cut):
    """k batches into epoch 1 (cut 6 = the epoch boundary: all six
    batches served), both loaders' state_dicts are equal, and a fresh
    loader resumed from the port's yields what the uninterrupted one
    does, into the next epoch."""
    t, j = _loaders()
    _port_batches(t)
    _jax_batches(j)                 # epoch 0 in full
    tit, jit = iter(t), iter(j)
    for _ in range(cut):
        next(tit)
        next(jit)
    state = t.state_dict()
    assert state == j.state_dict()
    want = [tuple(x.numpy() for x in b) for b in tit] + _port_batches(t)

    r, _ = _loaders()
    r.load_state_dict(state)
    _assert_same(_port_batches(r) + _port_batches(r), want)


def test_dataloader_state_after_a_finished_epoch_rolls_forward():
    t, j = _loaders()
    _port_batches(t)
    _jax_batches(j)
    state = t.state_dict()
    assert state == j.state_dict() and state["batches_served"] == 0
    r, _ = _loaders()
    r.load_state_dict(state)
    _assert_same(_port_batches(r), _port_batches(t))


def test_iterable_dataloader_resume_drops_consumed_batches():
    class Stream(io.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype=np.int64))

    loader = io.DataLoader(Stream(), batch_size=3, device="cpu")
    full = [b.tolist() for b in loader]
    assert full == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    loader.load_state_dict({"batches_served": 2})
    assert [b.tolist() for b in loader] == full[2:]
    with pytest.raises(TypeError):
        len(loader)


def test_default_collate_fn_structures():
    batch = [{"a": np.ones(2, np.float32), "b": 1, "c": "s",
              "d": (torch.zeros(2), 2.5)} for _ in range(3)]
    out = io.default_collate_fn(batch)
    assert out["a"].shape == (3, 2) and out["a"].dtype == torch.float32
    assert out["b"].tolist() == [1, 1, 1] and out["b"].dtype == torch.int64
    assert out["c"] == ["s", "s", "s"]
    assert out["d"][0].shape == (3, 2) and out["d"][1].tolist() == [2.5] * 3
    with pytest.raises(TypeError):
        io.default_collate_fn([object()])


class _Float64Samples:
    """Map-style samples of a Python float, a float64 array and an int."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return 0.1 * i, np.full(3, i / 7.0), i


@pytest.mark.parametrize("num_workers", [0, 2])
def test_collate_narrows_float64_to_float32_like_jax(num_workers):
    # JAX's tensors narrow Python floats and float64 arrays to float32
    # (its default float dtype); the port's batches must come out the
    # same, or a float32 layer refuses them. Integers stay int64.
    t = io.DataLoader(_Float64Samples(), batch_size=4,
                      num_workers=num_workers, device="cpu")
    j = JaxDataLoader(_Float64Samples(), batch_size=4)
    for got, want in zip(t, j):
        assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                          torch.int64]
        assert [w.numpy().dtype for w in want[:2]] == [np.float32] * 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
    out = io.default_collate_fn([1.5, 2.5])
    assert out.dtype == torch.float32 and out.tolist() == [1.5, 2.5]


def test_process_workers_are_refused_by_name():
    # process workers take map-style datasets (they are ported since the
    # layer-set slice: the batches equal the in-process loader's); an
    # iterable dataset is refused by name, as in the JAX package
    x, y = _data()

    def batches(**kw):
        return [[t.numpy() for t in b] for b in io.DataLoader(
            io.TensorDataset([x, y]), batch_size=2, device="cpu", **kw)]

    got = batches(num_workers=2, use_shared_memory=True)
    want = batches()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)

    class Stream(io.IterableDataset):
        def __iter__(self):
            yield np.zeros((1,), np.float32)

    with pytest.raises(ValueError, match="map-style"):
        io.DataLoader(Stream(), batch_size=1, num_workers=2,
                      use_shared_memory=True, device="cpu")


def test_worker_errors_reach_the_consumer():
    class Bad(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("bad sample")
            return np.float32(i)

    loader = io.DataLoader(Bad(), batch_size=2, num_workers=2, device="cpu")
    with pytest.raises(KeyError, match="bad sample"):
        list(loader)
