"""The port's DataLoader process workers (``use_shared_memory=True``) on
the CPU.

The six behaviours of the JAX package's ``tests/test_dataloader_mp.py``
(in-order exact batches, real processes, a Python-bound transform, a
worker's exception with its traceback, ``worker_init_fn`` in the worker,
iterable datasets refused), then: batches equal to the in-process
loader's and to the JAX loader's for one sampler seed (the JAX loader
runs in process here), the resume
cursor, no shared-memory segment left after an early ``break``, the
``dataloader.worker`` fault site, CPU tensors collated in the workers,
a CUDA call in a worker raised with its traceback,
and the seeding repair: each worker seeds ``np.random`` with a base seed
plus its id (the JAX workers are forked with one numpy state and repeat
each other's random crops), the base seed drawn from the loader's
``generator`` (a ``torch.Generator``) or torch's default one.

Each test runs under its own alarm (``_deadline``), so a hung worker
fails its test instead of holding the suite; pools have 2 workers.
"""
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.io import DataLoader as JaxDataLoader
from paddle_tpu_torch import io
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.vision import transforms as T

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded {DEADLINE_S}s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _loader(ds, **kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("use_shared_memory", True)
    return io.DataLoader(ds, device="cpu", **kw)


class PidDataset(io.Dataset):
    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((4,), i, dtype="float32"),
                "pid": np.asarray([os.getpid()], dtype="int64")}


class TransformDataset(io.Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        acc = 0.0
        for k in range(200):
            acc += (i * 31 + k) % 7
        return np.asarray([i, acc], dtype="float32")


class BoomDataset(io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros((2,), "float32")


class CropDataset(io.Dataset):
    """One fixed image through CIFAR's random crop and flip."""

    def __init__(self, n=16, transform=None):
        self.n = n
        self.img = np.arange(32 * 32 * 3, dtype=np.uint8).reshape(32, 32, 3)
        self.transform = transform or T.Compose([
            T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(),
            T.ToTensor()])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.transform(self.img), np.int64(os.getpid())


def test_batches_in_order_and_exact():
    got = np.concatenate([b["x"][:, 0].numpy()
                          for b in _loader(PidDataset(32), batch_size=4)])
    np.testing.assert_array_equal(got, np.arange(32, dtype="float32"))


def test_workers_are_processes():
    pids = {int(p) for b in _loader(PidDataset(16), batch_size=4)
            for p in b["pid"].numpy().ravel()}
    assert os.getpid() not in pids and len(pids) == 2


def test_compute_bound_transform_correct():
    rows = np.concatenate([b.numpy() for b in _loader(TransformDataset(),
                                                      batch_size=4)])
    for i, acc in rows:
        assert acc == sum((int(i) * 31 + k) % 7 for k in range(200))


def test_worker_exception_carries_its_traceback():
    with pytest.raises(RuntimeError, match="boom at 5") as err:
        list(_loader(BoomDataset(), batch_size=2))
    text = str(err.value)
    assert "Traceback" in text and "__getitem__" in text


def test_worker_init_fn_runs_in_worker(tmp_path):
    marker = str(tmp_path / "w{}.txt")

    def init(worker_id):
        with open(marker.format(worker_id), "w") as f:
            f.write(str(os.getpid()))

    list(_loader(PidDataset(8), batch_size=4, worker_init_fn=init))
    pids = set()
    for w in range(2):
        with open(marker.format(w)) as f:
            pids.add(int(f.read()))
    assert os.getpid() not in pids and len(pids) == 2


def test_shared_memory_rejects_iterable():
    class It(io.IterableDataset):
        def __iter__(self):
            yield np.zeros((1,), "float32")

    with pytest.raises(ValueError, match="map-style"):
        _loader(It(), batch_size=1)


def _dataset():
    x = np.random.RandomState(3).randn(37, 3, 4).astype(np.float32)
    y = np.arange(37, dtype=np.int64) * 7
    return x, y


def test_batches_equal_in_process_and_jax_loaders():
    x, y = _dataset()

    def port(**kw):
        sampler = io.BatchSampler(
            sampler=io.RandomSampler(io.TensorDataset([x, y]), seed=5),
            batch_size=5)
        return [[t.numpy() for t in b] for b in io.DataLoader(
            io.TensorDataset([x, y]), batch_sampler=sampler, device="cpu",
            **kw)]

    paddle.seed(0)
    jds = paddle.io.TensorDataset([paddle.to_tensor(x), paddle.to_tensor(y)])
    jsampler = paddle.io.BatchSampler(
        sampler=paddle.io.RandomSampler(jds, seed=5), batch_size=5)
    # the JAX loader in process (its forked workers deadlock under a
    # multithreaded JAX runtime): the same index stream
    jax = [[t.numpy() for t in b] for b in JaxDataLoader(
        jds, batch_sampler=jsampler)]
    procs = port(num_workers=2, use_shared_memory=True)
    for other in (port(), jax):
        assert len(other) == len(procs) == 8
        for a, b in zip(procs, other):
            for u, v in zip(a, b):
                # JAX keeps its integers in int32 (x64 off)
                assert u.dtype == v.dtype or other is jax
                np.testing.assert_array_equal(u, v)


def test_resume_through_state_dict():
    x, y = _dataset()

    def make():
        return _loader(io.TensorDataset([x, y]),
                       batch_sampler=io.BatchSampler(
                           sampler=io.RandomSampler(range(37), seed=9),
                           batch_size=4))

    full = [b[1].numpy() for b in make()]
    first = make()
    it = iter(first)
    head = [next(it)[1].numpy() for _ in range(3)]
    state = first.state_dict()
    it.close()
    resumed = make()
    resumed.load_state_dict(state)
    rest = [b[1].numpy() for b in resumed]
    assert state["batches_served"] == 3
    for a, b in zip(head + rest, full):
        np.testing.assert_array_equal(a, b)
    assert len(head) + len(rest) == len(full)


def _segments(prefix="ptt"):
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))


def test_early_break_leaves_no_segment():
    before = _segments()
    loader = _loader(PidDataset(64), batch_size=2, prefetch_factor=4)
    for i, _ in enumerate(loader):
        if i == 2:
            break
    assert _segments() == before


def test_fault_site_reaches_the_worker():
    spec = faults.FaultSpec(OSError("disk gone"), at=2)
    with faults.inject({"dataloader.worker": spec}):
        with pytest.raises(RuntimeError, match="disk gone"):
            list(_loader(PidDataset(16), batch_size=2, num_workers=1))


def test_workers_collate_cpu_tensors():
    # a dataset that returns CPU torch tensors: the default collate stacks
    # them in the worker (as numpy) and the batches equal the in-process
    # loader's
    class Tensors(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return (torch.arange(3, dtype=torch.float32) + i,
                    torch.tensor([os.getpid()]))

    got = list(_loader(Tensors(), batch_size=2))
    want = list(_loader(Tensors(), batch_size=2, num_workers=0,
                        use_shared_memory=False))
    assert len(got) == len(want) == 4
    for (a, pa), (b, _) in zip(got, want):
        assert torch.equal(a, b)
        assert os.getpid() not in set(pa.flatten().tolist())


def test_a_cuda_call_in_a_worker_raises_with_its_traceback():
    # a worker never reaches the card: a dataset that makes a CUDA call
    # fails in the worker (here: torch without CUDA; on a card, after the
    # parent's CUDA context: "Cannot re-initialize CUDA in forked
    # subprocess"), and the loader raises with the worker's traceback
    class OnCard(io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return torch.zeros(2, device="cuda").cpu().numpy()

    with pytest.raises(RuntimeError, match="DataLoader worker failed") as e:
        list(_loader(OnCard(), batch_size=2))
    assert "in __getitem__" in str(e.value)
    assert "cuda" in str(e.value).lower()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _first_crops(**kw):
    """Each worker's first item of one epoch: (image, worker pid)."""
    out = {}
    for imgs, pids in _loader(CropDataset(), batch_size=1, **kw):
        out.setdefault(int(pids[0]), imgs[0].numpy())
    return out


def test_workers_draw_different_augmentations():
    # the repair: forked JAX workers start from one numpy state, so the
    # first crop of every worker is the same; here each worker is seeded
    # with its own id added to the base seed
    crops = list(_first_crops(generator=_gen(7)).values())
    assert len(crops) == 2
    assert not np.array_equal(crops[0], crops[1])


def test_fixed_seed_gives_the_same_epoch():
    def epoch(**kw):
        return [b[0].numpy() for b in _loader(CropDataset(), batch_size=2,
                                              **kw)]

    a, b, c = (epoch(generator=_gen(11)), epoch(generator=_gen(11)),
               epoch(generator=_gen(12)))
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not all(np.array_equal(u, v) for u, v in zip(a, c))
    # without a generator, torch's default one gives the base seed
    torch.manual_seed(4)
    d = epoch()
    torch.manual_seed(4)
    e = epoch()
    assert all(np.array_equal(u, v) for u, v in zip(d, e))
    # one loader, two epochs: the base seed is drawn once per iterator
    loader = _loader(CropDataset(), batch_size=2, generator=_gen(11))
    first = [x[0].numpy() for x in loader]
    second = [x[0].numpy() for x in loader]
    assert all(np.array_equal(u, v) for u, v in zip(first, a))
    assert not all(np.array_equal(u, v) for u, v in zip(first, second))
    with pytest.raises(TypeError, match="torch.Generator"):
        _loader(CropDataset(), batch_size=2, generator=11)
