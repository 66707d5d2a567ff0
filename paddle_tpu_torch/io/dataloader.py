"""DataLoader.

The port's counterpart of ``paddle_tpu/io/dataloader.py``: map-style and
iterable datasets, custom ``batch_sampler`` and ``collate_fn``,
``shuffle``, ``drop_last``, and ``num_workers`` thread workers (the
bounded, in-order ``_Prefetcher``). Batches come out as torch tensors on
the loader's device (``device=``: the card unless the caller asks for
the CPU, as every entry point of the port).

The training resume contract is the JAX package's: ``state_dict()``
holds the batches delivered this epoch and the sampler's shuffle state
(its RNG at the start of the epoch), and ``load_state_dict`` arms the
next ``__iter__`` to skip that many batches at the index level, so a
resumed run sees the same batches as one that never stopped.

Process workers over shared memory (the JAX ``use_shared_memory=True``
transport, ``_MPLoaderIter``) are not ported: ``use_shared_memory=True``
raises.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def _narrow(arr):
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def default_collate_fn(batch):
    """Stack samples into batched torch tensors (on the host; the loader
    moves them to its device): tensors and numpy arrays are stacked,
    numbers become a 1-D tensor, strings stay a list, dicts, lists and
    tuples are collated field by field. Python floats and float64 numpy
    data come out float32, as the JAX package's tensors narrow them to
    the default float dtype; integers keep int64, torch's index
    dtype."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(_narrow(np.stack(batch)))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(_narrow(np.asarray(batch)))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {
            k: default_collate_fn([s[k] for s in batch]) for k in sample
        }
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(
            default_collate_fn(list(items)) for items in transposed
        )
    raise TypeError(f"cannot collate batch of {type(sample)}")


def _to_device(obj, device):
    """Every tensor (or numpy array) in ``obj`` on ``device``."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


class _Prefetcher:
    """Bounded background producer over a batch iterator.

    Batches are tagged with their production index and re-ordered on the
    consumer side, so they come out in order whatever each batch's
    collate latency on its thread.
    """

    _DONE = object()

    def __init__(self, gen_fn, depth, num_threads):
        self._q = queue.Queue(maxsize=depth)
        self._gen_fn = gen_fn
        self._threads = []
        self._lock = threading.Lock()
        self._iter = None
        self._stop = threading.Event()
        self._n = num_threads
        self._next_idx = 0

    def start(self):
        self._iter = self._gen_fn()
        for _ in range(self._n):
            t = threading.Thread(target=self._work, daemon=True)
            t.start()
            self._threads.append(t)

    def _next_job(self):
        with self._lock:
            try:
                job = next(self._iter)
            except StopIteration:
                return None, self._DONE
            except Exception as e:  # producer failure must reach consumer
                return None, e
            idx = self._next_idx
            self._next_idx += 1
            return idx, job

    def _put(self, item):
        """Queue put that stays responsive to shutdown (never blocks
        forever on a full queue after the consumer abandoned us)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        while not self._stop.is_set():
            idx, job = self._next_job()
            if job is self._DONE:
                self._put((None, self._DONE))
                return
            if isinstance(job, Exception):
                self._put((None, job))
                return
            try:
                self._put((idx, job()))
            except Exception as e:
                self._put((None, e))
                return

    def __iter__(self):
        done = 0
        pending = {}
        want = 0
        while True:
            idx, payload = self._q.get()
            if payload is self._DONE:
                done += 1
                if done == self._n:
                    # drain any stragglers already produced in order
                    while want in pending:
                        yield pending.pop(want)
                        want += 1
                    return
                continue
            if isinstance(payload, Exception):
                self.shutdown()
                raise payload
            pending[idx] = payload
            while want in pending:
                yield pending.pop(want)
                want += 1

    def shutdown(self):
        self._stop.set()
        # unblock any producer stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5)


class DataLoader:
    """Batches of ``dataset`` as torch tensors on ``device``. Supported:
    map and iterable datasets, custom sampler/batch_sampler/collate_fn,
    shuffle, drop_last, ``num_workers`` thread workers with
    ``prefetch_factor``. ``feed_list``, ``places``, ``return_list``,
    ``use_buffer_reader``, ``timeout``, ``worker_init_fn`` and
    ``persistent_workers`` are accepted as in the JAX package and change
    nothing here; ``use_shared_memory=True`` (process workers) is not
    ported and raises."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=False, timeout=0,
                 worker_init_fn=None, persistent_workers=False, *,
                 device=None):
        if use_shared_memory:
            raise NotImplementedError(
                "DataLoader(use_shared_memory=True): process workers over "
                "shared memory are not ported; num_workers > 0 runs "
                "thread workers"
            )
        self.dataset = dataset
        self.device = resolve_device(device)
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.timeout = float(timeout or 0)
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)

        if self._iterable_mode:
            if batch_sampler is not None or shuffle:
                raise ValueError(
                    "IterableDataset does not support sampler/shuffle"
                )
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            if batch_size is None:
                raise ValueError("batch_size or batch_sampler required")
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last,
            )
        # mid-epoch resume cursor: batches DELIVERED to the consumer this
        # epoch, counted at yield time, so prefetch depth never leaks
        # into the cursor
        self._served_in_epoch = 0
        self._resume_skip = 0

    # -- training resume contract ------------------------------------------
    def state_dict(self):
        """Mid-epoch cursor: batches delivered this epoch plus the
        sampler's shuffle state (epoch-start RNG / epoch number), enough
        to regenerate the same index stream and skip forward. Assumes a
        single active iterator (the training loop's)."""
        sd = {"batches_served": self._served_in_epoch}
        if self.batch_sampler is not None and hasattr(
            self.batch_sampler, "state_dict"
        ):
            sd["sampler"] = self.batch_sampler.state_dict()
        return sd

    def load_state_dict(self, state):
        """Arm the next ``__iter__`` to skip the already-consumed
        batches. Map-style datasets skip at the INDEX level (no sample
        is loaded); iterable datasets must consume-and-drop, since the
        stream has no random access."""
        self._resume_skip = int(state.get("batches_served", 0))
        self._served_in_epoch = self._resume_skip
        if state.get("sampler") is not None and hasattr(
            self.batch_sampler, "load_state_dict"
        ):
            self.batch_sampler.load_state_dict(state["sampler"])

    def _index_batches(self):
        """Index-batch stream with the resume skip applied (consumed
        once; later epochs start at batch 0)."""
        skip, self._resume_skip = self._resume_skip, 0
        it = iter(self.batch_sampler)
        for _ in range(skip):
            if next(it, None) is None:
                break
        yield from it

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _batches_map(self):
        for indices in self._index_batches():
            yield [self.dataset[i] for i in indices]

    def _batches_iterable(self):
        skip, self._resume_skip = self._resume_skip, 0
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                if skip > 0:
                    skip -= 1  # consume-and-drop: streams can't seek
                else:
                    yield batch
                batch = []
        if batch and not getattr(self, "drop_last", False):
            if skip <= 0:
                yield batch

    def __iter__(self):
        from ..observability import metrics as _obs_metrics

        batches = _obs_metrics.counter(
            "paddle_tpu_dataloader_batches_total",
            "batches delivered to the training loop", ("transport",),
        )
        transport = "sync" if self.num_workers == 0 else "thread"
        # the armed skip (if any) counts as already served; delivered
        # batches advance the cursor from there
        self._served_in_epoch = self._resume_skip
        for batch in self._iter_impl():
            batches.inc(transport=transport)
            self._served_in_epoch += 1
            yield batch
        # the epoch COMPLETED: the cursor and the sampler's epoch-start
        # RNG snapshot now refer to the next epoch, so a checkpoint taken
        # between the consumer's StopIteration and the next epoch's
        # first batch neither skips nor replays an epoch
        self._served_in_epoch = 0
        roll = getattr(self.batch_sampler, "_roll_epoch", None)
        if roll is not None:
            roll()

    def _collated(self, samples):
        return _to_device(self.collate_fn(samples), self.device)

    def _iter_impl(self):
        if self.num_workers == 0:
            gen = (self._batches_iterable() if self._iterable_mode
                   else self._batches_map())
            for batch in gen:
                yield self._collated(batch)
            return

        def job_stream():
            if self._iterable_mode:
                # iterable datasets are pulled sequentially; workers
                # parallelize collate and the copy to the device only
                for batch in self._batches_iterable():
                    yield (lambda b=batch: self._collated(b))
            else:
                # map-style: item loading happens inside the job, so
                # worker threads overlap dataset reads
                for indices in self._index_batches():
                    yield (lambda idx=indices: self._collated(
                        [self.dataset[i] for i in idx]))

        pf = _Prefetcher(
            job_stream,
            depth=self.prefetch_factor * self.num_workers,
            num_threads=self.num_workers,
        )
        pf.start()
        try:
            yield from pf
        finally:
            pf.shutdown()
