"""DataLoader.

The port's counterpart of ``paddle_tpu/io/dataloader.py``: map-style and
iterable datasets, custom ``batch_sampler`` and ``collate_fn``,
``shuffle``, ``drop_last``, and ``num_workers`` workers of two kinds, as
in the JAX package:

* threads (the default): the bounded, in-order ``_Prefetcher``;
* processes (``use_shared_memory=True``, map-style datasets only):
  forked workers that load and collate each batch to numpy and ship it
  through ``multiprocessing.shared_memory`` (``_MPLoaderIter``). They
  suit transforms that are Python-bound (the GIL serialises threads).
  A worker runs dataset, transform and collate code only and never
  touches CUDA (after ``fork`` in a process with a CUDA context any CUDA
  call in the child is fatal): the default collate runs as numpy there,
  and the parent turns the arrays into tensors and moves them to the
  device. Each worker seeds ``np.random`` and ``random`` with a base seed
  plus its worker id, the base seed drawn once per iterator from the
  loader's ``generator=`` or from torch's default generator
  (``torch.manual_seed``): forked workers would otherwise start from one
  numpy state and repeat each other's random augmentations, as the JAX
  package's do.

Batches come out as torch tensors on the loader's device (``device=``:
the card unless the caller asks for the CPU, as every entry point of the
port).

The training resume contract is the JAX package's: ``state_dict()``
holds the batches delivered this epoch and the sampler's shuffle state
(its RNG at the start of the epoch), and ``load_state_dict`` arms the
next ``__iter__`` to skip that many batches at the index level, so a
resumed run sees the same batches as one that never stopped.
"""
from __future__ import annotations

import multiprocessing as _mp
import os
import queue
import random
import threading
import time
import traceback
import uuid

import numpy as np
import torch

from ..core.device import resolve_device
from ..resilience import faults
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def _narrow(arr):
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def _collate(batch, as_numpy):
    """Stack samples field by field: tensors and numpy arrays are
    stacked, numbers become a 1-D array, strings stay a list, dicts,
    lists and tuples are collated field by field. float64 numpy data and
    Python floats come out float32; integers keep int64. Tensors come out
    as torch tensors, or with ``as_numpy`` everything as numpy arrays."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return (np.stack([s.numpy() for s in batch]) if as_numpy
                else torch.stack(batch))
    if isinstance(sample, (np.ndarray, int, float, np.integer,
                           np.floating)):
        arr = _narrow(np.stack(batch) if isinstance(sample, np.ndarray)
                      else np.asarray(batch))
        return arr if as_numpy else torch.from_numpy(arr)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _collate([s[k] for s in batch], as_numpy) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(_collate(list(items), as_numpy)
                            for items in zip(*batch))
    raise TypeError(f"cannot collate batch of {type(sample)}")


def default_collate_fn(batch):
    """Stack samples into batched torch tensors (on the host; the loader
    moves them to its device), as ``_collate`` says. Python floats and
    float64 numpy data come out float32, as the JAX package's tensors
    narrow them to the default float dtype; integers keep int64, torch's
    index dtype."""
    return _collate(batch, as_numpy=False)


def _numpy_collate(batch):
    """``default_collate_fn`` in numpy, for the process workers."""
    return _collate(batch, as_numpy=True)


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


# -- process workers over shared memory --------------------------------------
_SHM_DIR = "/dev/shm"


def _shm_pack(tree, prefix):
    """numpy (or CPU tensor) tree -> (meta, segments): each array copied
    into a ``SharedMemory`` segment named ``prefix`` + its leaf number
    and described by (name, shape, dtype), no pickling of the data."""
    from multiprocessing import shared_memory

    shms = []

    def pack(v):
        if isinstance(v, torch.Tensor):
            v = v.numpy()
        if isinstance(v, np.ndarray):
            shm = shared_memory.SharedMemory(
                name=f"{prefix}_{len(shms)}", create=True,
                size=max(1, v.nbytes))
            np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
            shms.append(shm)
            return ("__shm__", shm.name, v.shape, str(v.dtype))
        if isinstance(v, dict):
            return {k: pack(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(pack(x) for x in v)
        return v

    return pack(tree), shms


def _shm_unpack(meta):
    """The tree of ``meta`` with every segment copied out into a numpy
    array, closed and unlinked."""
    from multiprocessing import shared_memory

    def unpack(v):
        if isinstance(v, tuple) and len(v) == 4 and v[0] == "__shm__":
            _, name, shape, dtype = v
            shm = shared_memory.SharedMemory(name=name)
            try:
                return np.array(np.ndarray(shape, dtype, buffer=shm.buf),
                                copy=True)
            finally:
                shm.close()
                shm.unlink()
        if isinstance(v, dict):
            return {k: unpack(x) for k, x in v.items()}
        if isinstance(v, list):
            return [unpack(x) for x in v]
        if isinstance(v, tuple):
            return tuple(unpack(x) for x in v)
        return v

    return unpack(meta)


def _mp_worker_loop(dataset, collate_fn, index_q, result_q, worker_id,
                    worker_init_fn, seed, prefix):
    """A worker process: seed ``np.random`` and ``random`` with ``seed``,
    run ``worker_init_fn``, then load and collate each index batch it is
    sent and ship it through shared memory, until it gets None. Dataset,
    transform and collate code only: no torch device call."""
    try:
        np.random.seed(seed % 2 ** 32)
        random.seed(seed)
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        while True:
            job = index_q.get()
            if job is None:
                result_q.put((None, "__done__", None))
                return
            bidx, indices = job
            try:
                faults.fire("dataloader.worker", worker_id=worker_id,
                            batch=bidx)
                batch = collate_fn([dataset[i] for i in indices])
                meta, shms = _shm_pack(batch, f"{prefix}_{bidx}")
                result_q.put((bidx, "__ok__", meta))
                for shm in shms:
                    shm.close()          # the parent unlinks
            except Exception:
                result_q.put((None, "__err__", traceback.format_exc()))
                return
    except KeyboardInterrupt:
        pass


class _MPLoaderIter:
    """One epoch over forked workers: index batches fed in order, batch b
    to worker b % num_workers, within a window of ``prefetch_factor *
    num_workers`` outstanding batches (so shared memory holds O(window)
    batches), results put back in order,
    a worker's exception raised with its traceback, a dead worker pool
    detected. ``shutdown`` stops the workers (SIGTERM, then SIGKILL after
    the grace period, ``timeout`` or 5 s) and unlinks every segment of
    this iterator that was not consumed, so breaking out of the loop
    early leaves nothing in /dev/shm."""

    def __init__(self, loader):
        from multiprocessing import resource_tracker

        ctx = _mp.get_context("fork")
        self._n = loader.num_workers
        self._device = loader.device
        self._grace = float(loader.timeout or 5.0)
        # one tracker for the parent and its workers: a segment a worker
        # creates and the parent unlinks is registered and unregistered
        # with the same process
        resource_tracker.ensure_running()
        self._prefix = f"ptt{os.getpid()}_{uuid.uuid4().hex[:8]}"
        # one index queue a worker, batch b to worker b % n: with the
        # per-worker seeds, an epoch's random augmentations do not depend
        # on which worker was free first
        self._index_qs = [ctx.Queue() for _ in range(self._n)]
        self._result_q = ctx.Queue()
        self._batches = list(enumerate(loader._index_batches()))
        self._total = len(self._batches)
        self._depth = max(self._n, loader.prefetch_factor * self._n)
        self._fed = 0
        self._sent_stop = False
        collate = (_numpy_collate
                   if loader.collate_fn is default_collate_fn
                   else loader.collate_fn)
        base = loader._base_seed()
        self._procs = [
            ctx.Process(
                target=_mp_worker_loop,
                args=(loader.dataset, collate, self._index_qs[w],
                      self._result_q, w, loader.worker_init_fn, base + w,
                      f"{self._prefix}_{w}"),
                daemon=True)
            for w in range(self._n)
        ]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.shutdown()
            raise

    def _feed(self, served):
        while self._fed < self._total and self._fed - served < self._depth:
            self._index_qs[self._fed % self._n].put(self._batches[self._fed])
            self._fed += 1
        if self._fed >= self._total and not self._sent_stop:
            for q in self._index_qs:
                q.put(None)
            self._sent_stop = True

    def __iter__(self):
        done, served, want, pending = 0, 0, 0, {}
        try:
            self._feed(0)
            while served < self._total:
                try:
                    bidx, tag, payload = self._result_q.get(timeout=5.0)
                except queue.Empty:
                    # a worker killed by the OS posts nothing: if none is
                    # left and nothing came through the timeout, nothing
                    # will
                    if not any(p.is_alive() for p in self._procs):
                        raise RuntimeError(
                            "DataLoader workers died before producing all "
                            "batches (killed by the OS?)") from None
                    continue
                if tag == "__done__":
                    done += 1
                    if done == self._n and served < self._total:
                        raise RuntimeError(
                            "DataLoader workers exited before producing "
                            "all batches")
                    continue
                if tag == "__err__":
                    raise RuntimeError(f"DataLoader worker failed:\n{payload}")
                pending[bidx] = payload
                while want in pending:
                    batch = _shm_unpack(pending.pop(want))
                    want += 1
                    served += 1
                    self._feed(served)
                    yield _to_device(batch, self._device)
        finally:
            for meta in pending.values():
                _shm_unpack(meta)
            self.shutdown()

    def shutdown(self, grace=None):
        """Stop the workers (SIGTERM; SIGKILL for those still alive after
        ``grace`` seconds), drain the result queue and unlink every
        segment of this iterator left behind. Raises if a worker survives
        SIGKILL."""
        grace = self._grace if grace is None else float(grace)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + grace
        for p in self._procs:
            if p.pid is not None:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
        stragglers = [p for p in self._procs if p.is_alive()]
        if stragglers:
            from ..observability import flight, metrics

            metrics.counter(
                "paddle_tpu_dataloader_worker_kills_total",
                "process workers that ignored SIGTERM and were SIGKILLed "
                "at shutdown").inc(len(stragglers))
            flight.record("dataloader", "worker-kill",
                          pids=[p.pid for p in stragglers])
        for p in stragglers:
            p.kill()
        for p in stragglers:
            p.join(timeout=5)
        try:
            while True:
                _, tag, payload = self._result_q.get_nowait()
                if tag == "__ok__":
                    _shm_unpack(payload)
        except queue.Empty:
            pass
        self._unlink_leftovers()
        leaked = [p.pid for p in self._procs if p.is_alive()]
        if leaked:
            raise RuntimeError(
                f"DataLoader workers survived SIGKILL: pids {leaked}")

    def _unlink_leftovers(self):
        """Segments a worker made but never handed over (it was stopped
        between creating and sending them)."""
        from multiprocessing import shared_memory

        try:
            names = [n for n in os.listdir(_SHM_DIR)
                     if n.startswith(self._prefix)]
        except FileNotFoundError:
            return
        for name in names:
            try:
                shm = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                continue
            shm.close()
            shm.unlink()


class DataLoader:
    """Batches of ``dataset`` as torch tensors on ``device``. Supported:
    map and iterable datasets, custom sampler/batch_sampler/collate_fn,
    shuffle, drop_last, ``num_workers`` workers with ``prefetch_factor``
    (threads; forked processes over shared memory with
    ``use_shared_memory=True``, map-style datasets only),
    ``worker_init_fn`` (process workers; called in each with its worker
    id after the seeding) and ``timeout`` (the process workers' shutdown
    grace, 5 s when 0). ``generator`` (the port's; a CPU
    ``torch.Generator``, else torch's default one) gives the process
    workers' base seeds. ``feed_list``, ``places``, ``return_list``,
    ``use_buffer_reader`` and ``persistent_workers`` are accepted as in
    the JAX package and change nothing (each epoch starts its
    workers)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=False, timeout=0,
                 worker_init_fn=None, persistent_workers=False, *,
                 device=None, generator=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.timeout = float(timeout or 0)
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.use_shared_memory = bool(use_shared_memory)
        self.worker_init_fn = worker_init_fn
        if generator is not None and not isinstance(generator,
                                                    torch.Generator):
            raise TypeError(f"generator must be a torch.Generator, got "
                            f"{type(generator).__name__}")
        self.generator = generator
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self.use_shared_memory and self._iterable_mode:
            raise ValueError(
                "use_shared_memory (process workers) requires a map-style "
                "dataset; IterableDataset pulls are sequential")

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

    def _base_seed(self):
        """The process workers' base seed for one iterator: drawn from
        the loader's generator, or from torch's default one."""
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=self.generator))

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
        transport = ("sync" if self.num_workers == 0
                     else "process" if self.use_shared_memory
                     else "thread")
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
        if self.use_shared_memory:
            yield from _MPLoaderIter(self)
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
