"""Samplers.

The port's copy of ``paddle_tpu/io/sampler.py``. Random samplers draw
from a PER-INSTANCE ``np.random.RandomState`` (seedable via ``seed=``),
never the global ``np.random`` stream and never a torch generator: the
shuffle order is then the JAX package's, index for index, it is
capturable for the training resume contract, and it neither perturbs
nor is perturbed by user code sharing a global stream.
``state_dict()``/``load_state_dict()`` expose the RNG state as recorded
at the START of the current epoch, so a resumed run regenerates the same
permutation and skips forward.

``DistributedBatchSampler`` takes an explicit ``num_replicas`` and
``rank``: the port has no parallel environment to ask.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
]


def _new_rng(seed, generator):
    """Per-instance RNG: an explicit np RandomState/Generator is used
    as-is; an int is a seed; a ``torch.Generator`` is adapted through its
    ``initial_seed()``. Anything else degrades to a warned fresh
    RandomState, as in the JAX package. The global ``np.random`` stream
    is never touched."""
    if generator is not None:
        if isinstance(generator, (np.random.RandomState,
                                  np.random.Generator)):
            return generator
        if isinstance(generator, (int, np.integer)):
            return np.random.RandomState(int(generator))
        init = getattr(generator, "initial_seed", None)
        if callable(init):  # torch.Generator
            return np.random.RandomState(int(init()) % (2**32))
        import warnings

        warnings.warn(
            f"unsupported generator type {type(generator).__name__}; "
            "using a fresh per-instance RandomState (pass an int seed "
            "or a numpy RandomState/Generator for reproducibility)",
            RuntimeWarning,
        )
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2**32)
    return np.random.RandomState(int(seed))


def _encode_rng_state(state):
    """MT19937 state tuple -> json-able list (keys widened to ints)."""
    name, keys, pos, has_gauss, cached = state
    return [name, np.asarray(keys).tolist(), int(pos), int(has_gauss),
            float(cached)]


def _decode_rng_state(enc):
    name, keys, pos, has_gauss, cached = enc
    return (name, np.asarray(keys, dtype=np.uint32), int(pos),
            int(has_gauss), float(cached))


def _encode_gen_state(state):
    """``np.random.Generator`` bit_generator state -> json-able dict
    (MT19937's key array and numpy ints widened to lists/ints)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = _encode_gen_state(v)
        elif isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(),
                      "__dtype__": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        else:
            out[k] = v
    return out


def _decode_gen_state(enc):
    out = {}
    for k, v in enc.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["__dtype__"])
        elif isinstance(v, dict):
            out[k] = _decode_gen_state(v)
        else:
            out[k] = v
    return out


class _ResumableRandom:
    """Mixin: epoch-start RNG snapshot + state_dict round-trip shared by
    the random samplers. ``_epoch_start()`` must be called by __iter__
    BEFORE the first draw of an epoch."""

    def _init_rng(self, seed, generator):
        self._rng = _new_rng(seed, generator)
        self._epoch_state = None  # RNG state when the epoch began

    def _epoch_start(self):
        if isinstance(self._rng, np.random.RandomState):
            self._epoch_state = self._rng.get_state()
        elif isinstance(self._rng, np.random.Generator):
            self._epoch_state = dict(self._rng.bit_generator.state)
        return self._rng

    def _roll_epoch(self):
        """The epoch's delivery COMPLETED (DataLoader reached
        exhaustion): the epoch-start snapshot is stale now — drop it so
        a checkpoint taken in the rollover window captures the CURRENT
        RNG (every sampler draws its whole permutation up front, so
        current == next epoch's start), not a replay of the finished
        epoch."""
        self._epoch_state = None

    def state_dict(self):
        """Capturable shuffle state: the RNG as of the START of the
        current (or next, if not yet iterating) epoch. Both the default
        per-instance RandomState and a user-supplied
        ``np.random.Generator`` are captured — an emergency checkpoint
        must never crash on a sampler."""
        if isinstance(self._rng, np.random.RandomState):
            state = (self._epoch_state if self._epoch_state is not None
                     else self._rng.get_state())
            return {"rng_state": _encode_rng_state(state)}
        state = (self._epoch_state if self._epoch_state is not None
                 else dict(self._rng.bit_generator.state))
        return {"generator_state": _encode_gen_state(state)}

    def load_state_dict(self, state):
        if "generator_state" in state:
            if not isinstance(self._rng, np.random.Generator):
                raise TypeError(
                    "checkpoint captured an np.random.Generator sampler "
                    "but this instance uses a RandomState — rebuild the "
                    "sampler with the same generator kind"
                )
            self._rng.bit_generator.state = _decode_gen_state(
                state["generator_state"]
            )
        else:
            if not isinstance(self._rng, np.random.RandomState):
                raise TypeError(
                    "checkpoint captured a RandomState sampler but this "
                    "instance uses an np.random.Generator — rebuild the "
                    "sampler with the same generator kind"
                )
            self._rng.set_state(_decode_rng_state(state["rng_state"]))
        self._epoch_state = None


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler, _ResumableRandom):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, seed=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        self._init_rng(seed, generator)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self._epoch_start()
        if self.replacement:
            draw = (rng.integers
                    if isinstance(rng, np.random.Generator)
                    else rng.randint)  # Generator has no .randint
            yield from draw(0, n, self.num_samples).tolist()
        else:
            perm = rng.permutation(n).tolist()
            yield from perm[: self.num_samples]

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler, _ResumableRandom):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None, seed=None):
        super().__init__()
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError(
                "num_samples > len(weights) without replacement"
            )
        self._init_rng(seed, generator)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = self._epoch_start().choice(
            len(self.weights), self.num_samples,
            replace=self.replacement, p=p,
        )
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler, _ResumableRandom):
    def __init__(self, indices, generator=None, seed=None):
        super().__init__()
        self.indices = list(indices)
        self._init_rng(seed, generator)

    def __iter__(self):
        perm = self._epoch_start().permutation(len(self.indices))
        yield from (self.indices[i] for i in perm)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    """Index lists of ``batch_size`` from ``sampler`` (or a sequence or
    random sampler over ``dataset``)."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (
                RandomSampler(dataset) if shuffle
                else SequenceSampler(dataset)
            )
        elif dataset is not None and shuffle:
            raise ValueError("cannot give both sampler and shuffle")
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def state_dict(self):
        """Shuffle state of the wrapped sampler (mid-epoch batch cursor
        lives in the DataLoader, which counts delivered batches)."""
        if hasattr(self.sampler, "state_dict"):
            return {"sampler": self.sampler.state_dict()}
        return {}

    def load_state_dict(self, state):
        if "sampler" in state and hasattr(self.sampler, "load_state_dict"):
            self.sampler.load_state_dict(state["sampler"])

    def _roll_epoch(self):
        # DistributedBatchSampler has no wrapped sampler (its shuffle
        # is epoch-keyed) — getattr covers both shapes
        roll = getattr(getattr(self, "sampler", None),
                       "_roll_epoch", None)
        if roll is not None:
            roll()


class DistributedBatchSampler(BatchSampler):
    """Per-rank slice of the index space: rank ``rank`` of
    ``num_replicas`` takes every ``num_replicas``-th index of the
    (epoch-keyed) permutation, padded to divide evenly. Both are
    required: the port has no parallel environment to ask."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        if num_replicas is None or rank is None:
            raise ValueError(
                "DistributedBatchSampler: pass num_replicas and rank (the "
                "port has no parallel environment to read them from)"
            )
        if not 0 <= int(rank) < int(num_replicas):
            raise ValueError(
                f"DistributedBatchSampler: rank {rank} outside "
                f"[0, {num_replicas})"
            )
        self.nranks = num_replicas
        self.local_rank = rank
        self.shuffle = shuffle
        self.epoch = 0
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.num_samples = int(
            np.ceil(len(dataset) / self.nranks)
        )
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to be evenly divisible
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank : self.total_size : self.nranks]

        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def state_dict(self):
        """The shuffle here is a pure function of ``epoch`` (the
        RandomState is re-seeded from it every __iter__), so the epoch
        IS the capturable shuffle state."""
        return {"epoch": self.epoch, "rank": self.local_rank,
                "nranks": self.nranks}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])
        if (state.get("nranks") is not None
                and int(state["nranks"]) != self.nranks):
            import sys

            # resuming at a different world size is legal (elastic
            # scale-down) but changes the per-rank batch stream; surface
            # it so a bit-exactness expectation isn't silently violated
            sys.stderr.write(
                "[sampler] DistributedBatchSampler resumed at world size "
                f"{self.nranks} (checkpoint was {state['nranks']}); the "
                "per-rank batch stream will differ from the original "
                "run\n"
            )
