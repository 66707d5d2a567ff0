"""Dataset abstractions.

The port's copy of ``paddle_tpu/io/dataset.py`` (Dataset,
IterableDataset, TensorDataset, ComposeDataset, ConcatDataset,
ChainDataset, Subset, random_split). Nothing here touches a device:
``TensorDataset`` indexes torch tensors or numpy arrays alike, and
``random_split`` draws its permutation from a per-instance numpy
``RandomState``, so the split is the JAX package's, index for index.
"""
from __future__ import annotations

import bisect

import numpy as np

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ConcatDataset", "ChainDataset", "Subset", "random_split",
]


class Dataset:
    """Map-style dataset (ref io/dataset.py Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__getitem__", self.__class__.__name__
            )
        )

    def __len__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__len__", self.__class__.__name__
            )
        )


class IterableDataset(Dataset):
    """Iterable-style dataset (ref io/dataset.py IterableDataset)."""

    def __iter__(self):
        raise NotImplementedError(
            "'{}' not implement in class {}".format(
                "__iter__", self.__class__.__name__
            )
        )

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lengths = {len(t) for t in tensors}
        if len(lengths) != 1:
            raise ValueError("all tensors must have the same length")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Fields of several same-length datasets merged per sample."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("datasets must not be empty")
        lengths = {len(d) for d in datasets}
        if len(lengths) != 1:
            raise ValueError("datasets must share length")
        self.datasets = list(datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must not be empty")
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]
        ).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx if ds_idx == 0 else idx - self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][off]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Split ``dataset`` into ``Subset``s of ``lengths`` (fractions that
    sum to 1 are supported). ``generator``: an int seed, a numpy
    ``RandomState``/``Generator``, or a ``torch.Generator`` (its
    ``initial_seed()``)."""
    if np.isclose(sum(lengths), 1.0) and sum(lengths) <= 1.0:
        sizes = []
        for i, frac in enumerate(lengths):
            sizes.append(int(np.floor(len(dataset) * frac)))
        rem = len(dataset) - sum(sizes)
        for i in range(rem):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError(
            "sum of input lengths does not equal the dataset length"
        )
    # per-instance RNG via the sampler helper; the global np.random
    # stream is never touched
    from .sampler import _new_rng

    rng = _new_rng(None, generator)
    perm = rng.permutation(sum(lengths)).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n]))
        off += n
    return out
