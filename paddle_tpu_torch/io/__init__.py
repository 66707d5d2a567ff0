"""Datasets, samplers and the DataLoader (counterpart of
``paddle_tpu.io``): the same index streams, shuffle orders and resume
cursors as the JAX package, with batches as torch tensors on the
loader's device."""
from .dataloader import DataLoader, default_collate_fn
from .dataset import (
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .sampler import (
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ConcatDataset", "ChainDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "default_collate_fn",
]
