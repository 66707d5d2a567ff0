"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``):
``Cifar10``, ``Cifar100`` and ``MNIST``, items (HWC uint8 numpy image,
int label).

They read a local archive when one is given (``data_file``: the
``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz`` format;
``image_path``/``label_path``: MNIST's idx files, gzipped or not) and
otherwise, or with ``backend="synthetic"``, make the JAX package's
deterministic synthetic split (the same images and labels, value for
value). Nothing downloads, and unlike the JAX package no default path
under the home directory is read.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ..io.dataset import Dataset

__all__ = ["Cifar10", "Cifar100", "MNIST"]


class _SyntheticImages(Dataset):
    def __init__(self, n, shape, num_classes, transform=None, seed=0):
        rng = np.random.RandomState(seed)
        self.labels = (rng.rand(n) * num_classes).astype(np.int64)
        # class-dependent means so models can actually learn
        base = rng.rand(num_classes, *shape).astype(np.float32)
        noise = rng.rand(n, *shape).astype(np.float32) * 0.4
        self.images = (
            (base[self.labels] * 0.6 + noise) * 255.0
        ).astype(np.uint8)
        self.transform = transform

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])


class Cifar10(Dataset):
    """CIFAR-10 from its python-version archive, or synthetic (32 x 32 x
    3, 10 classes; 1024 train / 256 test items unless
    ``synthetic_size``)."""

    num_classes = 10
    _archive = "cifar-10-python.tar.gz"
    _train_files = [f"data_batch_{i}" for i in range(1, 6)]
    _test_files = ["test_batch"]

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None, allow_synthetic=True,
                 synthetic_size=None):
        assert mode in ("train", "test")
        self.mode = mode
        self.transform = transform
        if backend == "synthetic" or (
            (data_file is None or not os.path.exists(data_file))
            and allow_synthetic
        ):
            n = (synthetic_size if synthetic_size is not None
                 else (1024 if mode == "train" else 256))
            self._syn = _SyntheticImages(
                n, (32, 32, 3), self.num_classes, transform,
                seed=0 if mode == "train" else 1,
            )
            self.images, self.labels = self._syn.images, self._syn.labels
            return
        self._syn = None
        if data_file is None:
            raise FileNotFoundError(
                f"{type(self).__name__}: no data_file given and "
                "allow_synthetic is False")
        names = self._train_files if mode == "train" else self._test_files
        images, labels = [], []
        with tarfile.open(data_file, "r:gz") as tf:
            for member in tf.getmembers():
                base = os.path.basename(member.name)
                if base in names:
                    d = pickle.load(tf.extractfile(member), encoding="bytes")
                    images.append(d[b"data"])
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        self.images = (
            np.concatenate(images).reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1)
        )
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])


class Cifar100(Cifar10):
    num_classes = 100
    _archive = "cifar-100-python.tar.gz"
    _train_files = ["train"]
    _test_files = ["test"]


class MNIST(Dataset):
    """MNIST from its idx-ubyte files, or synthetic (28 x 28)."""

    num_classes = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 allow_synthetic=True, synthetic_size=None):
        assert mode in ("train", "test")
        self.transform = transform
        if (
            backend == "synthetic"
            or image_path is None
            or not os.path.exists(image_path)
        ) and allow_synthetic:
            n = (synthetic_size if synthetic_size is not None
                 else (1024 if mode == "train" else 256))
            self._syn = _SyntheticImages(
                n, (28, 28), self.num_classes, transform,
                seed=2 if mode == "train" else 3,
            )
            self.images, self.labels = self._syn.images, self._syn.labels
            return
        import gzip
        import struct

        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self.images = np.frombuffer(
                f.read(), np.uint8
            ).reshape(n, rows, cols)
        with opener(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[idx])
