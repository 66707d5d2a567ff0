"""Vision transforms (counterpart of ``paddle_tpu/vision/transforms.py``):
the numpy subset training pipelines use. Images are numpy arrays, HWC in
and (after ``ToTensor``) CHW float32 out, as in the JAX package, so a
DataLoader's process workers run them without touching torch.

``RandomCrop`` and ``RandomHorizontalFlip`` draw from the global
``np.random`` stream, as the JAX transforms do; the DataLoader seeds that
stream in each process worker (base seed plus worker id), so forked
workers do not repeat each other's crops and flips."""
from __future__ import annotations

import numpy as np

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "CenterCrop",
    "RandomCrop", "RandomHorizontalFlip", "Transpose", "Pad",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (a numpy array)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class Resize:
    """Nearest/bilinear resize on HWC numpy arrays."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        if (h, w) == (th, tw):
            return arr
        ys = np.linspace(0, h - 1, th)
        xs = np.linspace(0, w - 1, tw)
        if self.interpolation == "nearest":
            return arr[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        a = arr.astype(np.float32)
        if a.ndim == 2:
            a = a[:, :, None]
            squeeze = True
        else:
            squeeze = False
        out = (
            a[y0][:, x0] * (1 - wy) * (1 - wx)
            + a[y0][:, x1] * (1 - wy) * wx
            + a[y1][:, x0] * wy * (1 - wx)
            + a[y1][:, x1] * wy * wx
        )
        if arr.dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        return out[:, :, 0] if squeeze else out


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return arr[i : i + th, j : j + tw]


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pads = [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pads, mode="constant")
        h, w = arr.shape[:2]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[i : i + th, j : j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)  # l, t, r, b
        pads = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(
            arr, pads, mode=self.padding_mode,
            constant_values=self.fill if self.padding_mode == "constant" else None,
        ) if self.padding_mode == "constant" else np.pad(
            arr, pads, mode=self.padding_mode
        )
