"""Shape ops of the layer set (counterparts of ``flatten``, ``pad`` and
``one_hot`` in ``paddle_tpu/ops/impl/manipulation.py``) and the complex
constructors ``complex``, ``as_complex`` and ``as_real`` (``complex`` is
in ``paddle_tpu/ops/impl/creation.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.auto_cast import amp_op

__all__ = ["flatten", "pad", "one_hot", "complex", "as_complex", "as_real"]


def flatten(x, start_axis=0, stop_axis=-1):
    """Merge the axes ``start_axis`` .. ``stop_axis`` into one; a 0-d
    tensor becomes shape [1]."""
    if x.dim() == 0:
        return x.reshape(1)
    start, stop = start_axis % x.dim(), stop_axis % x.dim()
    if stop < start:
        return x.reshape(x.shape[:start] + (1,) + x.shape[stop + 1:])
    return x.flatten(start, stop)


def _pad_index(n, lo, hi, mode, device):
    """Source index of each output cell along an axis of ``n`` cells padded
    by (lo, hi) in a non-constant mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    period = 2 * (n - 1)                       # reflect
    i = i.abs() % max(period, 1)
    return torch.where(i >= n, period - i, i)


@amp_op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_last_axis=True):
    """``pad`` holds (low, high) pairs, one for each of the last k axes,
    the last axis first (torch's order); with ``pad_from_last_axis=False``
    the pairs cover the first k axes, the first axis first. Modes
    constant, reflect, replicate and circular, on any axes."""
    pad = [int(p) for p in pad]
    if len(pad) % 2:
        raise ValueError("pad length must be even")
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    k = len(pad) // 2
    axes = ([x.dim() - 1 - i for i in range(k)] if pad_from_last_axis
            else list(range(k)))
    if mode == "constant":
        width = [(0, 0)] * x.dim()
        for i, ax in enumerate(axes):
            width[ax] = (pad[2 * i], pad[2 * i + 1])
        return F.pad(x, [v for lo, hi in reversed(width) for v in (lo, hi)],
                     value=value)
    for i, ax in enumerate(axes):
        lo, hi = pad[2 * i], pad[2 * i + 1]
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def one_hot(x, num_classes):
    """float32 one-hot rows of the integer ids ``x``."""
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def complex(real, imag):
    """``real + 1j * imag`` (both float32, or both float64)."""
    return torch.complex(real, imag)


def as_complex(x):
    """[..., 2] (real, imaginary) pairs -> complex [...]."""
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    """complex [...] -> [..., 2] (real, imaginary) pairs, a new tensor."""
    return torch.stack([torch.real(x), torch.imag(x)], -1)
