"""The FFT op family and signal framing (counterpart of
``paddle_tpu/ops/impl/fft_ops.py``).

Each transform is ``torch.fft``'s (cuFFT on the card, every transform on
the card) under the JAX op's contract: ``n``/``s`` pad or truncate,
``axis``/``axes`` select, ``norm`` is "backward", "forward" or "ortho"
(anything else a ``ValueError``), a float32 input gives complex64. The
transforms of a real input (``rfft``, ``ihfft``, ``rfft2``, ``rfftn``)
refuse float16 and bfloat16 with JAX's ``ValueError``; the others take a
16-bit input as float32, as JAX does. ``fftfreq``/``rfftfreq`` place
their output by ``resolve_device(device)``.

``frame`` and ``overlap_add`` keep the JAX ops' layouts: framing the last
axis gives [..., frame_length, num_frames], any other axis [...,
num_frames, frame_length, ...]. ``overlap_add`` sums the frames with a
gather (``F.fold``), so two runs on the card agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.dtype import to_torch

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
    "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "fftshift",
    "ifftshift", "fftfreq", "rfftfreq", "frame", "overlap_add",
]

_HALF = (torch.float16, torch.bfloat16)


def _norm(norm):
    if norm not in ("backward", "forward", "ortho"):
        raise ValueError(
            f"norm must be 'backward', 'forward' or 'ortho', got {norm!r}")
    return norm


def _real_in(x):
    """The input of a real-to-complex transform: 16-bit refused."""
    if x.dtype in _HALF:
        raise ValueError(f"RFFT input must be float32 or float64, got "
                         f"{str(x.dtype).replace('torch.', '')}")
    return x


def _any_in(x):
    """The input of any other transform: 16-bit taken as float32."""
    return x.float() if x.dtype in _HALF else x


def _ints(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    if isinstance(v, int):
        return [v]
    return [int(i) for i in v]


def fft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.fft(_any_in(x), n, int(axis), _norm(norm))


def ifft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ifft(_any_in(x), n, int(axis), _norm(norm))


def rfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.rfft(_real_in(x), n, int(axis), _norm(norm))


def irfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.irfft(_any_in(x), n, int(axis), _norm(norm))


def hfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.hfft(_any_in(x), n, int(axis), _norm(norm))


def ihfft(x, n=None, axis=-1, norm="backward"):
    return torch.fft.ihfft(_real_in(x), n, int(axis), _norm(norm))


def fft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.fft2(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def ifft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.ifft2(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def rfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.rfft2(_real_in(x), _ints(s), _ints(axes), _norm(norm))


def irfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return torch.fft.irfft2(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def fftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.fftn(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def ifftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.ifftn(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def rfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.rfftn(_real_in(x), _ints(s), _ints(axes), _norm(norm))


def irfftn(x, s=None, axes=None, norm="backward"):
    return torch.fft.irfftn(_any_in(x), _ints(s), _ints(axes), _norm(norm))


def fftshift(x, axes=None):
    return torch.fft.fftshift(x, _ints(axes))


def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, _ints(axes))


def _freq(fn, n, d, dtype, device):
    out = fn(int(n), float(d), dtype=torch.float64,
             device=resolve_device(device))
    return out.to(to_torch(dtype, torch.float32))


def fftfreq(n, d=1.0, dtype=None, *, device=None):
    """The sample frequencies of an ``n``-point FFT at spacing ``d``
    (float32 unless ``dtype``)."""
    return _freq(torch.fft.fftfreq, n, d, dtype, device)


def rfftfreq(n, d=1.0, dtype=None, *, device=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype, device)


def frame(x, frame_length, hop_length, axis=-1):
    """Overlapping frames of ``x`` along ``axis`` (a strided view). The
    last axis gives [..., frame_length, num_frames], any other [...,
    num_frames, frame_length, ...]; for a 1-D ``x`` the signed axis
    decides (-1 the first layout, 0 the second)."""
    ax = axis + x.dim() if axis < 0 else axis
    framed = x.unfold(ax, frame_length, hop_length)   # [..., num, ..., fl]
    framed = framed.movedim(-1, ax + 1)               # [..., num, fl, ...]
    last = ax == x.dim() - 1 and (axis < 0 or x.dim() > 1)
    return framed.transpose(-1, -2) if last else framed


def _fold(x, hop_length):
    """Overlap-add of real frames [rows, fl, num] -> [rows, n_out]."""
    fl, num = x.shape[-2], x.shape[-1]
    n_out = fl + hop_length * (num - 1)
    out = F.fold(x, (n_out, 1), (fl, 1), stride=(hop_length, 1))
    return out.reshape(x.shape[0], n_out)


def overlap_add(x, hop_length, axis=-1):
    """Inverse of ``frame`` for the [..., frame_length, num_frames]
    layout: [..., frame_length + hop_length * (num_frames - 1)]."""
    if axis not in (-1, x.dim() - 1):
        raise NotImplementedError("overlap_add supports axis=-1")
    fl, num = x.shape[-2], x.shape[-1]
    rows = x.reshape(-1, fl, num)
    if rows.is_complex():
        out = torch.complex(_fold(rows.real.contiguous(), hop_length),
                            _fold(rows.imag.contiguous(), hop_length))
    else:
        out = _fold(rows, hop_length)
    return out.reshape(x.shape[:-2] + (out.shape[-1],))
