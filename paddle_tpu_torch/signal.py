"""``frame``, ``overlap_add``, ``stft`` and ``istft`` (counterpart of
``paddle_tpu/signal.py``).

JAX's composition, not ``torch.stft``/``torch.istft``, whose conventions
differ (window padding, normalisation, the envelope, and ``torch.istft``
raising where this one zero-fills an unaligned tail): framing is a strided
view (``Tensor.unfold``), the transforms are ``torch.fft``'s (cuFFT on the
card), the overlap-add a gather (``F.fold``, so two runs on the card agree
bit for bit), and the window envelope is clipped at 1e-11.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .core.device import resolve_device
from .ops import fft_ops as _fft

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=resolve_device())


def frame(x, frame_length, hop_length, axis=-1):
    """Overlapping frames: a signal [..., seq] (``axis=-1``) gives [...,
    frame_length, num_frames]; [seq, ...] (``axis=0``) gives [num_frames,
    frame_length, ...]."""
    x = _t(x)
    if axis not in (0, -1):
        raise ValueError(f"axis must be 0 or -1, got {axis}")
    if axis == -1 and frame_length > x.shape[-1]:
        raise ValueError(
            f"frame_length ({frame_length}) > signal length ({x.shape[-1]})")
    return _fft.frame(x, frame_length, hop_length, axis)


def overlap_add(x, hop_length, axis=-1):
    """Inverse of ``frame``: [..., frame_length, num_frames] (``axis=-1``)
    or [num_frames, frame_length, ...] (``axis=0``) -> the signal of
    (num_frames - 1) * hop_length + frame_length samples."""
    x = _t(x)
    if axis not in (0, -1):
        raise ValueError(f"axis must be 0 or -1, got {axis}")
    if axis == 0:
        x = x.permute(list(range(2, x.dim())) + [1, 0])
    out = _fft.overlap_add(x, hop_length)
    return out.movedim(-1, 0) if axis == 0 else out


def _fft_window(window, win_length, n_fft, device):
    """The window (ones when None) centred in ``n_fft`` samples."""
    if window is None:
        window = torch.ones(win_length, dtype=torch.float32, device=device)
    window = _t(window)
    if window.shape[0] != win_length:
        raise ValueError("window length must equal win_length")
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        window = F.pad(window, [lp, n_fft - win_length - lp])
    return window


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True):
    """Short-time Fourier transform: [batch, seq] (or [seq]) -> complex
    [batch, n_fft // 2 + 1, num_frames] (``onesided``) or [batch, n_fft,
    num_frames]."""
    x = _t(x)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _fft_window(window, win_length, n_fft, x.device)
    if center:
        # F.pad's non-constant modes pad the last axis of [b, c, t]
        x = F.pad(x[:, None], [n_fft // 2, n_fft // 2], mode=pad_mode)[:, 0]
    if n_fft > x.shape[-1]:
        raise ValueError(
            f"frame_length ({n_fft}) > signal length ({x.shape[-1]})")
    frames = x.unfold(-1, n_fft, hop_length) * window    # [b, num, n_fft]
    out = _fft.rfft(frames) if onesided else _fft.fft(frames)
    if normalized:
        out = out / float(math.sqrt(n_fft))
    out = out.transpose(1, 2)                            # [b, bins, num]
    return out[0] if squeeze else out


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False):
    """Inverse STFT, normalized by the overlap-added squared window; with
    ``length`` past the frames' reach, the tail is zeros."""
    x = _t(x)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    window = _fft_window(window, win_length, n_fft, x.device)

    spec = x.transpose(1, 2)                             # [b, num, bins]
    if normalized:
        spec = spec * float(math.sqrt(n_fft))
    if onesided:
        wave = _fft.irfft(spec, n=n_fft)                 # [b, num, n_fft]
    else:
        wave = _fft.ifft(spec)
        if not return_complex:
            wave = torch.real(wave)
    wave = (wave * window).transpose(1, 2)               # [b, n_fft, num]
    out = _fft.overlap_add(wave, hop_length)

    num = x.shape[-1]
    sq = (window * window)[None, :, None].expand(1, n_fft, num)
    env = _fft.overlap_add(sq.contiguous(), hop_length)
    out = out / torch.clamp(env, min=1e-11)
    if center:
        out = out[:, n_fft // 2: out.shape[-1] - n_fft // 2]
    if length is not None:
        if out.shape[-1] < length:
            # the frames may not reach the padded signal's end: the
            # samples past them (< hop_length) are zeros
            out = F.pad(out, [0, length - out.shape[-1]])
        out = out[:, :length]
    return out[0] if squeeze else out
