"""Mel scales (Slaney by default, HTK optional), the triangular mel
filterbank, decibels, the DCT-II basis and the window functions
(counterpart of ``paddle_tpu/audio/functional/functional.py``).

The constructors (``mel_frequencies``, ``fft_frequencies``,
``compute_fbank_matrix``, ``create_dct``, ``get_window``) make CPU
tensors: the feature layers hold them as buffers, built on the CPU and
moved with ``.to()`` like every layer of the port. ``get_window`` returns
the ``dtype`` it is asked for (float64 by default), where the JAX
package, with x64 off, returns float32. ``power_to_db`` keeps its
``top_db`` floor on the device: no host read.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dtype import to_torch

__all__ = [
    "hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
    "compute_fbank_matrix", "power_to_db", "create_dct", "get_window",
]

# Slaney's scale: linear below 1 kHz, logarithmic above
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def hz_to_mel(freq, htk=False):
    """Hz -> mel, for a number or a tensor."""
    tensor = isinstance(freq, torch.Tensor)
    if htk:
        if tensor:
            return 2595.0 * torch.log10(1.0 + freq / 700.0)
        return 2595.0 * math.log10(1.0 + freq / 700.0)
    if tensor:
        lin = freq / _F_SP
        log = _MIN_LOG_MEL + torch.log(
            torch.clamp(freq, min=1e-10) / _MIN_LOG_HZ) / _LOGSTEP
        return torch.where(freq >= _MIN_LOG_HZ, log, lin)
    if freq >= _MIN_LOG_HZ:
        return _MIN_LOG_MEL + math.log(freq / _MIN_LOG_HZ) / _LOGSTEP
    return freq / _F_SP


def mel_to_hz(mel, htk=False):
    """mel -> Hz, for a number or a tensor."""
    if htk:
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if isinstance(mel, torch.Tensor):
        lin = _F_SP * mel
        log = _MIN_LOG_HZ * torch.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
        return torch.where(mel >= _MIN_LOG_MEL, log, lin)
    if mel >= _MIN_LOG_MEL:
        return _MIN_LOG_HZ * math.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    return _F_SP * mel


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    """``n_mels`` frequencies evenly spaced on the mel scale."""
    lo = hz_to_mel(float(f_min), htk)
    hi = hz_to_mel(float(f_max), htk)
    return mel_to_hz(torch.linspace(lo, hi, n_mels, dtype=to_torch(dtype)),
                     htk)


def fft_frequencies(sr, n_fft, dtype="float32"):
    """The 1 + n_fft // 2 bin frequencies of an ``n_fft``-point FFT."""
    return torch.linspace(0, float(sr) / 2, 1 + n_fft // 2,
                          dtype=to_torch(dtype))


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    """Triangular mel filterbank [n_mels, 1 + n_fft // 2]; ``norm``
    "slaney" scales each filter to unit area."""
    f_max = f_max or float(sr) / 2
    fftfreqs = fft_frequencies(sr, n_fft, dtype)              # [bins]
    melfreqs = mel_frequencies(n_mels + 2, f_min, f_max, htk, dtype)
    fdiff = melfreqs[1:] - melfreqs[:-1]                      # [m + 1]
    ramps = melfreqs[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = torch.maximum(torch.zeros_like(lower),
                            torch.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (melfreqs[2: n_mels + 2] - melfreqs[:n_mels])
        weights = weights * enorm[:, None]
    return weights


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10 log10(max(spect, amin) / max(amin, ref_value)); with ``top_db``,
    floored at ``top_db`` below the largest value of the whole tensor
    (the floor is a constant of the gradient, as in JAX)."""
    if not isinstance(spect, torch.Tensor):
        spect = torch.as_tensor(spect)
    log_spec = 10.0 * torch.log10(torch.clamp(spect, min=amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
    if top_db is not None:
        if top_db < 0:
            raise ValueError("top_db must be non-negative")
        floor = (log_spec.max() - top_db).detach()
        log_spec = torch.maximum(log_spec, floor)
    return log_spec


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32"):
    """The DCT-II basis [n_mels, n_mfcc] ("ortho": orthonormal)."""
    n = np.arange(n_mels, dtype="float64")
    k = np.arange(n_mfcc, dtype="float64")
    basis = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    if norm == "ortho":
        basis[:, 0] *= 1.0 / math.sqrt(2.0)
        basis *= math.sqrt(2.0 / n_mels)
    else:
        basis *= 2.0
    return torch.from_numpy(basis).to(to_torch(dtype))


# -- windows (numpy in float64, as the JAX package computes them) ---------
_WINDOWS = {}


def _register(name):
    def deco(fn):
        _WINDOWS[name] = fn
        return fn
    return deco


def _extended(M, sym):
    return (M + 1, True) if not sym else (M, False)


def _cosine_sum(M, coefs, sym):
    m, trunc = _extended(M, sym)
    if m == 1:
        return np.ones(1)
    n = np.arange(m, dtype="float64")
    w = np.zeros(m, dtype="float64")
    for i, a in enumerate(coefs):
        w += (-1) ** i * a * np.cos(2 * math.pi * i * n / (m - 1))
    return w[:-1] if trunc else w


@_register("hann")
def _hann(M, sym=True):
    return _cosine_sum(M, [0.5, 0.5], sym)


@_register("hamming")
def _hamming(M, sym=True):
    return _cosine_sum(M, [0.54, 0.46], sym)


@_register("blackman")
def _blackman(M, sym=True):
    return _cosine_sum(M, [0.42, 0.5, 0.08], sym)


@_register("nuttall")
def _nuttall(M, sym=True):
    return _cosine_sum(
        M, [0.3635819, 0.4891775, 0.1365995, 0.0106411], sym)


@_register("bartlett")
def _bartlett(M, sym=True):
    m, trunc = _extended(M, sym)
    n = np.arange(m, dtype="float64")
    w = 1.0 - np.abs(2.0 * n / (m - 1) - 1.0)
    return w[:-1] if trunc else w


@_register("triang")
def _triang(M, sym=True):
    m, trunc = _extended(M, sym)
    n = np.arange(1, (m + 1) // 2 + 1, dtype="float64")
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        w = np.concatenate([w, w[::-1]])
    else:
        w = 2 * n / (m + 1.0)
        w = np.concatenate([w, w[-2::-1]])
    return w[:-1] if trunc else w


@_register("cosine")
def _cosine(M, sym=True):
    m, trunc = _extended(M, sym)
    w = np.sin(math.pi / m * (np.arange(m) + 0.5))
    return w[:-1] if trunc else w


@_register("gaussian")
def _gaussian(M, std=7.0, sym=True):
    m, trunc = _extended(M, sym)
    n = np.arange(m, dtype="float64") - (m - 1) / 2
    w = np.exp(-(n ** 2) / (2 * std * std))
    return w[:-1] if trunc else w


@_register("kaiser")
def _kaiser(M, beta=14.0, sym=True):
    m, trunc = _extended(M, sym)
    w = np.kaiser(m, beta)
    return w[:-1] if trunc else w


@_register("exponential")
def _exponential(M, center=None, tau=1.0, sym=True):
    m, trunc = _extended(M, sym)
    if center is None:
        center = (m - 1) / 2
    n = np.arange(m, dtype="float64")
    w = np.exp(-np.abs(n - center) / tau)
    return w[:-1] if trunc else w


@_register("bohman")
def _bohman(M, sym=True):
    m, trunc = _extended(M, sym)
    fac = np.abs(np.linspace(-1, 1, m)[1:-1])
    w = (1 - fac) * np.cos(math.pi * fac) + np.sin(math.pi * fac) / math.pi
    w = np.concatenate([[0.0], w, [0.0]])
    return w[:-1] if trunc else w


@_register("tukey")
def _tukey(M, alpha=0.5, sym=True):
    m, trunc = _extended(M, sym)
    if alpha <= 0:
        w = np.ones(m)
    elif alpha >= 1.0:
        w = _hann(m, sym=True)
    else:
        n = np.arange(m, dtype="float64")
        width = int(alpha * (m - 1) / 2.0)
        n1, n2, n3 = (n[: width + 1], n[width + 1: m - width - 1],
                      n[m - width - 1:])
        w1 = 0.5 * (1 + np.cos(math.pi * (-1 + 2.0 * n1 / alpha / (m - 1))))
        w2 = np.ones(n2.shape[0])
        w3 = 0.5 * (1 + np.cos(
            math.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / (m - 1))))
        w = np.concatenate([w1, w2, w3])
    return w[:-1] if trunc else w


def get_window(window, win_length, fftbins=True, dtype="float64"):
    """A window by name, or (name, parameter...); ``fftbins`` gives the
    periodic form an STFT uses."""
    if isinstance(window, (tuple, list)):
        name, *args = window
    else:
        name, args = window, []
    if name not in _WINDOWS:
        raise ValueError(
            f"unknown window {name!r}; supported: {sorted(_WINDOWS)}")
    w = _WINDOWS[name](win_length, *args, sym=not fftbins)
    return torch.from_numpy(np.asarray(w, dtype="float64")).to(
        to_torch(dtype))
