"""The feature layers (counterpart of ``paddle_tpu/audio/features``):
``Spectrogram`` (|STFT|^power), ``MelSpectrogram``, ``LogMelSpectrogram``
and ``MFCC``, over ``signal.stft`` and ``audio.functional``.

Like every layer of the port they are built on the CPU and moved with
``.to()``; their buffers are ``fft_window``, ``fbank_matrix`` and
``dct_matrix``. ``dtype`` is the buffers' dtype (float64 computes the
whole feature in float64).
"""
from __future__ import annotations

import torch

from ... import signal as _signal
from ...nn.layer.layers import Layer
from ..functional import (
    compute_fbank_matrix,
    create_dct,
    get_window,
    power_to_db,
)

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    """|STFT|^power of a waveform [batch, time] -> [batch, n_fft // 2 +
    1, num_frames]; the hop defaults to (win_length or n_fft) // 4."""

    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True,
                 pad_mode="reflect", dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or (win_length or n_fft) // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("fft_window", get_window(
            window, self.win_length, fftbins=True, dtype=dtype))

    def forward(self, x):
        spec = _signal.stft(x, self.n_fft, self.hop_length, self.win_length,
                            self.fft_window, center=self.center,
                            pad_mode=self.pad_mode)
        mag = torch.abs(spec)
        if self.power != 1.0:
            mag = torch.pow(mag, self.power)
        return mag


class MelSpectrogram(Layer):
    """The spectrogram through a mel filterbank: [batch, n_mels,
    num_frames]."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", dtype="float32"):
        super().__init__()
        self._spectrogram = Spectrogram(n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        dtype)
        self.register_buffer("fbank_matrix", compute_fbank_matrix(
            sr, n_fft, n_mels, f_min, f_max, htk, norm, dtype))

    def forward(self, x):
        return torch.matmul(self.fbank_matrix, self._spectrogram(x))


class LogMelSpectrogram(Layer):
    """The mel spectrogram in decibels (``power_to_db``)."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        self._melspectrogram = MelSpectrogram(
            sr, n_fft, hop_length, win_length, window, power, center,
            pad_mode, n_mels, f_min, f_max, htk, norm, dtype)
        self.ref_value = ref_value
        self.amin = amin
        self.top_db = top_db

    def forward(self, x):
        return power_to_db(self._melspectrogram(x), self.ref_value,
                           self.amin, self.top_db)


class MFCC(Layer):
    """Mel-frequency cepstral coefficients, the DCT-II of the log-mel
    spectrogram: [batch, n_mfcc, num_frames]."""

    def __init__(self, sr=22050, n_mfcc=40, norm="ortho", dtype="float32",
                 **mel_kwargs):
        super().__init__()
        self._log_melspectrogram = LogMelSpectrogram(sr=sr, dtype=dtype,
                                                     **mel_kwargs)
        n_mels = self._log_melspectrogram._melspectrogram \
            .fbank_matrix.shape[0]
        if n_mfcc > n_mels:
            raise ValueError(
                f"n_mfcc ({n_mfcc}) cannot exceed n_mels ({n_mels})")
        self.register_buffer("dct_matrix",
                             create_dct(n_mfcc, n_mels, norm, dtype))

    def forward(self, x):
        logmel = self._log_melspectrogram(x)      # [b, n_mels, frames]
        return torch.einsum("mk,bmt->bkt", self.dct_matrix, logmel)
