"""Mel scales, filterbanks, the DCT, decibels and windows (counterpart of
``paddle_tpu/audio/functional``)."""
from .functional import (  # noqa: F401
    compute_fbank_matrix,
    create_dct,
    fft_frequencies,
    get_window,
    hz_to_mel,
    mel_frequencies,
    mel_to_hz,
    power_to_db,
)

__all__ = [
    "hz_to_mel", "mel_to_hz", "mel_frequencies", "fft_frequencies",
    "compute_fbank_matrix", "power_to_db", "create_dct", "get_window",
]
