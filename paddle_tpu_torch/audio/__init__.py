"""Audio (counterpart of ``paddle_tpu/audio``): ``functional`` (mel
scales, filterbanks, the DCT, decibels, windows), ``features`` (the
``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram`` and ``MFCC``
layers) and the standard library's WAV backend."""
from . import backends, features, functional  # noqa: F401
from .backends import info, load, save  # noqa: F401

__all__ = ["functional", "features", "backends", "info", "load", "save"]
