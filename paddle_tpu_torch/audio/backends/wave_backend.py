"""16-bit PCM WAV files over the standard library's ``wave`` module
(counterpart of ``paddle_tpu/audio/backends/wave_backend.py``; the same
bytes on disk). ``load`` returns a CPU tensor, as a data loader's host
side does; move it with ``.to()``."""
from __future__ import annotations

import wave

import numpy as np
import torch


class AudioInfo:
    def __init__(self, sample_rate, num_samples, num_channels,
                 bits_per_sample, encoding="PCM_S"):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample
        self.encoding = encoding


def info(filepath):
    with wave.open(filepath, "rb") as f:
        return AudioInfo(f.getframerate(), f.getnframes(), f.getnchannels(),
                         f.getsampwidth() * 8)


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """(waveform [channels, time] (``channels_first``), sample rate);
    ``normalize`` scales the 16-bit samples to float32 in [-1, 1)."""
    with wave.open(filepath, "rb") as f:
        sr = f.getframerate()
        nch = f.getnchannels()
        width = f.getsampwidth()
        f.setpos(frame_offset)
        n = f.getnframes() - frame_offset if num_frames < 0 else num_frames
        raw = f.readframes(n)
    if width != 2:
        raise NotImplementedError(
            f"only 16-bit PCM supported, got {8 * width}-bit")
    data = np.frombuffer(raw, dtype="<i2").reshape(-1, nch)
    if normalize:
        data = (data / 32768.0).astype("float32")
    arr = data.T if channels_first else data
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_S", bits_per_sample=16):
    """Write ``src`` (a tensor on any device, or an array) as 16-bit PCM;
    float samples are clipped to [-1, 1] and scaled by 32767."""
    if bits_per_sample != 16:
        raise NotImplementedError("only 16-bit PCM supported")
    data = (src.detach().cpu().numpy() if isinstance(src, torch.Tensor)
            else np.asarray(src))
    if channels_first:
        data = data.T
    if data.dtype.kind == "f":
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype("<i2")
    with wave.open(filepath, "wb") as f:
        f.setnchannels(data.shape[1] if data.ndim > 1 else 1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(data).tobytes())
