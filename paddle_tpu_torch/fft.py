"""The ``fft`` namespace (counterpart of ``paddle_tpu/fft.py``): the
transforms of ``ops/fft_ops.py``, on ``torch.fft`` (cuFFT on the card)."""
from .ops.fft_ops import (  # noqa: F401
    fft,
    fft2,
    fftfreq,
    fftn,
    fftshift,
    hfft,
    ifft,
    ifft2,
    ifftn,
    ifftshift,
    ihfft,
    irfft,
    irfft2,
    irfftn,
    rfft,
    rfft2,
    rfftfreq,
    rfftn,
)

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "fftshift", "ifftshift", "fftfreq", "rfftfreq",
]
