"""WAV ``info``/``load``/``save`` and the backend registry (counterpart of
``paddle_tpu/audio/backends``): the standard library's ``wave`` module is
the one backend."""
from .wave_backend import AudioInfo, info, load, save  # noqa: F401


def list_available_backends():
    return ["wave_backend"]


def get_current_backend():
    return "wave_backend"


def set_backend(backend_name):
    if backend_name != "wave_backend":
        raise NotImplementedError(
            "only the stdlib wave_backend is available")


__all__ = [
    "info", "load", "save", "AudioInfo",
    "list_available_backends", "get_current_backend", "set_backend",
]
