"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, ported slice by slice. Module paths
mirror the JAX package (``paddle_tpu_torch/serving/adapter.py`` is the
counterpart of ``paddle_tpu/serving/adapter.py``). Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++ kernel
written by hand for Hopper (``kernels/csrc``), built with ``nvcc`` on
first use and bound with ``ctypes``.

Entry points (``models.LlamaForCausalLM``, ``serving.Engine``) run on the
CUDA device unless the caller passes ``device="cpu"``; without a CUDA
device and without that request they raise.

This package never imports ``jax`` or ``paddle_tpu``.
"""
from __future__ import annotations

from .core.device import resolve_device

__all__ = ["resolve_device"]
