"""Incubating layers (counterpart of ``paddle_tpu.incubate``): the MoE
family."""
from .moe import MoELayer, SwiGLUExperts, TopKGate

__all__ = ["MoELayer", "SwiGLUExperts", "TopKGate"]
