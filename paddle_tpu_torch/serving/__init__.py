"""Continuous-batching serving (counterpart of ``paddle_tpu.serving``, the
main-path slice: engine and its step programs, paged KV pool, adapter,
sampler)."""
from .adapter import LlamaServingAdapter, build_adapter
from .engine import Engine, EngineConfig, EngineOverloadedError
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .request import Request, RequestOutput, RequestState, SamplingParams
from .sampler import pack_sampling_params, sample_tokens

__all__ = [
    "BlockManager", "Engine", "EngineConfig", "EngineMetrics",
    "EngineOverloadedError", "KVPool",
    "LlamaServingAdapter", "Request", "RequestOutput", "RequestState",
    "SamplingParams", "build_adapter", "pack_sampling_params",
    "sample_tokens",
]
