"""Continuous-batching serving (counterpart of ``paddle_tpu.serving``, the
main-path slice: engine and its step programs, paged KV pool, prefix
cache, adapter, sampler)."""
from .adapter import LlamaServingAdapter, build_adapter
from .engine import Engine, EngineConfig, EngineOverloadedError
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .prefix_cache import PrefixCache, PrefixMatch, prompt_chain_digests
from .request import Request, RequestOutput, RequestState, SamplingParams
from .sampler import pack_sampling_params, sample_tokens

__all__ = [
    "BlockManager", "Engine", "EngineConfig", "EngineMetrics",
    "EngineOverloadedError", "KVPool", "LlamaServingAdapter",
    "PrefixCache", "PrefixMatch", "Request", "RequestOutput",
    "RequestState", "SamplingParams", "build_adapter",
    "pack_sampling_params", "prompt_chain_digests", "sample_tokens",
]
