"""Continuous-batching serving (counterpart of ``paddle_tpu.serving``: the
engine and its step programs, paged KV pool, prefix cache, the host KV
spill tier, adapter, sampler; the self-healing fleet of engine replicas
and their supervisor; the request journal, the access log, multi-tenant
QoS and the streaming HTTP front door with its CLI, ``python -m
paddle_tpu_torch.serving serve``)."""
from .access_log import AccessLog
from .adapter import LlamaServingAdapter, build_adapter
from .engine import Engine, EngineConfig, EngineOverloadedError
from .fleet import (
    Fleet,
    FleetConfig,
    FleetMetrics,
    FleetRequest,
    NoReplicaError,
)
from .journal import Journal, ReplayEntry
from .kv_cache import BlockManager, KVPool
from .metrics import EngineMetrics
from .prefix_cache import PrefixCache, PrefixMatch, prompt_chain_digests
from .qos import (
    QoS,
    QoSConfig,
    QoSRejection,
    TenantPolicy,
    UnknownTenantError,
)
from .request import (
    Request,
    RequestOutput,
    RequestState,
    RequestTimeline,
    SamplingParams,
)
from .sampler import pack_sampling_params, sample_tokens
from .server import Server, serve
from .spill import HostSpillTier
from .supervisor import ReplicaSupervisor

__all__ = [
    "AccessLog", "BlockManager", "Engine", "EngineConfig", "EngineMetrics",
    "EngineOverloadedError", "Fleet", "FleetConfig", "FleetMetrics",
    "FleetRequest",
    "HostSpillTier",
    "Journal", "KVPool", "LlamaServingAdapter", "NoReplicaError",
    "PrefixCache", "PrefixMatch", "QoS", "QoSConfig", "QoSRejection",
    "ReplayEntry", "ReplicaSupervisor", "Request", "RequestOutput",
    "RequestState", "RequestTimeline", "SamplingParams", "Server",
    "TenantPolicy", "UnknownTenantError", "build_adapter",
    "pack_sampling_params", "prompt_chain_digests", "sample_tokens",
    "serve",
]
