"""Serving plane of the port: the reference's request path, copied, over
the PyTorch paged-KV executor.

    HTTP POST /v1/generate (server.py)
      -> AdmissionQueue (queue.py)
      -> ContinuousBatcher (scheduler.py)
      -> PagedKVExecutor (kvcache/executor.py)
      -> PagedDecodeStep (kvcache/paged.py) + the CUDA paged-attention
         kernel (parallel/paged_attn.py)
"""

from .api import (PRIORITIES, Draining, GenerateRequest, QueueFull,
                  ServingError, TenantOverBudget, encode_prompt,
                  encode_prompt_tokens)
from .executor import Executor, ReplicaPool
from .kvcache import (HostKVTier, KVBlockAllocator, KVCacheOOM, KVLease,
                      PagedDecodeStep, PagedKVExecutor, ParkedKV,
                      PrefixTree)
from .queue import AdmissionQueue, TenantBudget
from .scheduler import ContinuousBatcher
from .server import ServingServer
from .spec import NO_TOKEN, SpecConfig

__all__ = [
    "AdmissionQueue",
    "ContinuousBatcher",
    "Draining",
    "Executor",
    "GenerateRequest",
    "HostKVTier",
    "KVBlockAllocator",
    "KVCacheOOM",
    "KVLease",
    "NO_TOKEN",
    "PRIORITIES",
    "PagedDecodeStep",
    "PagedKVExecutor",
    "ParkedKV",
    "PrefixTree",
    "QueueFull",
    "ReplicaPool",
    "ServingError",
    "ServingServer",
    "SpecConfig",
    "TenantBudget",
    "TenantOverBudget",
    "encode_prompt",
    "encode_prompt_tokens",
]
