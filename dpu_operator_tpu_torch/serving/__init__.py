"""Serving plane of the port: the reference's request path, copied, over
the PyTorch paged-KV executor.

    HTTP POST /v1/generate (server.py)
      -> AdmissionQueue (queue.py)
      -> ContinuousBatcher (scheduler.py)
      -> PagedKVExecutor (kvcache/executor.py)
      -> PagedDecodeStep (kvcache/paged.py) + the CUDA paged-attention
         kernel (parallel/paged_attn.py)

Speculative decoding (spec.py: the draft contract, greedy-verify
acceptance and the two drafts) is the KV executors' third mode:
``PagedKVExecutor(mode="speculative" | "speculative-pipelined")`` and
``SyntheticKVExecutor(spec=SpecConfig(...))``.
"""

from .api import (PRIORITIES, Draining, GenerateRequest, QueueFull,
                  ServingError, TenantOverBudget, encode_prompt,
                  encode_prompt_tokens)
from .executor import Executor, ReplicaPool
from .kvcache import (HostKVTier, KVBlockAllocator, KVCacheOOM, KVLease,
                      PagedDecodeStep, PagedKVExecutor, ParkedKV,
                      PrefixTree, SyntheticKVExecutor)
from .queue import AdmissionQueue, TenantBudget
from .scheduler import ContinuousBatcher
from .server import ServingServer
from .spec import NO_TOKEN, OracleDraft, SpecConfig, TruncatedDraft

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
    "OracleDraft",
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
    "SyntheticKVExecutor",
    "TenantBudget",
    "TenantOverBudget",
    "TruncatedDraft",
    "encode_prompt",
    "encode_prompt_tokens",
]
