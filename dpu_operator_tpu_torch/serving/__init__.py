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

Context-parallel paged KV (kvcache/sharded.py): ``ShardedPagedKVExecutor``
splits one replica's pools across ``world`` ranks along the head or the
page axis, behind the same submit/collect seam.

The row plane: ``LocalExecutor`` (executor.py) -> ``DecodeStep``
(infer.py) over the forward stage stack of ``parallel/train_step.py``
with its Switch MoE (``parallel/moe.py``), whose expert exchanges launch
the CUDA all-to-all kernel (``parallel/ring_probe.py``) at ep > 1.
"""

from .api import (PRIORITIES, Draining, GenerateRequest, QueueFull,
                  ServingError, TenantOverBudget, encode_prompt,
                  encode_prompt_tokens)
from .executor import Executor, LocalExecutor, ReplicaPool
from .kvcache import (HostKVTier, KVBlockAllocator, KVCacheOOM, KVLease,
                      KVShardProcessSet, PagedDecodeStep, PagedKVExecutor,
                      ParkedKV, PrefixTree, ShardedPagedKVExecutor,
                      SyntheticKVExecutor, SyntheticKVShardSet,
                      resolve_shard_axis)
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
    "KVShardProcessSet",
    "LocalExecutor",
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
    "ShardedPagedKVExecutor",
    "SpecConfig",
    "SyntheticKVExecutor",
    "SyntheticKVShardSet",
    "TenantBudget",
    "TenantOverBudget",
    "TruncatedDraft",
    "encode_prompt",
    "encode_prompt_tokens",
    "resolve_shard_axis",
]
