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

Fabric-sharded serving (sharded/): ``FabricExecutor`` spreads one row-plane
replica's decode step over ``world`` tensor-parallel shards, thread shards
(``SyntheticShardSet``) or ``shard_worker`` processes reducing over the
fabric ring (``ShardProcessSet``), behind the same submit/collect seam.

Disaggregated prefill/decode serving (disagg/): ``DisaggPool`` runs
role-typed prefill and decode ``ReplicaPool``s and streams each request's
KV pages between their executors over ``KVPageStream`` (hand it to
``ServingServer(pool_factory=...)``); ``RoleAutoscaler`` (autoscale.py)
moves replicas between the two roles. The prefix router (router/):
``PrefixRouter`` places requests on the ``RouterReplica`` whose pool holds
their prefix and pulls the prefix's pages to a less loaded replica.
``SyntheticExecutor`` is the serving plane's numpy test double.
"""

from .api import (PRIORITIES, Draining, GenerateRequest, QueueFull,
                  ServingError, TenantOverBudget, encode_prompt,
                  encode_prompt_tokens)
from .autoscale import RoleAutoscaler
from .disagg import DisaggPool, KVSpec, KVSpecMismatch
from .executor import (Executor, LocalExecutor, ReplicaPool,
                       SyntheticExecutor)
from .kvcache import (HostKVTier, KVBlockAllocator, KVCacheOOM, KVLease,
                      KVShardProcessSet, PagedDecodeStep, PagedKVExecutor,
                      ParkedKV, PrefixTree, ShardedPagedKVExecutor,
                      SyntheticKVExecutor, SyntheticKVShardSet,
                      resolve_shard_axis)
from .queue import AdmissionQueue, TenantBudget
from .router import PrefixRouter, RouterReplica
from .scheduler import ContinuousBatcher
from .server import ServingServer
from .sharded import FabricExecutor, ShardProcessSet, SyntheticShardSet
from .spec import NO_TOKEN, OracleDraft, SpecConfig, TruncatedDraft

__all__ = [
    "AdmissionQueue",
    "ContinuousBatcher",
    "DisaggPool",
    "Draining",
    "Executor",
    "FabricExecutor",
    "GenerateRequest",
    "HostKVTier",
    "KVBlockAllocator",
    "KVCacheOOM",
    "KVLease",
    "KVShardProcessSet",
    "KVSpec",
    "KVSpecMismatch",
    "LocalExecutor",
    "NO_TOKEN",
    "OracleDraft",
    "PRIORITIES",
    "PagedDecodeStep",
    "PagedKVExecutor",
    "ParkedKV",
    "PrefixRouter",
    "PrefixTree",
    "QueueFull",
    "ReplicaPool",
    "RoleAutoscaler",
    "RouterReplica",
    "ServingError",
    "ServingServer",
    "ShardProcessSet",
    "ShardedPagedKVExecutor",
    "SpecConfig",
    "SyntheticExecutor",
    "SyntheticKVExecutor",
    "SyntheticKVShardSet",
    "SyntheticShardSet",
    "TenantBudget",
    "TenantOverBudget",
    "TruncatedDraft",
    "encode_prompt",
    "encode_prompt_tokens",
    "resolve_shard_axis",
]
