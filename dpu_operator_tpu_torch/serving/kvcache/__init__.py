"""Paged KV-cache decode: the host plane (allocator, prefix tree,
tiering, planner — copied from the reference) over the PyTorch step and
its CUDA kernel, and the context-parallel replica (``sharded.py``) that
splits the pools across ranks."""

from .allocator import (CACHE_OWNER, KVBlockAllocator, KVCacheOOM,
                        KVLease, PrefixTree)
from .executor import (NO_TOKEN, KVExecutorBase, PagedKVExecutor,
                       SyntheticKVExecutor)
from .paged import (PagedDecodeStep, PagedFinishStep, PagedRankStep,
                    build_paged_params, kv_bytes_per_slot,
                    paged_kv_error_bound, params_from_numpy)
from .sharded import (KVShardProcessSet, ShardedPagedKVExecutor,
                      SyntheticKVShardSet, resolve_shard_axis)
from .tiering import HostKVTier, ParkedKV, verify_block_tokens

__all__ = [
    "CACHE_OWNER",
    "HostKVTier",
    "KVBlockAllocator",
    "KVCacheOOM",
    "KVExecutorBase",
    "KVLease",
    "KVShardProcessSet",
    "NO_TOKEN",
    "PagedDecodeStep",
    "PagedFinishStep",
    "PagedKVExecutor",
    "PagedRankStep",
    "ParkedKV",
    "PrefixTree",
    "ShardedPagedKVExecutor",
    "SyntheticKVExecutor",
    "SyntheticKVShardSet",
    "build_paged_params",
    "kv_bytes_per_slot",
    "paged_kv_error_bound",
    "params_from_numpy",
    "resolve_shard_axis",
    "verify_block_tokens",
]
