"""Paged KV-cache decode: the host plane (allocator, prefix tree,
tiering, planner — copied from the reference) over the PyTorch step and
its CUDA kernel."""

from .allocator import (CACHE_OWNER, KVBlockAllocator, KVCacheOOM,
                        KVLease, PrefixTree)
from .executor import (NO_TOKEN, KVExecutorBase, PagedKVExecutor,
                       SyntheticKVExecutor)
from .paged import (PagedDecodeStep, build_paged_params, kv_bytes_per_slot,
                    paged_kv_error_bound, params_from_numpy)
from .tiering import HostKVTier, ParkedKV, verify_block_tokens

__all__ = [
    "CACHE_OWNER",
    "HostKVTier",
    "KVBlockAllocator",
    "KVCacheOOM",
    "KVExecutorBase",
    "KVLease",
    "NO_TOKEN",
    "PagedDecodeStep",
    "PagedKVExecutor",
    "ParkedKV",
    "PrefixTree",
    "SyntheticKVExecutor",
    "build_paged_params",
    "kv_bytes_per_slot",
    "paged_kv_error_bound",
    "params_from_numpy",
    "verify_block_tokens",
]
