"""The paged-KV pool layout, declared once (``spec.py``): ``KVSpec`` and
the per-rank geometry of context-parallel KV that derives from it. The
page stream and the disaggregated pool come with the disagg plane."""

from .spec import (SHARD_AXES, WIRE_CODECS, CodecMismatch, KVSpec,
                   KVSpecMismatch)

__all__ = [
    "CodecMismatch",
    "KVSpec",
    "KVSpecMismatch",
    "SHARD_AXES",
    "WIRE_CODECS",
]
