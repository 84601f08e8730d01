"""KVSpec — the paged-KV pool layout, declared exactly once.

The disaggregated plane moves KV pages between pools that were built
by different executors in different processes. Everything both ends
must agree on to do that safely — block geometry, head layout, the
resident dtype (int8 codes + per-block scales vs fp32 rows), the
model identity that makes the bytes meaningful at all — lives in ONE
frozen ``KVSpec``, and every derived quantity (wire bytes per block,
the segment slicing of a transfer, the payload split a receiver
parses) is computed FROM it. This is the SpecLayout/pjit pattern from
the exemplars: declare the partitioning once, derive all slice math
from the declaration, so the sender's segmentation and the receiver's
parse can never drift apart — they are the same function.

The hello handshake (stream.py) exchanges ``fingerprint()`` dicts
plus the wire codec id before any payload moves, the quantized
ring's discipline: a codec disagreement raises the SAME typed
``CodecMismatch`` the quantized ring uses, a layout disagreement
raises ``KVSpecMismatch`` naming the differing fields — never int8
bytes decoded as floats, never pages appended into the wrong geometry.

Wire codecs (parallel/quantize.py's block-axis twins):

  * ``int8`` — codes + per-block scales. For an int8-resident pool
    this is a VERBATIM passthrough (the pool layout IS the wire
    layout; byte-identical on both ends by construction). For an fp32
    pool it quantizes per block on the way out (KV tolerates int8 far
    better than gradients — the quantized ring's lesson applied to
    residency).
  * ``fp32`` — raw rows, lossless; the exact-reference wire for fp32
    pools. An int8 pool REQUIRES the int8 wire: dequantizing resident
    codes to ship fp32 would quadruple the bytes and re-rounding on
    arrival would break the byte-identical stream contract.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Tuple

from ...parallel.fabric_collectives import CodecMismatch

# Per-rank geometry rides the SAME even-contiguous split the fabric
# ring and the row-plane shard ownership use (shard_math.segment_bounds
# is this exact symbol, re-exported) — one partition function, so a
# rank's pool slice, its transfer segmentation and the collective's
# wire segments can never disagree about where a rank's bytes start.
from ...parallel.fabric_collectives import (
    _segment_bounds as segment_bounds)

__all__ = ["KVSpec", "KVSpecMismatch", "CodecMismatch", "WIRE_CODECS",
           "SHARD_AXES"]

#: KV shard axes: "none" (single worker), "head" (Ulysses — every rank
#: holds ALL blocks, a contiguous head slice of each; decode's k+1
#: verify windows attend all-local), "page" (ring — every rank holds
#: ALL heads of a contiguous block-id range; long prefill chunks fold
#: cross-rank partials with the flash online-softmax recurrence).
SHARD_AXES = ("none", "head", "page")

#: Wire codecs the page stream understands (fp32 = raw rows, int8 =
#: parallel/quantize.py block-axis codes + per-block scales).
WIRE_CODECS = ("fp32", "int8")


class KVSpecMismatch(RuntimeError):
    """The two ends of a page stream disagree on the pool layout or
    model identity. Raised at hello time, before any page moves —
    the layout sibling of the codec's ``CodecMismatch``."""


@dataclass(frozen=True)
class KVSpec:
    """One paged-KV pool layout + the model identity its pages encode.

    ``num_blocks`` is deliberately NOT part of the spec: pool capacity
    is a per-replica sizing decision (a decode replica may hold far
    more resident context than a prefill replica) and block ids are
    remapped at import anyway. Everything that determines what a
    block's BYTES mean is here."""

    model: str            # executor family ("paged", "synthetic-kv")
    block_size: int       # tokens per block
    heads: int
    d_head: int
    vocab: int
    max_blocks_per_req: int
    pool_dtype: str       # "int8" (codes+scales) | "fp32"
    planes: int = 2       # K and V (synthetic ships 1 content plane)
    seed: int = 0         # weight identity: pages from a different
    #                       model are bytes, not KV
    #: Context-parallel KV: how the pools split across the
    #: shard workers of one replica. "head" gives every rank ALL block
    #: ids and a contiguous head slice of each block (Ulysses); "page"
    #: gives every rank ALL heads of a contiguous block-id range
    #: (ring). Per-rank pool shapes, slice bounds and per-rank wire
    #: framing all derive from these two fields — never recomputed
    #: inline at a use site (the GL018 contract).
    shard_axis: str = "none"
    world: int = 1

    def __post_init__(self):
        if self.pool_dtype not in ("int8", "fp32"):
            raise ValueError(f"pool_dtype must be int8|fp32, got "
                             f"{self.pool_dtype!r}")
        if self.block_size < 1 or self.heads < 1 or self.d_head < 1 \
                or self.planes < 1:
            raise ValueError("block_size/heads/d_head/planes must be "
                             ">= 1")
        if self.shard_axis not in SHARD_AXES:
            raise ValueError(f"shard_axis must be one of {SHARD_AXES},"
                             f" got {self.shard_axis!r}")
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if self.shard_axis == "none" and self.world != 1:
            raise ValueError(
                f"shard_axis='none' is the single-worker layout; "
                f"world={self.world} needs a shard axis")
        if self.shard_axis == "head" and self.heads % self.world:
            raise ValueError(
                f"head-sharded pools need heads % world == 0 (the "
                f"Ulysses all-to-all constraint): heads={self.heads}, "
                f"world={self.world}")

    # -- derived geometry (every slice below comes from here) ----------------

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return (self.block_size, self.heads, self.d_head)

    @property
    def elems_per_block(self) -> int:
        return self.block_size * self.heads * self.d_head

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_req * self.block_size

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def default_codec(self) -> str:
        """The natural wire for this pool: its own resident layout."""
        return "int8" if self.pool_dtype == "int8" else "fp32"

    def validate_codec(self, codec: str) -> str:
        if codec not in WIRE_CODECS:
            raise ValueError(f"wire codec must be one of {WIRE_CODECS},"
                             f" got {codec!r}")
        if self.pool_dtype == "int8" and codec != "int8":
            raise ValueError(
                "int8-resident pools require the int8 wire: the codes "
                "+ scales ARE the transfer format (fp32 would 4x the "
                "bytes and re-round on arrival)")
        return codec

    def plane_part_nbytes(self, codec: str,
                          n_blocks: int) -> Tuple[int, int]:
        """(payload_bytes, scale_bytes) for ONE plane of ``n_blocks``
        blocks under ``codec`` — the receiver's parse and the sender's
        frame are both this function."""
        if codec == "int8":
            return n_blocks * self.elems_per_block, n_blocks * 4
        return n_blocks * self.elems_per_block * 4, 0

    def wire_block_nbytes(self, codec: str) -> int:
        """Total wire bytes one block costs across all planes."""
        pay, sc = self.plane_part_nbytes(codec, 1)
        return self.planes * (pay + sc)

    def segments(self, n_blocks: int, codec: str,
                 max_seg_bytes: int = 1 << 18
                 ) -> List[Tuple[int, int]]:
        """Transfer segmentation: ``[(start_block, count), ...]``
        covering ``n_blocks`` with each segment's wire payload at most
        ``max_seg_bytes`` (always >= 1 block/segment). Derived from
        the spec so a layout change re-derives both ends at once."""
        if n_blocks <= 0:
            return []
        per = max(1, max_seg_bytes // self.wire_block_nbytes(codec))
        return [(s, min(per, n_blocks - s))
                for s in range(0, n_blocks, per)]

    # -- per-rank geometry (context-parallel KV) ------------------------------
    #
    # Everything a rank knows about its own slice of the pools comes
    # from the four methods below plus ``rank_view`` — pool shapes,
    # page counts, slice bounds, per-rank wire framing. Computing any
    # of these inline at a use site is the layout-drift class GL018
    # flags: this dataclass is the single blessed derivation site.

    @property
    def sharded(self) -> bool:
        return self.world > 1

    def _check_rank(self, rank: int) -> int:
        rank = int(rank)
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside world {self.world}")
        return rank

    def rank_heads(self, rank: int) -> Tuple[int, int]:
        """[lo, hi) of the contiguous head slice rank holds — the
        full head range unless the axis is "head"."""
        rank = self._check_rank(rank)
        if self.shard_axis == "head":
            return segment_bounds(self.heads, self.world)[rank]
        return (0, self.heads)

    def rank_head_count(self, rank: int) -> int:
        lo, hi = self.rank_heads(rank)
        return hi - lo

    def rank_blocks(self, rank: int, num_blocks: int
                    ) -> Tuple[int, int]:
        """[lo, hi) of the GLOBAL block-id range rank's pool holds.
        ``num_blocks`` is the replica's pool capacity (a sizing
        decision, deliberately outside the spec — see the class
        docstring); the partition of it is pure spec."""
        rank = self._check_rank(rank)
        if self.shard_axis == "page":
            if num_blocks < self.world:
                raise ValueError(
                    f"page-sharded pool needs num_blocks >= world: "
                    f"{num_blocks} < {self.world}")
            return segment_bounds(int(num_blocks), self.world)[rank]
        return (0, int(num_blocks))

    def rank_block_shape(self, rank: int) -> Tuple[int, int, int]:
        """One resident block's shape in rank's pool:
        ``(block_size, rank_heads, d_head)``."""
        return (self.block_size, self.rank_head_count(rank),
                self.d_head)

    def rank_view(self, rank: int) -> "KVSpec":
        """Rank's slice of the layout AS a single-worker KVSpec — the
        per-rank wire format. A sharded transfer is ``world``
        point-to-point streams, each framed/segmented/parsed by its
        rank_view exactly like an unsharded stream; deriving the view
        here (instead of re-declaring it rank-side) is what keeps the
        per-rank sender and receiver the same function."""
        rank = self._check_rank(rank)
        return replace(self, heads=self.rank_head_count(rank),
                       shard_axis="none", world=1)

    def rank_plane_part_nbytes(self, rank: int, codec: str,
                               n_blocks: int) -> Tuple[int, int]:
        """(payload_bytes, scale_bytes) for ONE plane of ``n_blocks``
        of rank's blocks — ``plane_part_nbytes`` through rank_view."""
        return self.rank_view(rank).plane_part_nbytes(codec, n_blocks)

    def rank_wire_block_nbytes(self, rank: int, codec: str) -> int:
        return self.rank_view(rank).wire_block_nbytes(codec)

    def rank_resident_nbytes(self, rank: int, num_blocks: int) -> int:
        """Resident pool bytes rank pins for a ``num_blocks`` replica
        pool (all planes, codes + scales for int8) — what the bench's
        resident-context-per-replica arithmetic divides by."""
        lo, hi = self.rank_blocks(rank, num_blocks)
        elem = 1 if self.pool_dtype == "int8" else 4
        per_block = (self.block_size * self.rank_head_count(rank)
                     * self.d_head * elem
                     + (4 if self.pool_dtype == "int8" else 0))
        return self.planes * (hi - lo) * per_block

    # -- the hello contract ---------------------------------------------------

    def fingerprint(self) -> Dict:
        return asdict(self)

    def check_hello(self, remote: Dict, local_codec: str,
                    remote_codec: str) -> None:
        """Validate a peer's hello against this spec + codec. Codec
        disagreement is the quantized ring's ``CodecMismatch``;
        layout/model disagreement is ``KVSpecMismatch`` naming every
        differing field — both raised BEFORE any payload byte is parsed."""
        if remote_codec != local_codec:
            raise CodecMismatch(
                f"kv page stream codec mismatch: local {local_codec!r}"
                f" vs peer {remote_codec!r}")
        mine = self.fingerprint()
        diffs = [f"{k}: {mine[k]!r} != {remote.get(k)!r}"
                 for k in mine if remote.get(k) != mine[k]]
        if diffs:
            raise KVSpecMismatch(
                "kv pool layout mismatch: " + "; ".join(sorted(diffs)))
