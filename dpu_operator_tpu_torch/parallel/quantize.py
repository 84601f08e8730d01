"""Wire codecs for the fabric collectives, and the block-axis int8 codec
of the resident paged-KV pools.

A copy of the JAX package's ``parallel/quantize.py``, statement for
statement: the per-chunk int8 (4x fewer bytes) and bf16 (2x) wire codecs
that ``fabric_collectives.RingTransport`` (``codec=``) and the synthetic
shard plane's reduce board run (``Codec``, ``Bf16Codec``, ``Int8Codec``,
``ErrorFeedback``, ``get_codec``, the self-describing ``FRAME_HEADER``
and the typed ``CodecError``), and their array-module twins
(``int8_*_xp``, ``bf16_*_xp``), numpy here. fp32 stays the identity
(``get_codec("fp32")`` is None), every reduce adds decoded fp32 values,
and a peer running another codec fails typed, never by decoding int8
bytes as floats. Error bounds: bf16 rounds to nearest even (relative
error <= 2^-8, exact on values already in bf16); int8 is symmetric per
chunk, scale = max|x|/127, absolute error <= scale/2.

The port's own, in torch: ``int8_block_encode`` / ``int8_block_decode``,
the counterparts of ``int8_block_encode_xp`` / ``int8_block_decode_xp``:
symmetric per-BLOCK quantization over a leading block axis,
``scales[b] = max|x[b]| / 127`` (1.0 for an all-zero block, so decode
stays exact zero and never 0/0). A pool block quantized by either
package decodes bit-identically in the other: the divide is IEEE, the
rounding is half-to-even (``torch.round``, like ``jnp.round``), and the
clip is to +/-127. The executor's host views
(``PagedDecodeStep.dequantized_pools``) decode with the numpy twin,
``int8_block_decode_xp``.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class CodecError(RuntimeError):
    """Typed codec failure: mixed-codec peers, torn frame, bad id —
    the caller must treat the transfer as poisoned, never decode."""


# Wire frame header ahead of every encoded chunk: codec id (u8) +
# per-chunk scale (f32). bf16 carries scale 1.0 — the field is the
# dtype tag's companion, present for every quantized codec so the
# receiver validates BOTH before touching payload bytes.
FRAME_HEADER = struct.Struct("!Bf")

_CODEC_IDS = {"fp32": 0, "bf16": 1, "int8": 2}


# -- jittable twins -----------------------------------------------------------
#
# Written against an injected array module: numpy here, jax.numpy
# under jit (only ufuncs and astype — everything traces). The Codec
# classes below bind xp=np; tests bind xp=jnp and assert equivalence.


def int8_encode_xp(x, xp=np):
    """(q int8, scale f32): symmetric per-chunk quantization,
    scale = max|x|/127 (1.0 for an all-zero chunk so decode is exact
    zero, not 0/0)."""
    scale = xp.max(xp.abs(x)) / 127.0
    scale = xp.where(scale > 0, scale, 1.0).astype(xp.float32)
    q = xp.clip(xp.round(x / scale), -127, 127).astype(xp.int8)
    return q, scale


def int8_decode_xp(q, scale, xp=np):
    return q.astype(xp.float32) * scale


def int8_block_encode_xp(x, xp=np):
    """Block-axis twin of ``int8_encode_xp``: symmetric per-BLOCK
    quantization over a LEADING block axis. ``x`` is ``[N, ...]``;
    returns ``(q int8 [N, ...], scales f32 [N])`` with
    ``scales[b] = max|x[b]|/127`` (1.0 for an all-zero block, the
    same exact-zero convention as the chunk codec). One codec shared
    by the resident paged-KV pools (serving/kvcache/paged.py — pool
    shape ``[num_blocks, block_size, heads, d_head]``) and the future
    fabric KV-transfer path: a pool block quantized on one box must
    decode bit-identically on another, so the math lives here, xp-
    parameterized, jittable, and is tested np↔jit like the twins
    above."""
    flat = xp.reshape(x, (x.shape[0], -1))
    amax = xp.max(xp.abs(flat), axis=1)
    scales = xp.where(amax > 0, amax / 127.0, 1.0).astype(xp.float32)
    tail = (-1,) + (1,) * (x.ndim - 1)
    q = xp.clip(xp.round(x / xp.reshape(scales, tail)),
                -127, 127).astype(xp.int8)
    return q, scales


def int8_block_decode_xp(q, scales, xp=np):
    """Decode the block-axis codec: ``scales``' shape must be a
    leading prefix of ``q``'s (``[N]`` against ``[N, ...]``, or the
    gathered ``[S, B]`` against ``[S, B, bs, H, dh]`` — the paged-
    attention table gather reuses the twin directly)."""
    tail = scales.shape + (1,) * (q.ndim - scales.ndim)
    return q.astype(xp.float32) * xp.reshape(scales, tail)


def bf16_encode_xp(x, xp=np):
    """fp32 -> bf16 by round-to-nearest-even on the mantissa split:
    the standard bias trick (add 0x7FFF + lsb, take the high 16
    bits). Returns uint16 code words (numpy has no native bf16)."""
    bits = x.astype(xp.float32).view(xp.uint32)
    lsb = (bits >> 16) & 1
    rounded = bits + 0x7FFF + lsb
    return (rounded >> 16).astype(xp.uint16)


def bf16_decode_xp(code, xp=np):
    return (code.astype(xp.uint32) << 16).view(xp.float32)


# -- the codec contract -------------------------------------------------------


class Codec:
    """One quantized wire format. Chunk-scoped: every call encodes ONE
    contiguous fp32 chunk (the transport's pipelining unit), carrying
    its own scale in the frame header.

    The numpy bindings are PASS-FUSED: every elementwise step writes
    into a reusable thread-local scratch (``out=``), because at wire
    speed the codec's cost is memory passes, not FLOPs — a naive
    chain of temporaries triples the traffic and eats the bytes the
    codec saved. Scratch is thread-local so the transport's
    per-stream sender/receiver pairs never share a buffer."""

    name = ""
    codec_id = 0
    wire_itemsize = 4  # wire bytes per fp32 element

    def __init__(self):
        self._tls = threading.local()

    def _scratch(self, kind: str, size: int, dtype) -> np.ndarray:
        store = getattr(self._tls, "bufs", None)
        if store is None:
            store = self._tls.bufs = {}
        buf = store.get(kind)
        if buf is None or buf.size < size or buf.dtype != dtype:
            buf = store[kind] = np.empty(size, dtype)
        return buf[:size]

    def encode(self, x: np.ndarray) -> Tuple[np.ndarray, float]:
        """(wire array, scale) for one fp32 chunk. The wire array may
        alias this thread's scratch — it is valid until this thread's
        next encode() (the transport sends or stashes it first)."""
        raise NotImplementedError

    def decode(self, payload, n_elems: int, scale: float,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """fp32 chunk back from the wire. ``payload`` is anything
        ``np.frombuffer`` accepts (bytes, bytearray, memoryview, or
        the encode() output array itself) — callers in transport hot
        loops pass the array/buffer directly, never a ``tobytes()``
        copy (the GL011 contract). With ``out`` the decode lands in
        the caller's buffer in one fused pass."""
        raise NotImplementedError

    # -- framing ---------------------------------------------------------

    def decode_add(self, payload, n_elems: int, scale: float,
                   into: np.ndarray) -> None:
        """into += decode(payload) in two fused passes through this
        thread's scratch — the reduce-side hot path (fp32-after-decode
        accumulation without a temporary per chunk)."""
        dec = self.decode(payload, n_elems, scale,
                          out=self._scratch("dec_f32", n_elems,
                                            np.float32))
        np.add(into, dec, out=into)

    def frame_header(self, scale: float) -> bytes:
        return FRAME_HEADER.pack(self.codec_id, scale)

    def parse_header(self, hdr) -> float:
        cid, scale = FRAME_HEADER.unpack(hdr)
        if cid != self.codec_id:
            got = next((n for n, i in _CODEC_IDS.items() if i == cid),
                       f"id {cid}")
            raise CodecError(
                f"codec mismatch on the wire: expected {self.name}, "
                f"peer sent {got} — mixed-codec rings are refused, "
                f"not decoded")
        return scale

    def roundtrip(self, x: np.ndarray) -> np.ndarray:
        """decode(encode(x)) without the wire — the synthetic shard
        board's model of what the transport would have done."""
        wire, scale = self.encode(np.ascontiguousarray(x, np.float32))
        return self.decode(wire, x.size, scale).reshape(x.shape)


class Bf16Codec(Codec):
    name = "bf16"
    codec_id = _CODEC_IDS["bf16"]
    wire_itemsize = 2

    def encode(self, x: np.ndarray) -> Tuple[np.ndarray, float]:
        # Flat view: callers pass 1-D chunks or [rows, d] parts; the
        # wire is flat either way (roundtrip() restores the shape).
        x = np.ascontiguousarray(x, np.float32).reshape(-1)
        if x.size == 0:
            return np.empty(0, np.uint16), 1.0
        bits = x.view(np.uint32)  # reinterpret, no copy
        u = self._scratch("enc_u32", x.size, np.uint32)
        # Round-to-nearest-even via the bias trick, fused in u:
        # u = ((bits >> 16) & 1) + 0x7FFF + bits, then take the high
        # half. Same math as bf16_encode_xp, zero temporaries.
        np.right_shift(bits, 16, out=u)
        np.bitwise_and(u, 1, out=u)
        np.add(u, 0x7FFF, out=u)
        np.add(u, bits, out=u)
        np.right_shift(u, 16, out=u)
        wire = self._scratch("enc_u16", x.size, np.uint16)
        np.copyto(wire, u, casting="unsafe")
        return wire, 1.0

    def decode(self, payload, n_elems: int, scale: float,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        code = np.frombuffer(payload, np.uint16, count=n_elems)
        if out is None:
            return bf16_decode_xp(code)
        # Fused: shift into the caller's buffer reinterpreted as u32.
        # dtype= forces the u32 ufunc loop — the u16 loop would shift
        # the bits off the top before the output cast.
        np.left_shift(code, 16, out=out.view(np.uint32),
                      dtype=np.uint32, casting="unsafe")
        return out


class Int8Codec(Codec):
    name = "int8"
    codec_id = _CODEC_IDS["int8"]
    wire_itemsize = 1

    def encode(self, x: np.ndarray) -> Tuple[np.ndarray, float]:
        # Flat view (see Bf16Codec.encode).
        x = np.ascontiguousarray(x, np.float32).reshape(-1)
        if x.size == 0:
            # Zero-length segments are legal (world > n_elems): an
            # empty chunk still frames (scale 1.0, no payload).
            return np.empty(0, np.int8), 1.0
        # Two allocation-free reduction passes beat one abs() temp:
        # amax = max(max(x), -min(x)).
        scale = max(float(np.max(x)), -float(np.min(x))) / 127.0
        if scale <= 0.0:
            scale = 1.0
        f = self._scratch("enc_f32", x.size, np.float32)
        np.multiply(x, np.float32(1.0 / scale), out=f)
        np.rint(f, out=f)  # |f| <= 127 by scale construction: no clip
        wire = self._scratch("enc_i8", x.size, np.int8)
        np.copyto(wire, f, casting="unsafe")
        return wire, float(scale)

    def decode(self, payload, n_elems: int, scale: float,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        q = np.frombuffer(payload, np.int8, count=n_elems)
        if out is None:
            return int8_decode_xp(q, np.float32(scale))
        np.multiply(q, np.float32(scale), out=out, casting="unsafe")
        return out


class ErrorFeedback:
    """Residual-carrying wrapper for REDUCTION traffic: what rounding
    dropped this call is added back to the next call's input for the
    same buffer size, so a per-step collective's quantization error
    stays a bounded offset instead of accumulating a drift (the
    standard EF-SGD construction, applied to the serving collective's
    per-step payloads). Stateful per (size, slot key) — one wrapper
    per transport, never shared across rings."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self._residual: Dict[Tuple[int, int], np.ndarray] = {}

    def encode(self, x: np.ndarray,
               slot: int = 0) -> Tuple[np.ndarray, float]:
        key = (x.size, slot)
        res = self._residual.get(key)
        if res is None:
            res = self._residual[key] = np.zeros(x.shape, np.float32)
        fed = x + res
        wire, scale = self.codec.encode(fed)
        np.subtract(
            fed,
            self.codec.decode(wire, fed.size, scale).reshape(fed.shape),
            out=res)
        return wire, scale


def get_codec(name: Optional[str]) -> Optional[Codec]:
    """Codec by wire name; None (the identity) for fp32/None. Unknown
    names are a typed config error, not a silent fp32 fallback —
    'quantization silently off' is the failure mode the acceptance
    criteria forbid."""
    if name is None or isinstance(name, Codec):
        return name if name else None
    key = str(name).lower()
    if key in ("fp32", "none", ""):
        return None
    if key == "bf16":
        return Bf16Codec()
    if key == "int8":
        return Int8Codec()
    raise CodecError(f"unknown wire codec {name!r} "
                     f"(known: fp32, bf16, int8)")


# -- the resident pools' block codec, in torch ---------------------------------


def int8_block_encode(x: torch.Tensor):
    """``x [N, ...]`` f32 -> ``(q int8 [N, ...], scales f32 [N])``."""
    flat = x.reshape(x.shape[0], -1)
    amax = flat.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / 127.0,
                         torch.ones_like(amax)).to(torch.float32)
    tail = (-1,) + (1,) * (x.dim() - 1)
    q = torch.round(x / scales.reshape(tail)).clamp(-127, 127)
    return q.to(torch.int8), scales


def int8_block_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode the block-axis codec: ``scales``' shape is a leading
    prefix of ``q``'s (``[N]`` against ``[N, ...]``, or the gathered
    ``[S, B]`` against ``[S, B, bs, H, dh]``)."""
    tail = tuple(scales.shape) + (1,) * (q.dim() - scales.dim())
    return q.to(torch.float32) * scales.reshape(tail)
