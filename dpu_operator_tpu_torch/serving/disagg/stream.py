"""KVPageStream — paged KV blocks point-to-point over the fabric.

One prefill replica's finished pages ship to one decode replica's
pool over the SAME framed transport the sharded plane speaks
(serving/sharded/protocol.py: ``!II`` header + JSON + raw payload
parts, whole-frame receive deadlines — the GL010 discipline), with
the quantized ring's wire rules on top:

  * **hello before payload** — the first frame each way carries the
    ``KVSpec.fingerprint()`` and the wire codec id; a codec
    disagreement raises the quantized ring's typed ``CodecMismatch``
    and a layout disagreement ``KVSpecMismatch``, both before a
    single page byte is parsed (never int8 codes decoded as floats,
    never rows scattered into the wrong block geometry);
  * **self-describing segments** — a transfer is ``pages`` metadata
    followed by N ``seg`` frames whose slicing is DERIVED from the
    spec (``KVSpec.segments``): sender slice and receiver parse are
    the same function, so they cannot drift;
  * **int8 by default where it is free** — an int8-resident pool's
    codes + per-block scales ship VERBATIM (4x fewer bytes than fp32
    rows, byte-identical on both ends by construction); an fp32 pool
    can opt into the int8 wire via the ``parallel/quantize.py``
    block-axis codec twins (KV tolerates int8 far better than
    gradients), or stay lossless on the fp32 wire.

Failure surface: every receive carries a deadline, sockets are armed
with timeouts at connect, and ``faults.fire("kvstream.send")`` sits
between segments — the chaos matrix cuts a transfer MID-STREAM there
and the importer must discard the partial accumulation with zero
leaked blocks (the transfer plane in pool.py owns the retry/requeue
disposition).
"""

from __future__ import annotations

import logging
import select
import socket
import threading
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ... import faults
from ...parallel.quantize import (int8_block_decode_xp,
                                  int8_block_encode_xp)
from ..sharded.protocol import ProtocolError, recv_msg, send_msg
from .spec import KVSpec

log = logging.getLogger(__name__)

__all__ = ["KVPageStream", "KVPageStreamServer", "KVStreamError",
           "KVStreamNack"]


class KVStreamError(RuntimeError):
    """Transport-level page-stream failure (peer gone, torn frame,
    deadline): the transfer is poisoned, the pool layer decides
    between retry and requeue-to-prefill."""


class KVStreamNack(KVStreamError):
    """The importer refused the pages (decode-side OOM, a failed
    integrity check). ``oom`` distinguishes capacity pressure (pages
    free as decode work finishes — retry is sane) from poison."""

    def __init__(self, error: str, oom: bool = False):
        super().__init__(error)
        self.oom = oom


def _wire_planes(spec: KVSpec, codec: str,
                 planes: List[Tuple[np.ndarray, np.ndarray]]
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Pool layout -> wire layout per plane. int8 pools pass through
    (codes + scales ARE the wire); fp32 pools either ship raw rows
    (fp32 wire) or quantize per block (int8 wire)."""
    out = []
    for payload, scales in planes:
        if codec == "int8":
            if spec.pool_dtype == "int8":
                out.append((np.ascontiguousarray(payload, np.int8),
                            np.ascontiguousarray(scales, np.float32)))
            else:
                q, sc = int8_block_encode_xp(
                    np.asarray(payload, np.float32))
                out.append((q, sc))
        else:
            out.append((np.ascontiguousarray(payload, np.float32),
                        np.zeros((0,), np.float32)))
    return out


def _split_segment(spec: KVSpec, codec: str, count: int, blob: bytes
                   ) -> List[Tuple[bytes, bytes]]:
    """One segment's payload blob -> per-plane (payload, scales) byte
    slices — the exact inverse of the sender's part order, both
    derived from plane_part_nbytes so they cannot drift."""
    pay_n, sc_n = spec.plane_part_nbytes(codec, count)
    need = spec.planes * (pay_n + sc_n)
    if len(blob) != need:
        raise ProtocolError(
            f"segment payload is {len(blob)} bytes, spec derives "
            f"{need} for {count} block(s) under {codec!r}")
    out = []
    off = 0
    for _ in range(spec.planes):
        out.append((blob[off:off + pay_n],
                    blob[off + pay_n:off + pay_n + sc_n]))
        off += pay_n + sc_n
    return out


def _pool_planes(spec: KVSpec, codec: str, n_blocks: int,
                 plane_bytes: List[Tuple[bytes, bytes]]
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Reassembled per-plane wire bytes -> pool-layout arrays: int8
    pools get (codes, scales) verbatim; fp32 pools get fp32 rows (+
    all-ones scales), decoded through the quantize.py block twin when
    the wire was int8."""
    shape = (n_blocks,) + spec.block_shape
    out = []
    for raw, sc_raw in plane_bytes:
        if codec == "int8":
            codes = np.frombuffer(raw, np.int8).reshape(shape)
            scales = np.frombuffer(sc_raw, np.float32).copy()
            if spec.pool_dtype == "int8":
                out.append((codes.copy(), scales))
            else:
                out.append((int8_block_decode_xp(codes, scales),
                            np.ones((n_blocks,), np.float32)))
        else:
            out.append((np.frombuffer(raw, np.float32).reshape(
                shape).copy(), np.ones((n_blocks,), np.float32)))
    return out


class KVPageStream:
    """Client half: one prefill-side connection to one decode-side
    ``KVPageStreamServer``. ``connect()`` runs the hello/spec check;
    ``send_pages()`` ships one request's pages as spec-derived
    segments and blocks for the import ack. Not thread-safe — the
    transfer plane owns one stream per (worker, target) pair."""

    def __init__(self, spec: KVSpec, addr: Tuple[str, int],
                 codec: Optional[str] = None, timeout_s: float = 5.0,
                 seg_bytes: int = 1 << 18):
        self.spec = spec
        self.addr = addr
        self.codec = spec.validate_codec(
            codec if codec is not None else spec.default_codec())
        self.timeout_s = float(timeout_s)
        self.seg_bytes = int(seg_bytes)
        self._sock: Optional[socket.socket] = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def connect(self) -> None:
        if self._sock is not None:
            return
        sock = socket.create_connection(self.addr,
                                        timeout=self.timeout_s)
        try:
            # Small control frames interleave with bulk segments on
            # one long-lived socket: never sit out a Nagle exchange.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            faults.fire("kvstream.connect")
            send_msg(sock, {"kind": "hello",
                            "spec": self.spec.fingerprint(),
                            "codec": self.codec})
            ack, _ = recv_msg(sock, timeout=self.timeout_s)
            if not ack.get("ok"):
                raise KVStreamNack(ack.get("error", "hello refused"))
            # Symmetric check: the server validated us; we validate
            # the server (a one-sided hello would let a stale peer
            # stream into a re-specced pool).
            self.spec.check_hello(ack["spec"], self.codec,
                                  ack.get("codec"))
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def send_pages(self, meta: Dict,
                   planes: List[Tuple[np.ndarray, np.ndarray]]
                   ) -> Dict:
        """Ship one transfer (``meta`` + pool-layout plane arrays) and
        return the importer's ack. Any failure closes the stream (the
        positional protocol is desynced past repair) and raises
        KVStreamError/KVStreamNack — the caller owns disposition."""
        if self.spec.sharded:
            # Context-parallel pools: ``planes`` is the
            # rank-major plane-set list kv_export produced, and the
            # transfer is ``world`` per-rank sub-streams multiplexed
            # on this socket — each framed/segmented by that rank's
            # ``rank_view`` (a single-worker KVSpec), so the per-rank
            # sender and the receiver's parse stay the same function.
            if len(planes) != self.spec.world:
                raise ValueError(
                    f"sharded spec (world {self.spec.world}) wants "
                    f"rank-major plane sets, caller passed "
                    f"{len(planes)}")
        elif len(planes) != self.spec.planes:
            raise ValueError(
                f"spec declares {self.spec.planes} plane(s), caller "
                f"passed {len(planes)}")
        self.connect()
        sock = self._sock
        n_blocks = int(meta["n_blocks"])
        xfer = meta.get("xfer") or uuid.uuid4().hex[:12]
        if self.spec.sharded:
            counts = [int(c) for c in meta["rank_blocks"]]
            rank_segs = [
                self.spec.rank_view(r).segments(counts[r], self.codec,
                                                self.seg_bytes)
                for r in range(self.spec.world)]
            n_segs = sum(len(s) for s in rank_segs)
        else:
            counts, rank_segs = [n_blocks], [self.spec.segments(
                n_blocks, self.codec, self.seg_bytes)]
            n_segs = len(rank_segs[0])
        try:
            send_msg(sock, dict(meta, kind="pages", xfer=xfer,
                                codec=self.codec, segments=n_segs))
            si = 0
            for r, segs in enumerate(rank_segs):
                rv = (self.spec.rank_view(r) if self.spec.sharded
                      else self.spec)
                wire = _wire_planes(rv, self.codec,
                                    planes[r] if self.spec.sharded
                                    else planes)
                for start, count in segs:
                    # The chaos seam: a mid-transfer kill lands
                    # BETWEEN segments, after real bytes moved.
                    faults.fire("kvstream.send",
                                attrs={"xfer": xfer, "seg": si,
                                       "rank": r})
                    parts = []
                    for payload, scales in wire:
                        parts.append(payload[start:start + count])
                        if self.codec == "int8":
                            parts.append(np.ascontiguousarray(
                                scales[start:start + count],
                                np.float32))
                    send_msg(sock, {"kind": "seg", "xfer": xfer,
                                    "seq": si, "rank": r,
                                    "start": start, "count": count,
                                    "last": si == n_segs - 1}, *parts)
                    si += 1
            ack, _ = recv_msg(sock, timeout=self.timeout_s)
        except (OSError, ProtocolError) as e:
            self.close()
            raise KVStreamError(
                f"page stream to {self.addr} failed mid-transfer "
                f"(xfer {xfer}): {e}") from e
        except BaseException:
            # Any other failure mid-segment (an injected fault, a
            # codec bug) leaves the positional stream desynced past
            # repair: the socket must not be reused.
            self.close()
            raise
        if not ack.get("ok"):
            raise KVStreamNack(ack.get("error", "import refused"),
                               oom=bool(ack.get("oom")))
        return ack

    def close(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class KVPageStreamServer:
    """Decode-side half: accepts page streams, validates the hello,
    reassembles spec-derived segments and hands complete transfers to
    ``import_fn(meta, planes) -> ack_extras`` (the executor's
    ``kv_import`` wrapper in pool.py). An import raising nacks the
    transfer — ``oom=True`` for KVCacheOOM-shaped errors — and the
    connection survives; a torn stream drops the partial accumulation
    on the floor (no blocks were allocated until import runs)."""

    def __init__(self, spec: KVSpec, import_fn: Callable,
                 host: str = "127.0.0.1", port: int = 0,
                 codec: Optional[str] = None, timeout_s: float = 5.0):
        self.spec = spec
        self.import_fn = import_fn
        self.codec = spec.validate_codec(
            codec if codec is not None else spec.default_codec())
        self.timeout_s = float(timeout_s)
        self._stop = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                               1)
        self._lsock.bind((host, port))
        self._lsock.listen(8)
        # The accept loop selects first, but the socket is armed too
        # (the GL010 connect-time discipline): no receive leg in this
        # module can ever block unbounded, select bug or not.
        self._lsock.settimeout(1.0)
        self.addr = self._lsock.getsockname()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"kvstream-accept-{self.addr[1]}")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                r, _, _ = select.select([self._lsock], [], [], 0.1)
            except (OSError, ValueError):
                return  # close() tore the listener down mid-select
            if not r:
                continue
            try:
                conn, peer = self._lsock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn,
                                 args=(conn, peer), daemon=True,
                                 name=f"kvstream-conn-{peer[1]}")
            t.start()
            # Prune the dead before tracking the new: every failed
            # transfer reconnects, and a long-lived server must not
            # hoard one Thread object per retry forever.
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _recv(self, conn: socket.socket):
        """Idle-tolerant receive: re-arm on quiet (a healthy prefill
        peer submits nothing between transfers), whole-frame deadline
        once bytes flow (the shard_worker select-then-recv shape)."""
        while not self._stop.is_set():
            r, _, _ = select.select([conn], [], [], 0.1)
            if r:
                return recv_msg(conn, timeout=self.timeout_s)
        raise ProtocolError("server stopping")

    def _serve_conn(self, conn: socket.socket, peer) -> None:
        try:
            with conn:
                try:
                    hello, _ = recv_msg(conn, timeout=self.timeout_s)
                    self.spec.check_hello(hello.get("spec", {}),
                                          self.codec,
                                          hello.get("codec"))
                except Exception as e:
                    # Typed refusal BEFORE any payload: the client
                    # raises its own CodecMismatch/KVSpecMismatch off
                    # this ack.
                    send_msg(conn, {"ok": False, "error": str(e)})
                    return
                send_msg(conn, {"ok": True,
                                "spec": self.spec.fingerprint(),
                                "codec": self.codec})
                while not self._stop.is_set():
                    try:
                        msg, _ = self._recv(conn)
                    except (OSError, ProtocolError):
                        return  # peer gone / torn stream: partial
                        # accumulations die with the connection
                    if msg.get("kind") != "pages":
                        send_msg(conn, {"ok": False,
                                        "error": f"unexpected frame "
                                                 f"{msg.get('kind')!r}"})
                        return
                    self._one_transfer(conn, msg)
        except (OSError, ProtocolError) as e:
            # A peer dying mid-transfer is an EXPECTED failure mode
            # (the chaos matrix's bread and butter): the partial
            # accumulation dies with the connection, no blocks were
            # allocated, the sender owns the retry.
            log.warning("kv page stream: connection from %s torn "
                        "mid-transfer: %s", peer, e)
        except Exception:
            log.exception("kv page stream: connection from %s died",
                          peer)

    def _one_transfer(self, conn: socket.socket, meta: Dict) -> None:
        n_blocks = int(meta["n_blocks"])
        n_segs = int(meta["segments"])
        codec = meta.get("codec", self.codec)
        if codec != self.codec:
            # The codec was NEGOTIATED at hello; a frame stamped with
            # another one is a skewed/poisoned peer, and parsing its
            # payload under either codec would scatter misinterpreted
            # bytes into the pool — the exact failure the hello check
            # exists to make impossible.
            raise ProtocolError(
                f"pages frame stamped codec {codec!r} on a "
                f"{self.codec!r}-negotiated stream")
        # Sharded pools: ``world`` per-rank sub-streams multiplexed on
        # this socket, each parsed by its rank_view (the same derived
        # geometry the sender framed with); the flat path is the
        # world-1 degenerate case of the same loop.
        if self.spec.sharded:
            counts = [int(c) for c in meta["rank_blocks"]]
            views = [self.spec.rank_view(r)
                     for r in range(self.spec.world)]
        else:
            counts, views = [n_blocks], [self.spec]
        acc: List[List[List[bytes]]] = [
            [[] for _ in range(2 * self.spec.planes)] for _ in views]
        covered = [0] * len(views)
        for si in range(n_segs):
            msg, payload = recv_msg(conn, timeout=self.timeout_s)
            r = int(msg.get("rank", 0))
            if (msg.get("kind") != "seg"
                    or msg.get("xfer") != meta.get("xfer")
                    or int(msg.get("seq", -1)) != si
                    or not 0 <= r < len(views)
                    or int(msg.get("start", -1)) != covered[r]):
                raise ProtocolError(
                    f"segment stream desync at seq {si}: {msg}")
            count = int(msg["count"])
            for p, (raw, sc) in enumerate(_split_segment(
                    views[r], codec, count, payload)):
                acc[r][2 * p].append(raw)
                acc[r][2 * p + 1].append(sc)
            covered[r] += count
        if covered != counts:
            raise ProtocolError(
                f"segments cover {covered} block(s), header declared "
                f"{counts}")
        rank_planes = [
            _pool_planes(
                views[r], codec, counts[r],
                [(b"".join(acc[r][2 * p]),
                  b"".join(acc[r][2 * p + 1]))
                 for p in range(self.spec.planes)])
            for r in range(len(views))]
        planes = (rank_planes if self.spec.sharded
                  else rank_planes[0])
        try:
            faults.fire("kvstream.import",
                        attrs={"xfer": meta.get("xfer")})
            extras = self.import_fn(meta, planes) or {}
        except Exception as e:
            oom = "exhausted" in str(e) or "KVCacheOOM" in type(e).__name__
            log.warning("kv page stream: import refused (request %s): "
                        "%s", meta.get("req"), e)
            send_msg(conn, {"ok": False, "error": str(e), "oom": oom})
            return
        send_msg(conn, {"ok": True, "xfer": meta.get("xfer"),
                        **extras})

    def close(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=2.0)
