"""The port's fabric ring transport and wire codecs against the JAX
package's.

``parallel/fabric_collectives.py`` and the wire codecs of
``parallel/quantize.py`` are copies (numpy over TCP; no card). Held here:

  * every wire codec encodes byte for byte as the reference's (the wire
    array and its scale), its twins agree, and error feedback carries the
    same residuals;
  * ``RingTransport.allreduce`` over loopback threads gives byte-identical
    results to the reference's ring on the same inputs, for fp32, int8
    (with and without error feedback) and bf16 — and a ring whose ranks
    alternate between the two packages agrees with both, so the two
    speak one wire format;
  * the typed errors, ``bench_ring`` and ``quantized_error_bound``.
"""

import errno
import socket
import threading

import numpy as np
import pytest
import torch

from dpu_operator_tpu.parallel import fabric_collectives as ref_fc
from dpu_operator_tpu.parallel import quantize as ref_q
from dpu_operator_tpu_torch.parallel import fabric_collectives as fc
from dpu_operator_tpu_torch.parallel import quantize as q

torch.set_num_threads(1)


def _ports(n):
    """n distinct loopback ports, bound together before any is released
    (the same allocation ``procset._distinct_ports`` makes)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _ring(modules, fn, codec=None, error_feedback=False, streams=1,
          chunk_bytes=64 << 10):
    """Run fn(transport, rank) on every rank at once, rank r's transport
    from ``modules[r]`` (a package's ``fabric_collectives``); returns the
    per-rank results and re-raises the first failure. A port stolen
    between allocation and bind retries the ring on fresh ports."""
    world = len(modules)
    for _attempt in range(3):
        peers = [f"127.0.0.1:{p}" for p in _ports(world)]
        results, errors = [None] * world, []

        def rank(r):
            t = modules[r].RingTransport(
                r, world, "127.0.0.1", peers, streams=streams,
                chunk_bytes=chunk_bytes,
                codec=codec[r] if isinstance(codec, list) else codec,
                error_feedback=error_feedback)
            try:
                t.connect(timeout=20.0)
                results[r] = fn(t, r)
            except BaseException as e:
                errors.append(e)
            finally:
                t.close()

        threads = [threading.Thread(target=rank, args=(r,), daemon=True)
                   for r in range(world)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        if errors and isinstance(errors[0], OSError) \
                and errors[0].errno == errno.EADDRINUSE:
            continue
        if errors:
            raise errors[0]
        return results
    raise errors[0]


def _payload(elems, r):
    base = (np.arange(elems, dtype=np.float64) * 0.6180339887
            % 2.0 - 1.0).astype(np.float32)
    return base * (r + 1) + np.float32(0.001 * r)


# -- the wire codecs ------------------------------------------------------------


@pytest.mark.parametrize("name", ["int8", "bf16"])
@pytest.mark.parametrize("n", [0, 1, 7, 4099])
def test_wire_codec_encodes_byte_for_byte(name, n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 3).astype(np.float32)
    if n > 3:
        x[3] = 0.0
    port, ref = q.get_codec(name), ref_q.get_codec(name)
    assert (port.name, port.codec_id, port.wire_itemsize) == \
        (ref.name, ref.codec_id, ref.wire_itemsize)
    pw, ps = port.encode(x)
    rw, rs = ref.encode(x)
    assert pw.dtype == rw.dtype and pw.tobytes() == rw.tobytes()
    assert ps == rs
    dec = port.decode(pw, n, ps)
    assert dec.tobytes() == ref.decode(rw, n, rs).tobytes()
    out = np.empty(n, np.float32)
    assert port.decode(pw.tobytes(), n, ps, out=out) is out
    assert out.tobytes() == dec.tobytes()
    into_p, into_r = np.ones(n, np.float32), np.ones(n, np.float32)
    port.decode_add(pw, n, ps, into_p)
    ref.decode_add(rw, n, rs, into_r)
    assert into_p.tobytes() == into_r.tobytes()
    assert port.frame_header(ps) == ref.frame_header(rs)
    assert port.roundtrip(x.reshape(-1, 1)).tobytes() == \
        ref.roundtrip(x.reshape(-1, 1)).tobytes()


def test_codec_twins_match_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(5, 33) * 2).astype(np.float32)
    x[2] = 0.0
    for a, b in zip(q.int8_encode_xp(x), ref_q.int8_encode_xp(x)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    qa, sa = q.int8_encode_xp(x)
    assert q.int8_decode_xp(qa, sa).tobytes() == \
        ref_q.int8_decode_xp(qa, sa).tobytes()
    for a, b in zip(q.int8_block_encode_xp(x), ref_q.int8_block_encode_xp(x)):
        assert a.tobytes() == b.tobytes()
    qb, sb = q.int8_block_encode_xp(x)
    assert q.int8_block_decode_xp(qb, sb).tobytes() == \
        ref_q.int8_block_decode_xp(qb, sb).tobytes()
    code = q.bf16_encode_xp(x)
    assert code.tobytes() == ref_q.bf16_encode_xp(x).tobytes()
    assert q.bf16_decode_xp(code).tobytes() == \
        ref_q.bf16_decode_xp(code).tobytes()
    # The port's torch block codec is the block twin's counterpart.
    tq, ts = q.int8_block_encode(torch.from_numpy(x))
    assert tq.numpy().tobytes() == qb.tobytes()
    assert ts.numpy().tobytes() == sb.tobytes()


def test_error_feedback_residuals_match_reference():
    x = np.full(64, 0.7003, np.float32)
    x[0] = 1.0
    port = q.ErrorFeedback(q.Int8Codec())
    ref = ref_q.ErrorFeedback(ref_q.Int8Codec())
    for k in range(8):
        pw, ps = port.encode(x * (1 + k % 3), slot=k % 2)
        rw, rs = ref.encode(x * (1 + k % 3), slot=k % 2)
        assert pw.tobytes() == rw.tobytes() and ps == rs
    assert sorted(port._residual) == sorted(ref._residual)
    for key, res in ref._residual.items():
        assert port._residual[key].tobytes() == res.tobytes()


def test_codec_registry_and_typed_errors():
    assert q.get_codec(None) is None and q.get_codec("fp32") is None
    assert isinstance(q.get_codec("BF16"), q.Bf16Codec)
    codec = q.Int8Codec()
    assert q.get_codec(codec) is codec
    for mod in (q, ref_q):
        with pytest.raises(mod.CodecError, match="unknown") as ei:
            mod.get_codec("int4")
        assert str(ei.value) == "unknown wire codec 'int4' (known: fp32, " \
            "bf16, int8)"
    hdr = q.Int8Codec().frame_header(0.5)
    assert q.Int8Codec().parse_header(hdr) == pytest.approx(0.5)
    with pytest.raises(q.CodecError, match="mismatch") as got:
        q.Bf16Codec().parse_header(hdr)
    with pytest.raises(ref_q.CodecError, match="mismatch") as want:
        ref_q.Bf16Codec().parse_header(hdr)
    assert str(got.value) == str(want.value)
    assert q.FRAME_HEADER.format == ref_q.FRAME_HEADER.format


# -- the ring transport -------------------------------------------------------------


@pytest.mark.parametrize("world,elems,codec,ef", [
    (2, 40000, None, False),
    (3, (1 << 16) + 7, None, False),
    (3, 40007, "int8", False),
    (3, 40007, "int8", True),
    (2, 40000, "bf16", False),
    (3, 2, "int8", False),
])
def test_allreduce_byte_identical_to_reference(world, elems, codec, ef):
    """The port's ring and the reference's give the same bytes on every
    rank, over three calls (error feedback carries residuals across
    them); fp32 is the exact sum."""
    def fn(t, r):
        return [t.allreduce(_payload(elems, r) * (k + 1)).copy()
                for k in range(3)]

    port = _ring([fc] * world, fn, codec=codec, error_feedback=ef)
    ref = _ring([ref_fc] * world, fn, codec=codec, error_feedback=ef)
    for p, r in zip(port, ref):
        for a, b in zip(p, r):
            assert a.tobytes() == b.tobytes()
    if codec is None:
        want = sum(_payload(elems, r) for r in range(world))
        np.testing.assert_allclose(port[0][0], want, rtol=1e-6, atol=1e-6)
    for out in port[1:]:
        assert out[0].tobytes() == port[0][0].tobytes()


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
def test_mixed_package_ring_speaks_one_wire(codec):
    """Ranks alternate between the two packages' transports in one ring:
    the hello, the frames and the result are the same as an all-port
    ring's."""
    elems = 30011

    def fn(t, r):
        return t.allreduce(_payload(elems, r)).copy()

    mixed = _ring([fc, ref_fc, fc], fn, codec=codec)
    port = _ring([fc] * 3, fn, codec=codec)
    for a, b in zip(mixed, port):
        assert a.tobytes() == b.tobytes()


def test_mixed_codec_ring_fails_typed_at_connect():
    with pytest.raises(fc.CodecMismatch):
        _ring([fc, fc], lambda t, r: t.allreduce(np.ones(64, np.float32)),
              codec=["int8", "fp32"])


def test_world_one_identity_exchange_and_accounting():
    t = fc.RingTransport(0, 1, "127.0.0.1", ["127.0.0.1"])
    local = np.arange(100, dtype=np.float32)
    out = t.allreduce(local)
    assert np.array_equal(out, local) and out is not local
    _ring([fc] * 3, lambda t, r: t.exchange(np.ones(10000, np.float32)))
    for world in (2, 3, 8):
        tp = fc.RingTransport(0, world, "127.0.0.1", ["127.0.0.1"] * world)
        tr = ref_fc.RingTransport(0, world, "127.0.0.1",
                                  ["127.0.0.1"] * world)
        assert tp.wire_bytes(1 << 20) == tr.wire_bytes(1 << 20)
    with pytest.raises(fc.RingError):
        fc.RingTransport(2, 2, "127.0.0.1", ["a", "b"])
    with pytest.raises(fc.RingError):
        fc.RingTransport(0, 2, "127.0.0.1", ["a"])


def test_absent_peer_fails_typed_within_its_deadline():
    """No peer listening: the dial gives up with ``FabricConnectError``
    naming the peer, inside the connect deadline."""
    p0, p1 = _ports(2)
    t = fc.RingTransport(0, 2, "127.0.0.1",
                         [f"127.0.0.1:{p0}", f"127.0.0.1:{p1}"])
    try:
        with pytest.raises(fc.RingError) as ei:
            t.connect(timeout=0.5)
        assert isinstance(ei.value, fc.FabricConnectError)
        assert ei.value.peer == ("127.0.0.1", p1)
    finally:
        t.close()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_bench_ring_reports_and_verifies(codec):
    res = _ring([fc, fc], lambda t, r: fc.bench_ring(t, 1 << 18, 2,
                                                     mode="allreduce"),
                codec=codec)
    for r in res:
        assert r["ok"] and r["gbps"] > 0
        assert r["codec"] == (codec or "fp32")
        if codec:
            assert 0.0 <= r["max_abs_err"] <= r["err_bound"]
    raw = _ring([fc, fc], lambda t, r: fc.bench_ring(t, 1 << 16, 2,
                                                     mode="exchange"))
    assert all(r["ok"] and r["mode"] == "exchange" for r in raw)
    for world in (2, 3, 8):
        for name in ("int8", "bf16", "fp32"):
            assert fc.quantized_error_bound(world, 2.5, name) == \
                ref_fc.quantized_error_bound(world, 2.5, name)
