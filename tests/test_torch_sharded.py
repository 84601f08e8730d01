"""The port's fabric-sharded serving plane against the JAX package's.

``serving/sharded/shard_math.py`` is the port's own, in torch; the
coordinator (``executor.py``), the thread shard set (``synthetic.py``), the
process shard set (``procset.py``) and the row worker (``shard_worker.py``)
are the reference's code (``tests/test_torch_isolation.py``). On the CPU,
with ``device="cpu"``, at the reference tests' sizes:

  * the slices' ``partial``, ``finish``, ``forward`` and
    ``forward_overlapped`` against the reference's numpy slices, rtol 1e-5
    / atol 1e-6 (the same f32 products in two libraries);
  * ``FabricExecutor`` token streams exactly equal to the reference's
    ``FabricExecutor`` on the same shard set, and to its
    ``SyntheticExecutor`` (the double) or ``LocalExecutor`` (real params) —
    sync and pipelined, overlap on and off, int8 and bf16 codecs;
  * ``make_mesh_stage_fn`` against the reference's jitted one on the
    8-device CPU mesh: tokens exact, states rtol 1e-4 / atol 1e-5 (the
    reference's own bar for this form);
  * two ``ShardProcessSet`` lanes over real ``shard_worker`` processes;
  * the failure and metrics contracts, without wall-clock margins.
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dpu_operator_tpu import faults as ref_faults
from dpu_operator_tpu.parallel.train_step import init_params as ref_init
from dpu_operator_tpu.serving import AdmissionQueue as RefQueue
from dpu_operator_tpu.serving import ContinuousBatcher as RefBatcher
from dpu_operator_tpu.serving import FabricExecutor as RefFabric
from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import LocalExecutor as RefLocal
from dpu_operator_tpu.serving import SyntheticExecutor as RefSynthetic
from dpu_operator_tpu.serving import SyntheticShardSet as RefShardSet
from dpu_operator_tpu.serving import encode_prompt as ref_encode
from dpu_operator_tpu.serving.sharded import shard_math as ref_math
from dpu_operator_tpu_torch import faults
from dpu_operator_tpu_torch.obs import trace as obs_trace
from dpu_operator_tpu_torch.parallel import collective_matmul as cm
from dpu_operator_tpu_torch.parallel import train_step as ts
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            FabricExecutor, GenerateRequest,
                                            LocalExecutor, ReplicaPool,
                                            ShardProcessSet,
                                            SyntheticShardSet,
                                            encode_prompt)
from dpu_operator_tpu_torch.serving.sharded import (ShardAborted, ShardError,
                                                    ShardStepError,
                                                    StepOutput)
from dpu_operator_tpu_torch.serving.sharded import shard_math
from dpu_operator_tpu_torch.serving.sharded.procset import _distinct_ports
from dpu_operator_tpu_torch.serving.sharded.shard_worker import _maybe_jit
from dpu_operator_tpu_torch.utils.metrics import Registry

torch.set_num_threads(1)

MODEL = dict(S=1, d=8, h=8, E=1)
WIDE = dict(S=2, d=16, h=32, E=1)
CPU = dict(device="cpu")
RTOL, ATOL = 1e-5, 1e-6


def _real_params(**model):
    """The reference's seed-0 ``init_params`` weights as numpy."""
    return {k: np.asarray(v, np.float32)
            for k, v in ref_init(seed=0, **model).items()}


def _trace(n, d, toks, port=True):
    req, enc = ((GenerateRequest, encode_prompt) if port
                else (RefRequest, ref_encode))
    return [req(prompt_vec=enc(f"sh-{i}", d), max_tokens=toks,
                deadline=time.monotonic() + 600.0) for i in range(n)]


def _drive(ex, n, d, toks, port=True):
    """The reference's ``_drive``: every request through the admission
    queue and the continuous batcher; returns (error, tokens) a request."""
    reqs = _trace(n, d, toks, port)
    q = (AdmissionQueue if port else RefQueue)(max_depth=len(reqs) + 1)
    b = (ContinuousBatcher if port else RefBatcher)(ex, q)
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=60), "request lost"
    finally:
        b.stop()
        ex.close()
    return [(r.error, list(r.tokens)) for r in reqs]


# -- the slices -----------------------------------------------------------------


def _seam(p, s):
    return p


def _overlap_seams(calls):
    def submit(part, stage, block):
        calls.append((stage, block, part.shape[0]))
        assert isinstance(part, np.ndarray) and part.dtype == np.float32
        return part

    return submit, lambda t: t


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_tp_slice_matches_reference(world):
    params = _real_params(S=2, d=8, h=8, E=1)
    x = np.random.RandomState(world).randn(4, 8).astype(np.float32)
    for rank in range(world):
        ref = ref_math.TpShardSlice(params, rank, world)
        port = shard_math.TpShardSlice(params, rank, world, **CPU)
        assert (port.stages, port.d, port.h) == (ref.stages, ref.d, ref.h)
        assert tuple(port.w1.shape) == ref.w1.shape
        xt = torch.from_numpy(x)
        for s in range(2):
            part = port.partial(xt, s)
            np.testing.assert_allclose(part.numpy(), ref.partial(x, s),
                                       rtol=RTOL, atol=ATOL)
            dense = ref.partial(x, s) * 3
            np.testing.assert_allclose(
                port.finish(xt, torch.from_numpy(dense), s).numpy(),
                ref.finish(x, dense, s), rtol=RTOL, atol=ATOL)
    # The whole step at world 1 (the reduce is the identity).
    ref = ref_math.TpShardSlice(params, 0, 1)
    port = shard_math.TpShardSlice(params, 0, 1, **CPU)
    rx, rt = ref.forward(x.copy(), _seam)
    px, pt = port.forward(x.copy(), _seam)
    np.testing.assert_allclose(px, rx, rtol=RTOL, atol=ATOL)
    assert pt.tolist() == rt.tolist() and pt.dtype == np.int32
    calls = []
    ox, ot = port.forward_overlapped(x.copy(), *_overlap_seams(calls),
                                     blocks=2)
    rox, rot = ref.forward_overlapped(x.copy(), lambda p, s, b: p,
                                      lambda t: t, blocks=2)
    np.testing.assert_allclose(ox, rox, rtol=RTOL, atol=ATOL)
    assert ot.tolist() == rot.tolist()
    assert calls == [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]


@pytest.mark.parametrize("world", [1, 3, 20])
def test_double_slice_matches_reference(world):
    """The seeded double: the same W draw, partials summed over the
    ranks == the reference's, and rank shapes off the width (world 20 >
    d 16 gives empty slices that contribute zeros)."""
    d = 16
    x = np.random.RandomState(1).randn(5, d).astype(np.float32)
    total_p = total_r = 0
    for rank in range(world):
        ref = ref_math.DoubleShardSlice(d, 3, rank, world)
        port = shard_math.DoubleShardSlice(d, 3, rank, world, **CPU)
        pp = port.partial(torch.from_numpy(x), 0).numpy()
        assert pp.dtype == np.float32
        rp = np.asarray(ref.partial(x, 0), np.float32)
        np.testing.assert_allclose(pp, rp, rtol=RTOL, atol=ATOL)
        total_p, total_r = total_p + pp, total_r + rp
    np.testing.assert_allclose(total_p, total_r, rtol=RTOL, atol=ATOL)
    port = shard_math.DoubleShardSlice(d, 3, 0, 1, **CPU)
    ref = ref_math.DoubleShardSlice(d, 3, 0, 1)
    px, pt = port.forward(x.copy(), _seam)
    rx, rt = ref.forward(x.copy(), _seam)
    np.testing.assert_allclose(px, rx, rtol=RTOL, atol=ATOL)
    assert pt.tolist() == rt.tolist()


def test_overlap_blocks_exceeding_slots_degrades_to_per_row():
    sl = shard_math.DoubleShardSlice(8, seed=1, rank=0, world=1, **CPU)
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    calls = []
    x_ref, tok_ref = sl.forward(x.copy(), _seam)
    x_ov, tok_ov = sl.forward_overlapped(x.copy(), *_overlap_seams(calls),
                                         blocks=8)
    assert tok_ref.tolist() == tok_ov.tolist()
    assert x_ref.tobytes() == x_ov.tobytes()
    assert [c[2] for c in calls] == [1, 1, 1]


def test_slices_share_one_device_copy_and_keep_the_reference_errors():
    params = ts.init_params(S=2, d=8, h=8, E=1, **CPU)
    a = shard_math.TpShardSlice(params, 0, 2, **CPU)
    b = shard_math.TpShardSlice(params, 1, 2, **CPU)
    for name in ("w1", "w2", "moe_w1", "moe_w2"):
        assert getattr(a, name).untyped_storage().data_ptr() == \
            params[name].untyped_storage().data_ptr()
    assert b.moe_w1.data_ptr() == a.moe_w1.data_ptr()
    s = SyntheticShardSet(world=3, slots=2, params=_real_params(**MODEL),
                          **CPU)
    ptr = s.params["moe_w1"].data_ptr()
    assert all(s._make_slice(r).moe_w1.data_ptr() == ptr for r in range(3))
    assert s.d == 8
    bad = _real_params(S=1, d=8, h=8, E=2)
    for args in ((bad, 0, 2), (_real_params(**MODEL), 2, 2)):
        with pytest.raises(ValueError) as want:
            ref_math.TpShardSlice(*args)
        with pytest.raises(ValueError) as got:
            shard_math.TpShardSlice(*args, **CPU)
        assert str(got.value) == str(want.value)
    wq = dict(_real_params(**MODEL), wq=np.zeros((1, 8, 8), np.float32))
    with pytest.raises(ValueError, match="attention"):
        shard_math.TpShardSlice(wq, 0, 1, **CPU)
    with pytest.raises(ValueError, match="bad shard shape"):
        shard_math.DoubleShardSlice(8, 0, -1, 2, **CPU)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default is it")
def test_default_device_is_the_card():
    """Nothing in the plane falls back to the CPU on its own: without a
    CUDA device every entry point asked for the default raises."""
    params = _real_params(**MODEL)
    for make in (lambda: shard_math.TpShardSlice(params, 0, 1),
                 lambda: shard_math.DoubleShardSlice(8, 0, 0, 1),
                 lambda: SyntheticShardSet(world=2, slots=2, d=8),
                 lambda: ShardProcessSet(world=2, slots=2, d=8),
                 lambda: shard_math.make_mesh_stage_fn({"tp": 2}, params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -- token streams: the acceptance contract ------------------------------------


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
@pytest.mark.parametrize("overlap", [False, True])
def test_double_streams_equal_reference(mode, overlap):
    """FabricExecutor over 3 thread shards of the seeded double: the
    port's streams == the reference's sharded ones == its single
    SyntheticExecutor's, more requests than slots."""
    ref_local = _drive(RefSynthetic(slots=4, d=16, seed=3,
                                    pipelined=(mode == "pipelined")),
                       10, 16, 5, port=False)
    ref = _drive(RefFabric(RefShardSet(world=3, slots=4, d=16, seed=3,
                                       overlap=overlap), mode=mode),
                 10, 16, 5, port=False)
    port = _drive(FabricExecutor(SyntheticShardSet(
        world=3, slots=4, d=16, seed=3, overlap=overlap, **CPU), mode=mode),
        10, 16, 5)
    assert all(e is None for e, _ in port)
    assert port == ref == ref_local


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_quantized_double_streams_equal_reference(codec):
    """The codec's rounding is the reference's (the board's roundtrip),
    so quantized streams equal the reference's, and repeat."""
    def port():
        return _drive(FabricExecutor(SyntheticShardSet(
            world=3, slots=4, d=16, seed=3, codec=codec, overlap=True,
            **CPU), mode="pipelined"), 8, 16, 5)

    ref = _drive(RefFabric(RefShardSet(world=3, slots=4, d=16, seed=3,
                                       codec=codec, overlap=True),
                           mode="pipelined"), 8, 16, 5, port=False)
    first = port()
    assert all(e is None for e, _ in first)
    assert first == ref == port()


#: The reference LocalExecutor's streams by (model, mode): deterministic,
#: and each build jits the reference's step anew.
_REF_LOCAL = {}


@pytest.mark.parametrize("model", ["small", "wide"])
@pytest.mark.parametrize("mode,overlap,world", [
    ("sync", False, 2), ("pipelined", False, 2), ("pipelined", True, 2),
    ("sync", True, 3)])
def test_real_params_streams_equal_reference(model, mode, overlap, world):
    """Tensor-parallel slices of the reference's seed-0 weights: the
    port's streams == the reference's FabricExecutor's == its jitted
    LocalExecutor's == the port's own LocalExecutor's on the same
    weights. "wide" (S 2, d 16, h 32) gives streams that move."""
    m = MODEL if model == "small" else WIDE
    params = _real_params(**m)
    key = (model, mode)
    if key not in _REF_LOCAL:
        _REF_LOCAL[key] = _drive(RefLocal(slots=4, mode=mode, seed=0, **m),
                                 8, m["d"], 5, port=False)
    ref_local = _REF_LOCAL[key]
    ref = _drive(RefFabric(RefShardSet(world=world, slots=4, params=params,
                                       overlap=overlap), mode=mode),
                 8, m["d"], 5, port=False)
    port = _drive(FabricExecutor(SyntheticShardSet(
        world=world, slots=4, params=params, overlap=overlap, **CPU),
        mode=mode), 8, m["d"], 5)
    local = _drive(LocalExecutor(params=ts.params_from_numpy(params, "cpu"),
                                 slots=4, mode=mode, **m, **CPU),
                   8, m["d"], 5)
    assert all(e is None for e, _ in port)
    assert port == ref == ref_local == local
    if model == "wide":
        assert len({tuple(t) for _, t in port}) > 1


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_quantized_real_params_streams_equal_reference(codec):
    params = _real_params(**WIDE)

    def run(port):
        if port:
            shards = SyntheticShardSet(world=2, slots=4, params=params,
                                       codec=codec, overlap=True, **CPU)
            return _drive(FabricExecutor(shards), 6, 16, 4)
        shards = RefShardSet(world=2, slots=4, params=params, codec=codec,
                             overlap=True)
        return _drive(RefFabric(shards), 6, 16, 4, port=False)

    assert run(True) == run(False)


def test_tp_slice_multistage_matches_world1():
    params = _real_params(S=2, d=8, h=8, E=1)
    streams = {}
    for world in (1, 3):
        ex = FabricExecutor(SyntheticShardSet(world=world, slots=2,
                                              params=params, **CPU),
                            mode="sync")
        try:
            ex.reset()
            x = np.stack([encode_prompt(f"ms-{i}", 8)
                          for i in range(2)]).astype(np.float32)
            toks = []
            for _ in range(4):
                x = ex.step(x)
                toks.append(np.argmax(x, axis=1).tolist())
            streams[world] = toks
        finally:
            ex.close()
    assert streams[1] == streams[3]


# -- the mesh-stage form (TPU kernel 11's serving path) -------------------------


@pytest.mark.parametrize("tp,slots,h", [(2, 4, 8), (8, 8, 16), (8, 64, 16)])
def test_mesh_stage_fn_matches_reference(tp, slots, h):
    """The port's ``make_mesh_stage_fn`` (plain all-gather matmul on the
    CPU, the rank-ordered sum closing w2) against the reference's jitted
    one over ``tp`` devices of the CPU mesh and against ``TpShardSlice``
    at world 1, overlap on and off, three steps. (8, 64, 16) has the
    full-width stage's blocks of 8 rows, the card's gathered form."""
    from dpu_operator_tpu.serving.sharded.shard_math import \
        make_mesh_stage_fn as ref_stage

    params = _real_params(S=2, d=8, h=h, E=1)
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    x0 = np.random.RandomState(tp).randn(slots, 8).astype(np.float32)
    sl = shard_math.TpShardSlice(params, 0, 1, **CPU)
    for overlap in (True, False):
        ref = ref_stage(mesh, params, overlap=overlap)
        port = shard_math.make_mesh_stage_fn({"tp": tp}, params,
                                             overlap=overlap, **CPU)
        xr = xp = xs = x0.copy()
        for _ in range(3):
            xr, tr = ref(xr)
            xp, tp_tok = port(xp)
            xs, ts_tok = sl.forward(xs, _seam)
            assert tp_tok.tolist() == tr.tolist() == ts_tok.tolist()
            np.testing.assert_allclose(xp, xr, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(xp, xs, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divide") as got:
        port(np.zeros((slots + 1, 8), np.float32))
    with pytest.raises(ValueError, match="divide") as want:
        ref(np.zeros((slots + 1, 8), np.float32))
    assert str(got.value) == str(want.value)


def test_mesh_stage_fn_routes_and_errors():
    """The w1 product goes through ``make_allgather_matmul``'s pick (the
    plain ring on the CPU; ``overlap=False`` the naive product); E != 1
    raises the reference's text; ``kernel="cuda"`` on the CPU raises."""
    from dpu_operator_tpu.serving.sharded.shard_math import \
        make_mesh_stage_fn as ref_stage

    params = _real_params(S=2, d=8, h=8, E=1)
    calls = {"plain": 0, "naive": 0}
    real_plain, real_naive = cm.ag_matmul_plain, cm.ag_matmul_naive

    def plain(*a):
        calls["plain"] += 1
        return real_plain(*a)

    def naive(*a):
        calls["naive"] += 1
        return real_naive(*a)

    cm.ag_matmul_plain, cm.ag_matmul_naive = plain, naive
    try:
        for overlap in (True, False):
            step = shard_math.make_mesh_stage_fn({"tp": 2}, params,
                                                 overlap=overlap, **CPU)
            step(np.ones((4, 8), np.float32))
    finally:
        cm.ag_matmul_plain, cm.ag_matmul_naive = real_plain, real_naive
    assert calls == {"plain": 2, "naive": 2}
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    bad = _real_params(S=1, d=8, h=8, E=2)
    with pytest.raises(ValueError) as want:
        ref_stage(mesh, bad)
    with pytest.raises(ValueError) as got:
        shard_math.make_mesh_stage_fn({"tp": 2}, bad, **CPU)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="CUDA"):
        shard_math.make_mesh_stage_fn({"tp": 2}, params, kernel="cuda",
                                      **CPU)


# -- failure, lifecycle and metrics contracts -------------------------------------


def test_hung_peer_surfaces_typed():
    with faults.injected() as plan:
        plan.inject("stall1.step", hang_s=5.0, at_calls=[1])
        ex = FabricExecutor(SyntheticShardSet(
            world=2, slots=2, d=8, collective_timeout_s=0.3,
            fault_site="stall", **CPU), step_timeout_s=2.0)
        try:
            ex.reset()
            with pytest.raises(ShardError):
                ex.collect(ex.submit([]))
        finally:
            ex.close()


def test_reset_aborts_outstanding_steps_and_respawns():
    """A reset with a step in flight (rank 0 hangs in its first step, so
    the step cannot finish first) aborts the handle typed, abandons the
    hung thread and serves from a fresh generation."""
    with faults.injected() as plan:
        plan.inject("slow0.step", hang_s=5.0, at_calls=[1])
        shards = SyntheticShardSet(world=2, slots=2, d=8,
                                   fault_site="slow", **CPU)
        ex = FabricExecutor(shards)
        try:
            ex.reset()
            h = ex.submit([(0, np.ones(8, np.float32))])
            ex.reset()
            with pytest.raises(ShardAborted):
                ex.collect(h)
            assert shards.outstanding() == 0
            tokens = ex.collect(ex.submit([]))
            assert tokens.shape == (2,)
            assert shards.live_shards() == 2
        finally:
            ex.close()
    assert shards.outstanding() == 0


def test_shard_step_error_lands_typed_in_collect():
    assert faults is not ref_faults
    with faults.injected() as plan:
        plan.inject("dead0.step", exc=RuntimeError("chip fell off"),
                    at_calls=[2])
        ex = FabricExecutor(SyntheticShardSet(world=2, slots=2, d=8,
                                              fault_site="dead", **CPU),
                            step_timeout_s=2.0)
        try:
            ex.reset()
            ex.collect(ex.submit([]))
            with pytest.raises(ShardStepError) as ei:
                ex.collect(ex.submit([]))
            assert ei.value.rank == 0
        finally:
            ex.close()


def test_shard_metrics_pool_dimension_and_registry_binding():
    """The shard series carry ``{replica, codec}``; the pool publishes
    the ``sharded`` dimension and binds its registry into the
    executor."""
    reg = Registry()
    ex = FabricExecutor(SyntheticShardSet(world=2, slots=2, d=8,
                                          codec="int8", **CPU),
                        registry=reg, name="shardtest")
    try:
        ex.reset()
        for _ in range(3):
            ex.collect(ex.submit([]))
    finally:
        ex.close()
    text = reg.render()
    assert "serving_shard_collective_seconds_bucket" in text
    assert 'codec="int8"' in text and 'replica="shardtest"' in text
    labels = {"replica": "shardtest", "codec": "int8"}
    assert reg.quantile("serving_shard_step_skew_seconds", 0.5,
                        labels) is not None
    reg = Registry()
    q = AdmissionQueue(max_depth=4)
    ex_sh = FabricExecutor(SyntheticShardSet(world=2, slots=2, d=8, **CPU))
    pool = ReplicaPool([ex_sh], q, registry=reg, poll_s=0.005)
    pool.start()
    try:
        assert reg.gauge_value(
            "serving_pool_replicas",
            {"state": "live", "sharded": "true", "role": "unified"}) == 1.0
        assert ex_sh._registry is reg
        r = GenerateRequest(prompt_vec=encode_prompt("m", 8), max_tokens=2,
                            deadline=time.monotonic() + 30.0)
        q.submit(r)
        assert r.wait(timeout=10)
    finally:
        pool.stop()
    assert "serving_shard_step_skew_seconds" in reg.render()


def _taxonomy(tracer):
    from collections import Counter

    return Counter((s.name, s.attrs.get("rank"))
                   for s in tracer.spans_snapshot()
                   if s.name in ("shard.step", "shard.compute",
                                 "shard.reduce_blocked", "shard.encode"))


def test_trace_taxonomy_equals_reference():
    from dpu_operator_tpu.obs import trace as ref_trace

    def drive(ex, scoped):
        with scoped() as tr:
            ex.reset()
            try:
                for k in range(3):
                    ex.collect(ex.submit(
                        [(0, np.full(8, 1.0 + k, np.float32))],
                        occupants=[f"rq-{k}"]))
                return _taxonomy(tr)
            finally:
                ex.close()

    for codec in (None, "int8"):
        port = drive(FabricExecutor(SyntheticShardSet(
            world=2, slots=4, d=8, seed=3, codec=codec, **CPU)),
            obs_trace.scoped)
        ref = drive(RefFabric(RefShardSet(world=2, slots=4, d=8, seed=3,
                                          codec=codec)), ref_trace.scoped)
        assert port == ref and port[("shard.step", None)] == 3


def test_step_output_and_distinct_ports():
    out = StepOutput(np.zeros(2, np.int32), None, [0.0], [0.0])
    assert out.spans_by_rank is None and out.metrics_by_rank is None
    assert len(set(_distinct_ports(16))) == 16


def test_worker_warm_up_runs_every_stage_once():
    """``--jit`` is the warm-up: every stage's partial and finish run
    once on the slice's device before the hello; without it nothing
    runs. The step's math is the slice's own either way."""
    params = ts.init_params(S=3, d=8, h=8, E=1, **CPU)
    sl = shard_math.TpShardSlice(params, 0, 2, **CPU)
    seen = []
    real_p, real_f = sl.partial, sl.finish
    sl.partial = lambda x, s: (seen.append(("p", s, tuple(x.shape))),
                               real_p(x, s))[1]
    sl.finish = lambda x, d, s: (seen.append(("f", s)), real_f(x, d, s))[1]
    assert _maybe_jit(sl, False, slots=4) is False
    assert seen == []
    assert _maybe_jit(sl, True, slots=4) is True
    assert seen == [("p", 0, (4, 8)), ("f", 0), ("p", 1, (4, 8)), ("f", 1),
                    ("p", 2, (4, 8)), ("f", 2)]


# -- real shard_worker processes ------------------------------------------------------


def test_procset_codec_overlap_and_re_rendezvous():
    """int8 + overlap over two real workers: steps serve, the state comes
    back from rank 0, spans and metrics ride the replies, a reset with a
    step outstanding re-rendezvouses (kill + respawn) and the old handle
    fails typed; the ledger is clean after close."""
    reg = Registry()
    procs = ShardProcessSet(world=2, slots=4, d=8, jit=True, codec="int8",
                            overlap=True, spawn_timeout_s=60.0,
                            metrics_interval=1, **CPU)
    assert procs.codec_name == "int8"
    ex = FabricExecutor(procs, mode="pipelined", registry=reg, name="xp")
    with obs_trace.scoped() as tr:
        try:
            ex.reset()
            h = ex.submit([(0, np.ones(8, np.float32))])
            out = procs.collect(h.handle, timeout=30.0)
            assert out.tokens.shape == (4,)
            assert out.spans_by_rank and out.metrics_by_rank
            ex._finish_step(h, out)
            out2 = procs.collect(procs.submit(9, [], want_state=True),
                                 timeout=30.0)
            assert out2.state is not None and out2.state.shape == (4, 8)
            stale = procs.submit(10, [])
            procs.reset()
            assert procs.respawns == 1
            with pytest.raises(ShardAborted):
                procs.collect(stale, timeout=5.0)
            assert ex.collect(ex.submit([])).shape == (4,)
        finally:
            ex.close()
        steps = {s.span_id for s in tr.spans_snapshot()
                 if s.name == "shard.step"}
        comp = [s for s in tr.spans_snapshot() if s.name == "shard.compute"]
        assert comp and all(c.parent_id in steps for c in comp)
    assert procs.outstanding() == 0
    assert 'shard_steps_total{codec="int8",rank="1",replica="xp"}' in \
        reg.render()


def test_procset_streams_equal_thread_shards_and_reference():
    """The world-2 stream equivalence over real workers (warmed up, fp32
    ring on loopback): == the thread shards' == the reference's
    LocalExecutor's on the same seed-0 weights."""
    params = _real_params(S=1, d=16, h=32, E=1)
    procs = ShardProcessSet(world=2, slots=4, params=params, jit=True,
                            **CPU)
    port = _drive(FabricExecutor(procs, mode="pipelined",
                                 step_timeout_s=120.0), 6, 16, 4)
    threads = _drive(FabricExecutor(SyntheticShardSet(
        world=2, slots=4, params=params, **CPU)), 6, 16, 4)
    ref = _drive(RefLocal(slots=4, mode="pipelined", seed=0, S=1, d=16,
                          h=32, E=1), 6, 16, 4, port=False)
    assert all(e is None for e, _ in port)
    assert port == threads == ref
    assert procs.outstanding() == 0
