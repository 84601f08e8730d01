"""The port's 1F1B schedules (``parallel/pipeline_1f1b.py``) against the
JAX package's.

The scheduler is a copy: its instruction tables, high-water marks, bubble
and in-flight peaks must equal the reference's exactly. The executor is
the port's own: the same seeded numpy stage weights and microbatches go
through the reference's ``make_1f1b`` (jitted, on the virtual CPU mesh)
and the port's, whose devices are stacked on the CPU, at the shapes of
``tests/test_pipeline_moe.py``.

Bars (the reference test's own, of its schedule against ``jax.grad`` of
the sequential loss): loss ``rtol=1e-5``; gradients ``rtol=2e-4,
atol=1e-6``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from dpu_operator_tpu.parallel import pipeline as ref_pl
from dpu_operator_tpu.parallel import pipeline_1f1b as ref
from dpu_operator_tpu.parallel import train_step as ref_ts
from dpu_operator_tpu_torch.parallel import pipeline as pl
from dpu_operator_tpu_torch.parallel import pipeline_1f1b as pf
from dpu_operator_tpu_torch.parallel import train_step as ts

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
CPU = dict(device="cpu")
TABLES = ("op", "s", "m", "fin_k", "stash_k", "bin_k", "frecv_valid",
          "frecv_s", "frecv_k", "brecv_valid", "brecv_s", "brecv_k",
          "max_inflight")
SCHEDULES = [(1, 3, 1), (2, 5, 3), (3, 7, 2), (4, 6, 1), (4, 8, 2),
             (4, 16, 4)]
RUNS = [(4, 6, 1), (4, 8, 2), (2, 5, 3)]  # tests/test_pipeline_moe.py:287


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _case(n, M, v, d=12, rows=6, seed=11):
    """Per-stage numpy weights (natural order), x and target [M, rows,
    d]."""
    rng = np.random.RandomState(seed)
    per_stage = [{"w": (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
                  "b": (0.1 * rng.randn(d)).astype(np.float32)}
                 for _ in range(n * v)]
    x = rng.randn(M, rows, d).astype(np.float32)
    tgt = rng.randn(M, rows, d).astype(np.float32)
    return per_stage, x, tgt


@functools.lru_cache(maxsize=None)
def _reference(n, M, v):
    """The reference's jitted make_1f1b on the case: loss and gradients,
    uninterleaved to the natural stage order, numpy."""
    per_stage, x, tgt = _case(n, M, v)
    mesh = _mesh(n)
    stacked = ref_pl.shard_stage_params(
        ref.interleave_stack(per_stage, n, v), mesh)
    step = jax.jit(ref.make_1f1b(mesh, ref_pl.mlp_stage, v=v, M=M))
    loss, grads = step(stacked, x, tgt)
    return float(loss), ref.uninterleave(jax.tree.map(np.asarray, grads),
                                         n, v)


def _torch(per_stage):
    return [{k: torch.from_numpy(a) for k, a in p.items()}
            for p in per_stage]


# -- the scheduler: a copy ---------------------------------------------------------


@pytest.mark.parametrize("n,M,v", SCHEDULES)
def test_schedule_tables_are_the_reference(n, M, v):
    got, want = pf.build_schedule(n, M, v), ref.build_schedule(n, M, v)
    for name in ("n", "v", "M", "T", "Kf", "Kb", "Ks", "bubble", "stages"):
        assert getattr(got, name) == getattr(want, name), name
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    # Every unit runs once: 2·S·M non-idle (device, tick) pairs.
    assert int((got.op != pf.IDLE).sum()) == 2 * n * v * M
    assert got.max_inflight.tolist() == [
        min((v - 1) * n + (n - d), v * M) for d in range(n)]


def test_1f1b_memory_is_bounded_by_depth_not_microbatches():
    """Peak in-flight microbatches a device is the warmup depth W_d =
    (v-1)n + (n-d), whatever M (tests/test_pipeline_moe.py:313)."""
    for M in (8, 32, 128):
        s = pf.build_schedule(4, M, v=1)
        assert s.max_inflight.tolist() == [4, 3, 2, 1], M
        assert s.Ks <= 4, (M, s.Ks)


def test_1f1b_bubble_matches_gpipe_and_interleaved_beats_it():
    """v = 1 has GPipe's bubble exactly; v = 2 beats it on the same n, M;
    v = 4 beats v = 1 at M = 16 (tests/test_pipeline_moe.py:327)."""
    s1 = pf.build_schedule(4, 8, v=1)
    assert np.isclose(s1.bubble, pf.gpipe_bubble(4, 8))
    assert pf.build_schedule(4, 8, v=2).bubble < s1.bubble
    assert (pf.build_schedule(4, 16, v=4).bubble
            < pf.build_schedule(4, 16, v=1).bubble)


@pytest.mark.parametrize("n,v", [(1, 1), (2, 3), (4, 2), (3, 1)])
def test_interleave_helpers_are_the_reference(n, v):
    per_stage, _, _ = _case(n, 1, v, d=3)
    np.testing.assert_array_equal(pf.interleave_order(n, v),
                                  ref.interleave_order(n, v))
    want = jax.tree.map(np.asarray, ref.interleave_stack(per_stage, n, v))
    got = pf.interleave_stack(_torch(per_stage), n, v)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    back = pf.uninterleave(got, n, v)
    for k in want:
        assert torch.equal(back[k], torch.stack(
            [torch.from_numpy(p[k]) for p in per_stage]))
    np.testing.assert_array_equal(
        pf.uninterleave(want, n, v)["w"],
        np.asarray(ref.uninterleave(want, n, v)["w"]))
    stacked = {k: np.stack([p[k] for p in per_stage]) for k in want}
    inter = ts.interleave_params(
        {k: torch.from_numpy(a) for k, a in stacked.items()}, n, v)
    ref_inter = ref_ts.interleave_params(stacked, n, v)
    for k in want:
        np.testing.assert_array_equal(inter[k].numpy(),
                                      np.asarray(ref_inter[k]))
        np.testing.assert_array_equal(
            ts.uninterleave_params(inter, n, v)[k].numpy(), stacked[k])
    with pytest.raises(ValueError, match=f"need {n * v} stages"):
        pf.interleave_stack(_torch(per_stage)[1:], n, v)


# -- the executor against the reference's ----------------------------------------


@pytest.mark.parametrize("n,M,v", RUNS)
def test_1f1b_matches_reference_and_sequential_autograd(n, M, v):
    """Loss and every gradient == the reference's make_1f1b and autograd
    of the sequential loss (interleaved v > 1 included)."""
    per_stage, x, tgt = _case(n, M, v)
    want_loss, want_grads = _reference(n, M, v)
    step = pf.make_1f1b({"pp": n}, pl.mlp_stage, v=v, M=M, **CPU)
    assert step.schedule.stages == n * v
    stacked = pf.interleave_stack(_torch(per_stage), n, v)
    xt, tt = torch.from_numpy(x), torch.from_numpy(tgt)
    loss, grads = step(stacked, xt, tt)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    got = pf.uninterleave(grads, n, v)
    for k in want_grads:
        np.testing.assert_allclose(got[k].numpy(), want_grads[k],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)

    leaves = [{k: t.clone().requires_grad_() for k, t in p.items()}
              for p in _torch(per_stage)]
    seq = pf.sequential_loss(leaves, xt, tt, pl.mlp_stage)
    seq_grads = torch.autograd.grad(seq, [t for p in leaves
                                          for t in p.values()])
    np.testing.assert_allclose(float(loss), float(seq.detach()),
                               rtol=LOSS_RTOL)
    flat = [got[k][i] for i in range(n * v) for k in leaves[0]]
    for a, b in zip(flat, seq_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("n,M,v", [(1, 3, 1), (3, 7, 2), (4, 6, 1)])
def test_run_schedule_runs_each_unit_once_and_skips_the_bubble(n, M, v):
    """The stage runs S·M times without a graph (F) and S·M times with one
    (B, rematerialized): idle pairs run nothing. ``make_1f1b`` is this
    run, bit for bit."""
    per_stage, x, tgt = _case(n, M, v, d=4, rows=2)
    calls = {True: 0, False: 0}

    def stage(p, h):
        calls[torch.is_grad_enabled()] += 1
        return pl.mlp_stage(p, h)

    sched = pf.build_schedule(n, M, v)
    stacked = pf.interleave_stack(_torch(per_stage), n, v)
    grads, loss = pf.run_schedule(sched, stage, stacked,
                                  torch.from_numpy(x), torch.from_numpy(tgt),
                                  norm=float(x.size))
    assert calls == {False: n * v * M, True: n * v * M}
    step = pf.make_1f1b({"pp": n}, pl.mlp_stage, v=v, M=M, **CPU)
    loss2, grads2 = step(stacked, torch.from_numpy(x), torch.from_numpy(tgt))
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_1f1b_masked_grads_survive_division_bearing_stage():
    """An rmsnorm-style stage (0/0 = NaN on an all-zero input): the
    reference masks its idle ticks' compute on zero ghosts by selection
    (tests/test_pipeline_moe.py:364); the port runs no idle unit. Loss
    and gradients finite and == autograd of the sequential loss."""
    def rms_stage(p, x):
        h = x @ p["w"]
        return h / torch.sqrt(torch.mean(h ** 2))

    n, M, v, d, rows = 2, 3, 1, 8, 4
    rng = np.random.RandomState(5)
    per_stage = [{"w": torch.from_numpy(
        (rng.randn(d, d) / np.sqrt(d)).astype(np.float32))}
        for _ in range(n * v)]
    x = torch.from_numpy(rng.randn(M, rows, d).astype(np.float32))
    tgt = torch.from_numpy(rng.randn(M, rows, d).astype(np.float32))
    assert torch.isnan(rms_stage(per_stage[0], torch.zeros(rows, d))).all()
    step = pf.make_1f1b({"pp": n}, rms_stage, v=v, M=M, **CPU)
    loss, grads = step(pf.interleave_stack(per_stage, n, v), x, tgt)
    assert torch.isfinite(loss) and torch.isfinite(grads["w"]).all()
    leaves = [{"w": p["w"].clone().requires_grad_()} for p in per_stage]
    seq = pf.sequential_loss(leaves, x, tgt, rms_stage)
    want = torch.autograd.grad(seq, [p["w"] for p in leaves])
    np.testing.assert_allclose(float(loss), float(seq.detach()),
                               rtol=LOSS_RTOL)
    for i, g in enumerate(want):
        np.testing.assert_allclose(grads["w"][i].numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_1f1b_rejects_wrong_chunk_count_and_microbatches():
    """4 stages stacked on a 2-way axis with v = 1 raise naming v=1
    (tests/test_pipeline_moe.py:346); so does an M unlike the schedule's,
    a missing M, a tensor off the step's device."""
    stacked = pl.stack_stage_params(pl.demo_stage_params(4, 8, **CPU))
    x = torch.randn(2, 4, 8)
    step = pf.make_1f1b({"pp": 2}, pl.mlp_stage, v=1, M=2, **CPU)
    with pytest.raises(ValueError, match="v=1"):
        step(stacked, x, x)
    step2 = pf.make_1f1b({"pp": 2}, pl.mlp_stage, v=2, M=3, **CPU)
    with pytest.raises(ValueError, match="built for M=3"):
        step2(stacked, x, x)
    with pytest.raises(ValueError, match="M .microbatch count. is static"):
        pf.make_1f1b({"pp": 2}, pl.mlp_stage)
    with pytest.raises(ValueError, match="axis 'pp' is not in the mesh"):
        pf.make_1f1b({"dp": 2}, pl.mlp_stage, M=2, **CPU)
    with pytest.raises(ValueError, match="need n,M,v >= 1"):
        pf.make_1f1b({"pp": 2}, pl.mlp_stage, M=0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pf.make_1f1b({"pp": 2}, pl.mlp_stage, M=2)
