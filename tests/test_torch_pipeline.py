"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's.

The same seeded numpy stage weights and microbatches go through the
reference's ``make_pipeline`` (jitted, on the virtual CPU mesh) and the
port's, whose stages are stacked on the CPU, at the shapes of
``tests/test_pipeline_moe.py``: S = 4 with M = 6, S = 2 with M = 1 (all
bubble but one tick) and M = 9 (M ≫ S), and pp inside a dp × pp × tp mesh.

Bars: against the reference and the sequential ground truth, the
reference test's ``rtol=atol=2e-5``; the port's pipeline against its own
sequential reference, bit for bit (the same products in another order of
launches; the bubble the port skips never reached an output).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from dpu_operator_tpu.parallel import pipeline as ref
from dpu_operator_tpu_torch.parallel import pipeline as pl

torch.set_num_threads(1)

TOL = 2e-5
CPU = dict(device="cpu")


def _stages(S, d, seed):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
             "b": (0.1 * rng.randn(d)).astype(np.float32)}
            for _ in range(S)]


def _mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return Mesh(np.array(jax.devices()[:n]).reshape(
        tuple(s for _, s in axes)), tuple(a for a, _ in axes))


def _torch_stages(per_stage):
    return [{k: torch.from_numpy(v) for k, v in p.items()}
            for p in per_stage]


def _check(axes, S, M, mb, d, seed):
    per_stage = _stages(S, d, seed)
    x = np.random.RandomState(seed + 1).randn(M, mb, d).astype(np.float32)
    mesh = _mesh(axes)
    want = np.asarray(jax.jit(ref.make_pipeline(mesh, ref.mlp_stage))(
        ref.shard_stage_params(ref.stack_stage_params(per_stage), mesh), x))
    ours = _torch_stages(per_stage)
    sizes = dict(axes)
    stacked = pl.shard_stage_params(pl.stack_stage_params(ours), sizes,
                                    **CPU)
    got = pl.make_pipeline(sizes, pl.mlp_stage, **CPU)(
        stacked, torch.from_numpy(x))
    seq = pl.sequential_reference(ours, torch.from_numpy(x), pl.mlp_stage)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(
        ref.sequential_reference(per_stage, x, ref.mlp_stage)),
        rtol=TOL, atol=TOL)
    assert torch.equal(got, seq)


def test_pipeline_matches_reference():
    """S = 4 stages, M = 6 microbatches: stage weights all differ, so a
    permuted or off-by-one schedule cannot pass."""
    _check([("pp", 4)], S=4, M=6, mb=8, d=16, seed=1)


@pytest.mark.parametrize("M", [1, 9])
def test_pipeline_single_microbatch_and_many(M):
    _check([("pp", 2)], S=2, M=M, mb=4, d=8, seed=M)


def test_pipeline_composes_with_dp_axis():
    """pp inside a larger mesh: the other axes do not disturb the
    schedule."""
    _check([("dp", 2), ("pp", 2), ("tp", 2)], S=2, M=4, mb=4, d=8, seed=3)


@pytest.mark.parametrize("S,M", [(1, 3), (2, 1), (3, 5), (4, 2)])
def test_gpipe_skips_the_bubble_and_keeps_tick_order(S, M):
    """run_gpipe runs each (stage, microbatch) once, S·M calls where the
    reference's scan runs S·(M + S - 1); stage s sees microbatch t - s at
    tick t, after stage s - 1 handed it on; outputs land in order."""
    seen = []

    def stage(s, x):
        seen.append((s, int(x[0])))
        return x + 10 ** s

    outs = pl.run_gpipe(stage, [torch.tensor([m]) for m in range(M)], S)
    assert len(seen) == S * M
    ticks = [(s + m, s, m) for s, m in
             ((s, m) for s in range(S) for m in range(M))]
    want = [(s, m + sum(10 ** j for j in range(s))) for _, s, m in
            sorted(ticks)]
    assert seen == want
    step = sum(10 ** j for j in range(S))
    assert [int(o[0]) for o in outs] == [m + step for m in range(M)]


def test_stage_count_mismatch_raises_the_reference_error():
    """Four stages stacked onto a 2-way pp axis: the reference's message,
    word for word."""
    per_stage = _stages(4, 8, seed=5)
    x = np.zeros((2, 4, 8), np.float32)
    mesh = _mesh([("pp", 2)])
    with pytest.raises(ValueError) as want:
        ref.make_pipeline(mesh, ref.mlp_stage)(
            ref.shard_stage_params(ref.stack_stage_params(per_stage), mesh),
            x)
    stacked = pl.stack_stage_params(_torch_stages(per_stage))
    with pytest.raises(ValueError) as got:
        pl.make_pipeline({"pp": 2}, pl.mlp_stage, **CPU)(
            stacked, torch.from_numpy(x))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="3 stages do not shard over pp=2"):
        pl.shard_stage_params(pl.stack_stage_params(
            _torch_stages(per_stage[:3])), {"pp": 2}, **CPU)


def test_pipeline_entry_points_pick_their_device():
    per_stage = pl.demo_stage_params(3, 8, seed=4, **CPU)
    again = pl.demo_stage_params(3, 8, seed=4, **CPU)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(per_stage, again)
               for k in a)
    assert not torch.equal(per_stage[0]["w"], per_stage[1]["w"])
    assert per_stage[0]["w"].shape == (8, 8) and not per_stage[0]["b"].any()
    with pytest.raises(ValueError, match="axis 'pp' is not in the mesh"):
        pl.make_pipeline({"dp": 2}, pl.mlp_stage, **CPU)
    stacked = pl.stack_stage_params(per_stage)
    fn = pl.make_pipeline({"pp": 3}, pl.mlp_stage, **CPU)
    with pytest.raises(ValueError, match="runs on cpu"):
        fn(stacked, torch.zeros((2, 4, 8), device="meta"))
    if not torch.cuda.is_available():
        for call in (lambda: pl.make_pipeline({"pp": 3}, pl.mlp_stage),
                     lambda: pl.demo_stage_params(2, 8),
                     lambda: pl.shard_stage_params(stacked, {"pp": 3})):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
