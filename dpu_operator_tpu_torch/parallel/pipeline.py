"""Pipeline parallelism: the ``pp`` mesh axis, as a GPipe schedule.

Counterpart of the JAX package's ``parallel/pipeline.py``. There each
device on the ``pp`` axis holds one stage's weights, activations hop
stage to stage with ``lax.ppermute`` along a line (not a ring), and the
schedule is one ``lax.scan`` of ``T = M + S - 1`` ticks: at tick t stage 0
injects microbatch t, every stage applies itself to what it received, and
stage S - 1 records tick t into output slot ``t - (S - 1)``.

Here the S stages are stacked on one device, as every multi-rank path of
the port runs its ranks: the stage-stacked weights keep their leading
stage dim, and a tick runs the stages one after another. The hop is a
shift along the stage index: what stage s - 1 produced at tick t - 1 is
stage s's input at tick t. The reference computes the bubble too (every
stage every tick, on zero ghosts that are never recorded, so the scan
keeps one shape); here those (stage, tick) pairs carry no microbatch and
are skipped, which leaves every recorded output as it was
(``tests/test_torch_pipeline.py`` holds the outputs against the
reference's). ``run_gpipe`` is the schedule; ``make_pipeline`` and the
training step (``train_step.make_train_step``) run it. The 1F1B and
interleaved-1F1B schedules, whose stash is bounded by the pipeline's depth
and not by M, are ``pipeline_1f1b.py``'s.

The mesh is a mapping of axis sizes; only ``axis`` shapes the schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import torch

from ..device import resolve_device


def stack_stage_params(per_stage_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """[{'w': ..., 'b': ...} per stage] -> one dict whose tensors carry a
    leading stage dim."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


def run_gpipe(stage: Callable[[int, torch.Tensor], torch.Tensor],
              x_mb: Sequence[torch.Tensor], S: int) -> List[torch.Tensor]:
    """GPipe over S stages stacked on one device: ``outs[m] = stage(S - 1,
    ... stage(0, x_mb[m]))``, computed tick by tick (tick t runs stage s on
    microbatch t - s). ``stage(s, x)`` applies stage s. Bubble pairs are
    skipped: ``stage`` runs exactly S·M times."""
    M = len(x_mb)
    held: List = [None] * S   # held[s]: what stage s received this tick
    outs: List = [None] * M
    for t in range(M + S - 1):
        sent: List = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue  # the bubble: no microbatch here
            y = stage(s, x_mb[m] if s == 0 else held[s])
            if s == S - 1:
                outs[m] = y
            else:
                sent[s + 1] = y  # the ppermute along the line
        held = sent
    return outs


def _check_stages(params_stacked: Mapping[str, torch.Tensor], S: int,
                  axis: str) -> None:
    """The reference's per-device check: each rank holds exactly one
    stage (its local leading dims are the stacked ones over S)."""
    leading = {n // S if n % S == 0 else n / S
               for n in (a.shape[0] for a in params_stacked.values())}
    if leading != {1}:
        raise ValueError(
            f"stage count must equal mesh.shape[{axis!r}]={S}: each "
            f"device must hold exactly one stage, got local leading "
            f"dims {sorted(leading)} (did you stack "
            f"{S * max(leading)} stages onto a {S}-way axis?)")


def make_pipeline(mesh: Mapping[str, int], stage_fn: Callable,
                  axis: str = "pp", *, device=None):
    """Returns pipelined(params_stacked, microbatches) on ``device``:
    ``params_stacked`` tensors carry a leading stage dim of
    ``mesh[axis]``, ``microbatches`` is [M, mb, d]. Result == applying
    the S stages in order to every microbatch: out[m] = fS(...f1(x[m])).
    ``device`` None means the CUDA card, and raises without one."""
    if axis not in mesh:
        raise ValueError(f"axis {axis!r} is not in the mesh {dict(mesh)}")
    S = int(mesh[axis])
    device = resolve_device(device, "make_pipeline")

    def pipelined(params_stacked, x_mb):
        for name, t in [("microbatches", x_mb), *params_stacked.items()]:
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this pipeline "
                                 f"runs on {device}")
        _check_stages(params_stacked, S, axis)

        def stage(s, x):
            return stage_fn({k: v[s] for k, v in params_stacked.items()}, x)

        return torch.stack(run_gpipe(stage, list(x_mb), S))

    return pipelined


def sequential_reference(per_stage_params, x_mb, stage_fn):
    """The ground truth the pipeline must match: stages applied in order
    to every microbatch, no parallelism."""
    ys = []
    for m in range(x_mb.shape[0]):
        h = x_mb[m]
        for params in per_stage_params:
            h = stage_fn(params, h)
        ys.append(h)
    return torch.stack(ys)


def shard_stage_params(params_stacked: Mapping[str, torch.Tensor],
                       mesh: Mapping[str, int], axis: str = "pp",
                       device=None) -> Dict[str, torch.Tensor]:
    """The stage-stacked tensors placed on ``device`` (None means the CUDA
    card), their leading dim split over the ``axis`` ranks stacked there;
    it must cut into ``mesh[axis]`` equal parts, as the reference's
    placement wants."""
    S = int(mesh[axis])
    device = resolve_device(device, "shard_stage_params")
    for name, t in params_stacked.items():
        if t.shape[0] % S:
            raise ValueError(f"{name}: {t.shape[0]} stages do not shard "
                             f"over {axis}={S}")
    return {k: v.to(device) for k, v in params_stacked.items()}


def mlp_stage(params, x):
    """The default stage body of the tests: one matmul + nonlinearity,
    enough for the numerics to catch ordering or permutation bugs (stage
    weights differ, so stage order matters)."""
    return torch.tanh(x @ params["w"] + params["b"])


def demo_stage_params(S: int, d: int, seed: int = 0, device=None):
    """S stages of {"w": [d, d], "b": [d]} drawn from a seeded
    ``torch.Generator`` on ``device`` (None means the CUDA card). The
    reference's ``jax.random`` draws are not reproduced: hold the two
    packages against each other on weights carried across."""
    device = resolve_device(device, "demo_stage_params")
    g = torch.Generator(device=device).manual_seed(seed)
    return [{"w": torch.randn((d, d), generator=g, device=device)
             / math.sqrt(d),
             "b": torch.zeros((d,), device=device)}
            for _ in range(S)]
