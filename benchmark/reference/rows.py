"""Plain float32 reference of the row model.

A request's prompt string becomes its ``[d]`` state (``encode.py``); each
step passes the state through ``S`` stages, and the step's token is the
index of the state's largest element. A stage: ``y = tanh(relu(x @ w1) @
w2)``; a router ``softmax(y @ router)`` picks one expert of ``E`` (the
first of equal gates); the output is ``y`` plus the gate times that
expert's ``relu(y @ moe_w1[e]) @ moe_w2[e]``. The experts' capacity
drops nothing at the configuration's capacity factor, so each request's
state evolves on its own; an all-zero state stays zero.

The state is carried from step to step through every stage, so a
disturbance the size of float32's rounding is carried too, and along some
requests it grows, until a routing or a token turns on it; and once the
router's two best gates lie closer than rounding can separate, float32
does not fix which expert a state takes. From there the program's
trajectory and the reference's may part, both being right to float32. So
a request's tokens are compared only while, in the reference's own
trajectories, (a) every routing so far has had a margin of at least
``MIN_GATE_MARGIN`` between its best two gates, and (b) a twin trajectory,
started from the prompt's state nudged by a relative ``TWIN_NUDGE`` (a
hundred times float32's rounding), stays within ``TWIN_DRIFT`` of the
state's standard deviation in every element: a disturbance of the
program's rounding has then grown too little to turn anything.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .encode import encode_prompt
from .paged import gaps, matmul_precision

#: Routing margin (gate units) below which a step is no longer compared:
#: some hundred times float32's rounding of a gate near 1/E.
MIN_GATE_MARGIN = 1e-5
#: The twin's nudge (relative, each element of the prompt's state, from a
#: fixed seed), and the drift (over the state's standard deviation) past
#: which the two trajectories no longer fix the program's.
TWIN_NUDGE = 1e-5
TWIN_DRIFT = 1e-3
TWIN_SEED = 20240611


def stage(W: Dict[str, torch.Tensor], s: int, x: torch.Tensor):
    """(next state, the routing margin of each row) of stage ``s``."""
    y = torch.tanh(torch.relu(x @ W["w1"][s]) @ W["w2"][s])
    gate = torch.softmax(y @ W["router"][s], dim=-1)
    top = torch.topk(gate, 2, dim=-1).values
    e = gate.argmax(dim=-1)
    out = torch.zeros_like(y)
    for j in range(gate.shape[1]):
        rows = (e == j).nonzero()[:, 0]
        if rows.numel():
            h = torch.relu(y[rows] @ W["moe_w1"][s, j])
            out[rows] = (h @ W["moe_w2"][s, j]) * gate[rows, j, None]
    return y + out, top[:, 0] - top[:, 1]


def trajectory(W, prompts: List[str], n_steps: int, tf32: bool = False,
               nudge: float = 0.0, stop: bool = True):
    """(states [k, R, d], margins [k, R]): the state after each of the
    first k <= n_steps steps and the smallest routing margin of the step's
    stages; with ``stop`` it stops early once no row keeps
    ``MIN_GATE_MARGIN``. ``nudge`` scales each element of the prompts'
    states by ``1 + nudge * z``, z normal from ``TWIN_SEED``."""
    d = W["w1"].shape[1]
    dev = W["w1"].device
    x = torch.as_tensor(np.stack([encode_prompt(p, d) for p in prompts]),
                        device=dev)
    if nudge:
        g = torch.Generator(device=dev).manual_seed(TWIN_SEED)
        x = x * (1.0 + nudge * torch.randn(x.shape, generator=g,
                                           device=dev))
    states, margins = [], []
    alive = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    with matmul_precision(tf32):
        for _ in range(n_steps):
            m = None
            for s in range(W["w1"].shape[0]):
                x, ms = stage(W, s, x)
                m = ms if m is None else torch.minimum(m, ms)
            states.append(x)
            margins.append(m)
            alive &= m >= MIN_GATE_MARGIN
            if stop and not bool(alive.any()):
                break
    return torch.stack(states), torch.stack(margins)


def judge(W, prompts: List[str], served: List[List[int]],
          control: bool = False) -> dict:
    """The widest gap of the served tokens under the float32 reference
    over the compared steps; with ``control``, that of the tokens the
    TF32 reference puts first at those steps."""
    n = max(len(t) for t in served)
    states, margins = trajectory(W, prompts, n)
    twin = trajectory(W, prompts, states.shape[0], nudge=TWIN_NUDGE,
                      stop=False)[0]
    drift = ((twin - states).abs().amax(dim=2)
             / states.std(dim=2).clamp_min(1e-30))
    del twin
    # A step is compared while every routing up to it kept its margin and
    # the twin kept close.
    ok = torch.cummin(((margins >= MIN_GATE_MARGIN)
                       & (drift < TWIN_DRIFT)).int(), dim=0).values
    low = (trajectory(W, prompts, states.shape[0], tf32=True)[0]
           if control else None)
    worst, worst_c, compared = 0.0, 0.0, 0
    for r, toks in enumerate(served):
        k = min(len(toks), int(ok[:, r].sum()))
        if low is not None:
            k = min(k, low.shape[0])
        if k == 0:
            continue
        ref = states[:k, r]
        worst = max(worst, float(gaps(ref, torch.as_tensor(
            toks[:k], device=ref.device)).max()))
        if low is not None:
            worst_c = max(worst_c, float(gaps(
                ref, low[:k, r].argmax(dim=1)).max()))
        compared += k
    out = {"served": worst, "tokens": compared}
    if control:
        out["control"] = worst_c
    return out
