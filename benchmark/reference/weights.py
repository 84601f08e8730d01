"""The models' weights, drawn again from the seed.

``paged_params`` is a frozen copy of the draw the paged model makes for
itself (float32 normal draws of a ``numpy.random.RandomState``, each
divided by ``sqrt(rows)`` in float64 and rounded to float32, in the order
of ``PAGED_NAMES``). ``rows_params`` is the benchmark's own draw of the
row model's weights, on the card, which the benchmark hands to the program
and draws again for the reference.

The row draw scales each weight by ``ROWS_GAIN / sqrt(fan_in)``: the two
products that read a ReLU's output (``w2``, ``moe_w2``) take the gain
``sqrt(2)`` (He's), so that a stage keeps its state's size and a request's
state neither dies away over the steps (at gain 1 it shrank several-fold a
step, and every routing fell to expert 0 once it was
zero) nor, at a larger gain, grows chaotic, where float32's rounding
alone would part the program from the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np

PAGED_NAMES = ("embed", "wpos", "wq", "wk", "wv", "wo", "w1", "w2", "wout")
ROWS_NAMES = ("w1", "w2", "router", "moe_w1", "moe_w2")
ROWS_GAIN = dict(w1=1.0, w2=math.sqrt(2.0), router=1.0, moe_w1=1.0,
                 moe_w2=math.sqrt(2.0))


def paged_shapes(vocab: int, d: int, max_context: int, hidden: int
                 ) -> Dict[str, Tuple[int, ...]]:
    return dict(embed=(vocab, d), wpos=(max_context, d), wq=(d, d),
                wk=(d, d), wv=(d, d), wo=(d, d), w1=(d, hidden),
                w2=(hidden, d), wout=(d, vocab))


def paged_draws(seed: int, vocab: int, d: int, max_context: int,
                hidden: int) -> Iterator[Tuple[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    for name, shape in paged_shapes(vocab, d, max_context, hidden).items():
        x = rng.randn(*shape).astype(np.float32).astype(np.float64)
        yield name, (x / np.sqrt(float(shape[0]))).astype(np.float32)


def paged_params(seed: int, vocab: int, d: int, max_context: int,
                 hidden: int) -> Dict[str, np.ndarray]:
    return dict(paged_draws(seed, vocab, d, max_context, hidden))


def rows_shapes(S: int, d: int, h: int, E: int
                ) -> Dict[str, Tuple[int, ...]]:
    return dict(w1=(S, d, h), w2=(S, h, d), router=(S, d, E),
                moe_w1=(S, E, d, h), moe_w2=(S, E, h, d))


def rows_params(seed: int, S: int, d: int, h: int, E: int, device):
    """Stage-stacked row-model weights: normal draws of one
    ``torch.Generator`` on ``device`` seeded with ``seed``, each times
    ``ROWS_GAIN`` over the square root of its fan-in, in ``ROWS_NAMES``
    order."""
    import torch
    g = torch.Generator(device=device).manual_seed(int(seed))
    fan_in = dict(w1=d, w2=h, router=d, moe_w1=d, moe_w2=h)
    out = {}
    for name, shape in rows_shapes(S, d, h, E).items():
        t = torch.randn(shape, generator=g, device=device)
        out[name] = t.mul_(ROWS_GAIN[name] / math.sqrt(fan_in[name]))
    return out

