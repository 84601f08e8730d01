"""The models' own operations for a served request, whatever computes them.

Counted: every prompt token that had to be computed (those not served from
the prefix cache) and every generated token but the last, each through the
whole model, with attention at its position; the logits at each position
that yields a generated token. Not counted: padding rows, idle slots, or a
step's fixed window, which are the program's choice and not the model's
work. A multiply-add is 2 operations.
"""

from __future__ import annotations


def paged_request_flops(prompt_len: int, n_out: int, cached: int, *,
                        d: int, heads: int, vocab: int, mlp: int) -> float:
    """The paged model (one block: q/k/v/o projections, causal attention,
    a ReLU MLP of width ``mlp``, untied logits) for one request."""
    if n_out <= 0:
        return 0.0
    first = cached                        # first position computed
    last = prompt_len + n_out - 2         # last position fed forward
    n_pos = last - first + 1
    per_pos = 2 * 4 * d * d + 2 * 2 * d * mlp
    # q.k and p.v at position p: 2 * 2 * d * (p + 1).
    attn = 4 * d * (sum_range(first + 1, last + 1))
    logits = 2 * d * vocab * n_out
    return float(n_pos * per_pos + attn + logits)


def sum_range(a: int, b: int) -> int:
    """a + (a+1) + ... + b."""
    return (a + b) * (b - a + 1) // 2 if b >= a else 0


def rows_request_flops(n_out: int, *, d: int, ffn: int, experts: int,
                       layers: int, top_k: int = 1) -> float:
    """The row model: each generated token is one pass of the state through
    ``layers`` stages of a dense pair, the router and ``top_k`` expert
    FFNs."""
    per_layer = 2 * 2 * d * ffn + 2 * d * experts + top_k * 2 * 2 * d * ffn
    return float(n_out * layers * per_layer)
