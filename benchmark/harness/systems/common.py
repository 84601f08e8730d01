"""What the system modules share."""

from __future__ import annotations

import sys


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def empty_cache(device) -> None:
    import torch
    if getattr(device, "type", str(device)).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def at_most(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit,
            "ok": value <= limit, "kind": "at_most"}


def at_least(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit,
            "ok": value >= limit, "kind": "at_least"}


def compare(gap: float, tokens: int, limits: dict) -> list:
    """The numbers ``correct`` is decided by, each beside its limit: the
    widest gap of the tokens judged and how many were judged."""
    return [at_most("served_gap", gap, limits["served_gap"]),
            at_least("tokens_compared", tokens, limits["min_tokens"])]


def control_readings(gap: float, tokens: int, limits: dict) -> dict:
    """The control's tokens in the program's place, at the same positions,
    through the same comparison: ``control_correct`` has to come out
    false."""
    return {"control_gap": gap, "control_correct": all(
        c["ok"] for c in compare(gap, tokens, limits))}
