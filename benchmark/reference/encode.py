"""Frozen copy of the row plane's prompt encoder: a prompt string to its
``[d]`` float32 state (sha256 of the text seeds a ``RandomState``)."""

from __future__ import annotations

import hashlib

import numpy as np


def encode_prompt(text: str, d: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
    return np.random.RandomState(seed).randn(d).astype(np.float32)
