"""Block-axis int8 codec for the resident paged-KV pools.

Torch counterpart of ``int8_block_encode_xp`` / ``int8_block_decode_xp``
in the JAX package's ``parallel/quantize.py``: symmetric per-BLOCK
quantization over a leading block axis, ``scales[b] = max|x[b]| / 127``
(1.0 for an all-zero block, so decode stays exact zero and never 0/0).
A pool block quantized by either package decodes bit-identically in the
other: the divide is IEEE, the rounding is half-to-even
(``torch.round``, like ``jnp.round``), and the clip is to +/-127.

``int8_block_decode_np`` is the numpy decode the executor's host views
(``PagedDecodeStep.dequantized_pools``) use.
"""

from __future__ import annotations

import numpy as np
import torch


def int8_block_encode(x: torch.Tensor):
    """``x [N, ...]`` f32 -> ``(q int8 [N, ...], scales f32 [N])``."""
    flat = x.reshape(x.shape[0], -1)
    amax = flat.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / 127.0,
                         torch.ones_like(amax)).to(torch.float32)
    tail = (-1,) + (1,) * (x.dim() - 1)
    q = torch.round(x / scales.reshape(tail)).clamp(-127, 127)
    return q.to(torch.int8), scales


def int8_block_decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Decode the block-axis codec: ``scales``' shape is a leading
    prefix of ``q``'s (``[N]`` against ``[N, ...]``, or the gathered
    ``[S, B]`` against ``[S, B, bs, H, dh]``)."""
    tail = tuple(scales.shape) + (1,) * (q.dim() - scales.dim())
    return q.to(torch.float32) * scales.reshape(tail)


def int8_block_decode_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Host-side numpy decode, same layout rule as ``int8_block_decode``."""
    tail = scales.shape + (1,) * (q.ndim - scales.ndim)
    return q.astype(np.float32) * np.reshape(scales, tail)
