"""dpu_operator_tpu_torch — the PyTorch/CUDA port of the JAX package.

A second package beside ``dpu_operator_tpu``, which stays the reference.
This package imports torch and numpy, never jax and never the reference
package: what it needs of the reference's jax-free modules it keeps as
its own copies, whose code stays the reference's statement for statement
(``tests/test_torch_isolation.py``). Module paths mirror the reference's
(``serving/kvcache/paged.py`` here ports ``serving/kvcache/paged.py``
there).

Ported so far:

  * the paged-KV serving path — ``POST /v1/generate``
    (``serving/server.py``) -> ``AdmissionQueue`` -> ``ContinuousBatcher``
    -> ``PagedKVExecutor`` -> ``PagedDecodeStep`` — with the fused paged
    attention as a hand-written CUDA kernel for Hopper
    (``csrc/paged_attn.cu``, wrapped in ``parallel/paged_attn.py``);
  * the chip-health burn (``parallel/burn.py``,
    ``parallel/fabric_probe.py``) and the tensor-core/HBM microbench
    (``parallel/mxu_bench.py``, run by ``parallel/bench_gpu.py``), whose
    kernels are one hand-written CUDA source (``csrc/tile_mma.cu``);
  * sequence-parallel ring attention (``parallel/ring_attention.py``:
    ``make_ring_attention``), all ranks of the ring on one card in one
    cooperative launch of ``csrc/ring_attn.cu``, whose ring protocol is
    the shared template ``csrc/ring_stream.cuh``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""

__version__ = "0.1.0"
