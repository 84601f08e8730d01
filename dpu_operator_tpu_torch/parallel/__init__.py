"""Kernels, codecs and microbenchmarks of the port: the fused
paged-attention step (``paged_attn``), the block-axis int8 codec
(``quantize``), the health burn (``fabric_probe``, ``burn``), the
tensor-core/HBM microbench (``mxu_bench``, run by ``bench_gpu``), whose
kernels share the bf16 tile product of ``tile_mma``, and the
sequence-parallel ring attention (``ring_attention``), whose kernel runs
on the ring-stream protocol (``ring_probe``, ``csrc/ring_stream.cuh``),
the fabric probe's collectives (``ring_probe``: ring all-gather, ring
reduce-scatter, all-to-all), Ulysses attention (``ulysses_attention``),
whose four exchanges are the all-to-all, and the tensor-parallel
collective matmuls (``collective_matmul``: ``make_allgather_matmul``,
``make_matmul_reduce_scatter``), whose kernels run the tile product of
``csrc/tile_product.cuh`` inside the ring protocols, and the row-plane
model: the forward stage (``train_step``) and its Switch MoE (``moe``),
whose two expert exchanges a stage are the all-to-all."""
