"""Kernels, codecs and microbenchmarks of the port, and the slice
topology (``topology``: ``Chip``, ``SliceTopology``, ``ring_order``;
exported here) with the mesh builders over it (``mesh``): the fused
paged-attention step (``paged_attn``), the block-axis int8 codec and
the fabric's wire codecs (``quantize``), the fabric ring transport the
sharded serving plane reduces over (``fabric_collectives``: numpy over
TCP, no card), the health burn (``fabric_probe``, ``burn``) and the
fabric probe's training step over a (dp, sp, tp) mesh
(``fabric_probe.make_probe_train_step``, ``run_probe``, on the mesh of
``mesh.build_mesh``; both exported here, ``run_probe`` imported at its
first call), the tensor-core/HBM microbench (``mxu_bench``, run by ``bench_gpu``), whose
kernels share the bf16 tile product of ``tile_mma``, and the
sequence-parallel ring attention (``ring_attention``), whose kernel runs
on the ring-stream protocol (``ring_probe``, ``csrc/ring_stream.cuh``),
the fabric probe's collectives (``ring_probe``: ring all-gather, ring
reduce-scatter, all-to-all), Ulysses attention (``ulysses_attention``),
whose four exchanges are the all-to-all, differentiated as the same
all-to-all (``ring_probe.kernel_exchange``), and the tensor-parallel
collective matmuls (``collective_matmul``: ``make_allgather_matmul``,
``make_matmul_reduce_scatter``), whose kernels run the tile product of
``csrc/tile_product.cuh`` inside the ring protocols, and the five-axis
model: the GPipe schedule (``pipeline``), the 1F1B and interleaved-1F1B
schedules (``pipeline_1f1b``), the stage and the training steps over
ranks of every axis stacked on one card (``train_step``: the forward the
row plane serves, ``make_train_step``, ``make_train_step_1f1b``,
``dense_loss_reference``; the stage's causal ring attention is
``ring_attention.ring_attention_batched``) and its Switch MoE (``moe``),
whose two expert exchanges a stage are the all-to-all, differentiated as
the same all-to-all."""


from .mesh import build_mesh
from .topology import Chip, SliceTopology


def run_probe(*args, **kwargs):
    from .fabric_probe import run_probe as f

    return f(*args, **kwargs)


__all__ = ["Chip", "SliceTopology", "build_mesh", "run_probe"]
