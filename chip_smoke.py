#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (Hopper).

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. device  — a CUDA card is present; print its name and power limit.
  2. build   — compile the port's kernel from ``csrc/`` (nvcc, sm_90a).
  3. kernel  — the paged-attention kernel (the context split across
               CTAs, 32 block-table entries a CTA) built with no spills
               in any instance (ptxas); against its plain PyTorch version
               and the split's arithmetic written out in PyTorch
               (``paged_attn_split_plain`` at the kernel's chunk size) at
               the shapes the serving path gives it, int8 and fp32 pools,
               once more with a prefill chunk straddling the first chunk
               boundary and one from the table's last position (rows
               past the table clip to its last block): pools bitwise
               equal, outputs within the stated tolerance, a poisoned
               pool gives the clean output, 20 repeats bitwise equal;
               median times of the kernel and the plain version (CUDA
               events).
  4. serve   — the port's serving path end to end at full width
               (``ServingServer`` -> ``PagedKVExecutor`` ->
               ``PagedDecodeStep`` -> the CUDA kernel): 8 HTTP requests,
               32 tokens each, in pipelined and sync mode and with the
               plain attention; token streams must be identical. Before
               it, a small configuration on the card must decode the same
               streams as the CPU path the tests hold against the JAX
               package, in sync mode and in three speculative lanes
               (``speculative``, ``speculative-pipelined``, and that with
               tree width 3), int8 and fp32 pools; with fp32 pools the
               speculative streams equal the sync streams.
  5. profile — one more served run under ``torch.profiler``: device time
               by kernel and the device's idle share.
  6. tiles   — the bf16 tile-product kernels of the health burn and the
               benchmark matmul against their plain versions, at the
               shapes their path gives them: the burn chain at 1024^2,
               the burn tile at 2048^2 and 1024 x 2048, the matmul at
               4096^3 on its full-K and K-blocked routes; max error
               against the stated tolerance, median times of the kernel,
               the plain version and (matmul) ``torch.matmul``, bound.
               The chain (TMA-fed wgmma in one cooperative launch) at
               n 128, 640 and 1152 and 1, 2, 3 and 8 steps against
               plain, 20 repeats at 1024^2 bitwise equal, a launch's
               device time and the host's time to queue a call, whole
               and by part of the wrapper. The chain kernel and the tile
               kernel (TMA-fed wgmma) built with no spills (ptxas); the
               tile kernel at both of its widths (128 x 256 and 128 x
               128) a product off the K step and off the wide tile within
               1 ulp of plain, and both widths timed at 4096^3 and
               2048^2; repeats bitwise equal; a launch's device time and
               the host's time to queue a call.
  7. health  — the health/bench path: ``best_burn_step()`` on the health
               burn's own inputs (one chain launch, finite signature), the
               2048^2 burn (eight tile launches), the block-config sweep
               of ``mxu_bench``, and one ``bench_gpu`` run in a process
               of its own, whose JSON is logged, and its chain's TFLOP/s
               beside those of the 8 (matmul + tanh) composition.
  8. ring    — ring attention: the kernel's eight instances built
               with no spills (ptxas); small rings (n 1-8; shards off
               the 128-row tile; heads up to 256 wide and off the mma's
               8; mixed bf16/f32 inputs) against the plain version; f32
               with q scaled, where the TF32 split holds the f32 bar and
               one TF32 pass (emulated) must miss it; the long-context
               path (``make_ring_attention``, 8 ranks on the one card)
               at S = 32768, d 128, f32 and bf16, causal and not, and at
               the reference's proof shape S = 1024 bf16, each against
               the plain version; 20 repeats bitwise equal; times of the
               kernel, the plain version and one
               ``scaled_dot_product_attention`` call (a yardstick only,
               its kernels named from ``torch.profiler``) beside two
               bounds, the split's passes at the TF32 peak (the
               record's) and the flops at the f32 FMA peak.
  9. collectives — the ring collectives of the fabric probe: the one-way
               and the bidirectional ring all-gather and the ring
               reduce-scatter. Small rings (n 1, 2, 3, 4, 8; f32, bf16,
               f16 and int32 payloads; an odd shard, which must run the
               one-way ring; blocks that are no multiple of 16 bytes):
               every rank's gathered copy equals the input bit for bit,
               the reduce-scatter equals its plain version bit for bit
               and a float64 sum within the stated bar. Then the path at
               full width on 8 ranks sharing the card:
               ``measure_ring_bandwidth`` at the reference's 16 MiB
               payload and at 256 MiB, one way and both ways,
               ``make_ring_reduce_scatter`` on 16 MiB per rank and the
               all-reduce composition against the plain one; 20 repeats
               of each kernel bitwise equal; times of the kernel, the
               plain version and one PyTorch call (a yardstick only), the
               bytes each protocol moves and their rate, and the time of
               the all-reduce.
 10. ulysses — the all-to-all and Ulysses attention. Small all-to-alls
               (n 1, 2, 3, 4, 5, 8; f32, bf16, f16, int32; blocks of 1
               and 3 rows that are no multiple of 16 bytes) equal the
               plain version and the transpose bit for bit; n = 1
               launches nothing; an odd-byte block raises. Then the path
               at full width on 8 ranks sharing the card:
               ``make_all_to_all`` at the probe's 16 MiB payload and
               ``make_ulysses_attention`` at Llama-2-7B's attention widths
               (S = 16384, 32 heads of 128), f32 and bf16, causal and not:
               4 launches a call, the kernel route equal to the torch
               route bit for bit, within the stated bars of the dense
               reference and of ring attention on heads 0 and 31, repeats
               bitwise equal; times of the all-to-all (CUDA events, its
               launch's device time from the profiler and the host's time
               to queue a call, split into the wrapper's parts), its plain
               version and one PyTorch call, and of a Ulysses call with
               the exchanges' share of it. Then Ulysses' gradient at the
               same widths (f32, causal): one ``torch.autograd.grad`` of
               sum(out**2) with kernel 10 makes 4 launches forward and 4
               backward (the main path, counts at 0); its q, k and v
               gradients equal the torch route's bit for bit and the
               dense reference's (a head group at a time) within the
               ring bars, 3 repeats bitwise; forward + backward by
               events, peak memory, the idle share of one profiled call;
               one bf16 call's gradients within RING_ULPS of the f32
               route's on the same inputs and cotangent.
 11. tp-mlp  — the collective matmuls (all-gather matmul, matmul
               reduce-scatter). The bf16 kernels (TMA-fed wgmma) built
               with no spills (ptxas). Small rings (n 1, 2, 3, 4, 5, 8 at
               the reference tests' shapes, one shape off every tile edge,
               f32 and bf16; in bf16 also a contraction a rank that is no
               multiple of the K step and three or more products a CTA a
               ring step) against the plain versions; n = 1 of the
               reduce-scatter launches nothing; rows that are no whole
               16-byte units and ``overlap=False`` with the kernel raise.
               Then the tensor-parallel MLP pair of the served model
               (``make_allgather_matmul`` -> relu ->
               ``make_matmul_reduce_scatter``; x [4096, 4096], w1
               [4096, 8192], w2 [8192, 4096], 8 ranks sharing the card),
               f32 and bf16: 2 launches a pair call, each kernel against
               its plain version and the pair against the dense product
               within the stated bars, 20 repeats bitwise equal; times of
               each kernel (CUDA events, a launch's device time from the
               profiler, the host's time to queue a call), its plain
               version and ``torch.matmul``, and the pair's wall time.
 12. spec    — speculative decoding on the served path at full width
               (phase 4's model, prompts and 8 HTTP requests, spec_k 4, the
               truncated draft over the step's own weights). fp32 pools:
               the ``sync`` streams are the golden, and ``speculative``,
               ``speculative-pipelined`` and ``speculative-pipelined``
               with tree width 3 must each equal them token for token.
               int8 pools: ``speculative`` and ``speculative-pipelined``
               twice each, each pair identical (int8 speculative streams
               are not compared with sync ones: a verify window's rows,
               rejected ones included, set a block's scale). In chain
               runs the paged-attention kernel launches at least once a
               step; tree runs launch it never (their windows go through
               ``tree_step``, the PyTorch composition). Every speculative
               run has verify steps, every pipelined one a pipeline peak
               of at least 2, and every run returns all its blocks. A line
               a run: steps, verify steps, proposed and accepted tokens,
               accept rate, tokens a verify step, pipeline peak, wall,
               tokens/s, ms a step. Then the draft's host time idle and
               behind queued verify steps, from its own stream and from
               the executor's, and one profiled speculative-pipelined run.
 13. shard   — context-parallel paged KV at full width. A direct step:
               one window through ``PagedDecodeStep`` and the rank steps
               (head world 1, 2 and 4, page world 2 and 3) on copies of
               one pre-filled pool, int8 and fp32: every rank's pools
               bitwise the single pool's slice, a head rank's ``o_r``
               bitwise those heads of the kernel's output at H = 32 and
               within phase 3's bar of its ``kernel="torch"`` output, the
               page ranks' merged ``o`` within the stated bar of the
               kernel's. Then 8 HTTP requests through
               ``ShardedPagedKVExecutor`` (rank threads sharing the card,
               each on its own stream): head world 2 int8 sync and
               pipelined, fp32 sync, world 4 int8 sync and world 2 fp32
               ``speculative`` must decode the single worker's streams
               (phase 4's int8, phase 12's fp32 sync) token for token
               with ``world`` kernel launches a step; page world 2 int8
               and world 3 fp32 on the first 3 requests launch no kernel,
               and their first difference from the single worker's
               streams is logged, not checked. A line a lane: steps,
               wall, ms a step, each rank's resident pool bytes against
               the single worker's.
 14. rows    — row-plane decode (``LocalExecutor`` -> ``DecodeStep`` ->
               the forward stage stack of ``train_step`` with its top-1
               Switch MoE) at Mixtral-8x7B's widths (d 4096, FFN width
               14336 for the dense pair and each expert, 8 experts, ep =
               8 ranks sharing the card), depth cut to 4 of its 32
               layers, 64 slots, random weights (16.91 GB f32, one set
               shared by every ep = 8 lane). A direct step at capacity
               factor 1 (C = 1, rows dropped): kernel 10 for the two
               expert exchanges a stage against the plain exchange bit
               for bit, 2 x 4 launches a step, 20 repeats bitwise, one
               row alone in slot 0 and in slot 63 within rtol 1e-5, atol
               1e-6 with idle rows exactly zero; at capacity factor 8
               within the stated bar of the dense composition
               (``moe.dense_reference`` for each stage's MoE). Kernel 10
               at the MoE's shape ([512, 4096] f32, blocks of 8 rows)
               against plain, timed. Then 64 HTTP requests of 32 tokens
               at capacity factor 8 (dropless) through ``ServingServer``:
               ep = 8 pipelined, sync and pipelined with the plain
               exchange must decode identical streams, the kernel lanes
               launching kernel 10 2 x 4 times a step; at least half of
               the pipelined submits return before their step's end
               event; ep = 1 pipelined (its own 3.76 GB weights) launches
               none. A line a lane (steps, wall, ms a step, tokens/s,
               launches, peak device memory), then one profiled
               pipelined run: the idle share and device time by kernel.
               Then dp 2 x tp 2 x ep 8 (32 ranks on the card, the same
               weights, 4 rows a rank): a direct step at capacity factor
               1 with kernel 10 == the plain exchange bit for bit, 2 x 4
               launches; at capacity factor 8 within the stated bar of
               the ep = 8 step on the same batch; kernel 10 at the
               served exchange's shape timed; the 64 requests pipelined
               with kernel 10 and with the plain exchange decode
               identical streams (whether they equal the ep = 8 lanes'
               is logged, with the median step interval).
 15. train   — the GPipe training step (``make_train_step``: 4 stages
               pipelined over M = 4 microbatches, the dense pair cut over
               tp = 2, each stage's Switch MoE over ep = 8 ranks sharing
               the card, the loss, its gradient by autograd, SGD) at
               phase 14's widths and seed, microbatches of 2 sequences of
               64 tokens, capacity factor 1 (rows dropped): kernel-10
               launches 2 x S x M in a forward and 4 x S x M in a step
               (each exchange's backward is one more launch), loss and
               every gradient leaf with kernel 10 == the plain
               exchange's bit for bit, the loss within the stated bar of
               the port's dense twin (``dense_loss_reference``), 5
               repeated steps bitwise, the loss descending over 3 steps;
               kernel 10 forward and backward at the step's exchange
               shape against plain; step time by events (kernel and
               plain exchange in turns), the host's time, peak memory,
               and one profiled step.
 16. 1f1b    — the hand-scheduled 1F1B training step
               (``make_train_step_1f1b``: ``pipeline_1f1b.run_schedule``
               over the reference's instruction tables, F units without a
               graph, B units rematerialized) on phase 15's model, batch
               and seed with the attention branch (each stage opens with
               causal ring attention over the token ranks, plain torch),
               in two lanes of the same 4 stages: pp 4 with v 1, and pp 2
               with v 2 (interleaved). Each lane's schedule (ticks,
               bubble against GPipe's, microbatches in flight, stash
               slots); kernel-10 launches 2 x S x M in the F units and 6 x
               S x M in a step; loss and every gradient leaf with kernel
               10 == the plain exchange's bit for bit in each lane; the
               loss within the stated bar of the dense twin, and loss and
               gradients within the stated bars of the GPipe step with
               attention on the same weights; step time by events, the
               host's time and peak memory of lane a, lane b and GPipe
               with attention in turns; one profiled lane-a step; the
               memory lane: one step each of GPipe, lane a and lane b on
               a batch of 16 x 2 x 512 tokens, where the activations are
               a real share of the card (launches, losses against
               GPipe's, step time, peak memory); 3 repeated steps
               bitwise; the loss descending over 3 steps.
 17. probe   — the fabric probe's training step
               (``make_probe_train_step``, ``run_probe``) at
               ``build_mesh(8)`` = dp 2 x sp 2 x tp 2 and at
               ``build_mesh(1)``: ``run_probe(mesh, steps=2)``, the
               multi-chip dry run, gives a finite loss and launches no
               ring kernel; 5 steps descend; a second run of them is
               bitwise the first; the update equals tp x LR x the
               one-rank dense loss's gradient within the stated bar; ms a
               step by events.
 18. fabric  — fabric-sharded serving on the row model at E = 1 (phase
               14's widths, depth 4, seed 0, 64 slots, tp = 8 ranks on
               the card): (a) ``make_mesh_stage_fn``, each stage's w1
               product one launch of the all-gather matmul kernel (S a
               step, the main path with counts at 0), every launch
               within the bar of its plain version, tokens equal to
               ``TpShardSlice`` at world 1's and states within the
               stated bar in the kernel, torch and overlap=False forms,
               repeats bitwise, ms a step, the kernel at this shape
               against plain, ``torch.matmul`` f32 and its bound; (b)
               ``FabricExecutor`` over ``SyntheticShardSet(world=8)``,
               sync, pipelined, with overlap and with the int8 codec, 64
               requests of 32 tokens: fp32 streams equal
               ``LocalExecutor``'s on the same weights, int8 streams
               repeat, ms a step and the collective and skew series;
               then 8 requests over HTTP through ``ServingServer``,
               profiled (idle share); (c) ``ShardProcessSet(world=2)``
               at depth 1: two ``shard_worker`` processes with their
               own CUDA contexts, warmed up, reducing over the fabric
               ring on loopback: fp32 streams equal the thread shards',
               int8 with overlap after a re-rendezvous; the workers'
               compute and collective seconds; ``outstanding() == 0``
               after every close.

Phase 2 builds every source at once (one nvcc each). The second line
from the end is one JSON object with a record per kernel (launches on
its path, max error, times, bound; the collective matmuls' records give
f32 under the contract's keys and bf16 under the same keys prefixed
``bf16_``; the paged-attention record adds ``sharded_launches``, phase
13's head lanes' launches, and the all-to-all's adds ``moe_launches``,
phase 14's ep = 8 kernel lanes' launches, with its ``moe_`` times at the
MoE's shape, ``train_launches``, phase 15's launches in one training
step, with its ``train_`` times at the step's exchange shape, and
``train_1f1b_launches`` / ``train_1f1b_v2_launches``, phase 16's launches
in one 1F1B step of lane a / b, with its ``train_1f1b_`` step times and
peaks, the memory lane's under ``train_1f1b_memory_peak_gb`` and
``train_gpipe_memory_peak_gb``, ``ulysses_grad_launches``, phase 10's
launches in one Ulysses call with its gradient, and
``row_dptp_launches``, phase 14's dp x tp kernel lane's; the all-gather
matmul's adds ``mesh_stage_launches``, phase 18's launches in its
mesh-stage steps, with its ``mesh_stage_`` times at that shape); the last
line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import weakref

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

SOURCES = ("paged_attn", "tile_mma", "ring_attn", "ring_collectives",
           "all_to_all", "collective_matmul")

# Kernel phase: the deploy shape of the serving phase below.
KS, KC, KB, KBS, KH, KDH, KN = 16, 16, 256, 16, 32, 128, 8192
# Kernel vs plain: both accumulate f32 over up to 4096 positions, in
# another order (online softmax by blocks vs one softmax), and scale by
# 1/sqrt(dh) vs divide by sqrt(dh). The same bar against the split's
# PyTorch arithmetic, which sums in torch's order within a chunk.
O_RTOL, O_ATOL = 1e-4, 1e-5
PA_REPEATS = 20

# Serving phase: the attention widths of Llama-2-7B (d 4096, 32 heads
# of 128), the repo's default MLP width 2*d, a 4096-token context.
SERVE = dict(vocab=32000, d=4096, heads=32, block_size=16,
             max_blocks_per_req=256, num_blocks=8192, slots=16,
             prefill_chunk=16, pool_dtype="int8", seed=0)
PROMPT_LENS = [256, 3000, 1200, 2000, 800, 2600]  # + two sharing 512
SHARED_PREFIX = 512
MAX_TOKENS = 32

# Tile phase: the health/bench path's shapes. Burn tile: x [m, n] @ w
# [n, n], the tiled branch's smallest square and one m != n case.
TILE_SHAPES = ((2048, 2048), (1024, 2048))
MM_N = 4096
MM_ROUTES = (("mm_fullk", (1024, 256, 4096), "mxu_bench.py:97"),
             ("mm_kblocked", (512, 512, 1024), "mxu_bench.py:116"))
# The tile kernel off its grid: k = 32 * 5, whose last 64-wide K box TMA
# zero-fills past k, and n = 3 * 128, whose second 256-wide tile lies half
# past n; checked at both widths, with and without tanh.
TILE_ODD = (384, 160, 384)
TILE_REPEATS = 5
# Kernel vs plain, in bf16 (burn.bf16_ulps: ulps at the larger magnitude,
# at 2**-5 below it). One product or one tanh step: both sum exact f32
# products in f32, in another order, and round once, so a value at a
# rounding boundary may land on either side: at most 1 ulp.
STEP_ULPS = 1.0
# The 8-step chain: each step's 1-ulp flips enter the next step as
# absolute perturbations, amplified by the burn weights (0.05 * sqrt(1024)
# = 1.6 before tanh); on an H100 this phase measured 0.0188. The bound is
# 2**-4 = 16 ulps at the top of tanh's range, far below a fault's O(1).
CHAIN_ATOL = 2.0 ** -4
# The chain off the health burn's size and length: the smallest square
# (one tile), one whose 5 x 5 tiles leave a partial last wave, and the
# largest that ``burn.chain_fits``; one step (no barrier), two, three (a
# scratch part written twice) and eight. Inputs drawn as the burn's own.
CHAIN_SIZES = (128, 640, 1152)
CHAIN_LENGTHS = (1, 2, 3, 8)
CHAIN_REPEATS = 20
# The f32 signature sum(h**2) over the burn: its per-element flips have
# random signs (the reference's own test allows 5 %).
SIG_RTOL = 1e-4
# The 2048^2 health burn's signature against eight plain steps: the same
# random flips, over a longer chain of wider steps.
SIG2048_RTOL = 1e-3

# Ring phase: the long-context path at the served model's head width
# (Llama-2-7B, 128) on an 8-rank ring, 4096 rows per rank (the served
# run's context per rank), f32 and bf16, causal and not; then the
# reference's own AOT proof shape (S 1024, 128, bf16, 8 ranks).
RING_MESH = {"dp": 1, "sp": 8, "tp": 1}
RING_S, RING_D = 32768, 128
RING_AOT_S = 1024
# Small rings held against the plain version: (n, S, dk, dv, q, k, v
# types) -- the reference tests' widths, shards that are no multiple of
# the kernel's 128-row tile (100, 120, 200 rows), head widths that are
# no multiple of 8 (20, 12, 100; the kernel pads dk to 16 and dv to 8),
# the widest heads (dk or dv > 128 takes the kernel's other instance),
# and the mixed types: bf16 q and k with f32 v (K/V then circulate as
# f32), f32 q with bf16 K/V, bf16 q with f32 K/V. Each names the inputs
# it rounds to bf16.
RING_SMALL = ((1, 256, 16, 8, ""), (2, 256, 16, 8, ""), (4, 256, 16, 8, ""),
              (4, 400, 128, 128, ""), (8, 4096, 16, 8, ""),
              (2, 512, 256, 256, ""), (4, 400, 64, 192, "qk"),
              (8, 1024, 128, 128, "kv"), (3, 360, 20, 12, ""),
              (5, 1000, 200, 100, "q"), (3, 360, 20, 12, "qkv"))
# f32 q scaled by RING_Q_SCALE at d 128 (scores ~N(0, 16)): the kernel's
# split holds the f32 bar, and one TF32 pass (``ring_attention_split``
# with ``single``, on the card) must miss it, or the case does not bite.
RING_SCALED = (4, 1024, 128, 128)
RING_Q_SCALE = 4.0
RING_REPEATS = 20
# Kernel vs plain in f32: both sum f32 products over up to 32 768 keys in
# another order (64-key tiles vs whole blocks), with expf vs torch.exp:
# the bar of the paged-attention kernel above.
RING_RTOL, RING_ATOL = 1e-4, 1e-5
# bf16 out: both compute the same f32 value up to that reordering and
# round once, so an element may land on either side of a rounding
# boundary: 1 ulp, counted at the larger magnitude or at 2**-12 below
# it (under 2**-12 an f32 sum's reordering error, ~1e-7, is no longer
# small beside the value's own ulp).
RING_ULPS, RING_ULP_FLOOR = 1.0, 2.0 ** -12

# Collectives phase: the fabric probe's ring at the reference's default
# payload, [8192, 512] f32 (16 MiB, 2 MiB per rank), on the ring mesh
# above; once more at the HBM pass's 256 MiB, beyond the card's L2; the
# reduce-scatter with 16 MiB per rank, so that its chunks are the
# all-gather's 2 MiB blocks; and the all-gather at ring attention's
# block (4 MiB per rank), to set its step beside that kernel's relay.
COLL_WIDTH = 512
COLL_MBYTES, COLL_BIG_MBYTES, COLL_ATTN_MBYTES = 16, 256, 32
COLL_ROUNDS = 4
# Small rings, checked and not timed: (n, rows per rank, width, type).
# The reference tests' shapes (4 rows of 8 f32 per rank; 3 rows, the odd
# shard that must run one way), blocks that are no multiple of 16 bytes
# (20, 36 and 12 bytes; 33 000 and 17 000 bytes, which several CTAs of a
# rank stripe by single values), and the 2-byte and integer payloads.
COLL_SMALL = ([(n, 4, 8, "float32") for n in (1, 2, 3, 4, 8)]
              + [(8, 3, 8, "float32"), (3, 2, 5, "bfloat16"),
                 (4, 3, 3, "float32"), (4, 6, 64, "bfloat16"),
                 (8, 2, 16, "float16"), (4, 4, 8, "int32"),
                 (5, 2, 3, "int32"), (8, 66, 250, "bfloat16"),
                 (4, 34, 125, "float32")])
# Reduce-scatter against a float64 sum: the reference's own bar between
# its ring and numpy (f32; up to 8 adds in another order).
RS_RTOL, RS_ATOL = 1e-4, 1e-5

# Ulysses phase: the exchange at the probe's payload above, then Ulysses
# attention at Llama-2-7B's attention widths (32 heads of 128) on the ring
# mesh, S = 16384 (2048 rows a rank). Not ring attention's 32 768: a
# rank's [4, S, S] f32 scores are 4 GiB at 16 384, and would be 16 GiB
# (about 48 GiB with the softmax's copies) at 32 768.
ULY_S, ULY_H, ULY_D = 16384, 32, 128
ULY_REPEATS = 3
# The gradient lane: the same widths and S (autograd keeps each rank's
# [4, S, S] f32 softmax output, 4.29 GB a rank, 34.4 GB over the 8 ranks,
# until the backward).
ULY_GRAD_S = ULY_S
# Small all-to-alls, checked and not timed: (n, rows per block, width,
# type). Blocks of 12, 30, 6 and 84 bytes, and of 24 006 and 32 764
# bytes, which two CTAs of a rank stripe by 2-byte units: none a multiple
# of 16 bytes.
A2A_SMALL = ([(n, 1, 3, "float32") for n in (1, 2, 3, 4, 5, 8)]
             + [(n, 3, 5, "bfloat16") for n in (2, 3, 5, 8)]
             + [(4, 1, 3, "float16"), (8, 3, 7, "int32"),
                (3, 3, 4001, "bfloat16"), (5, 1, 8191, "float32")])
# Ulysses against the dense reference and against ring attention: the
# same f32 products and softmax up to reassociation (one softmax over the
# whole sequence vs 64-key online folds, expf vs torch.exp), so ring
# attention's bars (``ring_compare``): f32 within RING_RTOL / RING_ATOL,
# bf16 within RING_ULPS.

# Collective-matmul phase: the served model's MLP (d 4096, the repo's
# width 2d) over a 4096-token sequence, tensor-parallel on 8 ranks sharing
# the card: x [4096, 4096] @ w1 [4096, 8192] (chunk 512, 1024 columns a
# rank), relu, @ w2 [8192, 4096] (1024 contraction rows a rank).
TP_MESH = {"dp": 1, "sp": 1, "tp": 8}
TP_B, TP_D, TP_H = 4096, SERVE["d"], 2 * SERVE["d"]
TP_REPEATS = 20
# Small rings, checked and not timed: the reference tests' shapes (all-
# gather x [2n, 16] @ w [16, 8n]; reduce-scatter x [2n, 8n] @ w [8n, 16])
# at every ring size, its bf16 case ([16, 64] @ [64, 16], n = 8), and one
# shape a ring off every tile edge: (n, rows, k, f) with 200-row shards,
# and 136 (all-gather) or 3 x 72 (reduce-scatter) contraction and 200 a
# rank's columns, none a multiple of a 64- or 128-wide tile or its step.
CM_RINGS = (1, 2, 3, 4, 5, 8)
CM_OFF_GRID = ((3, 600, 136, 600), (8, 1600, 136, 1600))
CM_RS_OFF_GRID = ((3, 600, 216, 200), (8, 1600, 576, 200))
# Cases aimed at the bf16 wgmma product (K steps of 64; tiles of 128 x
# 256, one CTA an SM, in the all-gather; 128 x 128, two CTAs an SM, in the
# reduce-scatter), as (n, rows, k, f, reduce_scatter): the reduce-scatter
# with 424-row blocks, kn = 200 (no multiple of 64; the next rank's
# contraction lies past it) and f = 4000 (no multiple of 128), 4 x 32
# tiles a block over at most 2 * 132 // 8 = 33 CTAs a rank on an H100, so
# every CTA runs three or four products a ring step, the mbarrier phases
# carried from one to the next; the all-gather with 1536-row shards, k =
# 200 and 1000 columns a rank, 12 x 4 tiles a block over at most 16 CTAs.
CM_WGMMA_CASES = ((8, 8 * 424, 8 * 200, 4000, True),
                  (8, 8 * 1536, 200, 8 * 1000, False))
# CTAs an SM of each bf16 kernel (its shared memory), and its tile.
CM_WGMMA_TILES = {False: (1, 128, 256), True: (2, 128, 128)}
# Cases aimed at the f32 split-TF32 product (K stages of 32; 128 x 128
# tiles, one CTA an SM, in both kernels), as CM_WGMMA_CASES: the
# reduce-scatter with 424-row blocks, kn = 200 (no multiple of 32) and
# f = 1800, 4 x 15 tiles a block over at most 132 // 8 = 16 CTAs a rank;
# the all-gather with 1480-row shards, k = 200 and 600 columns a rank,
# 12 x 5 tiles a block: three or four products a CTA a ring step, each
# with tails in M, N and K.
CM_TF32_CASES = ((8, 8 * 424, 8 * 200, 1800, True),
                 (8, 8 * 1480, 200, 8 * 600, False))
CM_TF32_TILE = (1, 128, 128)
# Kernel vs plain: in f32 the kernel sums split-TF32 passes (each
# product within ~2**-22 of the exact one, its f32 sums in other orders)
# where cuBLAS sums exact f32 products, so max |a - b| <= 1e-5 * max |b|
# (one TF32 pass is ~3e-4 off and must miss it); in
# bf16 both round an f32 value that differs by that reordering once: 1
# ulp, counted as phase 6 counts its matmul (STEP_ULPS): at the larger
# magnitude or at 2**-5 below it. Not ring attention's 2**-12: over k up
# to 8192 the reordering reaches ~1e-5 absolute, 5 ulps of a value near
# 2**-12 (seen on an H100 at the full-width all-gather matmul).
CM_F32_REL = 1e-5
# The pair against the dense product: f32 within CM_F32_REL as above. In
# bf16 the two round h = x @ w1 separately, and an element of h may land
# on either side of a rounding boundary (the all-gather check above allows
# 1 ulp), so the outputs may differ by that freedom carried through w2,
# sum_j ulp(h_j) |w2_jk|, plus 1 ulp of their own rounding.

# Small configuration held against the CPU path (the tests' widths).
SMALL = dict(slots=2, vocab=16, d=8, heads=2, block_size=4,
             num_blocks=32, max_blocks_per_req=4, prefill_chunk=4, seed=0)
SMALL_PROMPTS = [[1, 2, 3, 4, 5, 6], [7, 8, 9]]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg) -> None:
    """A phase's pass/fail test (kept under ``python -O``, unlike
    ``assert``)."""
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3: kernel against plain --------------------------------------------


def kernel_inputs(torch, pool_dtype, poisoned, seed=0, chunk_positions=0):
    """Seeded inputs at deploy shape: one idle slot, decode rows, and
    16-row prefill chunks crossing block edges, ctx from 0 to ~4000. The
    pools are drawn on the card (a CUDA generator), the rest with
    numpy. With ``chunk_positions`` (the positions one CTA of the kernel
    owns), slot 2's prefill chunk straddles the first chunk boundary and
    slot 4's starts at the table's last position, so that its rows past
    the table clip to the last block."""
    rng = np.random.RandomState(seed)
    S, C, B, bs, H, dh, N = KS, KC, KB, KBS, KH, KDH, KN
    ctx = np.zeros(S, np.int64)
    n_new = np.zeros(S, np.int64)
    for s in range(1, S):
        if s % 2:                      # decode
            ctx[s] = rng.randint(1, 4000)
            n_new[s] = 1
        else:                          # prefill chunk, off a block edge
            ctx[s] = rng.randint(0, 4000 - C) // bs * bs + rng.randint(1, bs)
            n_new[s] = C
    ctx[S - 1] = B * bs - 1            # the very last position
    if chunk_positions:
        ctx[2], n_new[2] = chunk_positions - 5, C
        ctx[4], n_new[4] = B * bs - 1, C
    tables = rng.permutation(N)[:S * B].reshape(S, B)
    tables[0] = 0                      # idle slot: the planner's zero row
    q, k, v = (rng.randn(S, C, H, dh).astype(np.float32) for _ in range(3))
    if pool_dtype == "int8":
        kscale = rng.uniform(0.01, 0.03, N).astype(np.float32)
        vscale = rng.uniform(0.01, 0.03, N).astype(np.float32)
    else:
        kscale = np.ones(N, np.float32)
        vscale = np.ones(N, np.float32)
    rows = np.clip((ctx[:, None] + np.arange(C)) // bs, 0, B - 1)
    blk_rows = np.take_along_axis(tables, rows, axis=1)
    ksc_tbl, vsc_tbl = kscale[tables], vscale[tables]
    limit = ctx + n_new
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (N, bs, H, dh)
    if pool_dtype == "int8":
        kpool, vpool = (torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
                        for _ in range(2))
    else:
        kpool, vpool = (torch.randn(shape, generator=gen, device="cuda")
                        for _ in range(2))
    if poisoned:
        ok = np.zeros((N, bs), bool)
        for s in range(S):
            p = np.arange(min(limit[s], B * bs))  # the table's positions
            ok[tables[s, p // bs], p % bs] = True
        bad = torch.from_numpy(~ok).cuda()
        if pool_dtype == "int8":
            kpool[bad], vpool[bad] = 113, -113
        else:
            kpool[bad], vpool[bad] = float("nan"), float("nan")
        past = np.arange(B)[None, :] >= -(-limit[:, None] // bs)
        ksc_tbl = np.where(past, np.nan, ksc_tbl).astype(np.float32)
        vsc_tbl = np.where(past, np.nan, vsc_tbl).astype(np.float32)
    small = [tables.astype(np.int32), ctx.astype(np.int32),
             n_new.astype(np.int32), q, k, v, kscale[blk_rows],
             vscale[blk_rows], ksc_tbl, vsc_tbl]
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in small]
    return args + [kpool, vpool], ctx, n_new


def bits(torch, t):
    """A view whose equality is bitwise (NaN rows compare equal)."""
    return t.view(torch.int32) if t.is_floating_point() else t


def attn_cost(ctx, n_new, pool_dtype):
    """(bytes, flops) the function needs on these inputs, each byte moved
    once: q read and o written for all S*C rows; k_new, v_new and their
    row scales read for the appended rows only (sum n_new); K/V read at
    the sum(ctx) positions already in the pools, and the appended rows
    written (the new rows attend them from k_new/v_new, they need not be
    read back); table entries and table scales read for the blocks below
    each slot's limit; ctx and n_new. 4 flops per (row, position,
    element) attended (q.k and p.v)."""
    item = 1 if pool_dtype == "int8" else 4
    row = KH * KDH
    appended = int(np.sum(n_new))
    blocks = int(np.sum(-(-(ctx + n_new) // KBS)))
    nbytes = (2 * KS * KC * row * 4                  # q in, o out
              + 2 * appended * (row * 4 + 4)         # k/v_new, row scales
              + 2 * int(np.sum(ctx)) * row * item    # K/V pages read
              + 2 * appended * row * item            # appended rows
              + 3 * blocks * 4                       # table, its scales
              + 2 * KS * 4)                          # ctx, n_new
    flops = 4 * row * int(sum(int(ctx[s]) * int(n_new[s])
                              + int(n_new[s]) * (int(n_new[s]) + 1) // 2
                              for s in range(len(ctx))))
    return nbytes, flops


def time_ms(torch, fn, n=25, warm=3, batch=10):
    """Device ms of one ``fn()``: the median over ``n`` samples, each the
    mean of ``batch`` back-to-back calls between two CUDA events. Within a
    batch the host runs ahead of the card, so the wrappers' host work
    (checks, allocation, the launch itself) hides behind the queue; an
    event pair around a single call would count it whenever the card
    waits for the host."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def check_paged_attn_build(cuda_build):
    """The paged-attention kernel's six instances (int8 pools read 16 or
    4 codes at a time, f32 pools, each for heads up to 128 and 256 wide)
    as ptxas reported them in this run: no spills. Returns a line for the
    log."""
    text = cuda_build.build_logs.get("paged_attn")
    if text is None:
        return ("paged_attn: ptxas report not in this run (the library was "
                "built earlier in this checkout)")
    kernels = {}
    for name, regs in ptxas_entries(text).items():
        found = re.search(r"paged_attn_kernelI([af])Li(\d+)ELi(\d+)E", name)
        if found:
            pool = "int8" if found[1] == "a" else "f32"
            kernels[f"{pool} x{found[2]} dh<={128 * int(found[3])}"] = regs
    check(len(kernels) == 6, f"paged_attn: ptxas reported {sorted(kernels)}")
    for name, (regs, stores, loads) in kernels.items():
        check(stores == 0 and loads == 0,
              f"paged_attn {name}: {stores} B spill stores, {loads} B loads")
    return ", ".join(f"{name} {regs} registers, 0 spills"
                     for name, (regs, _, _) in sorted(kernels.items()))


def phase_kernel(torch, card):
    from dpu_operator_tpu_torch import cuda_build
    from dpu_operator_tpu_torch.parallel import paged_attn as pa

    log(f"kernel build: {check_paged_attn_build(cuda_build)}")
    chunk = pa.CHUNK_BLOCKS * KBS
    record = None
    for pool_dtype in ("int8", "fp32"):
        for edges in (False, True):
            clean = {}
            for poisoned in (False, True):
                args, ctx, n_new = kernel_inputs(
                    torch, pool_dtype, poisoned,
                    chunk_positions=chunk if edges else 0)
                kargs = [a.clone() for a in args]
                sargs = [a.clone() for a in args]
                before = pa.paged_attn_step_cuda.launches
                o_k = pa.paged_attn_step_cuda(*kargs)
                o_p = pa.paged_attn_step_plain(*args)
                o_s = pa.paged_attn_split_plain(
                    *sargs, chunk_blocks=pa.CHUNK_BLOCKS)
                torch.cuda.synchronize()
                check(pa.paged_attn_step_cuda.launches == before + 1,
                      "the wrapper must count its one launch")
                tag = (f"{pool_dtype}{' edges' if edges else ''}"
                       f"{' poisoned' if poisoned else ''}")
                for i, name in ((10, "kpool"), (11, "vpool")):
                    for got, who in ((kargs, "kernel"), (sargs, "split")):
                        if not torch.equal(bits(torch, got[i]),
                                           bits(torch, args[i])):
                            raise AssertionError(
                                f"{who} {tag}: {name} differs from the "
                                f"plain version's")
                del sargs
                for o, who in ((o_k, "kernel"), (o_p, "plain"),
                               (o_s, "split")):
                    check(torch.isfinite(o).all(), f"{who} {tag}: non-finite o")
                err = float((o_k - o_p).abs().max())
                err_s = float((o_k - o_s).abs().max())
                for want, who, e in ((o_p, "plain version", err),
                                     (o_s, "split's PyTorch arithmetic",
                                      err_s)):
                    if not torch.allclose(o_k, want, rtol=O_RTOL,
                                          atol=O_ATOL):
                        raise AssertionError(f"kernel {tag}: o differs from "
                                             f"the {who} by {e}")
                check(not o_k[0].any(), "idle slot rows must be 0")
                if poisoned:
                    if not (torch.equal(o_k, clean["k"])
                            and torch.equal(o_p, clean["p"])
                            and torch.equal(o_s, clean["s"])):
                        raise AssertionError(f"{tag}: poisoned pool leaked "
                                             f"into o")
                    log(f"kernel {tag}: pools bitwise equal, o equals the "
                        f"clean run's exactly")
                    continue
                # A repeat appends the same codes to the same places, so
                # it reads what the first call read.
                for i in range(PA_REPEATS):
                    again = pa.paged_attn_step_cuda(*kargs)
                    check(torch.equal(bits(torch, again), bits(torch, o_k)),
                          f"kernel {tag} repeat {i}: differs from the first "
                          f"call's bits")
                clean = {"k": o_k, "p": o_p, "s": o_s}
                if edges:
                    log(f"kernel {tag}: pools bitwise equal (kernel, split, "
                        f"plain), max |o err| {err:.3e} vs plain, "
                        f"{err_s:.3e} vs split (rtol {O_RTOL}, atol "
                        f"{O_ATOL}), {PA_REPEATS} repeats bitwise equal")
                    continue
                ms = time_ms(torch, lambda: pa.paged_attn_step_cuda(*kargs))
                plain_ms = time_ms(torch,
                                   lambda: pa.paged_attn_step_plain(*args),
                                   n=20, warm=2)
                nbytes, flops = attn_cost(ctx, n_new, pool_dtype)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / FP32_FLOP_PER_S * 1e3
                log(f"kernel {tag}: pools bitwise equal (kernel, split, "
                    f"plain), max |o err| {err:.3e} vs plain, {err_s:.3e} vs "
                    f"split (rtol {O_RTOL}, atol {O_ATOL}), {PA_REPEATS} "
                    f"repeats bitwise equal; kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms (median of 25/20 batches of 10), "
                    f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes} B, "
                    f"{flops} flop) [{card}]")
                if pool_dtype == "int8":
                    record = dict(
                        name="paged_attn", route="cuda",
                        source="dpu_operator_tpu_torch/csrc/paged_attn.cu",
                        replaces="dpu_operator_tpu/parallel/"
                                 "pallas_paged_attn.py:292",
                        launches=None, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by=("bytes" if t_bytes >= t_ops
                                  else "operations"),
                        library_ms=None)
            del args, kargs, clean
            torch.cuda.empty_cache()
    return record


# -- phase 4: the serving path ------------------------------------------------


def post(url, body, timeout):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def post_all(url, bodies, timeout=900, sent=None):
    """POST every body to ``url`` at once, a thread each; returns the
    (status, body) of each, or None where a request got no answer. A
    ``sent`` list gets each request's ``time.monotonic()`` just before its
    POST."""
    results = [None] * len(bodies)

    def one(i):
        if sent is not None:
            sent[i] = time.monotonic()
        results[i] = post(url, bodies[i], timeout)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def serve_prompts():
    rng = np.random.RandomState(1)
    vocab = SERVE["vocab"]
    prefix = rng.randint(0, vocab, SHARED_PREFIX).tolist()
    prompts = [prefix + rng.randint(0, vocab, 300).tolist(),
               prefix + rng.randint(0, vocab, 700).tolist()]
    prompts += [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]
    return prompts


def serve_once(torch, ex, prompts, card):
    from dpu_operator_tpu_torch.serving import ServingServer

    srv = ServingServer([ex], max_tokens_cap=MAX_TOKENS,
                        pool_opts={"watchdog_s": 300.0}).start()
    steps0 = ex._step_no
    t0 = time.monotonic()
    try:
        results = post_all(srv.url, [{"prompt_tokens": p,
                                      "max_tokens": MAX_TOKENS,
                                      "deadline_ms": 600000}
                                     for p in prompts])
    finally:
        srv.stop()
    wall = time.monotonic() - t0
    steps = ex._step_no - steps0
    streams = []
    for i, res in enumerate(results):
        check(res is not None, f"request {i}: no response")
        code, body = res
        check(code == 200, f"request {i}: HTTP {code} {body}")
        toks = body["tokens"]
        check(len(toks) == MAX_TOKENS and not body["truncated"],
              f"request {i}: {len(toks)} tokens, "
              f"truncated={body['truncated']}")
        check(all(0 <= t < SERVE["vocab"] for t in toks),
              f"request {i}: token out of vocab")
        streams.append(toks)
    if ex.prefix is not None:
        ex.prefix.flush()
    ex.allocator.assert_clean()
    n_tok = MAX_TOKENS * len(prompts)
    n_prompt = sum(len(p) for p in prompts)
    return streams, dict(wall_s=wall, steps=steps,
                         gen_tok_per_s=n_tok / wall,
                         all_tok_per_s=(n_tok + n_prompt) / wall,
                         step_ms=wall / max(steps, 1) * 1e3)


# Speculative lanes of the small configuration: (mode, spec_k, tree width).
SMALL_SPEC = (("speculative", 3, 1), ("speculative-pipelined", 3, 1),
              ("speculative-pipelined", 3, 3))


def phase_small(torch):
    """A small configuration on the card decodes the streams the CPU path
    decodes, in sync mode and in the three speculative lanes; the CPU path
    is what the tests hold against the JAX package. With fp32 pools the
    speculative streams also equal the sync streams."""
    from dpu_operator_tpu_torch.serving import (GenerateRequest,
                                                PagedKVExecutor)
    from dpu_operator_tpu_torch.serving.spec import token_run

    def drive(ex, tag):
        reqs = [GenerateRequest(prompt_vec=None, max_tokens=4,
                                deadline=time.monotonic() + 60,
                                prompt_tokens=list(p))
                for p in SMALL_PROMPTS]
        for s, r in enumerate(reqs):
            ex.kv_attach(s, r)
        live = set(range(len(reqs)))
        for _ in range(100):
            toks = ex.collect(ex.submit((), gen=ex.kv_gen()))
            for s in sorted(live):
                r = reqs[s]
                for t in token_run(toks[s]):
                    if len(r.tokens) < 4:
                        r.tokens.append(t)
                if len(r.tokens) == 4:
                    ex.kv_release_slot(s, cache=False)
                    r.finish()
                    live.discard(s)
            if not live:
                break
        check(not live, f"small {tag}: requests unfinished")
        ex.allocator.assert_clean()
        return [list(r.tokens) for r in reqs]

    lanes = [("sync", dict(mode="sync"))]
    lanes += [(f"{mode} k={k}" + (f" tree {w}" if w > 1 else ""),
               dict(mode=mode, spec_k=k, spec_tree_width=w))
              for mode, k, w in SMALL_SPEC]
    for pool_dtype in ("int8", "fp32"):
        sync = None
        for label, kw in lanes:
            out = {}
            for dev, extra in (("cpu", dict(device="cpu")),
                               ("card", dict(kernel="cuda",
                                             device="cuda"))):
                ex = PagedKVExecutor(**SMALL, pool_dtype=pool_dtype, **kw,
                                     **extra)
                out[dev] = drive(ex, f"{label} {pool_dtype} {dev}")
            gpu, cpu = out["card"], out["cpu"]
            check(gpu == cpu, f"small {label} {pool_dtype}: card {gpu} "
                  f"!= cpu {cpu}")
            check(all(len(s) == 4 for s in gpu),
                  f"small {label} {pool_dtype}: short")
            if sync is None:
                sync = gpu
            elif pool_dtype == "fp32":
                check(gpu == sync, f"small {label} fp32: {gpu} != sync "
                      f"{sync}")
            log(f"small {label} {pool_dtype}: card streams == CPU streams "
                f"{gpu}" + (" == sync" if pool_dtype == "fp32"
                            and label != "sync" else ""))


def phase_serve(torch, card):
    from dpu_operator_tpu_torch.parallel import paged_attn as pa
    from dpu_operator_tpu_torch.serving import PagedKVExecutor

    prompts = serve_prompts()
    runs = {}
    launches = None
    for label, kw in (("pipelined/cuda", dict(mode="pipelined",
                                               kernel="cuda")),
                      ("sync/cuda", dict(mode="sync", kernel="cuda")),
                      ("pipelined/torch", dict(mode="pipelined",
                                                kernel="torch"))):
        t0 = time.monotonic()
        ex = PagedKVExecutor(**SERVE, **kw, device="cuda")
        setup = time.monotonic() - t0
        if label == "pipelined/cuda":
            pa.paged_attn_step_cuda.launches = 0
        streams, st = serve_once(torch, ex, prompts, card)
        if label == "pipelined/cuda":
            launches = pa.paged_attn_step_cuda.launches
            check(launches >= st["steps"] > 0,
                  f"kernel launches {launches} for {st['steps']} steps")
        runs[label] = streams
        log(f"serve {label}: {len(prompts)} requests x {MAX_TOKENS} "
            f"tokens, prompts {sum(map(len, prompts))} tokens, "
            f"{st['steps']} steps in {st['wall_s']:.3f} s -> "
            f"{st['gen_tok_per_s']:.1f} generated tok/s, "
            f"{st['all_tok_per_s']:.1f} prompt+generated tok/s, "
            f"{st['step_ms']:.3f} ms/step wall (setup {setup:.1f} s) "
            f"[{card}]")
        del ex
        torch.cuda.empty_cache()
    base = runs["pipelined/cuda"]
    for label, streams in runs.items():
        check(streams == base,
              f"{label} streams differ from pipelined/cuda")
    distinct = [len(set(s)) for s in base]
    check(min(distinct) > 1, f"degenerate streams: {distinct}")
    check(len({tuple(s) for s in base}) == len(base), "identical streams")
    log(f"serve: streams identical across pipelined/sync and cuda/torch; "
        f"distinct tokens per stream {distinct}")
    return launches, base


def device_rows(prof):
    """([(device us, launches, kernel name)] by time, device busy ms) of a
    ``torch.profiler`` run."""
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e3


def phase_profile(torch, card, label="pipelined", **kw):
    """Where a served run's device time goes: ``torch.profiler`` over one
    run with the kernel (phase 5: pipelined mode; phase 12 passes a
    speculative mode), device time summed by kernel name. The profiler's
    own host cost inflates the wall clock, so the idle share read here is
    an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from dpu_operator_tpu_torch.serving import PagedKVExecutor

    kw = kw or dict(mode="pipelined")
    ex = PagedKVExecutor(**SERVE, **kw, kernel="cuda", device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st = serve_once(torch, ex, serve_prompts(), card)
    rows, busy_ms = device_rows(prof)
    wall_ms = st["wall_s"] * 1e3
    log(f"profile {label}: {st['steps']} steps, device busy {busy_ms:.1f} "
        f"ms of {wall_ms:.1f} ms wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f}, profiled) [{card}]")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:10.3f} ms {us / 1e3 / busy_ms:6.3f}  x{count:<6d} "
            f"{key[:90]}")
    del ex
    torch.cuda.empty_cache()


# -- phase 6: the tile-product kernels against plain --------------------------


def bound(flops, nbytes):
    """(bound ms, what bounds it) for bf16 tensor-core work."""
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def tile_record(name, replaces, err, ms, plain_ms, flops, nbytes,
                library_ms=None):
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(name=name, route="cuda",
                source="dpu_operator_tpu_torch/csrc/tile_mma.cu",
                replaces=f"dpu_operator_tpu/parallel/{replaces}",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def randn_pair(torch, m, n, seed):
    """x [m, n] ~ N(0, 1) and w [n, n] ~ N(0, 1/n), bf16, drawn on the
    card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((m, n), generator=gen, device="cuda")
    w = torch.randn((n, n), generator=gen, device="cuda") / math.sqrt(n)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def compare(torch, burn, tag, got, want, ulps=None, atol=None):
    check(torch.isfinite(got.float()).all(), f"{tag}: non-finite kernel out")
    check(torch.isfinite(want.float()).all(), f"{tag}: non-finite plain out")
    err = float((got.float() - want.float()).abs().max())
    dist = burn.bf16_ulps(got, want)
    if ulps is not None and dist > ulps:
        raise AssertionError(f"{tag}: {dist} bf16 ulps from the plain "
                             f"version (max {ulps})")
    if atol is not None and err > atol:
        raise AssertionError(f"{tag}: max |err| {err} over {atol}")
    return err, dist


def phase_tiles(torch, card):
    from dpu_operator_tpu_torch.parallel import burn, fabric_probe, mxu_bench

    records = []
    n = fabric_probe.BURN_DIM
    x, w = fabric_probe.burn_example_args(device="cuda")
    got, want = burn.burn_chain(x, w), burn.burn_chain_plain(x, w)
    err, dist = compare(torch, burn, "burn_chain", got, want,
                        atol=CHAIN_ATOL)
    sig_k, sig_p = (float(torch.sum(h.float() ** 2)) for h in (got, want))
    check(abs(sig_k - sig_p) <= SIG_RTOL * abs(sig_p),
          f"burn_chain: signature {sig_k} vs plain {sig_p}")
    differ = float((got != want).float().mean())
    ms = time_ms(torch, lambda: burn.burn_chain(x, w))
    plain_ms = time_ms(torch, lambda: burn.burn_chain_plain(x, w))
    rec = tile_record("burn_chain", "pallas_burn.py:85", err, ms, plain_ms,
                      8 * 2 * n ** 3, 3 * n * n * 2)
    records.append(rec)
    log(f"tiles burn_chain {n}^2 x 8: max |err| {err:.3e} (atol "
        f"{CHAIN_ATOL}), {differ:.3f} of elements differ, signature "
        f"{sig_k:.2f} vs plain {sig_p:.2f} (rtol {SIG_RTOL}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    chain_cases(torch, card, burn, x, w, got)

    for i, (m, n) in enumerate(TILE_SHAPES):
        x, w = randn_pair(torch, m, n, seed=1 + i)
        err, dist = compare(torch, burn, f"burn_tile {m}x{n}",
                            burn.burn_tile(x, w), burn.burn_tile_plain(x, w),
                            ulps=STEP_ULPS)
        ms = time_ms(torch, lambda: burn.burn_tile(x, w))
        plain_ms = time_ms(torch, lambda: burn.burn_tile_plain(x, w))
        rec = tile_record("burn_tile", "pallas_burn.py:114", err, ms,
                          plain_ms, 2 * m * n * n, (m * n + n * n + m * n) * 2)
        if i == 0:
            records.append(rec)
        log(f"tiles burn_tile x {m}x{n} @ w {n}x{n}: {dist:.2f} ulps (max "
            f"{STEP_ULPS}), max |err| {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}) [{card}]")

    n = MM_N
    x, w = randn_pair(torch, n, n, seed=3)
    want = mxu_bench.matmul_plain(x, w)
    plain_ms = time_ms(torch, lambda: mxu_bench.matmul_plain(x, w), n=10,
                       warm=2)
    library_ms = time_ms(torch, lambda: torch.matmul(x, w))
    for name, cfg, replaces in MM_ROUTES:
        got = mxu_bench.pallas_matmul(x, w, *cfg)
        err, dist = compare(torch, burn, f"{name} {cfg}", got, want,
                            ulps=STEP_ULPS)
        ms = time_ms(torch, lambda: mxu_bench.pallas_matmul(x, w, *cfg))
        rec = tile_record(name, replaces, err, ms, plain_ms, 2 * n ** 3,
                          3 * n * n * 2, library_ms=library_ms)
        records.append(rec)
        log(f"tiles {name} {n}^3 blocks {cfg}: {dist:.2f} ulps (max "
            f"{STEP_ULPS}), max |err| {err:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul {library_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    first = mxu_bench.pallas_matmul(x, w, *MM_ROUTES[0][1])
    for i in range(TILE_REPEATS):
        check(torch.equal(mxu_bench.pallas_matmul(x, w, *MM_ROUTES[0][1]),
                          first), f"matmul repeat {i}: differs from the "
                                  f"first call's bits")
    tile_widths(torch, card, burn, mxu_bench, x, w)
    torch.cuda.empty_cache()
    return records


def chain_pair(torch, n, seed):
    """x [n, n] ~ N(0, 1) and w [n, n] ~ N(0, 0.05^2), bf16, drawn on the
    card: the health burn's own inputs (``burn_example_args``) at n."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.bfloat16)
    w = torch.randn((n, n), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.05
    return x, w


def chain_host_split(torch, burn, tile_mma, x, w):
    """{part: host us a call} of ``burn.burn_chain(x, w)`` (``host_us``):
    the whole call and each part of the wrapper, the checks, the scratch
    and output allocations, the views array (kept), the device and stream
    lookup, the library, and the C entry (three tensor-map encodes and
    the cooperative launch), with ``cudart_parts``."""
    from dpu_operator_tpu_torch.parallel import ring_probe as rp

    dev, n = x.device, x.shape[0]
    lib = tile_mma._library()
    h = torch.empty((2, n, n), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    stream = rp._raw_stream(dev)

    def c_launch():
        err = lib.burn_chain_launch(
            x.data_ptr(), w.data_ptr(), h.data_ptr(), out.data_ptr(),
            tile_mma._chain_views_arg(n), n, 8, stream)
        check(err == 0, f"burn_chain_launch: CUDA error {err}")

    return host_us(torch, {
        "checks": lambda: tile_mma.operands("burn_chain", x, w),
        "alloc": lambda: (torch.empty((2, n, n), dtype=torch.bfloat16,
                                      device=dev), torch.empty_like(x)),
        "views": lambda: tile_mma._chain_views_arg(n),
        "device_stream": lambda: (torch.cuda.current_device() != dev.index,
                                  rp._raw_stream(dev)),
        "library": tile_mma._library,
        "c_launch": c_launch,
        "call": lambda: burn.burn_chain(x, w),
        **cudart_parts(dev)})


def chain_cases(torch, card, burn, x, w, first):
    """The chain kernel off the health burn's size and length against
    plain (``CHAIN_SIZES`` x ``CHAIN_LENGTHS``), ``CHAIN_REPEATS`` repeats
    at the burn's own (x, w) equal to ``first`` bit for bit, a launch's
    device time beside the host's time to queue a call, and that time by
    part of the wrapper."""
    from dpu_operator_tpu_torch.parallel import tile_mma

    for n in CHAIN_SIZES:
        xs, ws = chain_pair(torch, n, seed=n)
        for length in CHAIN_LENGTHS:
            tag = f"burn_chain {n}^2 x {length}"
            got = burn.burn_chain(xs, ws, length)
            want = burn.burn_chain_plain(xs, ws, length)
            err, dist = compare(torch, burn, tag, got, want,
                                ulps=STEP_ULPS if length == 1 else None,
                                atol=CHAIN_ATOL)
            sig_k, sig_p = (float(torch.sum(h.float() ** 2))
                            for h in (got, want))
            check(abs(sig_k - sig_p) <= SIG_RTOL * abs(sig_p),
                  f"{tag}: signature {sig_k} vs plain {sig_p}")
            log(f"tiles {tag}: max |err| {err:.3e} (atol {CHAIN_ATOL}), "
                f"{dist:.2f} ulps, signature rel err "
                f"{abs(sig_k - sig_p) / abs(sig_p):.2e} (rtol {SIG_RTOL})")
    for i in range(CHAIN_REPEATS):
        check(torch.equal(burn.burn_chain(x, w), first),
              f"burn_chain repeat {i}: differs from the first call's bits")
    ms = time_ms(torch, lambda: burn.burn_chain(x, w))
    launch_ms, host_ms, how = device_ms(torch, lambda: burn.burn_chain(x, w),
                                        "chain_kernel")
    split = chain_host_split(torch, burn, tile_mma, x, w)
    log(f"tiles burn_chain {x.shape[0]}^2 x 8: {CHAIN_REPEATS} repeats "
        f"bitwise; {ms:.4f} ms by events, a launch {launch_ms:.4f} ms "
        f"({how}), the host queues a call in {host_ms:.4f} ms: the card "
        f"{'waits on' if host_ms > launch_ms else 'runs ahead of'} the "
        f"host; host us a call by part: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" [{card}]")


def tile_widths(torch, card, burn, mxu_bench, x, w):
    """The tile kernel at each width it is built for: off its grid
    against plain, then timed at the matmul's 4096^3 (x, w) and the burn
    tile's 2048^2, with a launch's device time and the host's time to
    queue a call at the width the wrappers launch."""
    from dpu_operator_tpu_torch import cuda_build
    from dpu_operator_tpu_torch.parallel import tile_mma

    log(f"tiles ptxas: {check_wgmma_build(cuda_build, 'tile_mma')}")
    m, k, n = TILE_ODD
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    xo = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wo = (torch.randn((k, n), generator=gen, device="cuda")
          / math.sqrt(k)).to(torch.bfloat16)
    for width in tile_mma.TILE_WIDTHS:
        for tanh, plain in ((False, mxu_bench.matmul_plain),
                            (True, burn.burn_tile_plain)):
            tag = f"tile {m}x{k}x{n} 128x{width} tanh={tanh}"
            _, dist = compare(torch, burn, tag, tile_mma.product_of_width(
                tag, xo, wo, tanh, width), plain(xo, wo), ulps=STEP_ULPS)
            log(f"tiles {tag}: {dist:.2f} ulps (max {STEP_ULPS})")
    xb, wb = randn_pair(torch, 2048, 2048, seed=1)
    times = {}
    for width in tile_mma.TILE_WIDTHS:
        times[width] = (
            time_ms(torch, lambda: tile_mma.product_of_width(
                "width", x, w, False, width)),
            time_ms(torch, lambda: tile_mma.product_of_width(
                "width", xb, wb, True, width)))
    faster = min(times, key=lambda wd: times[wd][0])
    log("tiles widths: " + "; ".join(
        f"128x{wd} matmul {times[wd][0]:.4f} ms "
        f"({2 * x.shape[0] * x.shape[1] * w.shape[1] / times[wd][0] / 1e9:.1f}"
        f" TFLOP/s), burn tile 2048^2 {times[wd][1]:.4f} ms"
        for wd in tile_mma.TILE_WIDTHS)
        + f"; faster at 4096^3: 128x{faster}; the wrappers launch "
          f"128x{tile_mma.TILE_WIDTH} [{card}]")
    for tag, fn in (("burn tile 2048^2", lambda: burn.burn_tile(xb, wb)),
                    ("matmul 4096^3", lambda: mxu_bench.pallas_matmul(
                        x, w, *MM_ROUTES[0][1]))):
        launch_ms, host_ms, how = device_ms(torch, fn, "tile_kernel")
        log(f"tiles {tag}: a launch {launch_ms:.4f} ms ({how}), the host "
            f"queues a call in {host_ms:.4f} ms: the card "
            f"{'waits on' if host_ms > launch_ms else 'runs ahead of'} the "
            f"host [{card}]")


# -- phase 7: the health/bench path -------------------------------------------


def phase_health(torch, card, name):
    """Drive the health/bench path with every tile-kernel count set to 0
    first; return each kernel's launches on it (this process's, plus those
    the bench process reports of its own)."""
    from dpu_operator_tpu_torch.parallel import burn, fabric_probe, mxu_bench

    counters = {"burn_chain": burn.burn_chain, "burn_tile": burn.burn_tile,
                "mm_fullk": mxu_bench.mm_fullk,
                "mm_kblocked": mxu_bench.mm_kblocked}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    sig = float(burn.best_burn_step()(
        *fabric_probe.burn_example_args(device="cuda")))
    wall_ms = (time.monotonic() - t0) * 1e3
    check(math.isfinite(sig) and sig > 0, f"health signature {sig}")
    check(burn.burn_chain.launches == 1 and burn.burn_tile.launches == 0,
          f"health burn at {fabric_probe.BURN_DIM}^2: "
          f"{burn.burn_chain.launches} chain, {burn.burn_tile.launches} "
          f"tile launches (want 1, 0)")
    log(f"health {fabric_probe.BURN_DIM}^2: signature {sig:.2f}, one chain "
        f"launch, {wall_ms:.3f} ms wall (inputs drawn, burn, readback) "
        f"[{card}]")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.randn((2048, 2048), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn((2048, 2048), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.05
    t0 = time.monotonic()
    sig = float(burn.best_burn_step()(x, w))
    wall_ms = (time.monotonic() - t0) * 1e3
    check(burn.burn_tile.launches == 8 and burn.burn_chain.launches == 1,
          f"health burn at 2048^2: {burn.burn_tile.launches} tile "
          f"launches (want 8)")
    h = x
    for _ in range(8):
        h = burn.burn_tile_plain(h, w)
    sig_p = float(torch.sum(h.float() ** 2))
    check(math.isfinite(sig) and abs(sig - sig_p) <= SIG2048_RTOL * sig_p,
          f"health 2048^2 signature {sig} vs plain {sig_p}")
    log(f"health 2048^2: signature {sig:.2f} (plain {sig_p:.2f}, rtol "
        f"{SIG2048_RTOL}), eight tile launches, {wall_ms:.3f} ms wall "
        f"(burn, readback) [{card}]")

    t0 = time.monotonic()
    cfg, best = mxu_bench.best_pallas_config(n=MM_N, reps=1, device="cuda")
    log(f"health sweep: best blocks {cfg} at {best['tflops']:.1f} TFLOP/s "
        f"({best['utilization_vs_peak']:.3f} of peak), reps=1, "
        f"{time.monotonic() - t0:.1f} s [{card}]")

    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=HERE)
    res = subprocess.run(
        [sys.executable, "-m", "dpu_operator_tpu_torch.parallel.bench_gpu"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0,
          f"bench_gpu exit {res.returncode}: {res.stderr[-2000:]}")
    bench = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"bench_gpu ({time.monotonic() - t0:.1f} s) [{card}]: "
        f"{json.dumps(bench)}")
    errors = [k for k in bench if k.endswith("_error")]
    check(not errors, f"bench_gpu sections failed: {errors}")
    check(bench["device_kind"] == name, f"bench ran on {bench['device_kind']}")
    for key in ("mxu_torch_tflops", "mxu_kernel_tflops", "burn_torch_tflops",
                "burn_kernel_tflops", "hbm_gbps", "ring_gbps",
                "ring_bidir_gbps"):
        check(bench[key] > 0, f"bench_gpu {key} = {bench[key]}")
    log(f"bench_gpu burn at {fabric_probe.BURN_DIM}^2 x 8: the chain kernel "
        f"{bench['burn_kernel_tflops']} TFLOP/s "
        f"{bench['burn_kernel_tflops_minmax']} against the composition of "
        f"8 (torch.matmul + tanh) {bench['burn_torch_tflops']} TFLOP/s "
        f"{bench['burn_torch_tflops_minmax']} (16 launches a chain, not "
        f"one library call) [{card}]")
    check(bench["ring_ranks_share_card"] is True
          and bench["ring_axis_size"] == RING_MESH["sp"],
          f"bench_gpu ring block: {bench['ring_axis_size']} ranks")
    for key in ("ring_all_gather", "ring_all_gather_bidir"):
        check(bench["kernel_launches"][key] > 0,
              f"bench_gpu launched no {key} kernel")
    launches = {k: fn.launches + bench["kernel_launches"][k]
                for k, fn in counters.items()}
    check(all(launches.values()), f"a kernel the path runs never launched: "
                                  f"{launches}")
    log(f"health/bench launches: {launches}")
    torch.cuda.empty_cache()
    return launches


# -- phase 8: ring attention ---------------------------------------------------


def ring_inputs(torch, S, dk, dv, dtype, seed):
    """q [S, dk], k [S, dk], v [S, dv] ~ N(0, 1), drawn on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn((S, d), generator=gen, device="cuda").to(dtype)
                 for d in (dk, dk, dv))


def ring_cost(S, n, dk, dv, causal, kv_item, q_item):
    """(bytes, flops, TF32 flops) of one ring attention over S rows cut
    into n shards: q, k, v read once, out written once, and each rank's
    relay of n - 1 packed K/V shards; 2 (dk + dv) flops per (row, key)
    pair attended; and those flops times the kernel's split passes (q . k
    3, less one for each bf16 operand; p . v 3, 2 with bf16 V)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    sk = S // n
    nbytes = (S * dk * q_item + S * (dk + dv) * kv_item + S * dv * q_item
              + n * (n - 1) * sk * (dk + dv) * kv_item)
    qk_passes = 1 + (q_item == 4) + (kv_item == 4)
    pv_passes = 2 + (kv_item == 4)
    return (nbytes, 2 * (dk + dv) * pairs,
            2 * pairs * (dk * qk_passes + dv * pv_passes))


def sdpa_kernels(torch, q4, k4, v4, causal, calls=5):
    """Names of the CUDA kernels that ``torch.profiler`` records for
    ``scaled_dot_product_attention`` calls: which of PyTorch's attention
    kernels the yardstick is. Up to ``PROFILE_WINDOWS`` windows of
    ``calls`` calls, as ``device_ms`` reads them: the profiler at times
    drops every launch record of a window."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal)
            torch.cuda.synchronize()
        names = sorted({evt.name for evt in prof.events()
                        if str(evt.device_type).endswith("CUDA")})
        if names:
            return names
    return [f"(no device event recorded in {PROFILE_WINDOWS} windows)"]


def check_ring_attn_build(cuda_build):
    """The ring attention kernel's eight instances (q f32/bf16 x K/V
    f32/bf16 x two widths) as ptxas reported them in this run: no spills.
    Returns a line for the log."""
    text = cuda_build.build_logs.get("ring_attn")
    if text is None:
        return ("ring_attn: ptxas report not in this run (the library was "
                "built earlier in this checkout)")
    kernels = {}
    for name, regs in ptxas_entries(text).items():
        found = re.search(r"ring_attn_kernelI(.*?)Li(\d+)ELi(\d+)E", name)
        if found:
            # bf16 mangles as its name, or as a back-reference once named
            types = re.sub(r"S\d*_", "b",
                           found[1].replace("13__nv_bfloat16", "b"))
            tag = "/".join("bf16" if c == "b" else "f32" for c in types)
            kernels[f"{tag} {found[2]} keys x dv {8 * int(found[3])}"] = regs
    check(len(kernels) == 8, f"ring_attn: ptxas reported {sorted(kernels)}")
    for name, (regs, stores, loads) in kernels.items():
        check(stores == 0 and loads == 0,
              f"ring_attn {name}: {stores} B spill stores, {loads} B loads")
    return ", ".join(f"{name} {regs} registers, 0 spills"
                     for name, (regs, _, _) in sorted(kernels.items()))


def ring_compare(torch, burn, tag, got, want):
    """Max |err| of the kernel's output against the plain version's (or
    another reference), within the f32 or the bf16 bar; raises
    otherwise."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tag}: {got.dtype} {tuple(got.shape)} vs plain {want.dtype} "
          f"{tuple(want.shape)}")
    check(torch.isfinite(got.float()).all(), f"{tag}: non-finite kernel out")
    check(torch.isfinite(want.float()).all(), f"{tag}: non-finite plain out")
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ulps = burn.bf16_ulps(got, want, floor=RING_ULP_FLOOR)
        check(ulps <= RING_ULPS, f"{tag}: {ulps} bf16 ulps from the "
                                 f"reference (max {RING_ULPS})")
        return err, f"{ulps:.2f} ulps (max {RING_ULPS})"
    if not torch.allclose(got, want, rtol=RING_RTOL, atol=RING_ATOL):
        raise AssertionError(f"{tag}: differs from the reference by {err}")
    return err, f"rtol {RING_RTOL}, atol {RING_ATOL}"


def phase_ring(torch, card):
    """Ring attention: small rings against the plain version, then the
    main path (``make_ring_attention`` at full width, counts set to 0
    just before), each output against the plain version, 20 repeats
    bitwise equal, and times of the kernel, the plain version and one
    ``scaled_dot_product_attention`` call."""
    from dpu_operator_tpu_torch import cuda_build
    from dpu_operator_tpu_torch.parallel import burn
    from dpu_operator_tpu_torch.parallel import ring_attention as ra

    log(f"ring: ptxas {check_ring_attn_build(cuda_build)}")
    n = RING_MESH["sp"]
    for i, (ns, S, dk, dv, in_bf16) in enumerate(RING_SMALL):
        q, k, v = (t.to(torch.bfloat16) if name in in_bf16 else t
                   for name, t in zip("qkv", ring_inputs(
                       torch, S, dk, dv, torch.float32, seed=10 + i)))
        for causal in (False, True):
            tag = (f"ring n={ns} S={S} dk={dk} dv={dv} bf16 inputs "
                   f"{in_bf16 or '-'} causal={causal}")
            err, bar = ring_compare(
                torch, burn, tag, ra.ring_attention_cuda(q, k, v, ns, causal),
                ra.ring_attention_plain(q, k, v, ns, causal))
            log(f"{tag}: max |err| {err:.3e} ({bar})")
    ns, S, dk, dv = RING_SCALED
    q, k, v = ring_inputs(torch, S, dk, dv, torch.float32, seed=19)
    q = q * RING_Q_SCALE
    for causal in (False, True):
        tag = (f"ring n={ns} S={S} dk={dk} dv={dv} f32, q x {RING_Q_SCALE}, "
               f"causal={causal}")
        want = ra.ring_attention_plain(q, k, v, ns, causal)
        err, bar = ring_compare(torch, burn, tag,
                                ra.ring_attention_cuda(q, k, v, ns, causal),
                                want)
        one = ra.ring_attention_split(q, k, v, ns, causal, single=True)
        check(not torch.allclose(one, want, rtol=RING_RTOL, atol=RING_ATOL),
              f"{tag}: one TF32 pass meets the f32 bar; the case does not "
              f"bite")
        log(f"{tag}: max |err| {err:.3e} ({bar}); one TF32 pass (emulated) "
            f"{float((one - want).abs().max()):.3e}, outside the bar")

    cases = [(S, dtype, causal)
             for S, dtypes in ((RING_S, (torch.float32, torch.bfloat16)),
                               (RING_AOT_S, (torch.bfloat16,)))
             for dtype in dtypes for causal in (False, True)]
    shapes = sorted({(S, dtype) for S, dtype, _ in cases}, key=str)
    inputs = {key: ring_inputs(torch, key[0], RING_D, RING_D, key[1],
                               seed=20 + j)
              for j, key in enumerate(shapes)}
    ra.ring_attention_cuda.launches = 0
    outs = {}
    t0 = time.monotonic()
    for S, dtype, causal in cases:
        fn = ra.make_ring_attention(RING_MESH, "sp", causal)
        outs[(S, dtype, causal)] = fn(*inputs[(S, dtype)])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ra.ring_attention_cuda.launches
    check(launches == len(cases),
          f"ring main path: {launches} kernel launches for {len(cases)} calls")
    log(f"ring main path: {len(cases)} calls of make_ring_attention "
        f"({RING_MESH}), {launches} kernel launches, {wall:.3f} s wall "
        f"[{card}]")

    record = None
    for S, dtype, causal in cases:
        q, k, v = inputs[(S, dtype)]
        got = outs[(S, dtype, causal)]
        tag = (f"ring S={S} n={n} d={RING_D} {str(dtype)[6:]} "
               f"causal={causal}")
        err, bar = ring_compare(torch, burn, tag, got,
                                ra.ring_attention_plain(q, k, v, n, causal))
        ms = time_ms(torch, lambda: ra.ring_attention_cuda(q, k, v, n, causal),
                     n=5, warm=1, batch=2)
        plain_ms = time_ms(torch,
                           lambda: ra.ring_attention_plain(q, k, v, n, causal),
                           n=3, warm=1, batch=1)
        q4, k4, v4 = (t[None, None] for t in (q, k, v))
        library_ms = time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), n=5, warm=1, batch=2)
        if S == RING_S and causal:
            log(f"{tag}: scaled_dot_product_attention runs "
                f"{', '.join(sdpa_kernels(torch, q4, k4, v4, causal))}")
        item = 2 if dtype == torch.bfloat16 else 4
        nbytes, flops, tf32_flops = ring_cost(S, n, RING_D, RING_D, causal,
                                              item, item)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_fma = flops / FP32_FLOP_PER_S * 1e3
        t_ops = tf32_flops / TF32_FLOP_PER_S * 1e3
        log(f"{tag}: max |err| {err:.3e} ({bar}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms on the "
            f"TF32 split ({tf32_flops} flop of passes at "
            f"{TF32_FLOP_PER_S:.3g}/s), {max(t_bytes, t_fma):.4f} ms on "
            f"the f32 FMA pipes ({flops} flop at {FP32_FLOP_PER_S:.3g}/s), "
            f"{t_bytes:.4f} ms of bytes ({nbytes} B) [{card}]")
        if S == RING_S and dtype == torch.float32 and causal:
            record = dict(
                name="ring_attn", route="cuda",
                source="dpu_operator_tpu_torch/csrc/ring_attn.cu",
                replaces="dpu_operator_tpu/parallel/ring_attention.py:184",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)

    q, k, v = inputs[(RING_S, torch.float32)]
    first = outs[(RING_S, torch.float32, True)]
    for i in range(RING_REPEATS):
        again = ra.ring_attention_cuda(q, k, v, n, True)
        if not torch.equal(bits(torch, again), bits(torch, first)):
            raise AssertionError(f"ring repeat {i}: output differs from the "
                                 f"first call's bits")
    log(f"ring: {RING_REPEATS} repeated calls at S={RING_S}, n={n}, f32 "
        f"causal give the first call's output bit for bit")
    del inputs, outs
    torch.cuda.empty_cache()
    return record


# -- phase 9: the ring collectives --------------------------------------------


def coll_payload(torch, rows, width, dtype, seed):
    """[rows, width] of ``dtype`` drawn on the card: N(0, 1), or integers
    in +-1000."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (rows, width), generator=gen,
                             device="cuda", dtype=dtype)
    return torch.randn((rows, width), generator=gen, device="cuda").to(dtype)


def same_bits(torch, a, b):
    """Equal shape, type and bits (2- and 4-byte types)."""
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(as_int), b.view(as_int)))


def check_gather(torch, rp, tag, x, n, bidirectional):
    """One launch of the all-gather: every rank's copy is x bit for bit
    and equals the plain version's; the launch is counted under the ring
    that ran. Returns the kernel's output."""
    want_bidir = bidirectional and (x.shape[0] // n) % 2 == 0
    before = (rp.ring_all_gather_cuda.launches,
              rp.ring_all_gather_cuda.launches_bidir)
    got = rp.ring_all_gather_cuda(x, n, bidirectional)
    torch.cuda.synchronize()
    after = (rp.ring_all_gather_cuda.launches,
             rp.ring_all_gather_cuda.launches_bidir)
    check(after == (before[0] + (not want_bidir), before[1] + want_bidir),
          f"{tag}: launch counted as {after} after {before}")
    check(got.shape == (n,) + tuple(x.shape) and got.dtype == x.dtype,
          f"{tag}: {got.dtype} {tuple(got.shape)}")
    for r in range(n):
        check(same_bits(torch, got[r], x),
              f"{tag}: rank {r}'s copy differs from x")
    check(same_bits(torch, got, rp.ring_all_gather_plain(x, n,
                                                          bidirectional)),
          f"{tag}: differs from the plain version")
    return got


def check_scatter(torch, rp, tag, x, n):
    """One launch of the reduce-scatter: the plain version's bits, and a
    float64 sum within the bar. Returns (output, max |err| against the
    plain version, against float64)."""
    before = rp.ring_reduce_scatter_cuda.launches
    got = rp.ring_reduce_scatter_cuda(x, n)
    torch.cuda.synchronize()
    check(rp.ring_reduce_scatter_cuda.launches == before + (n > 1),
          f"{tag}: {rp.ring_reduce_scatter_cuda.launches - before} launches")
    want = rp.ring_reduce_scatter_plain(x, n)
    check(same_bits(torch, got, want), f"{tag}: differs from the plain "
                                       f"version's bits")
    rows = x.shape[0] // n
    exact = x.double().view(n, rows, -1).sum(0)
    err = float((got.double() - exact).abs().max())
    if x.dtype == torch.int32:
        check(err == 0, f"{tag}: integer sum off by {err}")
    elif x.dtype == torch.float32:
        check(torch.allclose(got.double(), exact, rtol=RS_RTOL,
                             atol=RS_ATOL),
              f"{tag}: {err} from the float64 sum")
    return got, float((got.double() - want.double()).abs().max()), err


def phase_collectives(torch, card):
    """The ring collectives: small rings against x and the plain
    versions, then the main path (``measure_ring_bandwidth``,
    ``make_ring_reduce_scatter`` and the all-reduce composition at full
    width, counts set to 0 just before), 20 repeats bitwise equal, and
    times of each kernel, its plain version and one PyTorch call."""
    from dpu_operator_tpu_torch.parallel import ring_probe as rp

    mesh = RING_MESH
    n = mesh["sp"]
    for i, (ns, rows, width, tname) in enumerate(COLL_SMALL):
        dtype = getattr(torch, tname)
        x = coll_payload(torch, ns * rows, width, dtype, seed=40 + i)
        for bidirectional in (False, True):
            check_gather(torch, rp, f"all-gather n={ns} [{ns * rows}, "
                         f"{width}] {tname} bidirectional={bidirectional}",
                         x, ns, bidirectional)
        X = coll_payload(torch, ns * ns * rows, width, dtype, seed=60 + i)
        _, err, err64 = check_scatter(
            torch, rp, f"reduce-scatter n={ns} [{ns * ns * rows}, {width}] "
            f"{tname}", X, ns)
        log(f"collectives n={ns} rows/rank {rows} width {width} {tname}: "
            f"all-gather (one way, both ways) every rank's copy == x bit "
            f"for bit; reduce-scatter == plain bit for bit (max |err| "
            f"{err:.1e}), {err64:.3e} from the float64 sum")

    # The main path, counts at 0.
    rows = COLL_MBYTES * 2 ** 20 // (4 * COLL_WIDTH)
    rp.ring_all_gather_cuda.launches = 0
    rp.ring_all_gather_cuda.launches_bidir = 0
    rp.ring_reduce_scatter_cuda.launches = 0
    probes = {}
    for mbytes in (COLL_MBYTES, COLL_BIG_MBYTES):
        for bidirectional in (False, True):
            res = rp.measure_ring_bandwidth(
                mesh, "sp", mbytes=mbytes, rounds=COLL_ROUNDS,
                bidirectional=bidirectional)
            mode = "bidir" if bidirectional else "unidir"
            check(res["mode"] == mode and res["axis_size"] == n
                  and res["ici_adjacent"] is None
                  and res["effective_gbps"] > 0
                  and res["seconds_per_round"] > 0,
                  f"measure_ring_bandwidth {mbytes} MiB {mode}: {res}")
            probes[(mbytes, mode)] = res
            log(f"collectives measure_ring_bandwidth {mbytes} MiB {mode}: "
                f"{res['seconds_per_round'] * 1e3:.4f} ms/round wall, "
                f"{res['effective_gbps']:.2f} Gbit/s effective "
                f"({n} ranks share the card: the protocol and copies "
                f"within its memory, no link) [{card}]")
    X = coll_payload(torch, n * rows, COLL_WIDTH, torch.float32, seed=30)
    rs = rp.make_ring_reduce_scatter(mesh, "sp")
    ag = rp.make_ring_all_gather(mesh, "sp")
    rs_out = rs(X)
    allred = ag(rs(X))
    torch.cuda.synchronize()
    calls = 2 * (1 + COLL_ROUNDS)
    launches = {"ring_all_gather": rp.ring_all_gather_cuda.launches,
                "ring_all_gather_bidir":
                    rp.ring_all_gather_cuda.launches_bidir,
                "ring_reduce_scatter": rp.ring_reduce_scatter_cuda.launches}
    want = {"ring_all_gather": calls, "ring_all_gather_bidir": calls + 1,
            "ring_reduce_scatter": 2}
    check(launches == want, f"collectives main path: launches {launches}, "
                            f"calls {want}")
    rs_plain = rp.ring_reduce_scatter_plain(X, n)
    check(same_bits(torch, rs_out, rs_plain),
          "make_ring_reduce_scatter differs from the plain version's bits")
    exact = X.double().view(n, rows, -1).sum(0)
    check(torch.allclose(rs_out.double(), exact, rtol=RS_RTOL, atol=RS_ATOL),
          "make_ring_reduce_scatter is off the float64 sum")
    rs_err64 = float((rs_out.double() - exact).abs().max())
    check(same_bits(torch, allred,
                    rp.ring_all_gather_plain(rs_plain, n, True)[0]),
          "all-reduce ag(rs(X)) differs from the plain composition's bits")
    log(f"collectives main path: launches {launches}; reduce-scatter "
        f"[{n * rows}, {COLL_WIDTH}] f32 == plain bit for bit, "
        f"{rs_err64:.3e} from the float64 sum (rtol {RS_RTOL}, atol "
        f"{RS_ATOL}); all-reduce ag(rs(X)) == plain composition bit for bit")
    del rs_out, allred, exact

    # Every rank's copy at full width, repeats, times.
    x = coll_payload(torch, rows, COLL_WIDTH, torch.float32, seed=31)
    nbytes = x.numel() * 4
    chunk_bytes = nbytes // n
    records = []
    library_ms = time_ms(torch, lambda: x.expand(n, *x.shape).contiguous(),
                         n=10, warm=2)
    for name, bidirectional, line in (("ring_all_gather", False, 335),
                                      ("ring_all_gather_bidir", True, 299)):
        first = check_gather(torch, rp, f"{name} {COLL_MBYTES} MiB", x, n,
                             bidirectional)
        for i in range(RING_REPEATS):
            again = rp.ring_all_gather_cuda(x, n, bidirectional)
            check(same_bits(torch, again, first),
                  f"{name} repeat {i}: differs from the first call's bits")
        del again
        ms = time_ms(torch, lambda: rp.ring_all_gather_cuda(
            x, n, bidirectional), n=10, warm=2)
        plain_ms = time_ms(torch, lambda: rp.ring_all_gather_plain(
            x, n, bidirectional), n=5, warm=1, batch=2)
        t_bytes = (nbytes + n * nbytes) / HBM_BYTES_PER_S * 1e3
        moved = rp.all_gather_moved_bytes(n, chunk_bytes)
        log(f"collectives {name} [{rows}, {COLL_WIDTH}] f32 n={n}: every "
            f"rank's copy == x bit for bit, {RING_REPEATS} repeats bitwise "
            f"equal; kernel {ms:.4f} ms ({ms / (n - 1) * 1e3:.1f} us per "
            f"ring step), plain {plain_ms:.4f} ms, expand().contiguous() "
            f"{library_ms:.4f} ms, bound {t_bytes:.4f} ms ({nbytes} B read, "
            f"{n * nbytes} B written; the protocol reads and writes {moved} "
            f"B, {moved / ms / 1e9:.2f} TB/s: each rank reads its shard "
            f"once and writes it into its own and its neighbour's output, "
            f"then relays {n - 2} blocks from its output into the "
            f"neighbour's) [{card}]")
        records.append(dict(
            name=name, route="cuda",
            source="dpu_operator_tpu_torch/csrc/ring_collectives.cu",
            replaces=f"dpu_operator_tpu/parallel/ring_probe.py:{line}",
            launches=launches[name], max_abs_err=float(
                (first - x).abs().max()), ms=ms, plain_ms=plain_ms,
            bound_ms=t_bytes, bound_by="bytes", library_ms=library_ms))
        del first
    for mbytes in (COLL_ATTN_MBYTES, COLL_BIG_MBYTES):
        big = coll_payload(torch, mbytes * 2 ** 20 // (4 * COLL_WIDTH),
                           COLL_WIDTH, torch.float32, seed=32)
        for bidirectional in (False, True):
            check_gather(torch, rp, f"all-gather {mbytes} MiB", big, n,
                         bidirectional)
            ms = time_ms(torch, lambda: rp.ring_all_gather_cuda(
                big, n, bidirectional), n=5, warm=1, batch=2)
            t_bytes = (1 + n) * mbytes * 2 ** 20 / HBM_BYTES_PER_S * 1e3
            moved = rp.all_gather_moved_bytes(n, mbytes * 2 ** 20 // n)
            log(f"collectives all-gather {mbytes} MiB f32 n={n} "
                f"bidirectional={bidirectional}: every rank's copy == x; "
                f"kernel {ms:.4f} ms ({ms / (n - 1) * 1e3:.1f} us per ring "
                f"step of {mbytes // n} MiB blocks), bound {t_bytes:.4f} ms; "
                f"the protocol reads and writes {moved} B, "
                f"{moved / ms / 1e9:.2f} TB/s [{card}]")
        del big
        torch.cuda.empty_cache()

    first, err, _ = check_scatter(torch, rp, f"reduce-scatter "
                                  f"{COLL_MBYTES} MiB per rank", X, n)
    for i in range(RING_REPEATS):
        again = rp.ring_reduce_scatter_cuda(X, n)
        check(same_bits(torch, again, first),
              f"reduce-scatter repeat {i}: differs from the first call's "
              f"bits")
    ms = time_ms(torch, lambda: rp.ring_reduce_scatter_cuda(X, n), n=10,
                 warm=2)
    plain_ms = time_ms(torch, lambda: rp.ring_reduce_scatter_plain(X, n),
                       n=5, warm=1, batch=2)
    library_ms = time_ms(
        torch, lambda: X.view(n, n, rows // n, COLL_WIDTH).sum(0), n=10,
        warm=2)
    t_bytes = (n * nbytes + nbytes) / HBM_BYTES_PER_S * 1e3
    moved = rp.reduce_scatter_moved_bytes(n, chunk_bytes)
    allreduce_ms = time_ms(torch, lambda: ag(rs(X)), n=10, warm=2)
    log(f"collectives ring_reduce_scatter [{n * rows}, {COLL_WIDTH}] f32 "
        f"n={n}: == plain bit for bit, {RING_REPEATS} repeats bitwise "
        f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"view().sum(0) {library_ms:.4f} ms, bound {t_bytes:.4f} ms "
        f"({n * nbytes} B read, {nbytes} B written; the protocol reads "
        f"and writes {moved} B, {moved / ms / 1e9:.2f} TB/s: each rank, "
        f"{n - 1} times, reads two blocks and writes one, the first "
        f"arrival read in place from its neighbour's x); all-reduce "
        f"ag(rs(X)) {allreduce_ms:.4f} ms [{card}]")
    records.append(dict(
        name="ring_reduce_scatter", route="cuda",
        source="dpu_operator_tpu_torch/csrc/ring_collectives.cu",
        replaces="dpu_operator_tpu/parallel/ring_probe.py:644",
        launches=launches["ring_reduce_scatter"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=t_bytes, bound_by="bytes",
        library_ms=library_ms))
    del X, x, first, again
    torch.cuda.empty_cache()
    return records


# -- phase 10: the all-to-all and Ulysses attention ----------------------------


PROFILE_WINDOWS = 3


def device_ms(torch, fn, kernel, calls=20):
    """(device ms, host ms, how the device ms was read): the median device
    time of one launch of the kernel whose name holds ``kernel``, over the
    launches that ``torch.profiler`` recorded in up to ``PROFILE_WINDOWS``
    windows of ``calls`` calls of ``fn``, and the host's time to queue
    one call, unprofiled. ``time_ms`` reads the larger of the two: where
    the card runs a call faster than the host queues the next, the
    host's. On an H100 the profiler drops launch records, at times every
    one of a window's (a total over the recorded ones divided by
    ``calls`` reads short). Where no window recorded one, the device ms is
    the median gap between CUDA events recorded between back-to-back
    calls: a launch's own time where the host queues faster than the card
    runs, the host's otherwise."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = []
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [evt.time_range.elapsed_us() for evt in prof.events()
              if str(evt.device_type).endswith("CUDA") and kernel in evt.name]
        if us:
            break
    if us:
        launch_ms = statistics.median(us) / 1e3
        how = (f"profiled over {len(us)} of {calls} launches in window "
               f"{window}")
    else:
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(calls + 1)]
        marks[0].record()
        for mark in marks[1:]:
            fn()
            mark.record()
        torch.cuda.synchronize()
        launch_ms = statistics.median(
            a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        how = (f"the profiler recorded none of {PROFILE_WINDOWS * calls} "
               f"launches; median of CUDA events between {calls} "
               f"back-to-back calls")
    t0 = time.monotonic()
    for _ in range(calls):
        fn()
    host_ms = (time.monotonic() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return launch_ms, host_ms, how


def host_us(torch, parts, calls=200):
    """{part: host us a call}: each callable of ``parts`` timed alone,
    ``calls`` times in a row with ``time.perf_counter_ns`` between two
    synchronizations (the card runs each launch faster than ``calls``
    fill its queue, so the host is what is timed)."""
    us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
    return us


def cudart_parts(dev):
    """The CUDA runtime's cudaGetDevice and one cudaDeviceGetAttribute
    (the queries the cooperative launcher once made on every launch), as
    host-time parts, where the runtime library is found."""
    import ctypes

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in ("libcudart.so", "libcudart.so.12",
                 os.path.join(home, "lib64", "libcudart.so")):
        try:
            runtime = ctypes.CDLL(path)
        except OSError:
            continue
        value = ctypes.c_int()
        return {"cudart_get_device": lambda: runtime.cudaGetDevice(
                    ctypes.byref(value)),
                # cudaDevAttrCooperativeLaunch is 95
                "cudart_attribute": lambda: runtime.cudaDeviceGetAttribute(
                    ctypes.byref(value), 95, dev.index)}
    return {}


def a2a_host_split(torch, rp, x, n):
    """{part: host us a call} of ``rp.all_to_all_cuda(x, n)`` (``host_us``):
    the whole call and each part of the wrapper, the checks, the output's
    allocation, the device and stream lookup, the kept launch state and
    its epoch, and the C entry (the launcher's kept card queries and the
    cooperative launch), with ``cudart_parts``."""
    dev = x.device
    rank_bytes = x.shape[0] // n * x.shape[1] * x.element_size()
    lib = rp._a2a_library()
    out = torch.empty_like(x)
    stream = rp._raw_stream(dev)
    state = rp._a2a_launch(dev, stream, n, out.data_ptr(), rank_bytes)

    def checks():
        rp._a2a_rows(x, n)
        rp._kernel_input(x, n, "all_to_all_cuda")

    def c_launch():
        state.control.epoch += 1
        err = lib.all_to_all_launch(x.data_ptr(), state.outs, state.flags, n,
                                    rank_bytes // n, state.control.epoch,
                                    stream)
        check(err == 0, f"all_to_all_launch: CUDA error {err}")

    return host_us(torch, {
        "checks": checks,
        "alloc": lambda: torch.empty_like(x),
        "device_stream": lambda: (torch.cuda.current_device() != dev.index,
                                  rp._raw_stream(dev)),
        "launch_state": lambda: rp._next_epoch(rp._a2a_launch(
            dev, stream, n, out.data_ptr(), rank_bytes).control),
        "c_launch": c_launch,
        "library": rp._a2a_library,
        "call": lambda: rp.all_to_all_cuda(x, n),
        **cudart_parts(dev)})


def check_a2a(torch, rp, tag, x, n):
    """One launch of the all-to-all (none for n = 1): the plain version's
    bits and the transpose's. Returns the kernel's output."""
    before = rp.all_to_all_cuda.launches
    got = rp.all_to_all_cuda(x, n)
    torch.cuda.synchronize()
    check(rp.all_to_all_cuda.launches == before + (n > 1),
          f"{tag}: {rp.all_to_all_cuda.launches - before} launches")
    chunk = x.shape[0] // (n * n)
    lib = x.view(n, n, chunk, x.shape[1]).transpose(0, 1).reshape(x.shape)
    check(same_bits(torch, got, rp.all_to_all_plain(x, n)),
          f"{tag}: differs from the plain version's bits")
    check(same_bits(torch, got, lib), f"{tag}: differs from the transpose")
    return got


def uly_inputs(torch, dtype, seed):
    """q, k, v [S, H, D] ~ N(0, 1), drawn on the card in f32, cast."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tuple(torch.randn((ULY_S, ULY_H, ULY_D), generator=gen,
                             device="cuda").to(dtype) for _ in range(3))


def phase_ulysses(torch, card):
    """The all-to-all and Ulysses attention: small all-to-alls against the
    plain version and the transpose, then the main path
    (``make_all_to_all`` at the probe's payload and
    ``make_ulysses_attention`` at full width, counts set to 0 just
    before), each Ulysses output against the torch route, the dense
    reference and ring attention, repeats bitwise equal, and times; then
    Ulysses' gradient (``uly_grad_lane``). Returns kernel 10's record."""
    from dpu_operator_tpu_torch.parallel import burn
    from dpu_operator_tpu_torch.parallel import ring_attention as ra
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.parallel import ulysses_attention as uly

    mesh = RING_MESH
    n = mesh["sp"]
    for i, (ns, chunk, width, tname) in enumerate(A2A_SMALL):
        x = coll_payload(torch, ns * ns * chunk, width, getattr(torch, tname),
                         seed=90 + i)
        check_a2a(torch, rp, f"all-to-all n={ns} [{ns * ns * chunk}, "
                  f"{width}] {tname}", x, ns)
        log(f"ulysses all-to-all n={ns} block {chunk}x{width} {tname} "
            f"({chunk * width * x.element_size()} B): == plain == transpose "
            f"bit for bit, {int(ns > 1)} launch")
    odd = torch.zeros((4, 3), dtype=torch.int8, device="cuda")
    try:
        rp.all_to_all_cuda(odd, 2)
    except ValueError as e:
        log(f"ulysses all-to-all of 3-byte blocks raises: {e}")
    else:
        raise AssertionError("all-to-all of 3-byte blocks did not raise")

    # The main path, counts at 0.
    rows = COLL_MBYTES * 2 ** 20 // (4 * COLL_WIDTH)
    x = coll_payload(torch, rows, COLL_WIDTH, torch.float32, seed=33)
    dtypes = (torch.float32, torch.bfloat16)
    inputs = {dtype: uly_inputs(torch, dtype, seed=34) for dtype in dtypes}
    cases = [(dtype, causal) for dtype in dtypes for causal in (False, True)]
    rp.all_to_all_cuda.launches = 0
    t0 = time.monotonic()
    probe = rp.make_all_to_all(mesh, "sp")(x)
    outs = {}
    for dtype, causal in cases:
        fn = uly.make_ulysses_attention(mesh, "sp", causal)
        outs[(dtype, causal)] = fn(*inputs[dtype])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = rp.all_to_all_cuda.launches
    check(launches == 1 + 4 * len(cases),
          f"ulysses main path: {launches} all-to-all launches for one "
          f"exchange and {len(cases)} Ulysses calls")
    log(f"ulysses main path: make_all_to_all on [{rows}, {COLL_WIDTH}] f32 "
        f"and {len(cases)} calls of make_ulysses_attention ({mesh}, S "
        f"{ULY_S}, {ULY_H} heads of {ULY_D}), {launches} all-to-all "
        f"launches, {wall:.3f} s wall [{card}]")

    first = check_a2a(torch, rp, f"all-to-all {COLL_MBYTES} MiB", x, n)
    check(same_bits(torch, probe, first),
          "make_all_to_all differs from all_to_all_cuda's bits")
    for i in range(RING_REPEATS):
        again = rp.all_to_all_cuda(x, n)
        check(same_bits(torch, again, first),
              f"all-to-all repeat {i}: differs from the first call's bits")
    err = float((first - rp.all_to_all_plain(x, n)).abs().max())
    chunk = rows // (n * n)
    ms = time_ms(torch, lambda: rp.all_to_all_cuda(x, n), n=10, warm=2)
    plain_ms = time_ms(torch, lambda: rp.all_to_all_plain(x, n), n=5,
                       warm=1, batch=2)
    library_ms = time_ms(torch, lambda: x.view(
        n, n, chunk, COLL_WIDTH).transpose(0, 1).contiguous(), n=10, warm=2)
    kernel_ms, host_ms, seen = device_ms(
        torch, lambda: rp.all_to_all_cuda(x, n), "all_to_all_kernel")
    split = a2a_host_split(torch, rp, x, n)
    log(f"ulysses all_to_all host us a call, by part (200 calls each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f" [{card}]")
    nbytes = x.numel() * x.element_size()
    t_bytes = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    log(f"ulysses all_to_all [{rows}, {COLL_WIDTH}] f32 n={n}: == plain == "
        f"transpose bit for bit, {RING_REPEATS} repeats bitwise equal; "
        f"kernel {ms:.4f} ms ({kernel_ms:.4f} ms a launch on the card, "
        f"{seen}; {host_ms:.4f} ms of host time to queue a call), plain "
        f"{plain_ms:.4f} ms, "
        f"view().transpose().contiguous() {library_ms:.4f} ms, bound "
        f"{t_bytes:.4f} ms ({nbytes} B read, {nbytes} B written) [{card}]")
    record = dict(
        name="all_to_all", route="cuda",
        source="dpu_operator_tpu_torch/csrc/all_to_all.cu",
        replaces="dpu_operator_tpu/parallel/ring_probe.py:576",
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=t_bytes, bound_by="bytes", library_ms=library_ms)
    del probe, first, again

    h_loc = ULY_H // n
    s_loc = ULY_S // n
    flops = 4 * ULY_H * ULY_S * ULY_S * ULY_D  # two products, every pair
    exchange_ms = {}
    for dtype, causal in cases:
        q, k, v = inputs[dtype]
        got = outs.pop((dtype, causal))
        tag = (f"ulysses S={ULY_S} H={ULY_H} D={ULY_D} n={n} "
               f"{str(dtype)[6:]} causal={causal}")
        check(got.shape == (ULY_S, ULY_H, ULY_D) and got.dtype == dtype,
              f"{tag}: {got.dtype} {tuple(got.shape)}")
        check(torch.isfinite(got.float()).all(), f"{tag}: non-finite out")
        torch_route = uly.make_ulysses_attention(
            mesh, "sp", causal, kernel="torch", device="cuda")(q, k, v)
        check(same_bits(torch, got, torch_route),
              f"{tag}: kernel route differs from the torch route's bits")
        del torch_route
        # The dense reference a head group at a time: at all 32 heads its
        # [H, S, S] f32 scores alone would take 32 GiB. Heads are
        # independent, so the groups' outputs side by side are the whole.
        dense = torch.cat([uly.dense_attention_reference(
            q[:, g:g + h_loc], k[:, g:g + h_loc], v[:, g:g + h_loc], causal)
            for g in range(0, ULY_H, h_loc)], dim=1)
        err_d, bar_d = ring_compare(torch, burn, f"{tag} vs dense", got,
                                    dense)
        del dense
        ring_errs = []
        for h in (0, ULY_H - 1):
            ring = ra.make_ring_attention(mesh, "sp", causal)(
                *(t[:, h].contiguous() for t in (q, k, v)))
            ring_errs.append(ring_compare(
                torch, burn, f"{tag} head {h} vs ring attention",
                got[:, h].contiguous(), ring)[0])
        fn = uly.make_ulysses_attention(mesh, "sp", causal)
        for i in range(ULY_REPEATS):
            before = rp.all_to_all_cuda.launches
            again = fn(q, k, v)
            check(rp.all_to_all_cuda.launches == before + 4,
                  f"{tag}: {rp.all_to_all_cuda.launches - before} launches "
                  f"in a call")
            check(same_bits(torch, again, got),
                  f"{tag} repeat {i}: differs from the first call's bits")
        del again, got
        call_ms = time_ms(torch, lambda: fn(q, k, v), n=3, warm=1, batch=1)
        if dtype not in exchange_ms:
            xu = coll_payload(torch, n * ULY_H, s_loc * ULY_D, dtype,
                              seed=35)
            exchange_ms[dtype] = time_ms(
                torch, lambda: rp.all_to_all_cuda(xu, n), n=10, warm=2)
            kernel_ms, host_ms, seen = device_ms(
                torch, lambda: rp.all_to_all_cuda(xu, n), "all_to_all_kernel")
            rows_b = ULY_H // n  # a block: the heads one rank sends another
            plain_ms = time_ms(torch, lambda: rp.all_to_all_plain(xu, n),
                               n=5, warm=1, batch=2)
            library_ms = time_ms(torch, lambda: xu.view(
                n, n, rows_b, s_loc * ULY_D).transpose(0, 1).contiguous(),
                n=10, warm=2)
            xbytes = xu.numel() * xu.element_size()
            log(f"ulysses exchange [{n * ULY_H}, {s_loc * ULY_D}] "
                f"{str(dtype)[6:]} n={n} (blocks of {rows_b} rows): kernel "
                f"{exchange_ms[dtype]:.4f} ms ({kernel_ms:.4f} ms a launch on "
                f"the card, {seen}; {host_ms:.4f} ms of host time to queue a "
                f"call), plain {plain_ms:.4f} ms, "
                f"view().transpose().contiguous() {library_ms:.4f} ms, bound "
                f"{2 * xbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({xbytes} B "
                f"read and written) [{card}]")
            del xu
        share = 4 * exchange_ms[dtype] / call_ms
        log(f"{tag}: 4 launches a call, == torch route bit for bit, "
            f"{ULY_REPEATS} repeats bitwise equal; vs dense max |err| "
            f"{err_d:.3e} ({bar_d}); vs ring attention heads 0, "
            f"{ULY_H - 1} max |err| {max(ring_errs):.3e}; call {call_ms:.3f} "
            f"ms, the four exchanges {4 * exchange_ms[dtype]:.4f} ms "
            f"({share:.4f} of it); the local attention's f32 operation "
            f"bound {flops / FP32_FLOP_PER_S * 1e3:.3f} ms ({flops} flop) "
            f"[{card}]")
        torch.cuda.empty_cache()
    del inputs, x
    torch.cuda.empty_cache()
    record["ulysses_grad_launches"] = uly_grad_lane(torch, card)
    return record


def uly_grads(torch, fn, q, k, v, cot=None):
    """The gradients of sum(fn(q, k, v)**2), or with the cotangent ``cot``
    of fn's output, with respect to q, k and v (leaves made here)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = fn(*leaves)
        if cot is None:
            return torch.autograd.grad((out ** 2).sum(), leaves)
        return torch.autograd.grad(out, leaves, cot)


def uly_grad_lane(torch, card):
    """Ulysses' gradient at phase 10's full width (S = ULY_GRAD_S, f32,
    causal, 8 ranks sharing the card): the main path (counts at 0) is one
    ``torch.autograd.grad`` of sum(out**2) with ``kernel="cuda"``, 4
    kernel-10 launches forward and 4 backward; its q, k, v gradients ==
    the torch route's bit for bit, within the ring bars of the dense
    reference's (a head group at a time) and, at the first and last head
    groups, of PyTorch's math attention's, 3 repeats bitwise; device ms of
    forward + backward by events, the peak memory, the idle share of one
    profiled call; then one bf16 call's gradients against the f32 route's
    on the same (upcast) inputs and the same cotangent. Returns the main
    path's launches."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from dpu_operator_tpu_torch.parallel import burn
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.parallel import ulysses_attention as uly

    mesh, n, S = RING_MESH, RING_MESH["sp"], ULY_GRAD_S
    h_loc = ULY_H // n
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    q, k, v = (torch.randn((S, ULY_H, ULY_D), generator=gen, device="cuda")
               for _ in range(3))
    fn = uly.make_ulysses_attention(mesh, "sp", True)
    tag = f"ulysses grad S={S} H={ULY_H} D={ULY_D} n={n} f32 causal"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    entry_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    rp.all_to_all_cuda.launches = 0
    t0 = time.monotonic()
    got = uly_grads(torch, fn, q, k, v)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = rp.all_to_all_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == 8, f"{tag}: {launches} all-to-all launches for one "
          f"call and its gradient (want 4 + 4)")
    for g, name in zip(got, "qkv"):
        check(g.shape == q.shape and g.dtype == torch.float32
              and bool(torch.isfinite(g).all()),
              f"{tag}: d{name} {g.dtype} {tuple(g.shape)} not finite")
    log(f"{tag} main path: one torch.autograd.grad of sum(out**2) with "
        f"kernel 10, {launches} all-to-all launches (4 forward + 4 "
        f"backward), {wall:.3f} s wall (first call); peak device memory "
        f"{peak_gb:.3f} GB ({entry_gb:.3f} GB allocated on entry) [{card}]")

    plain = uly_grads(torch, uly.make_ulysses_attention(
        mesh, "sp", True, kernel="torch", device="cuda"), q, k, v)
    check(all(same_bits(torch, a, b) for a, b in zip(got, plain)),
          f"{tag}: kernel route's gradients differ from the torch route's "
          f"bits")
    del plain
    # The dense reference's gradients a head group at a time (its [H, S,
    # S] scores would take 32 GiB): the loss is a sum over heads, so each
    # group's gradients are the whole's at its heads. The dense reference
    # is the port's own _full_attention, the function each rank runs, so
    # it holds the layout and nothing more; the first and last groups are
    # also held against autograd through PyTorch's math attention
    # (scaled_dot_product_attention, f32, is_causal), which shares no code
    # with the port.
    def sdpa(a, b, c):
        with sdpa_kernel(SDPBackend.MATH):
            return torch.nn.functional.scaled_dot_product_attention(
                *(t.permute(1, 0, 2) for t in (a, b, c)),
                is_causal=True).permute(1, 0, 2)

    def dense(a, b, c):
        return uly.dense_attention_reference(a, b, c, True)

    errs, sdpa_errs, sdpa_rel = [], [], []
    for g0 in range(0, ULY_H, h_loc):
        heads = slice(g0, g0 + h_loc)
        refs = [("dense", dense, errs)]
        if g0 in (0, ULY_H - h_loc):
            refs.append(("math attention", sdpa, sdpa_errs))
        for label, ref, into in refs:
            want = uly_grads(torch, ref, q[:, heads], k[:, heads],
                             v[:, heads])
            for g, w, name in zip(got, want, "qkv"):
                into.append(ring_compare(
                    torch, burn, f"{tag} d{name} heads {g0}.. vs {label}",
                    g[:, heads].contiguous(), w)[0])
                if into is sdpa_errs:
                    # Each checked head's error against its own gradient
                    # scale, max |g| of the reference.
                    for hh in range(h_loc):
                        top = float(w[:, hh].abs().max())
                        hd = float((g[:, g0 + hh] - w[:, hh]).abs().max())
                        sdpa_rel.append((hd / top, hd, top, g0 + hh, name))
            del want
    for i in range(ULY_REPEATS):
        before = rp.all_to_all_cuda.launches
        again = uly_grads(torch, fn, q, k, v)
        check(rp.all_to_all_cuda.launches == before + 8,
              f"{tag} repeat {i}: {rp.all_to_all_cuda.launches - before} "
              f"launches")
        check(all(same_bits(torch, a, b) for a, b in zip(again, got)),
              f"{tag} repeat {i}: differs from the first call's bits")
        del again
    ms = time_ms(torch, lambda: uly_grads(torch, fn, q, k, v), n=3, warm=1,
                 batch=1)
    fwd_ms = time_ms(torch, lambda: fn(q, k, v), n=3, warm=1, batch=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        uly_grads(torch, fn, q, k, v)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    log(f"{tag}: == torch route bit for bit, {ULY_REPEATS} repeats bitwise, "
        f"8 launches each; vs dense (the port's own attention) max |err| "
        f"{max(errs):.3e}; vs PyTorch's math attention, heads 0..{h_loc - 1} "
        f"and {ULY_H - h_loc}..{ULY_H - 1}, max |err| {max(sdpa_errs):.3e} "
        f"(rtol {RING_RTOL}, atol {RING_ATOL}); forward + backward {ms:.3f} ms "
        f"by events (forward alone {fwd_ms:.3f} ms) [{card}]")
    log_a2a_profile(card, f"{tag} profile", prof, wall_ms)
    # The math attention's error against each head's gradient scale, and
    # against what reassociating f32 sums over S keys is expected to
    # give: ~sqrt(S) u for independent roundings, S u at the worst
    # (u = 2**-24).
    u = 2.0 ** -24
    rel, hd, top, head, name = max(sdpa_rel)
    log(f"{tag} vs PyTorch's math attention, per checked head (heads "
        f"0..{h_loc - 1}, {ULY_H - h_loc}..{ULY_H - 1}; dq, dk, dv): max "
        f"|err| / max |g| of its head {rel:.3e} (d{name} head {head}: "
        f"{hd:.3e} of {top:.3e}), median "
        f"{statistics.median(r[0] for r in sdpa_rel):.3e}; f32 "
        f"reassociation over {S} keys ~sqrt(S) u = {math.sqrt(S) * u:.3e}, "
        f"at most S u = {S * u:.3e}: the worst head is "
        f"{rel / (math.sqrt(S) * u):.1f} x sqrt(S) u and "
        f"{rel / (S * u):.3f} x S u [{card}]")
    del got, prof

    # bf16: the bf16 call's cotangent is 2·out exactly (a power-of-2
    # scaling of a bf16 value); given the same cotangent, the f32 route on
    # the upcast inputs runs the same f32 backward, so the bf16 gradients
    # are its gradients rounded once.
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    del q, k, v
    with torch.no_grad():
        cot = 2 * fn(qb, kb, vb)
    before = rp.all_to_all_cuda.launches
    got_b = uly_grads(torch, fn, qb, kb, vb)
    check(rp.all_to_all_cuda.launches == before + 8,
          f"{tag} bf16: {rp.all_to_all_cuda.launches - before} launches")
    want_b = uly_grads(torch, fn, *(t.float() for t in (qb, kb, vb)),
                       cot=cot.float())
    ulps = []
    for g, w, name in zip(got_b, want_b, "qkv"):
        check(g.dtype == torch.bfloat16, f"{tag} bf16: d{name} {g.dtype}")
        ulps.append(burn.bf16_ulps(g, w.to(torch.bfloat16),
                                   floor=RING_ULP_FLOOR))
    check(max(ulps) <= RING_ULPS, f"{tag} bf16: {max(ulps)} ulps from the "
          f"f32 route's gradients (max {RING_ULPS})")
    log(f"ulysses grad S={S} bf16 causal: 8 launches, dq/dk/dv within "
        f"{max(ulps):.2f} bf16 ulps (max {RING_ULPS}) of the f32 route's "
        f"on the same inputs and cotangent [{card}]")
    del got_b, want_b, cot, qb, kb, vb
    torch.cuda.empty_cache()
    return launches


# -- phase 11: the collective matmuls -----------------------------------------


def cm_compare(torch, burn, tag, got, want):
    """Max |err| of ``got`` against ``want`` within the collective matmuls'
    bar (f32: CM_F32_REL of max |want|; bf16: 1 ulp); raises otherwise."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tag}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    check(torch.isfinite(got.float()).all(), f"{tag}: non-finite kernel out")
    check(torch.isfinite(want.float()).all(), f"{tag}: non-finite reference")
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ulps = burn.bf16_ulps(got, want)
        check(ulps <= STEP_ULPS, f"{tag}: {ulps} bf16 ulps (max {STEP_ULPS})")
        return err, f"{ulps:.2f} ulps (max {STEP_ULPS})"
    top = float(want.abs().max())
    check(err <= CM_F32_REL * top, f"{tag}: max |err| {err} over "
                                   f"{CM_F32_REL} x {top}")
    return err, f"{err / top:.2e} of max |b| (max {CM_F32_REL})"


def bf16_ulp(torch, t):
    """The bf16 ulp at each element's magnitude, at 2**-5 below it (the
    floor of ``burn.bf16_ulps``), in f32."""
    mag = t.float().abs().clamp_min(2.0 ** -5)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def cm_pair_compare(torch, burn, tag, got, x, w1, w2, h):
    """The pair's output against the dense relu(x @ w1) @ w2 (torch.matmul,
    TF32 off), h the pair's own first half. f32: cm_compare's bar. bf16:
    |got - dense| <= sum_j ulp(h_j) |w2_jk| + 1 ulp of the output, each h
    ulp at the larger of the two h's; raises otherwise. Returns (max
    |err|, bar)."""
    h_dense = torch.matmul(x, w1)
    dense = torch.matmul(torch.relu(h_dense), w2)
    if got.dtype != torch.bfloat16:
        return cm_compare(torch, burn, tag, got, dense)
    check(torch.isfinite(got.float()).all(), f"{tag}: non-finite output")
    carried = torch.matmul(
        bf16_ulp(torch, torch.maximum(h.float().abs(), h_dense.float().abs())),
        w2.float().abs())
    diff = (got.float() - dense.float()).abs()
    own = bf16_ulp(torch, torch.maximum(got.float().abs(),
                                        dense.float().abs()))
    excess = float(((diff - carried) / own).max())
    check(excess <= STEP_ULPS, f"{tag}: {excess} output ulps beyond h's "
                               f"carried freedom (max {STEP_ULPS})")
    return float(diff.max()), (f"{burn.bf16_ulps(got, dense):.2f} ulps; "
                               f"{excess:.2f} ulps beyond h's 1-ulp freedom "
                               f"carried through w2 (max {STEP_ULPS})")


def cm_case(torch, cm, burn, tag, x, w, n, reduce_scatter):
    """One launch of a collective-matmul kernel (none for the
    reduce-scatter's ring of one) against its plain version. Returns
    (output, max |err|, bar)."""
    kern = cm.mm_rs_cuda if reduce_scatter else cm.ag_matmul_cuda
    plain = cm.mm_rs_plain if reduce_scatter else cm.ag_matmul_plain
    before = kern.launches
    got = kern(x, w, n)
    torch.cuda.synchronize()
    want_launches = 0 if reduce_scatter and n == 1 else 1
    check(kern.launches == before + want_launches,
          f"{tag}: {kern.launches - before} launches")
    err, bar = cm_compare(torch, burn, tag, got, plain(x, w, n))
    return got, err, bar


def ptxas_entries(text):
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` report."""
    out, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            spills = (int(words[words.index("spill") - 2]),
                      int(words[words.index("loads") - 3]))
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[name] = (int(words[words.index("registers") - 1]),) + spills
            name, spills = None, (0, 0)
    return out


def check_wgmma_build(cuda_build, source):
    """The tile-product kernels of ``source`` as ptxas reported them in
    this run: the collective matmuls' four (bf16 on wgmma, f32 on the
    split-TF32 mma.sync form), or ``tile_mma``'s five, the tile kernel's
    four instances (two widths, with and without tanh) and the chain
    kernel; no spills. Returns a line for the log."""
    text = cuda_build.build_logs.get(source)
    if text is None:
        return (f"{source}: ptxas report not in this run (the library was "
                f"built earlier in this checkout)")
    if source == "collective_matmul":
        want = 4
        kernels = {("ag_matmul" if "ag_matmul" in name else "mm_rs")
                   + (" bf16" if "bfloat16" in name else " f32"): regs
                   for name, regs in ptxas_entries(text).items()
                   if "ag_matmul_kernel" in name or "mm_rs_kernel" in name}
    else:
        want = 5
        kernels = {}
        for name, regs in ptxas_entries(text).items():
            found = re.search(r"tile_kernelILi(\d+)ELb([01])E", name)
            if found:
                kernels[f"tile 128x{found[1]}"
                        f"{' tanh' if found[2] == '1' else ''}"] = regs
            elif "chain_kernel" in name:
                kernels["chain"] = regs
    check(len(kernels) == want, f"{source}: ptxas reported {sorted(kernels)}")
    for name, (regs, stores, loads) in kernels.items():
        check(stores == 0 and loads == 0,
              f"{source} {name}: {stores} B spill stores, {loads} B loads")
    return ", ".join(f"{name} {regs} registers, 0 spills"
                     for name, (regs, _, _) in sorted(kernels.items()))


def tp_weights(torch, dtype, seed):
    """x [TP_B, TP_D] ~ N(0, 1), w1 ~ N(0, 1/TP_D), w2 ~ N(0, 1/TP_H):
    every sum stays O(1). Drawn on the card in f32, cast."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((TP_B, TP_D), generator=gen, device="cuda")
    w1 = torch.randn((TP_D, TP_H), generator=gen, device="cuda") / math.sqrt(
        TP_D)
    w2 = torch.randn((TP_H, TP_D), generator=gen, device="cuda") / math.sqrt(
        TP_H)
    return x.to(dtype), w1.to(dtype), w2.to(dtype)


def phase_tp_mlp(torch, card):
    """The collective matmuls: small rings against the plain versions,
    then the main path (the tensor-parallel MLP pair at full width, counts
    set to 0 just before), each kernel against its plain version and the
    pair against the dense product, 20 repeats bitwise equal, and times."""
    from dpu_operator_tpu_torch import cuda_build
    from dpu_operator_tpu_torch.parallel import burn
    from dpu_operator_tpu_torch.parallel import collective_matmul as cm
    from dpu_operator_tpu_torch.parallel import ring_probe as rp

    log(f"tp-mlp ptxas: {check_wgmma_build(cuda_build, 'collective_matmul')}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(50)

    def rand(rows, cols, dtype):
        return torch.randn((rows, cols), generator=gen,
                           device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        cases = ([(n, 2 * n, 16, 8 * n, False) for n in CM_RINGS]
                 + [(n, 2 * n, 8 * n, 16, True) for n in CM_RINGS]
                 + [c + (False,) for c in CM_OFF_GRID]
                 + [c + (True,) for c in CM_RS_OFF_GRID]
                 + [(8, 16, 64, 16, True)]
                 + list(CM_WGMMA_CASES if dtype == torch.bfloat16
                        else CM_TF32_CASES))
        for n, rows, k, f, reduce_scatter in cases:
            what = "matmul reduce-scatter" if reduce_scatter else \
                "all-gather matmul"
            tag = f"tp-mlp {what} n={n} [{rows}, {k}] @ [{k}, {f}] {name}"
            _, err, bar = cm_case(torch, cm, burn, tag, rand(rows, k, dtype),
                                  rand(k, f, dtype), n, reduce_scatter)
            extra = ""
            if (n, rows, k, f, reduce_scatter) in (CM_WGMMA_CASES
                                                   + CM_TF32_CASES):
                per_sm, bm, bn = (CM_WGMMA_TILES[reduce_scatter]
                                  if dtype == torch.bfloat16
                                  else CM_TF32_TILE)
                cols = f if reduce_scatter else f // n
                tiles = math.ceil(rows // n / bm) * math.ceil(cols / bn)
                ctas = min(tiles, per_sm * sms // n)
                products = tiles // ctas
                check(products >= 3, f"{tag}: {products} products a CTA")
                extra = (f"; {tiles} tiles of {bm} x {bn} a block over "
                         f"{ctas} CTAs a rank: at least {products} products "
                         f"a CTA a ring step")
            log(f"{tag}: == plain within the bar, max |err| {err:.3e} "
                f"({bar}){extra}")
    for fn, x, w in ((cm.ag_matmul_cuda, rand(16, 6, torch.float32),
                      rand(6, 16, torch.float32)),
                     (cm.mm_rs_cuda, rand(16, 24, torch.bfloat16),
                      rand(24, 16, torch.bfloat16))):
        try:
            fn(x, w, 4)
        except ValueError as e:
            log(f"tp-mlp {fn.__name__} with rows of 24 or 12 bytes raises: "
                f"{e}")
        else:
            raise AssertionError(f"{fn.__name__}: rows that are no whole "
                                 f"16-byte units did not raise")
    try:
        cm.make_allgather_matmul(TP_MESH, "tp", overlap=False, kernel="cuda")
    except ValueError as e:
        log(f"tp-mlp overlap=False with kernel='cuda' raises: {e}")
    else:
        raise AssertionError("overlap=False with kernel='cuda' did not raise")

    # The main path, counts at 0: one pair call per type.
    n = TP_MESH["tp"]
    dtypes = (torch.float32, torch.bfloat16)
    inputs = {dtype: tp_weights(torch, dtype, seed=0) for dtype in dtypes}
    ag = cm.make_allgather_matmul(TP_MESH, "tp")
    rs = cm.make_matmul_reduce_scatter(TP_MESH, "tp")

    def pair(x, w1, w2):
        return rs(torch.relu(ag(x, w1)), w2)

    cm.ag_matmul_cuda.launches = 0
    cm.mm_rs_cuda.launches = 0
    outs = {}
    t0 = time.monotonic()
    for dtype in dtypes:
        outs[dtype] = pair(*inputs[dtype])
        torch.cuda.synchronize()
        check(cm.ag_matmul_cuda.launches == cm.mm_rs_cuda.launches
              == len(outs), f"tp-mlp pair call {len(outs)}: "
                            f"{cm.ag_matmul_cuda.launches} all-gather, "
                            f"{cm.mm_rs_cuda.launches} reduce-scatter "
                            f"launches")
    wall = time.monotonic() - t0
    launches = {"ag_matmul": cm.ag_matmul_cuda.launches,
                "mm_reduce_scatter": cm.mm_rs_cuda.launches}
    log(f"tp-mlp main path: {len(dtypes)} pair calls (f32, bf16) of "
        f"make_allgather_matmul -> relu -> make_matmul_reduce_scatter "
        f"({TP_MESH}, x [{TP_B}, {TP_D}], w1 [{TP_D}, {TP_H}], w2 [{TP_H}, "
        f"{TP_D}]), launches {launches}: 2 a pair call, {wall:.3f} s wall "
        f"(the first call builds nothing: phase 2 did) [{card}]")

    records = []
    flops = 2 * TP_B * TP_D * TP_H
    for dtype in dtypes:
        name = str(dtype)[6:]
        x, w1, w2 = inputs[dtype]
        item = x.element_size()
        got = outs.pop(dtype)
        check(got.shape == (TP_B, TP_D) and got.dtype == dtype,
              f"tp-mlp pair {name}: {got.dtype} {tuple(got.shape)}")
        h = ag(x, w1)
        relu_h = torch.relu(h)
        err_pair, bar_pair = cm_pair_compare(
            torch, burn, f"tp-mlp pair {name} vs dense", got, x, w1, w2, h)
        for i in range(TP_REPEATS):
            again = pair(x, w1, w2)
            check(same_bits(torch, again, got),
                  f"tp-mlp pair {name} repeat {i}: differs from the first "
                  f"call's bits")
        del again
        pair_ms = time_ms(torch, lambda: pair(x, w1, w2), n=5, warm=1,
                          batch=2)
        t0 = time.monotonic()
        pair(x, w1, w2)
        torch.cuda.synchronize()
        pair_wall_ms = (time.monotonic() - t0) * 1e3
        log(f"tp-mlp pair {name}: vs relu(x @ w1) @ w2 (torch.matmul, TF32 "
            f"off) max |err| {err_pair:.3e} ({bar_pair}); {TP_REPEATS} "
            f"repeats bitwise equal; {pair_ms:.4f} ms a pair call (CUDA "
            f"events), {pair_wall_ms:.3f} ms wall for one [{card}]")
        for key, kern, plain, a, b, line, kname in (
                ("ag_matmul", cm.ag_matmul_cuda, cm.ag_matmul_plain, x, w1,
                 115, "ag_matmul_kernel"),
                ("mm_reduce_scatter", cm.mm_rs_cuda, cm.mm_rs_plain, relu_h,
                 w2, 283, "mm_rs_kernel")):
            mine = kern(a, b, n)
            err, bar = cm_compare(torch, burn, f"tp-mlp {key} {name}", mine,
                                  plain(a, b, n))
            if key == "ag_matmul":
                check(same_bits(torch, mine, h),
                      f"tp-mlp ag_matmul {name}: differs from the pair's "
                      f"first half")
            elif dtype == torch.float32:
                # One TF32 pass a slice (emulated) must miss the bar that
                # the kernel's three meet.
                want = plain(a, b, n)
                kn = a.shape[1] // n
                one = rp.ring_reduce_scatter_plain(torch.cat([
                    cm.tf32x3_product(a[:, r * kn:(r + 1) * kn],
                                      b[r * kn:(r + 1) * kn], single=True)
                    for r in range(n)]), n)
                one_err = float((one - want).abs().max())
                top = float(want.abs().max())
                check(one_err > CM_F32_REL * top,
                      f"tp-mlp {key} {name}: one TF32 pass is within the "
                      f"f32 bar ({one_err} of {top}); the bar does not bite")
                log(f"tp-mlp {key} {name}: one TF32 pass (emulated) max "
                    f"|err| {one_err:.3e} = {one_err / top:.2e} of max |b|, "
                    f"outside the bar ({CM_F32_REL}); the kernel's "
                    f"{err / top:.2e}")
                del want, one
            del mine
            ms = time_ms(torch, lambda: kern(a, b, n), n=5, warm=1, batch=2)
            launch_ms, host_ms, seen = device_ms(
                torch, lambda: kern(a, b, n), kname, calls=5)
            plain_ms = time_ms(torch, lambda: plain(a, b, n), n=3, warm=1,
                               batch=1)
            library_ms = time_ms(torch, lambda: torch.matmul(a, b), n=5,
                                 warm=1, batch=2)
            nbytes = (a.numel() + b.numel() + a.shape[0] * b.shape[1]) * item
            # f32: the split's three passes on the TF32 tensor cores; the
            # FMA pipes' bound is logged beside it.
            t_ops = (flops / BF16_FLOP_PER_S if dtype == torch.bfloat16
                     else 3 * flops / TF32_FLOP_PER_S) * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            fma = ("" if dtype == torch.bfloat16 else
                   f"; {max(flops / FP32_FLOP_PER_S * 1e3, t_bytes):.4f} ms "
                   f"on the f32 FMA pipes")
            log(f"tp-mlp {key} {name} [{a.shape[0]}, {a.shape[1]}] @ "
                f"[{b.shape[0]}, {b.shape[1]}] n={n}: == plain within the "
                f"bar, max |err| {err:.3e} ({bar}); kernel {ms:.4f} ms "
                f"({launch_ms:.4f} ms a launch on the card, {seen}; "
                f"{host_ms:.4f} ms of host time to queue a call; "
                f"{flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"torch.matmul {library_ms:.4f} ms, bound "
                f"{max(t_ops, t_bytes):.4f} ms ({flops} flop"
                f"{'' if dtype == torch.bfloat16 else ', x 3 split passes'}"
                f", {nbytes} B{fma}; {n} ranks share the card: the relay is "
                f"a copy within its memory) [{card}]")
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            if dtype == torch.float32:
                records.append(dict(
                    name=key, route="cuda",
                    source="dpu_operator_tpu_torch/csrc/collective_matmul.cu",
                    replaces=f"dpu_operator_tpu/parallel/collective_matmul.py"
                             f":{line}",
                    launches=launches[key], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                    bound_by=bound_by, library_ms=library_ms))
            else:
                # The record of the f32 instance carries the bf16 one's
                # numbers beside its own (the launches count both).
                rec = next(r for r in records if r["name"] == key)
                rec.update(bf16_max_abs_err=err, bf16_ms=ms,
                           bf16_plain_ms=plain_ms,
                           bf16_bound_ms=max(t_ops, t_bytes),
                           bf16_bound_by=bound_by, bf16_library_ms=library_ms)
        del got, h, relu_h
        torch.cuda.empty_cache()
    del inputs
    torch.cuda.empty_cache()
    return records


# -- phase 12: speculative decoding on the served path ------------------------


SPEC_K = 4          # a verify window of 5 rows, within the chunk of 16
SPEC_TREE = 3       # tree lanes: the trunk and 2 first-position siblings
# int8 repeats on all 8 requests (set to 4 if the script nears its limit)
SPEC_INT8_REQUESTS = 8


def first_diff(a, b):
    """(request, token index) of the first difference of two stream lists,
    or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None


def spec_run(torch, card, label, prompts, pool_dtype, **kw):
    """Serve ``prompts`` once over HTTP on a fresh executor at full width;
    check the kernel's launch count against the route (chain windows go
    through the kernel, tree windows through the PyTorch composition) and
    the spec counters; log one line; return the streams."""
    from dpu_operator_tpu_torch.parallel import paged_attn as pa
    from dpu_operator_tpu_torch.serving import PagedKVExecutor

    t0 = time.monotonic()
    ex = PagedKVExecutor(**dict(SERVE, pool_dtype=pool_dtype), **kw,
                         kernel="cuda", device="cuda")
    setup = time.monotonic() - t0
    pa.paged_attn_step_cuda.launches = 0
    streams, st = serve_once(torch, ex, prompts, card)
    launches = pa.paged_attn_step_cuda.launches
    kv = ex.kv_stats()
    tree = kw.get("spec_tree_width", 1) > 1
    if tree:
        check(launches == 0, f"{label}: a tree run launched the kernel "
              f"{launches} times")
    else:
        check(launches >= st["steps"] > 0,
              f"{label}: kernel launches {launches} for {st['steps']} steps")
    extra = ""
    if ex.spec is not None:
        check(kv["spec_verify_steps"] > 0, f"{label}: no verify step")
        if ex.pipelined:
            check(kv["spec_pipeline_peak"] >= 2,
                  f"{label}: pipeline peak {kv['spec_pipeline_peak']}")
        extra = (f"{kv['spec_verify_steps']} verify steps, "
                 f"{kv['spec_proposed_tokens']} proposed / "
                 f"{kv['spec_accepted_tokens']} accepted (rate "
                 f"{kv['spec_accept_rate']}, {kv['spec_tokens_per_step']} "
                 f"tokens a verify step), pipeline peak "
                 f"{kv['spec_pipeline_peak']}, replans "
                 f"{kv['spec_replans']}, ")
    n_prompt = sum(map(len, prompts))
    log(f"spec {label} {pool_dtype}: {len(prompts)} requests x "
        f"{MAX_TOKENS} tokens, prompts {n_prompt} tokens, {st['steps']} "
        f"steps, {extra}kernel launches {launches}, wall "
        f"{st['wall_s']:.3f} s -> {st['gen_tok_per_s']:.1f} generated "
        f"tok/s, {st['all_tok_per_s']:.1f} prompt+generated tok/s, "
        f"{st['step_ms']:.3f} ms/step (setup {setup:.1f} s) [{card}]")
    del ex
    torch.cuda.empty_cache()
    return streams


def draft_overlap(torch, card, queued=8, reps=5):
    """Whether the truncated draft waits for the verify window in flight:
    host ms of one ``propose_full`` (the pipelined planner's draft call,
    which ends in a copy to the host) on an idle card, then issued right
    after ``queued`` full-width verify steps were queued on the
    executor's stream, from the draft's own stream and, for comparison,
    from the executor's stream. Logged, not checked: the draft's kernels
    share the SMs with the steps'."""
    from dpu_operator_tpu_torch.serving import PagedKVExecutor
    from dpu_operator_tpu_torch.serving.spec import propose_full

    ex = PagedKVExecutor(**dict(SERVE, pool_dtype="fp32"),
                         mode="speculative-pipelined", spec_k=SPEC_K,
                         kernel="cuda", device="cuda")
    step, draft = ex._paged, ex.spec.draft
    S, C, B, dev = step.slots, step.chunk, step.max_blocks_per_req, ex.device
    i32 = dict(dtype=torch.int32, device=dev)
    ctx = B * step.block_size - C          # a full context, a full window
    args = (ex._kpool, ex._kscale, ex._vpool, ex._vscale,
            torch.zeros(S, **i32), torch.zeros((S, C), **i32),
            torch.ones(S, dtype=torch.bool, device=dev),
            torch.full((S,), ctx, **i32), torch.full((S,), C, **i32),
            torch.arange(S * B, **i32).reshape(S, B))
    last = np.arange(S, dtype=np.int32)
    base = np.full(S, ctx, np.int32)

    def queue(n):
        with ex._on_stream():
            for _ in range(n):
                step(*args)

    def draft_ms(n):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            queue(n)
            t0 = time.perf_counter()
            propose_full(draft, last, base)
            out.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(out)

    queue(1)
    propose_full(draft, last, base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue(queued)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / queued
    alone = draft_ms(0)
    own = draft_ms(queued)
    draft._stream, kept = ex._stream, draft._stream
    shared = draft_ms(queued)
    draft._stream = kept
    log(f"spec draft: propose_full (k={SPEC_K}, two chains) {alone:.3f} ms "
        f"on an idle card; behind {queued} queued verify steps "
        f"({step_ms:.3f} ms each, full window, full context) "
        f"{own:.3f} ms from the draft's own stream, {shared:.3f} ms from "
        f"the executor's stream (host clock, medians of {reps}) [{card}]")
    del ex
    torch.cuda.empty_cache()


def phase_spec(torch, card):
    """Speculative decoding at the served model's full width, through the
    entry point (HTTP -> batcher -> PagedKVExecutor in a speculative
    mode, the truncated draft over the step's own weights). fp32 pools:
    every speculative lane decodes the sync streams token for token. int8
    pools: each lane decodes the same streams twice (a verify window's
    rows set a block's scale, so int8 speculative streams are not compared
    with sync ones, by design)."""
    prompts = serve_prompts()
    log("spec: chain verify windows attend through the paged-attention "
        "kernel; tree runs route every step through tree_step, the "
        "PyTorch composition, and launch no paged-attention kernel (their "
        "count is checked to be 0)")
    chain = (("speculative/cuda", dict(mode="speculative", spec_k=SPEC_K)),
             ("speculative-pipelined/cuda",
              dict(mode="speculative-pipelined", spec_k=SPEC_K)))
    gold = spec_run(torch, card, "sync/cuda", prompts, "fp32", mode="sync")
    distinct = [len(set(s)) for s in gold]
    check(min(distinct) > 1, f"spec: degenerate streams {distinct}")
    lanes = chain + ((f"speculative-pipelined/tree {SPEC_TREE}",
                      dict(mode="speculative-pipelined", spec_k=SPEC_K,
                           spec_tree_width=SPEC_TREE)),)
    for label, kw in lanes:
        streams = spec_run(torch, card, label, prompts, "fp32", **kw)
        at = first_diff(streams, gold)
        check(at is None, f"spec {label} fp32: streams differ from "
              f"sync/cuda first at request {at and at[0]}, token "
              f"{at and at[1]}")
    log(f"spec fp32: speculative, pipelined and tree streams == sync "
        f"streams; distinct tokens per stream {distinct}")
    sub = prompts[:SPEC_INT8_REQUESTS]
    for label, kw in chain:
        a = spec_run(torch, card, f"{label} #1", sub, "int8", **kw)
        b = spec_run(torch, card, f"{label} #2", sub, "int8", **kw)
        at = first_diff(a, b)
        check(at is None, f"spec {label} int8: repeats differ at {at}")
    log(f"spec int8: both chain lanes repeat their streams on "
        f"{len(sub)} requests")
    draft_overlap(torch, card)
    phase_profile(torch, card, "speculative-pipelined",
                  mode="speculative-pipelined", spec_k=SPEC_K)
    return gold


# -- phase 13: context-parallel paged KV --------------------------------------


# Head-axis lanes, all 8 requests: (world, pool dtype, mode). World 4 has
# 8 heads a rank.
SHARD_HEAD_LANES = ((2, "int8", "sync"), (2, "int8", "pipelined"),
                    (2, "fp32", "sync"), (4, "int8", "sync"))
# Page-axis lanes: (world, pool dtype), sync, on the first
# SHARD_PAGE_REQUESTS requests (a page rank gathers and decodes its
# [slots, 4096, 32, 128] f32 keys and values over the whole table a
# step). 8192 blocks split unevenly over 3, and 32 heads do not divide by
# 3.
SHARD_PAGE_LANES = ((2, "int8"), (3, "fp32"))
SHARD_PAGE_REQUESTS = 3
# The direct step's page-axis merged o against the kernel at H = 32: both
# fold f32 softmax sums over up to 4096 positions, in other orders (a
# rank's one softmax and the rank-ordered fold vs the kernel's chunks of
# 32 table entries): phase 3's bar for kernel against plain.
PAGE_O_RTOL, PAGE_O_ATOL = O_RTOL, O_ATOL


def shard_close(ex):
    """Close a sharded executor and wait for its threads, so that its
    pools and partials are freed before the next lane."""
    ex.close()
    for t in list(ex.shards._threads) + [ex.shards._coord]:
        t.join(timeout=10)


def pool_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def shard_run(torch, card, label, prompts, pool_dtype, world, axis, gold,
              check_gold, **kw):
    """Serve ``prompts`` over HTTP through ``ServingServer`` on a fresh
    ``ShardedPagedKVExecutor`` at full width; count the paged-attention
    kernel's launches over the run; log a line (steps, wall, ms a step,
    each rank's resident pool bytes against the single worker's). Head
    lanes must launch the kernel ``world`` times a step and, with
    ``check_gold``, decode ``gold`` token for token; page lanes must
    launch it never, and their first difference from ``gold`` is logged.
    Returns (streams, launches)."""
    from dpu_operator_tpu_torch.parallel import paged_attn as pa
    from dpu_operator_tpu_torch.serving import ShardedPagedKVExecutor

    t0 = time.monotonic()
    ex = ShardedPagedKVExecutor(**dict(SERVE, pool_dtype=pool_dtype),
                                world=world, shard_axis=axis,
                                kernel="cuda" if axis == "head" else None,
                                device="cuda", **kw)
    setup = time.monotonic() - t0
    ranks = [pool_bytes((st.kpool, st.kscale, st.vpool, st.vscale))
             for st in ex.shards._states]
    item = 1 if pool_dtype == "int8" else 4
    N = SERVE["num_blocks"]
    single = 2 * (N * SERVE["block_size"] * SERVE["d"] * item + 4 * N)
    pa.paged_attn_step_cuda.launches = 0
    streams, st = serve_once(torch, ex, prompts, card)
    launches = pa.paged_attn_step_cuda.launches
    check(ex.shards.outstanding() == 0, f"shard {label}: leaked steps")
    spec = ""
    if ex.spec is not None:
        kv = ex.kv_stats()
        check(kv["spec_verify_steps"] > 0, f"shard {label}: no verify step")
        spec = (f"{kv['spec_verify_steps']} verify steps, accept rate "
                f"{kv['spec_accept_rate']}, ")
    shard_close(ex)
    if axis == "head":
        check(launches == world * st["steps"] > 0,
              f"shard {label}: {launches} kernel launches for "
              f"{st['steps']} steps of {world} ranks")
    else:
        check(launches == 0, f"shard {label}: a page lane launched the "
              f"kernel {launches} times")
    at = first_diff(streams, gold[:len(streams)])
    if check_gold:
        check(at is None, f"shard {label}: streams differ from the single "
              f"worker's first at request {at and at[0]}, token "
              f"{at and at[1]}")
        agree = "== the single worker's token for token"
    elif at is None:
        agree = "== the single worker's (logged, not checked)"
    else:
        agree = (f"first differ from the single worker's at request "
                 f"{at[0]}, token {at[1]} (logged, not checked: the "
                 f"rank-ordered fold reassociates the softmax otherwise "
                 f"than the kernel's chunk combine)")
    log(f"shard {label}: {len(prompts)} requests x {MAX_TOKENS} tokens, "
        f"{st['steps']} steps, {spec}kernel launches {launches}, wall "
        f"{st['wall_s']:.3f} s -> {st['gen_tok_per_s']:.1f} generated "
        f"tok/s, {st['step_ms']:.3f} ms/step (setup {setup:.1f} s); "
        f"resident pool bytes a rank {ranks} vs the single worker's "
        f"{single} ({', '.join(f'{b / single:.4f}' for b in ranks)} of "
        f"it); streams {agree} [{card}]")
    del ex
    torch.cuda.empty_cache()
    return streams, launches


def shard_direct(torch, card, pool_dtype):
    """One window through ``PagedDecodeStep`` and through the rank steps of
    every lane's partition, each on its own copy of one pre-filled pool
    (random codes or rows and per-block scales over all 8192 blocks;
    phase 3's tables, contexts and prefill/decode mix; host-fed tokens).
    Each rank's pools must be bitwise the single pool's slice; the
    world-1 head rank's ``o`` is ``paged_attn_step_cuda`` at H = 32 on
    the single worker's inputs, and its pools must be the single
    worker's; a head rank's ``o_r`` must be bitwise those heads of it and
    hold against the rank's ``kernel="torch"`` output within phase 3's
    bar; the page axis's merged ``o`` must hold against it on the
    appended rows within PAGE_O_RTOL / PAGE_O_ATOL."""
    from dpu_operator_tpu_torch.parallel.ring_attention import (
        merge_partial_softmax)
    from dpu_operator_tpu_torch.serving.disagg.spec import KVSpec
    from dpu_operator_tpu_torch.serving.kvcache.paged import (
        PagedDecodeStep, PagedRankStep, build_paged_params,
        params_from_numpy)

    S, C, H, dh, N = KS, KC, KH, KDH, KN
    dims = dict(slots=S, vocab=SERVE["vocab"], d=SERVE["d"], heads=H,
                block_size=KBS, num_blocks=N, max_blocks_per_req=KB,
                chunk=C, seed=SERVE["seed"], pool_dtype=pool_dtype,
                device="cuda")
    params = params_from_numpy(build_paged_params(
        SERVE["seed"], SERVE["vocab"], SERVE["d"], KB * KBS), "cuda")
    args, ctx, n_new = kernel_inputs(torch, pool_dtype, False)
    tables, ctx_t, n_new_t = args[0], args[1], args[2]
    kpool, vpool = args[10], args[11]
    del args
    rng = np.random.RandomState(7)
    if pool_dtype == "int8":
        kscale, vscale = (torch.from_numpy(rng.uniform(
            0.01, 0.03, N).astype(np.float32)).cuda() for _ in range(2))
    else:
        kscale, vscale = (torch.ones(N, device="cuda") for _ in range(2))
    base = (kpool, kscale, vpool, vscale)
    step_in = (torch.from_numpy(rng.randint(0, SERVE["vocab"], S).astype(
                   np.int32)).cuda(),
               torch.from_numpy(rng.randint(0, SERVE["vocab"], (S, C))
                                .astype(np.int32)).cuda(),
               torch.ones(S, dtype=torch.bool, device="cuda"),
               ctx_t, n_new_t, tables)
    single = [t.clone() for t in base]
    PagedDecodeStep(**dims, params=params, kernel="cuda")(*single,
                                                          *step_in)

    def rank(axis, world, r, kernel=None):
        spec = KVSpec(model="paged", block_size=KBS, heads=H, d_head=dh,
                      vocab=SERVE["vocab"], max_blocks_per_req=KB,
                      pool_dtype=pool_dtype, seed=SERVE["seed"],
                      shard_axis=axis if world > 1 else "none",
                      world=world)
        (h_lo, h_hi), (b_lo, b_hi) = spec.rank_heads(r), spec.rank_blocks(
            r, N)
        kp, ks, vp, vs = base
        if axis == "head":
            pools = [kp[:, :, h_lo:h_hi].contiguous(), ks.clone(),
                     vp[:, :, h_lo:h_hi].contiguous(), vs.clone()]
        else:
            pools = [t[b_lo:b_hi].clone() for t in base]
        # kernel=None: the kernel for a head rank, plain for a page rank.
        step = PagedRankStep(**dict(dims, kernel=kernel), shard_axis=axis,
                             head_bounds=(h_lo, h_hi),
                             block_bounds=(b_lo, b_hi), params=params)
        out = step(*pools, *step_in)
        return out[:4], out[4:], (h_lo, h_hi), (b_lo, b_hi)

    def same(a, b):
        return torch.equal(bits(torch, a), bits(torch, b))

    pools1, (o_full,), _, _ = rank("head", 1, 0)
    for name, a, b in zip(("kpool", "kscale", "vpool", "vscale"), pools1,
                          single):
        check(same(a, b), f"shard direct {pool_dtype}: the world-1 head "
              f"rank's {name} differs from PagedDecodeStep's")
    del pools1
    rows = [(s, int(n_new[s])) for s in range(S) if n_new[s]]
    for axis, world in (("head", 2), ("head", 4), ("page", 2),
                        ("page", 3)):
        parts = []
        for r in range(world):
            pools, out, (h_lo, h_hi), (b_lo, b_hi) = rank(axis, world, r)
            for name, a, b in zip(("kpool", "kscale", "vpool", "vscale"),
                                  pools, single):
                want = (b[b_lo:b_hi] if axis == "page" else
                        b[:, :, h_lo:h_hi] if name.endswith("pool") else b)
                check(same(a, want), f"shard direct {pool_dtype} {axis} "
                      f"world {world} rank {r}: {name} is not the single "
                      f"pool's slice")
            if axis == "head":
                o_r = out[0]
                check(same(o_r, o_full[:, :, h_lo:h_hi].contiguous()),
                      f"shard direct {pool_dtype} head world {world} rank "
                      f"{r}: o_r is not bitwise heads {h_lo}..{h_hi} of "
                      f"the kernel's output at H = {H}")
                if world == 2:
                    _, (o_t,), _, _ = rank(axis, world, r, "torch")
                    err = float((o_r - o_t).abs().max())
                    check(torch.allclose(o_r, o_t, rtol=O_RTOL,
                                         atol=O_ATOL),
                          f"shard direct {pool_dtype} head rank {r}: cuda "
                          f"vs torch o_r by {err}")
                    log(f"shard direct {pool_dtype} head world 2 rank {r}:"
                        f" kernel vs plain o_r max |err| {err:.3e} (rtol "
                        f"{O_RTOL}, atol {O_ATOL})")
                    del o_t
            else:
                parts.append(tuple(t.cpu().numpy() for t in out))
            del pools, out
            torch.cuda.empty_cache()
        if axis == "page":
            o = np.transpose(merge_partial_softmax(parts), (0, 2, 1, 3))
            want = o_full.cpu().numpy()
            err = max(float(np.abs(o[s, :n] - want[s, :n]).max())
                      for s, n in rows)
            ok = all(np.allclose(o[s, :n], want[s, :n], rtol=PAGE_O_RTOL,
                                 atol=PAGE_O_ATOL) for s, n in rows)
            check(ok, f"shard direct {pool_dtype} page world {world}: "
                  f"merged o off the kernel's by {err}")
            log(f"shard direct {pool_dtype} page world {world}: pools "
                f"bitwise the single pool's slices, merged o vs the kernel "
                f"at H = {H} on the appended rows max |err| {err:.3e} "
                f"(bar rtol {PAGE_O_RTOL}, atol {PAGE_O_ATOL}) [{card}]")
        else:
            log(f"shard direct {pool_dtype} head world {world}: pools "
                f"bitwise the single pool's slices, o_r bitwise the "
                f"kernel's heads at H = {H} [{card}]")
        del parts
    del base, single, o_full, params
    torch.cuda.empty_cache()


def phase_shard(torch, card, gold):
    """Context-parallel paged KV at the served model's full width, through
    the entry point (HTTP -> batcher -> ShardedPagedKVExecutor, rank
    threads sharing the card, each on its own stream). ``gold`` holds the
    single worker's streams by pool dtype (phase 4's int8, phase 12's
    fp32 sync). Returns the kernel launches of the head lanes."""
    prompts = serve_prompts()
    for pool_dtype in ("int8", "fp32"):
        shard_direct(torch, card, pool_dtype)
    launches = 0
    for world, pool_dtype, mode in SHARD_HEAD_LANES:
        _, n = shard_run(torch, card, f"head world {world} {pool_dtype} "
                         f"{mode}", prompts, pool_dtype, world, "head",
                         gold[pool_dtype], True, mode=mode)
        launches += n
    _, n = shard_run(torch, card, "head world 2 fp32 speculative", prompts,
                     "fp32", 2, "head", gold["fp32"], True,
                     mode="speculative", spec_k=SPEC_K)
    launches += n
    for world, pool_dtype in SHARD_PAGE_LANES:
        shard_run(torch, card, f"page world {world} {pool_dtype} sync",
                  prompts[:SHARD_PAGE_REQUESTS], pool_dtype, world, "page",
                  gold[pool_dtype], False, mode="sync")
    log(f"shard: head lanes == the single worker's streams, {launches} "
        f"kernel launches == world x steps; page lanes launch none")
    return launches


# -- phase 14: row-plane decode with the Switch MoE ---------------------------

# The repo's row-plane model (S stages of a dense pair and a top-1 Switch
# MoE, as train_step._stage_fn routes) at Mixtral-8x7B's widths
# (mistralai/Mixtral-8x7B-v0.1 config.json: hidden_size 4096,
# intermediate_size 14336 for the dense pair and each expert,
# num_local_experts 8): ep = 8, one expert a rank, the ranks sharing the
# card. Depth cut to 4 of its 32 layers: one f32 stage is 4.228 GB, 32
# would be 135 GB. dp = tp = 1; 64 slots, 8 rows a rank; random weights.
ROW_MODEL = dict(S=4, d=4096, h=14336, E=8)
ROW_SLOTS = 64
ROW_REQUESTS = 64
ROW_TOKENS = 32
# capacity_factor 8: C equals a rank's rows, so serving is dropless (as
# Mixtral inference is) and the three ep = 8 lanes' streams must agree.
ROW_SERVE_CF = 8.0
ROW_IDLE_VECTORS = 4
ROW_REPEATS = 20
# The dp x tp lane: two row groups of the 8 ep ranks (4 rows a rank), the
# dense pair cut into two tp shards of 7168, the same weights.
ROW_DPTP = {"dp": 2, "tp": 2, "ep": 8}
# The cf = 8 direct step against the dense composition (every expert on
# every row, moe.dense_reference): the same f32 products in other GEMM
# shapes, 4 stages deep, values of order 1.
ROW_DENSE_ATOL = 1e-4

# Phase 15: the GPipe training step at phase 14's widths and seed: pp = 4
# stages (the same 4 of 32 layers), tp = 2 (w1 cut on its columns, w2 on
# its rows), ep = 8; M = 4 microbatches of 2 sequences of 64 tokens, so a
# rank routes 16 rows (2 sequences x 8 tokens) and the exchanges carry
# [8 x 8 x C, 4096] f32; capacity factor 1: C = 2, rows dropped.
TRAIN_MESH = {"dp": 1, "pp": 4, "sp": 1, "tp": 2, "ep": 8}
TRAIN_BATCH = (4, 2, 64)  # M, mb, seq
TRAIN_CF = 1.0
TRAIN_LR = 0.05
TRAIN_STEPS = 3
TRAIN_REPEATS = 5
TRAIN_TIMED = 3
# The kernel step's loss against the port's dense twin on the card (every
# expert on every row, each piece's capacity reproduced): the bar of the
# reference's own test of its distributed loss against its twin.
TRAIN_DENSE_RTOL = 2e-5

# Phase 16: the 1F1B training step on phase 15's model and batch with the
# attention branch (wq/wk/wv [4, 4096, 4096] f32 after the other weights,
# seed 0): two lanes, each the same 4-stage model, and the GPipe step at
# pp = 4 with attention beside them.
TRAIN_1F1B_LANES = (("a", {"dp": 1, "pp": 4, "sp": 1, "tp": 2, "ep": 8}, 1),
                    ("b", {"dp": 1, "pp": 2, "sp": 1, "tp": 2, "ep": 8}, 2))
TRAIN_1F1B_REPEATS = 3
# The memory lane: M, mb, seq of a batch whose activations fill a real
# share of the card (16 384 tokens, 128 rows a rank, sequences of 512):
# GPipe keeps every microbatch's graph until its backward, 1F1B at most
# the scheduler's stash slots' inputs and one B unit's graph.
TRAIN_1F1B_MEMORY_BATCH = (16, 2, 512)
# 1F1B against GPipe on the same weights: each unit's forward is the same
# stage on the same inputs, so the activations and the routing are the same
# bits; what differs is the order of sums. The loss: per microbatch here,
# per (rank, all microbatches) there, each a tree sum of 2^18-2^19 positive
# terms, within log2(N)·u ≈ 19·2^-24 ≈ 1.1e-6 of its value, so the two
# within ~2.4e-6. A gradient element: the loss cotangent rounded once (one
# division by M·mb·seq·d) against twice (by M·mb·seq, then by d), 2 ulp,
# carried linearly through each microbatch's backward, and its M = 4
# contributions added in another order, 3 ulp of their magnitudes: each
# leaf's largest difference within ~5·4·2^-24 ≈ 1.2e-6 of its largest
# magnitude. Bars ~2x and ~8x those. The memory lane's losses: 2^22 and
# 2^23 terms, within ~2.8e-6 of each other, under the same bar.
TRAIN_1F1B_LOSS_RTOL = 5e-6
TRAIN_1F1B_GRAD_RTOL = 1e-5  # of each leaf's largest magnitude


def row_bodies(prompts):
    return [{"prompt": p, "max_tokens": ROW_TOKENS, "deadline_ms": 600000}
            for p in prompts]


def row_updates(d):
    """The direct steps' 64 admitted rows, as the server encodes prompts."""
    from dpu_operator_tpu_torch.serving import encode_prompt

    return [(i, encode_prompt(f"rows direct {i}", d))
            for i in range(ROW_SLOTS)]


def row_dense(torch, moe, params, x):
    """The stage stack with each stage's MoE computed densely (every
    expert on every row: ``moe.dense_reference``), capacity unbounded."""
    for s in range(params["router"].shape[0]):
        y = torch.tanh(torch.relu(x @ params["w1"][s]) @ params["w2"][s])
        x = y + moe.dense_reference(y, params["router"][s],
                                    params["moe_w1"][s], params["moe_w2"][s])
    return x


def row_direct(torch, card, params):
    """Direct DecodeStep checks at full width: kernel 10 against the plain
    exchange bitwise at cf = 1 (rows dropped), 2·S launches a step, 20
    repeats bitwise, the idle-slot check in slots 0 and 63; at cf = 8
    within ``ROW_DENSE_ATOL`` of the dense composition. Returns the cf = 8
    step's device ms, kernel and plain exchange."""
    from dpu_operator_tpu_torch.parallel import moe
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.serving import infer

    S, d, E = ROW_MODEL["S"], ROW_MODEL["d"], ROW_MODEL["E"]
    mesh = infer.serving_mesh(shape={"ep": E})
    ups = row_updates(d)
    steps = {k: infer.DecodeStep(mesh, params, ROW_SLOTS, 1.0, kernel=k,
                                 device="cuda") for k in ("cuda", "torch")}
    dk = steps["cuda"]
    before = rp.all_to_all_cuda.launches
    yk, tk = dk(dk.init_state(), ups)
    torch.cuda.synchronize()
    launches = rp.all_to_all_cuda.launches - before
    check(launches == 2 * S, f"rows cf=1: {launches} all-to-all launches "
          f"in a step of {S} stages")
    yt, tt = steps["torch"](steps["torch"].init_state(), ups)
    torch.cuda.synchronize()
    check(rp.all_to_all_cuda.launches - before == 2 * S,
          "rows cf=1: the plain exchange launched the kernel")
    check(same_bits(torch, yk, yt) and torch.equal(tk, tt),
          "rows cf=1: kernel 10 and the plain exchange differ")
    check(torch.isfinite(yk).all() and yk.shape == (ROW_SLOTS, d),
          f"rows cf=1: y {tuple(yk.shape)} not finite")
    # Drops at C = 1 in the first stage: assignments whose keep is 0.
    x0 = torch.stack([torch.from_numpy(r) for _, r in ups]).cuda()
    y0 = torch.tanh(torch.relu(x0 @ params["w1"][0]) @ params["w2"][0])
    rt = moe.route(y0.view(E, ROW_SLOTS // E, d), params["router"][0],
                   capacity_factor=1.0)
    dropped = int((rt["keep"] == 0).sum())
    check(dropped > 0, "rows cf=1: no assignment dropped at C = 1")
    for i in range(ROW_REPEATS):
        again, tok = dk(dk.init_state(), ups)
        check(same_bits(torch, again, yk) and torch.equal(tok, tk),
              f"rows cf=1 repeat {i}: differs from the first step's bits")
    gen = np.random.RandomState(14)
    worst = 0.0
    for _ in range(ROW_IDLE_VECTORS):
        r = gen.randn(d).astype(np.float32)
        y_first, _ = dk(dk.init_state(), [(0, r)])
        y_last, _ = dk(dk.init_state(), [(ROW_SLOTS - 1, r)])
        check(torch.allclose(y_first[0], y_last[-1], rtol=1e-5, atol=1e-6),
              "rows idle slots: slot 0 and slot 63 decode differently")
        check(not y_first[1:].any() and not y_last[:-1].any(),
              "rows idle slots: an idle row is not exactly zero")
        worst = max(worst, float((y_first[0] - y_last[-1]).abs().max()))
    log(f"rows direct cf=1 (C = 1, {dropped} of {ROW_SLOTS} first-stage "
        f"assignments dropped): kernel 10 == plain exchange bit for bit, "
        f"{launches} launches a step (2 x {S} stages), {ROW_REPEATS} "
        f"repeats bitwise; one row alone in slot 0 and in slot "
        f"{ROW_SLOTS - 1} (ranks 0 and {E - 1}) within rtol 1e-5, atol "
        f"1e-6 (max |diff| {worst:.3e}), idle rows exactly zero [{card}]")
    del steps, dk, yk, yt, again, y_first, y_last

    d8 = {k: infer.DecodeStep(mesh, params, ROW_SLOTS, ROW_SERVE_CF,
                              kernel=k, device="cuda")
          for k in ("cuda", "torch")}
    y8, _ = d8["cuda"](d8["cuda"].init_state(), ups)
    dense = row_dense(torch, moe, params, x0)
    err = float((y8 - dense).abs().max())
    check(err <= ROW_DENSE_ATOL, f"rows cf=8: max |y - dense| {err:.3e} > "
          f"{ROW_DENSE_ATOL}")
    times = {k: time_ms(torch, lambda k=k: d8[k](y8, ()), n=5, warm=2,
                        batch=4) for k in d8}
    host = {}
    for k, step in d8.items():  # the host's time to queue one step
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(y8, ())
            samples.append((time.perf_counter() - t0) * 1e3)
        host[k] = statistics.median(samples)
    torch.cuda.synchronize()
    log(f"rows direct cf={ROW_SERVE_CF:g}: y within {ROW_DENSE_ATOL} of the "
        f"dense composition (max |err| {err:.3e}); a step {times['cuda']:.3f} "
        f"ms with kernel 10, {times['torch']:.3f} ms with the plain "
        f"exchange; the host queues a step in {host['cuda']:.3f} / "
        f"{host['torch']:.3f} ms [{card}]")
    del d8, y8, dense
    torch.cuda.empty_cache()
    return times


def row_dptp_lane(torch, card, params, prompts, ep8_streams, executors):
    """The row plane at dp 2 x tp 2 x ep 8 (``ROW_DPTP``: 32 ranks stacked
    on the card, phase 14's weights shared, 4 rows a rank): a direct step
    at capacity factor 1 with kernel 10 == the plain exchange bit for bit,
    2·S launches; at capacity factor 8 (dropless) within ROW_DENSE_ATOL of
    the ep = 8 step on the same batch (the tp partials summed in another
    order); then the 64 requests pipelined with kernel 10 and with the
    plain exchange, whose streams must be identical, and whether they
    equal the ep = 8 lanes' (``ep8_streams``) is logged. Adds the served
    executors' weak references to ``executors``; returns the kernel
    lane's launches (its main path, counts at 0)."""
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.serving import infer

    S, d, E = ROW_MODEL["S"], ROW_MODEL["d"], ROW_MODEL["E"]
    mesh = infer.serving_mesh(shape=ROW_DPTP)
    label = " ".join(f"{a}={n}" for a, n in ROW_DPTP.items())
    groups = ROW_DPTP["dp"] * E
    ups = row_updates(d)
    steps = {k: infer.DecodeStep(mesh, params, ROW_SLOTS, 1.0, kernel=k,
                                 device="cuda") for k in ("cuda", "torch")}
    before = rp.all_to_all_cuda.launches
    yk, tk = steps["cuda"](steps["cuda"].init_state(), ups)
    torch.cuda.synchronize()
    launches = rp.all_to_all_cuda.launches - before
    check(launches == 2 * S, f"rows {label} cf=1: {launches} all-to-all "
          f"launches in a step of {S} stages")
    yt, tt = steps["torch"](steps["torch"].init_state(), ups)
    torch.cuda.synchronize()
    check(rp.all_to_all_cuda.launches - before == 2 * S,
          f"rows {label} cf=1: the plain exchange launched the kernel")
    check(same_bits(torch, yk, yt) and torch.equal(tk, tt),
          f"rows {label} cf=1: kernel 10 and the plain exchange differ")
    check(torch.isfinite(yk).all() and yk.shape == (ROW_SLOTS, d),
          f"rows {label} cf=1: y {tuple(yk.shape)} not finite")
    rows = ROW_SLOTS // groups
    C = math.ceil(rows / E)
    log(f"rows direct {label} cf=1 ({rows} rows a rank, C = {C}; the dp = "
        f"{ROW_DPTP['dp']} row groups folded into the exchange's width: "
        f"[{E * E * C}, {ROW_DPTP['dp'] * d}] f32, blocks of {C} rows): "
        f"kernel 10 == plain exchange bit for bit, {launches} launches a "
        f"step (2 x {S} stages) [{card}]")
    del steps, yk, yt

    d8 = infer.DecodeStep(mesh, params, ROW_SLOTS, ROW_SERVE_CF,
                          kernel="cuda", device="cuda")
    e8 = infer.DecodeStep(infer.serving_mesh(shape={"ep": E}), params,
                          ROW_SLOTS, ROW_SERVE_CF, kernel="cuda",
                          device="cuda")
    y, tok = d8(d8.init_state(), ups)
    y8, tok8 = e8(e8.init_state(), ups)
    err = float((y - y8).abs().max())
    check(err <= ROW_DENSE_ATOL, f"rows {label} cf={ROW_SERVE_CF:g}: max |y "
          f"- y(ep=8)| {err:.3e} > {ROW_DENSE_ATOL}")
    ms = time_ms(torch, lambda: d8(y, ()), n=5, warm=2, batch=4)
    ms8 = time_ms(torch, lambda: e8(y8, ()), n=5, warm=2, batch=4)
    log(f"rows direct {label} cf={ROW_SERVE_CF:g}: y within {ROW_DENSE_ATOL} "
        f"of the ep=8 step's on the same batch (max |err| {err:.3e}), "
        f"{int((tok != tok8).sum())} of {ROW_SLOTS} tokens differ; a step "
        f"{ms:.3f} ms with kernel 10 (ep=8 alone {ms8:.3f} ms) [{card}]")
    del d8, e8, y, y8

    # Kernel 10 at the served shape: [E·E·C, dp·d] f32, C = 4 at cf = 8.
    C8 = math.ceil(rows / E * ROW_SERVE_CF)
    x = coll_payload(torch, E * E * C8, ROW_DPTP["dp"] * d, torch.float32,
                     seed=42)
    check(same_bits(torch, rp.all_to_all_cuda(x, E),
                    rp.all_to_all_plain(x, E)),
          f"rows {label} all-to-all: kernel != plain")
    a2a_ms = time_ms(torch, lambda: rp.all_to_all_cuda(x, E), n=10, warm=2)
    launch_ms, host_ms, seen = device_ms(
        torch, lambda: rp.all_to_all_cuda(x, E), "all_to_all_kernel")
    plain_ms = time_ms(torch, lambda: rp.all_to_all_plain(x, E), n=5,
                       warm=1, batch=2)
    library_ms = time_ms(torch, lambda: x.view(
        E, E, C8, x.shape[1]).transpose(0, 1).contiguous(), n=10, warm=2)
    xbytes = x.numel() * x.element_size()
    log(f"rows {label} all_to_all {list(x.shape)} f32 n={E} (blocks of {C8} "
        f"rows): kernel {a2a_ms:.4f} ms ({launch_ms:.4f} ms a launch on the "
        f"card, {seen}; {host_ms:.4f} ms of host time to queue a call), "
        f"plain {plain_ms:.4f} ms, view().transpose().contiguous() "
        f"{library_ms:.4f} ms, bound "
        f"{2 * xbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({xbytes} B read "
        f"and written) [{card}]")
    del x

    lanes = {}
    for kernel in ("cuda", "torch"):
        lane = f"{label} pipelined" + ("" if kernel == "cuda" else " torch")
        streams, st, ex = row_lane(torch, card, lane, params, mesh,
                                   "pipelined", kernel, prompts)
        executors.append(weakref.ref(ex))
        del ex
        want = 2 * S * st["steps"] if kernel == "cuda" else 0
        check(st["launches"] == want and st["steps"] > 0,
              f"rows {lane}: {st['launches']} kernel-10 launches for "
              f"{st['steps']} steps (want {want})")
        lanes[kernel] = (streams, st)
    check(lanes["cuda"][0] == lanes["torch"][0],
          f"rows {label}: kernel 10 and the plain exchange decode different "
          f"streams, first at {first_diff(lanes['torch'][0], lanes['cuda'][0])}")
    same = lanes["cuda"][0] == ep8_streams
    log(f"rows {label}: the kernel and plain-exchange lanes' streams "
        f"identical; equal to the ep=8 lanes' streams: {same}"
        + ("" if same else
           f" (first difference at {first_diff(lanes['cuda'][0], ep8_streams)})")
        + f"; median step interval {lanes['cuda'][1]['median_ms']:.3f} / "
        f"{lanes['torch'][1]['median_ms']:.3f} ms [{card}]")
    torch.cuda.empty_cache()
    return lanes["cuda"][1]["launches"]


def row_arrival(label, results, sent, accepted, reqs, starts):
    """Log where each served request's time went before its admission and
    after: its POST to its ``GenerateRequest``'s creation in the handler
    (the front door), that to its entry in the admission queue (the
    handler), that to its admission to a slot (the batcher), the step
    that admitted it and the steps it then decoded for, from the
    requests' own monotonic stamps and the lane's step starts; and when
    the HTTP server accepted the connections (``accepted``), from the
    first POST, split at the longest pause between two accepts. Returns
    the largest of each wait and the last admitting step."""
    door, handler, queue, admit_step, decode_steps = [], [], [], [], []
    for i, (_, body) in enumerate(results):
        req = reqs[body["id"]]
        door.append((req.arrival - sent[i]) * 1e3)
        handler.append((req.enqueued_at - req.arrival) * 1e3)
        queue.append((req.admitted_at - req.enqueued_at) * 1e3)
        first = bisect.bisect_left(starts, req.admitted_at)
        admit_step.append(first + 1)
        decode_steps.append(bisect.bisect_left(starts, req.finished_at)
                            - first)

    def spread(v, fmt="{:.1f}"):
        return (f"median {fmt.format(statistics.median(v))}, "
                f"{fmt.format(min(v))}-{fmt.format(max(v))}")

    def gaps(v):
        return spread([(b - a) * 1e3 for a, b in zip(v, v[1:])] or [0.0])

    last = max(admit_step)
    t0 = min(sent)
    acc = sorted((a - t0) * 1e3 for a in accepted)
    k = max(range(1, len(acc)), key=lambda n: acc[n] - acc[n - 1])
    log(f"rows {label} arrival: POSTs sent over {(max(sent) - t0) * 1e3:.1f}"
        f" ms; connections accepted: {k} at +{acc[0]:.0f}..+{acc[k - 1]:.0f}"
        f" ms, then {len(acc) - k} at +{acc[k]:.0f}..+{acc[-1]:.0f} ms; "
        f"POST -> created {spread(door)} ms; created -> queued "
        f"{spread(handler)} ms; queued -> admitted {spread(queue)} ms; "
        f"admitted at step {spread(admit_step, '{:g}')} of {len(starts)}; "
        f"steps from admission to finish {spread(decode_steps, '{:g}')}; "
        f"step starts {gaps(starts[:last])} ms apart up to the last "
        f"admission, {gaps(starts[last - 1:])} ms after it")
    return dict(door_ms=max(door), handler_ms=max(handler),
                queue_ms=max(queue), last_admit_step=last)


def row_lane(torch, card, label, params, mesh, mode, kernel, prompts):
    """Serve ``prompts`` over HTTP through ``ServingServer`` on a fresh
    ``LocalExecutor`` sharing ``params``; count kernel-10 launches, steps
    (submits) and the submits that returned before their step's end event
    completed; log a line and each request's arrival (``row_arrival``).
    Returns (streams, stats)."""
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.serving import LocalExecutor, ServingServer

    t0 = time.monotonic()
    ex = LocalExecutor(params=params, mesh=mesh, slots=ROW_SLOTS,
                       capacity_factor=ROW_SERVE_CF, mode=mode,
                       kernel=kernel, device="cuda")
    setup = time.monotonic() - t0
    stats = {"steps": 0, "early": 0}
    starts, late = [], []
    inner_submit, inner_step = ex.submit, ex.step

    def submit(updates, step=None, request_ids=None, occupants=None):
        starts.append(time.monotonic())
        handle = inner_submit(updates, step=step, request_ids=request_ids,
                              occupants=occupants)
        stats["steps"] += 1
        if not handle.done.query():
            stats["early"] += 1
        else:  # the step, its updates and the host time its submit took
            late.append((stats["steps"], len(updates),
                         time.monotonic() - starts[-1]))
        return handle

    def step(x):  # the sync loop's seam
        starts.append(time.monotonic())
        stats["steps"] += 1
        return inner_step(x)

    if mode == "pipelined":
        ex.submit = submit
    else:
        ex.step = step
    srv = ServingServer([ex], max_queue_depth=2 * len(prompts),
                        max_tokens_cap=ROW_TOKENS,
                        pool_opts={"watchdog_s": 300.0}).start()
    reqs, accepted = {}, []
    inner_enqueue = srv.queue.submit
    inner_accept = srv._httpd.process_request

    def enqueue(req):
        reqs[req.request_id] = req
        return inner_enqueue(req)

    def accept(request, client_address):
        accepted.append(time.monotonic())
        return inner_accept(request, client_address)

    srv.queue.submit = enqueue
    srv._httpd.process_request = accept
    # One short request first: the HTTP path's first-call costs stay out
    # of the lane's numbers.
    post(srv.url, {"prompt": "rows warm-up", "max_tokens": 2,
                   "deadline_ms": 600000}, timeout=900)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats.update(steps=0, early=0)
    starts.clear()
    late.clear()
    reqs.clear()
    accepted.clear()
    sent = [0.0] * len(prompts)
    rp.all_to_all_cuda.launches = 0
    t0 = time.monotonic()
    try:
        results = post_all(srv.url, row_bodies(prompts), sent=sent)
    finally:
        srv.stop()
        # Each seam above holds the bound method it wraps, a cycle through
        # its object: undo them, so that dropping the executor frees its
        # device memory without the cycle collector.
        for obj, name in ((ex, "submit"), (ex, "step"), (srv.queue, "submit"),
                          (srv._httpd, "process_request")):
            vars(obj).pop(name, None)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    stats["launches"] = rp.all_to_all_cuda.launches
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["wall_s"] = wall
    streams = []
    for i, res in enumerate(results):
        check(res is not None, f"rows {label} request {i}: no response")
        code, body = res
        check(code == 200, f"rows {label} request {i}: HTTP {code} {body}")
        toks = body["tokens"]
        check(len(toks) == ROW_TOKENS and not body["truncated"],
              f"rows {label} request {i}: {len(toks)} tokens")
        check(all(0 <= t < ROW_MODEL["d"] for t in toks),
              f"rows {label} request {i}: token out of range")
        streams.append(toks)
    steps = stats["steps"]
    stats["step_ms"] = wall / max(steps, 1) * 1e3
    gaps = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    stats["median_ms"] = statistics.median(gaps) if gaps else 0.0
    early = (f", {stats['early']} of {steps} submits returned before their "
             f"step's end ({stats['early'] / max(steps, 1):.3f}"
             + "".join(f"; step {k} not: {n} updates, its submit "
                       f"{t * 1e3:.3f} ms" for k, n, t in late) + ")"
             if mode == "pipelined" else "")
    log(f"rows {label}: {len(prompts)} requests x {ROW_TOKENS} tokens, "
        f"{steps} steps in {wall:.3f} s -> {stats['step_ms']:.3f} ms a step "
        f"(median {stats['median_ms']:.3f} ms between step starts), "
        f"{ROW_TOKENS * len(prompts) / wall:.1f} generated tok/s, kernel-10 "
        f"launches {stats['launches']}, peak device memory "
        f"{stats['peak_gb']:.3f} GB{early} (setup {setup:.1f} s) [{card}]")
    stats.update(row_arrival(label, results, sent, accepted, reqs, starts))
    return streams, stats, ex


def row_profile(torch, card, ex, prompts):
    """One more served run of the ep = 8 pipelined executor under
    ``torch.profiler``: device time by kernel and the device's idle share
    (an upper bound: the profiler's host cost inflates the wall)."""
    from torch.profiler import ProfilerActivity, profile

    from dpu_operator_tpu_torch.serving import ServingServer

    srv = ServingServer([ex], max_queue_depth=2 * len(prompts),
                        max_tokens_cap=ROW_TOKENS,
                        pool_opts={"watchdog_s": 300.0}).start()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        try:
            post_all(srv.url, row_bodies(prompts))
        finally:
            srv.stop()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    log_a2a_profile(card, "rows profile pipelined ep=8", prof, wall_ms)


def log_a2a_profile(card, label, prof, wall_ms):
    """Log a profiled run's device busy time against its wall, kernel 10's
    share and the ten kernels that took the most device time."""
    rows, busy_ms = device_rows(prof)
    check(busy_ms > 0, f"{label}: no device time recorded")
    a2a = [r for r in rows if "all_to_all" in r[2]]
    log(f"{label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f}, profiled) in "
        f"{sum(r[1] for r in rows)} device operations; kernel 10 "
        f"{sum(r[0] for r in a2a) / 1e3:.3f} ms over "
        f"{sum(r[1] for r in a2a)} launches [{card}]")
    for us, count, key in rows[:10]:
        log(f"  {us / 1e3:10.3f} ms {us / 1e3 / busy_ms:6.3f}  x{count:<6d} "
            f"{key[:90]}")


def phase_rows(torch, card, record):
    """Row-plane decode at Mixtral-8x7B's widths through the entry point
    (HTTP -> batcher -> LocalExecutor -> DecodeStep -> the stage stack and
    its Switch MoE, whose two exchanges a stage launch kernel 10 at ep =
    8): the direct checks, kernel 10 at the MoE's shape, four served lanes
    and one profiled run. Adds the MoE's numbers to kernel 10's
    ``record``; returns the served lanes' kernel-10 launches."""
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.parallel import train_step as ts
    from dpu_operator_tpu_torch.serving import ServingServer, infer

    S, d, h, E = (ROW_MODEL[k] for k in ("S", "d", "h", "E"))
    # What earlier phases leave allocated, with no collect: a stopped,
    # dropped ServingServer is freed by reference counting (its HTTP
    # handler holds it weakly), with its pool's executors and their device
    # tensors, so none should be alive here.
    objs = gc.get_objects()
    servers = sum(type(o) is ServingServer for o in objs)
    held = sorted(((o.numel() * o.element_size(), tuple(o.shape), o.dtype)
                   for o in objs if type(o) is torch.Tensor and o.is_cuda),
                  key=lambda t: t[0], reverse=True)
    del objs
    log(f"rows: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated on "
        f"entry with {servers} ServingServers alive; Python's tensors on "
        f"the card: {len(held)}, {sum(t[0] for t in held) / 1e9:.3f} GB, the "
        f"largest {[t[1:] for t in held[:4]]} [{card}]")
    t0 = time.monotonic()
    params = ts.init_params(S, d, h, E, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"rows: weights {nbytes / 1e9:.3f} GB f32 ({S} stages of d {d}, "
        f"h {h}, {E} experts) drawn on the card in "
        f"{time.monotonic() - t0:.1f} s [{card}]")
    step_ms = row_direct(torch, card, params)

    # Kernel 10 at the MoE's shape: [E·E·C, d] f32, C = 8 at cf = 8.
    C = math.ceil(ROW_SLOTS // E / E * ROW_SERVE_CF)
    x = coll_payload(torch, E * E * C, d, torch.float32, seed=41)
    check(same_bits(torch, rp.all_to_all_cuda(x, E),
                    rp.all_to_all_plain(x, E)),
          "rows all-to-all: kernel != plain")
    ms = time_ms(torch, lambda: rp.all_to_all_cuda(x, E), n=10, warm=2)
    plain_ms = time_ms(torch, lambda: rp.all_to_all_plain(x, E), n=5,
                       warm=1, batch=2)
    library_ms = time_ms(torch, lambda: x.view(E, E, C, d).transpose(
        0, 1).contiguous(), n=10, warm=2)
    launch_ms, host_ms, seen = device_ms(
        torch, lambda: rp.all_to_all_cuda(x, E), "all_to_all_kernel")
    xbytes = x.numel() * x.element_size()
    bound = 2 * xbytes / HBM_BYTES_PER_S * 1e3
    log(f"rows all_to_all [{E * E * C}, {d}] f32 n={E} (blocks of {C} rows, "
        f"{C * d * 4} B): kernel {ms:.4f} ms ({launch_ms:.4f} ms a launch on "
        f"the card, {seen}; {host_ms:.4f} ms of host time to queue a call), "
        f"plain {plain_ms:.4f} ms, view().transpose().contiguous() "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms ({xbytes} B read and "
        f"written) [{card}]")
    del x

    mesh = infer.serving_mesh(shape={"ep": E})
    prompts = [f"rows request {i}" for i in range(ROW_REQUESTS)]
    lanes = {}
    profiled = None
    executors = []
    for label, mode, kernel in (("ep=8 pipelined", "pipelined", "cuda"),
                                ("ep=8 sync", "sync", "cuda"),
                                ("ep=8 pipelined torch", "pipelined",
                                 "torch")):
        streams, st, ex = row_lane(torch, card, label, params, mesh, mode,
                                   kernel, prompts)
        executors.append(weakref.ref(ex))
        want = 2 * S * st["steps"] if kernel == "cuda" else 0
        check(st["launches"] == want and st["steps"] > 0,
              f"rows {label}: {st['launches']} kernel-10 launches for "
              f"{st['steps']} steps (want {want})")
        lanes[label] = (streams, st)
        if profiled is None:
            profiled = ex
        else:
            del ex
    base, first = lanes["ep=8 pipelined"]
    check(first["early"] >= first["steps"] / 2,
          f"rows: only {first['early']} of {first['steps']} pipelined "
          f"submits returned before their step's end")
    for label, (streams, _) in lanes.items():
        check(streams == base, f"rows {label}: streams differ from ep=8 "
              f"pipelined first at {first_diff(streams, base)}")
    distinct = [len(set(s)) for s in base]
    check(len({tuple(s) for s in base}) > 1, "rows: identical streams")
    log(f"rows: the three ep=8 lanes' streams identical; distinct tokens "
        f"a stream {min(distinct)}-{max(distinct)}")
    row_profile(torch, card, profiled, prompts)
    served = first["launches"] + lanes["ep=8 sync"][1]["launches"]
    del profiled
    torch.cuda.empty_cache()
    record["row_dptp_launches"] = row_dptp_lane(torch, card, params, prompts,
                                                base, executors)

    p1 = ts.init_params(S, d, h, 1, seed=1, device="cuda")
    _, st1, ex1 = row_lane(torch, card, "ep=1 pipelined", p1,
                           infer.serving_mesh(), "pipelined", None, prompts)
    check(st1["launches"] == 0, f"rows ep=1: {st1['launches']} kernel-10 "
          f"launches (a ring of one launches none)")
    executors.append(weakref.ref(ex1))
    del ex1, p1, params
    alive = sum(r() is not None for r in executors)
    check(not alive, f"rows: {alive} of {len(executors)} served "
          f"LocalExecutors outlive their stopped servers and their last "
          f"reference")
    torch.cuda.empty_cache()
    log(f"rows: the {len(executors)} served LocalExecutors freed with their "
        f"stopped servers, no collect; {torch.cuda.memory_allocated() / 1e9:.3f}"
        f" GB left allocated [{card}]")
    record.update(moe_launches=served, moe_ms=ms, moe_bound_ms=bound,
                  moe_plain_ms=plain_ms, moe_library_ms=library_ms,
                  moe_step_ms=step_ms["cuda"])
    return served


def train_step_times(torch, step, params, x, tgt):
    """(device ms by events, host ms to return, peak GB) of ``step(params,
    x, tgt)``: medians of ``TRAIN_TIMED`` steps, each between a
    synchronisation and two CUDA events, and the largest step's peak (the
    peak statistics reset before each); the new weights are dropped at
    once."""
    dev, host, peak = [], [], 0.0
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        _, new = step(params, x, tgt)
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
        del new
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
    return statistics.median(dev), statistics.median(host), peak


def train_exchange(torch, card, moe, rp, E, rows, width):
    """Kernel 10 at the training step's exchange shape, forward and
    backward through ``moe.kernel_exchange``: the gradient equals the
    plain exchange of the incoming one bit for bit; each direction timed
    (one launch), the plain version and the library's transpose beside
    them. Returns the numbers for kernel 10's record."""
    x = coll_payload(torch, rows, width, torch.float32, seed=43)
    g = coll_payload(torch, rows, width, torch.float32, seed=44)
    xr = x.clone().requires_grad_()
    y = moe.kernel_exchange(xr, E)
    (gx,) = torch.autograd.grad(y, xr, g, retain_graph=True)
    check(same_bits(torch, y.detach(), rp.all_to_all_plain(x, E))
          and same_bits(torch, gx, rp.all_to_all_plain(g, E)),
          "train all-to-all: kernel forward or backward != plain")
    fwd = time_ms(torch, lambda: moe.kernel_exchange(xr, E), n=10, warm=2)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        y, xr, g, retain_graph=True), n=10, warm=2)
    plain = time_ms(torch, lambda: rp.all_to_all_plain(x, E), n=5, warm=1,
                    batch=2)
    library = time_ms(torch, lambda: x.view(E, E, rows // E // E, width)
                      .transpose(0, 1).contiguous(), n=10, warm=2)
    nbytes = x.numel() * x.element_size()
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    log(f"train all_to_all [{rows}, {width}] f32 n={E} (blocks of "
        f"{rows // E // E} rows): forward {fwd:.4f} ms, backward (autograd, "
        f"one launch on the gradient) {bwd:.4f} ms, gradient == plain "
        f"exchange of the cotangent bit for bit; plain {plain:.4f} ms, "
        f"view().transpose().contiguous() {library:.4f} ms, bound "
        f"{bound:.4f} ms ({nbytes} B read and written) [{card}]")
    return dict(train_ms=fwd, train_bwd_ms=bwd, train_plain_ms=plain,
                train_library_ms=library, train_bound_ms=bound)


def train_profile(torch, card, step, params, x, tgt,
                  label="train profile, one kernel step"):
    """One kernel step under ``torch.profiler``: device busy time against
    the wall, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, new = step(params, x, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    del new
    log_a2a_profile(card, label, prof, wall_ms)


def phase_train(torch, card, record):
    """The GPipe training step (``make_train_step``: the pipelined forward
    over 4 stages, the tp = 2 dense pair, each stage's Switch MoE over 8
    ep ranks with its two exchanges on kernel 10, the loss, its gradient,
    SGD) at phase 14's widths and seed: launches in a step against 4 x the
    step's MoE calls, loss and every gradient leaf with kernel 10 == the
    plain exchange's bit for bit, the loss against the dense twin,
    repeats bitwise, the loss descending over three steps, step time and
    peak memory. Adds the training numbers to kernel 10's ``record``."""
    from dpu_operator_tpu_torch.parallel import moe
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.parallel import train_step as ts

    S, d, h, E = (ROW_MODEL[k] for k in ("S", "d", "h", "E"))
    mesh = dict(TRAIN_MESH)
    check(mesh["pp"] == S and mesh["ep"] == E, "train mesh != phase 14's")
    M, mb, seq = TRAIN_BATCH
    torch.cuda.empty_cache()  # earlier phases' cached blocks, fragmented
    log(f"train: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated on "
        f"entry [{card}]")
    peaks = []

    def peak():  # the peak since the last call, in GB
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        return peaks[-1]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = ts.init_params(S, d, h, E, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    tgt = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"train: weights {nbytes / 1e9:.3f} GB f32 (phase 14's, seed 0), x "
        f"and target [{M}, {mb}, {seq}, {d}], mesh {mesh}, capacity factor "
        f"{TRAIN_CF:g}, drawn in {time.monotonic() - t0:.1f} s [{card}]")
    step_k, loss_k = ts.make_train_step(mesh, capacity_factor=TRAIN_CF,
                                        lr=TRAIN_LR, kernel="cuda",
                                        device="cuda")
    step_p, loss_p = ts.make_train_step(mesh, capacity_factor=TRAIN_CF,
                                        lr=TRAIN_LR, kernel="torch",
                                        device="cuda")
    sizes = ts._mesh_sizes(mesh)
    rows = mb * seq // E
    C = math.ceil(rows / E * TRAIN_CF)
    with torch.no_grad():  # the first stage's routing of microbatch 0
        x0 = ts._token_groups(x, sizes, True)[0]
        y0 = torch.tanh(torch.relu(x0 @ params["w1"][0]) @ params["w2"][0])
        dropped = int((moe.route(y0, params["router"][0],
                                 capacity_factor=TRAIN_CF)["keep"] == 0)
                      .sum())
    check(dropped > 0, f"train: no assignment dropped at C = {C}")

    # The main path's counts: a forward, then a step's value and gradient.
    rp.all_to_all_cuda.launches = 0
    with torch.no_grad():
        loss_fwd = loss_k(params, x, tgt)
    torch.cuda.synchronize()
    fwd = rp.all_to_all_cuda.launches
    rp.all_to_all_cuda.launches = 0
    t0 = time.monotonic()
    lk, gk = ts.value_and_grad(loss_k, params, x, tgt)
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    launches = rp.all_to_all_cuda.launches
    calls = S * M
    check(fwd == 2 * calls and launches == 4 * calls,
          f"train: {fwd} kernel-10 launches in a forward, {launches} in a "
          f"step (want 2 and 4 x {calls} MoE calls)")
    lp, gp = ts.value_and_grad(loss_p, params, x, tgt)
    torch.cuda.synchronize()
    check(rp.all_to_all_cuda.launches == launches,
          "train: the plain exchange launched the kernel")
    check(same_bits(torch, lk, loss_fwd), "train: the loss under autograd "
          "differs from the forward's bits")
    check(same_bits(torch, lk, lp), f"train: loss {float(lk)!r} with kernel "
          f"10, {float(lp)!r} with the plain exchange")
    differ = [k for k in gk if not same_bits(torch, gk[k], gp[k])]
    check(not differ, f"train: gradients differ between kernel 10 and the "
          f"plain exchange in {differ}")
    for k, g in gk.items():
        check(g.shape == params[k].shape and bool(torch.isfinite(g).all()),
              f"train: gradient {k} {tuple(g.shape)} not finite")
    norms = ", ".join(f"{k} {float(g.norm()):.4e}" for k, g in gk.items())
    del gk, gp
    check_gb = peak()
    log(f"train: C = {C} ({dropped} of {E * rows} first-stage assignments "
        f"of microbatch 0 dropped); kernel-10 launches {fwd} in a forward "
        f"and {launches} in a step (4 x {calls} MoE calls, the backward "
        f"one launch an exchange); loss {float(lk)!r} and all "
        f"{len(params)} gradient leaves == the plain exchange's bit for "
        f"bit (gradient norms: {norms}); first step {first_s:.2f} s; peak "
        f"{check_gb:.3f} GB with both gradient sets [{card}]")
    with torch.no_grad():
        dense = ts.dense_loss_reference(params, x, tgt,
                                        capacity_factor=TRAIN_CF,
                                        shards=mesh)
    rel = abs(float(lk) - float(dense)) / abs(float(dense))
    check(rel <= TRAIN_DENSE_RTOL, f"train: loss {float(lk)!r} against the "
          f"dense twin's {float(dense)!r}: rel {rel:.3e} > "
          f"{TRAIN_DENSE_RTOL}")
    log(f"train: the dense twin's loss {float(dense)!r}, relative "
        f"difference {rel:.3e} (bar {TRAIN_DENSE_RTOL}) [{card}]")
    record.update(train_exchange(torch, card, moe, rp, E, E * E * C, d))

    times = {}
    for kernel in ("cuda", "torch", "torch", "cuda"):
        step = step_k if kernel == "cuda" else step_p
        times.setdefault(kernel, []).append(
            train_step_times(torch, step, params, x, tgt))
    peaks.extend(r[2] for runs in times.values() for r in runs)
    for kernel, runs in times.items():
        log(f"train step ({'kernel 10' if kernel == 'cuda' else 'plain'} "
            f"exchange), two turns: device "
            + ", ".join(f"{r[0]:.3f}" for r in runs) + " ms by events; the "
            f"host returns in " + ", ".join(f"{r[1]:.3f}" for r in runs)
            + " ms; peak " + ", ".join(f"{r[2]:.3f}" for r in runs)
            + f" GB [{card}]")
    train_profile(torch, card, step_k, params, x, tgt)

    torch.cuda.empty_cache()
    first_loss, first = step_k(params, x, tgt)
    for i in range(TRAIN_REPEATS):
        again_loss, again = step_k(params, x, tgt)
        check(same_bits(torch, again_loss, first_loss)
              and all(same_bits(torch, again[k], first[k]) for k in first),
              f"train repeat {i}: the step differs from the first's bits")
        del again
    del params
    losses, current = [float(first_loss)], first
    for _ in range(TRAIN_STEPS - 1):
        loss, current = step_k(current, x, tgt)
        losses.append(float(loss))
    with torch.no_grad():
        losses.append(float(loss_k(current, x, tgt)))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"train: the loss does not descend: {losses}")
    del first, current
    peak()
    torch.cuda.empty_cache()
    log(f"train: {TRAIN_REPEATS} repeated steps bitwise the first; loss over "
        f"{TRAIN_STEPS} steps (lr {TRAIN_LR}) and after: "
        + " > ".join(repr(v) for v in losses)
        + f"; peak device memory in the phase {max(peaks):.3f} GB "
        f"[{card}]")
    record.update(train_launches=launches,
                  train_step_ms=statistics.median(
                      r[0] for r in times["cuda"]),
                  train_peak_gb=max(peaks))


def restack_(torch, params, order):
    """Reorder every stacked weight's leading dim in place, ``t[i] =
    t_old[order[i]]``, one stage's copy at a time (cycles of the
    permutation), so a second stack of the weights is never held."""
    for t in params.values():
        done = [False] * len(order)
        for start in range(len(order)):
            if done[start] or order[start] == start:
                continue
            held, i = t[start].clone(), start
            while True:
                done[i] = True
                if order[i] == start:
                    t[i].copy_(held)
                    break
                t[i].copy_(t[order[i]])
                i = order[i]
            del held


def inverse(order):
    """The permutation that undoes ``restack_(.., order)``."""
    return [order.index(i) for i in range(len(order))]


def counted_exchange(torch, kernel_exchange, rp, seen):
    """``kernel_exchange``, adding to ``seen`` the kernel-10 launches made
    in graph-free forwards (the F units': ``seen["f"]``) and in forwards
    that record a graph (the B units' rematerialized ones:
    ``seen["b"]``)."""

    def exchange(x, n):
        before = rp.all_to_all_cuda.launches
        y = kernel_exchange(x, n)
        seen["b" if torch.is_grad_enabled() else "f"] += (
            rp.all_to_all_cuda.launches - before)
        return y

    return exchange


def leaf_diff(torch, got, want, positions=None):
    """The largest |got - want| of a stacked leaf over its largest |want|;
    ``positions[i]`` is the stage of want that got's position i holds."""
    worst, scale = 0.0, 0.0
    for i in range(got.shape[0]):
        w = want[positions[i] if positions is not None else i]
        worst = max(worst, float((got[i] - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return worst / scale


def train_memory_lane(torch, card, rp, ts, params, gpipe_step, lanes):
    """One step each of GPipe with attention and 1F1B lanes a and b (built
    for its M) on ``TRAIN_1F1B_MEMORY_BATCH``: kernel-10 launches (4 and 6
    x S x M), each 1F1B loss against GPipe's within
    ``TRAIN_1F1B_LOSS_RTOL``, device ms by events, the host's ms and the
    step's peak. Returns {name: (loss, ms, host ms, peak GB)}."""
    S, d = ROW_MODEL["S"], ROW_MODEL["d"]
    M, mb, seq = TRAIN_1F1B_MEMORY_BATCH
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    tgt = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    steps = {"gpipe": (gpipe_step, None, 4)}
    for name, mesh, v in TRAIN_1F1B_LANES:
        steps[name] = (ts.make_train_step_1f1b(
            mesh, capacity_factor=TRAIN_CF, lr=TRAIN_LR, M=M, v=v,
            attention=True, kernel="cuda", device="cuda"), lanes[name][2], 6)
    out = {}
    for name, (step, order, per_call) in steps.items():
        if order is not None:
            restack_(torch, params, order)
        torch.cuda.empty_cache()
        rp.all_to_all_cuda.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        loss, new = step(params, x, tgt)
        host = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        del new
        launches = rp.all_to_all_cuda.launches
        out[name] = (float(loss), a.elapsed_time(b), host,
                     torch.cuda.max_memory_allocated() / 1e9)
        if order is not None:
            restack_(torch, params, inverse(order))
        check(launches == per_call * S * M and math.isfinite(out[name][0]),
              f"train 1f1b memory lane {name}: {launches} kernel-10 "
              f"launches (want {per_call} x {S * M}), loss {out[name][0]!r}")
    ref = out["gpipe"][0]
    rels = {n: abs(r[0] - ref) / abs(ref) for n, r in out.items()}
    check(max(rels.values()) <= TRAIN_1F1B_LOSS_RTOL,
          f"train 1f1b memory lane: losses against GPipe's {rels} (bar "
          f"{TRAIN_1F1B_LOSS_RTOL})")
    del x, tgt
    torch.cuda.empty_cache()
    log(f"train 1f1b memory lane, x and target [{M}, {mb}, {seq}, {d}] "
        f"({M * mb * seq} tokens, {mb * seq // ROW_MODEL['E']} rows a rank): "
        + "; ".join(
            f"{'GPipe' if n == 'gpipe' else '1F1B lane ' + n} loss {r[0]!r}"
            f" (rel to GPipe {rels[n]:.3e}), device {r[1]:.3f} ms by events,"
            f" host returns in {r[2]:.3f} ms, peak {r[3]:.3f} GB"
            for n, r in out.items())
        + f" (bar {TRAIN_1F1B_LOSS_RTOL}) [{card}]")
    return out


def phase_train_1f1b(torch, card, record):
    """The hand-scheduled 1F1B training step (``make_train_step_1f1b``:
    ``pipeline_1f1b.run_schedule`` over the reference's tables, each B unit
    rematerialized, every expert exchange on kernel 10) at phase 15's
    widths, batch and seed with the attention branch, in two lanes: (a) pp
    4, v 1 and (b) pp 2, v 2, the same 4-stage model. Checks launches (2·S·M
    in the F units, 6·S·M a step), kernel 10 == the plain exchange bit for
    bit in each lane, the loss against the dense twin, loss and gradients
    against the GPipe step with attention, repeats bitwise, the loss
    descending; logs the schedules, step times, peaks, a profiled step and
    the memory lane (``train_memory_lane``). Adds the 1F1B numbers to
    kernel 10's ``record``."""
    from dpu_operator_tpu_torch.parallel import moe
    from dpu_operator_tpu_torch.parallel import pipeline_1f1b as pf
    from dpu_operator_tpu_torch.parallel import ring_probe as rp
    from dpu_operator_tpu_torch.parallel import train_step as ts

    S, d, h, E = (ROW_MODEL[k] for k in ("S", "d", "h", "E"))
    M, mb, seq = TRAIN_BATCH
    gpipe_mesh = dict(TRAIN_MESH)
    torch.cuda.empty_cache()  # phase 15's cached blocks, fragmented
    log(f"train 1f1b: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated on entry [{card}]")
    torch.cuda.reset_peak_memory_stats()
    params = ts.init_params(S, d, h, E, seed=0, attention=True,
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    tgt = torch.randn((M, mb, seq, d), generator=gen, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"train 1f1b: weights {nbytes / 1e9:.3f} GB f32 (phase 15's, seed 0, "
        f"with wq/wk/wv), x and target [{M}, {mb}, {seq}, {d}], capacity "
        f"factor {TRAIN_CF:g} [{card}]")
    gpipe_k, gpipe_loss = ts.make_train_step(
        gpipe_mesh, capacity_factor=TRAIN_CF, lr=TRAIN_LR, attention=True,
        kernel="cuda", device="cuda")
    seen = {"f": 0, "b": 0}
    lanes = {}
    for name, mesh, v in TRAIN_1F1B_LANES:
        check(mesh["pp"] * v == S, f"1f1b lane {name}: not {S} stages")
        kw = dict(capacity_factor=TRAIN_CF, lr=TRAIN_LR, M=M, v=v,
                  attention=True, device="cuda")
        plain = ts.make_train_step_1f1b(mesh, kernel="torch", **kw)
        # The factory picks its exchange itself (moe.pick_exchange); for
        # kernel="cuda" that is moe.kernel_exchange, here counted by grad
        # mode while the step is built, so the split of the launches
        # below is that of the step's own choice.
        original = moe.kernel_exchange
        moe.kernel_exchange = counted_exchange(torch, original, rp, seen)
        try:
            kernel = ts.make_train_step_1f1b(mesh, kernel="cuda", **kw)
        finally:
            moe.kernel_exchange = original
        order = [int(i) for i in pf.interleave_order(mesh["pp"], v)]
        lanes[name] = (kernel, plain, order, v)
        sc = kernel.schedule
        log(f"train 1f1b lane {name} ({mesh}, v {v}): {sc.T} ticks, bubble "
            f"{sc.bubble:.4f} (GPipe at pp {S}: "
            f"{pf.gpipe_bubble(S, M):.4f}; pp {mesh['pp']}: "
            f"{pf.gpipe_bubble(mesh['pp'], M):.4f}), max in flight "
            f"{sc.max_inflight.tolist()} (GPipe: {M} a stage), stash slots "
            f"Kf {sc.Kf} Kb {sc.Kb} Ks {sc.Ks}, chunk order {order}")

    with torch.no_grad():
        dense = float(ts.dense_loss_reference(
            params, x, tgt, capacity_factor=TRAIN_CF, shards=gpipe_mesh))
    rp.all_to_all_cuda.launches = 0
    lg, gg = ts.value_and_grad(gpipe_loss, params, x, tgt)
    torch.cuda.synchronize()
    check(rp.all_to_all_cuda.launches == 4 * S * M,
          f"train 1f1b: the GPipe step launched kernel 10 "
          f"{rp.all_to_all_cuda.launches} times, not 4 x {S * M}")
    rel = abs(float(lg) - dense) / abs(dense)
    check(rel <= TRAIN_DENSE_RTOL, f"train 1f1b: GPipe loss {float(lg)!r} "
          f"against the dense twin's {dense!r}: rel {rel:.3e}")
    log(f"train 1f1b: GPipe with attention loss {float(lg)!r}, dense twin "
        f"{dense!r} (rel {rel:.3e}, bar {TRAIN_DENSE_RTOL}) [{card}]")

    # The main path's counts and the comparisons with GPipe, lane by lane:
    # the weights, GPipe's gradients and one lane's accumulating at once.
    launches = {}
    for name, (kernel, _, order, v) in lanes.items():
        restack_(torch, params, order)
        seen.update(f=0, b=0)
        rp.all_to_all_cuda.launches = 0
        t0 = time.monotonic()
        loss, grads = kernel.loss_and_grads(params, x, tgt)
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        launches[name] = rp.all_to_all_cuda.launches
        check(seen["f"] == 2 * S * M and launches[name] == 6 * S * M
              and seen["f"] + 2 * seen["b"] == launches[name],
              f"train 1f1b lane {name}: {seen['f']} kernel-10 launches in "
              f"the F units, {launches[name]} in a step (want 2 and 6 x "
              f"{S * M})")
        for k, g in grads.items():
            check(g.shape == params[k].shape and bool(torch.isfinite(g).all()),
                  f"train 1f1b lane {name}: gradient {k} not finite")
        rel = abs(float(loss) - dense) / abs(dense)
        check(rel <= TRAIN_DENSE_RTOL, f"train 1f1b lane {name}: loss "
              f"{float(loss)!r} against the dense twin's {dense!r}: rel "
              f"{rel:.3e}")
        rel_g = abs(float(loss) - float(lg)) / abs(float(lg))
        diffs = {k: leaf_diff(torch, grads[k], gg[k], order) for k in grads}
        check(rel_g <= TRAIN_1F1B_LOSS_RTOL
              and max(diffs.values()) <= TRAIN_1F1B_GRAD_RTOL,
              f"train 1f1b lane {name}: against GPipe loss rel {rel_g:.3e} "
              f"(bar {TRAIN_1F1B_LOSS_RTOL}), gradients {diffs} (bar "
              f"{TRAIN_1F1B_GRAD_RTOL})")
        del grads
        log(f"train 1f1b lane {name}: kernel-10 launches {seen['f']} in the "
            f"F units, {launches[name]} in a step (6 x {S * M}); loss "
            f"{float(loss)!r}, dense twin rel {rel:.3e}; against GPipe: loss "
            f"rel {rel_g:.3e} (bar {TRAIN_1F1B_LOSS_RTOL}), largest gradient "
            f"difference over the leaf's largest magnitude "
            + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
            + f" (bar {TRAIN_1F1B_GRAD_RTOL}); first step {first_s:.2f} s "
            f"[{card}]")
        restack_(torch, params, inverse(order))
    del gg

    # Kernel 10 against the plain exchange, bit for bit, in each lane.
    for name, (kernel, plain, order, v) in lanes.items():
        restack_(torch, params, order)
        lk, gk = kernel.loss_and_grads(params, x, tgt)
        before = rp.all_to_all_cuda.launches
        lp, gp = plain.loss_and_grads(params, x, tgt)
        torch.cuda.synchronize()
        check(rp.all_to_all_cuda.launches == before,
              f"train 1f1b lane {name}: the plain exchange launched kernel 10")
        differ = [k for k in gk if not same_bits(torch, gk[k], gp[k])]
        check(same_bits(torch, lk, lp) and not differ,
              f"train 1f1b lane {name}: kernel 10 against the plain "
              f"exchange: loss {float(lk)!r} / {float(lp)!r}, gradients "
              f"differ in {differ}")
        del gk, gp
        log(f"train 1f1b lane {name}: loss and all {len(params)} gradient "
            f"leaves with kernel 10 == the plain exchange's bit for bit; "
            f"peak so far {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
            f"[{card}]")
        restack_(torch, params, inverse(order))

    # Step times in turns: a, b, GPipe, GPipe, b, a (each resets the peak).
    peaks = [torch.cuda.max_memory_allocated() / 1e9]
    times = {}
    for name in ("a", "b", "gpipe", "gpipe", "b", "a"):
        if name == "gpipe":
            step, order = gpipe_k, None
        else:
            step, order = lanes[name][0], lanes[name][2]
            restack_(torch, params, order)
        times.setdefault(name, []).append(
            train_step_times(torch, step, params, x, tgt))
        if order is not None:
            restack_(torch, params, inverse(order))
    for name, runs in times.items():
        label = "GPipe with attention" if name == "gpipe" else (
            f"1F1B lane {name}")
        log(f"train 1f1b: {label}, two turns: device "
            + ", ".join(f"{r[0]:.3f}" for r in runs) + " ms by events; the "
            f"host returns in " + ", ".join(f"{r[1]:.3f}" for r in runs)
            + " ms; peak " + ", ".join(f"{r[2]:.3f}" for r in runs)
            + f" GB a step [{card}]")
    train_profile(torch, card, lanes["a"][0], params, x, tgt,
                  "train 1f1b profile, one lane-a kernel step")
    memory = train_memory_lane(torch, card, rp, ts, params, gpipe_k, lanes)

    # Lane a: repeats bitwise, then the loss descending.
    torch.cuda.empty_cache()
    step = lanes["a"][0]
    first_loss, first = step(params, x, tgt)
    for i in range(TRAIN_1F1B_REPEATS):
        again_loss, again = step(params, x, tgt)
        check(same_bits(torch, again_loss, first_loss)
              and all(same_bits(torch, again[k], first[k]) for k in first),
              f"train 1f1b repeat {i}: the step differs from the first's "
              f"bits")
        del again
    del params
    losses, current = [float(first_loss)], first
    for _ in range(TRAIN_STEPS - 1):
        loss, current = step(current, x, tgt)
        losses.append(float(loss))
    with torch.no_grad():
        losses.append(float(gpipe_loss(current, x, tgt)))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"train 1f1b: the loss does not descend: {losses}")
    del first, current
    peaks.extend(r[2] for runs in times.values() for r in runs)
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    log(f"train 1f1b: {TRAIN_1F1B_REPEATS} repeated lane-a steps bitwise the "
        f"first; loss over {TRAIN_STEPS} steps (lr {TRAIN_LR}) and after: "
        + " > ".join(repr(v) for v in losses)
        + f"; peak device memory in the phase {max(peaks):.3f} GB "
        f"[{card}]")
    record.update(
        train_1f1b_launches=launches["a"],
        train_1f1b_v2_launches=launches["b"],
        train_1f1b_step_ms=statistics.median(r[0] for r in times["a"]),
        train_1f1b_v2_step_ms=statistics.median(r[0] for r in times["b"]),
        train_1f1b_peak_gb=max(r[2] for r in times["a"]),
        train_1f1b_memory_peak_gb=memory["a"][3],
        train_gpipe_memory_peak_gb=memory["gpipe"][3])


# -- phase 17: the fabric probe's training step ------------------------------

# The operator's own multi-chip health step: build_mesh(8) = dp 2 x sp 2 x
# tp 2 (batch [8, 16, 128]) and build_mesh(1), the reference's probe model
# (DIM 128, HIDDEN 256), stacked on the card. Small by design: it checks
# the hand-offs, not the card's speed.
PROBE_MESHES = (8, 1)
PROBE_STEPS = 5
# The update against tp x LR x the one-rank gradient: the CPU test's bf16
# bar (each rank's gradient rounded to bf16 before the ranks' f32 sum,
# against one rounding of the whole).
PROBE_UPDATE_RTOL = 1e-2  # and atol 1e-2 of the largest magnitude


def phase_probe(torch, card):
    """The fabric probe's training step (``make_probe_train_step``,
    ``run_probe``) at ``build_mesh(8)`` and ``build_mesh(1)``: the dry
    run's ``run_probe(mesh, steps=2)`` (the main path; it reaches no
    kernel, and no ring kernel's count moves) gives a finite loss; 5 steps
    descend; a second run of them is bitwise the first; the update equals
    tp x LR x the one-rank dense loss's gradient (the update at
    ``build_mesh(1)`` on the same global batch) within the bf16 bar; ms a
    step by events."""
    from dpu_operator_tpu_torch.parallel import build_mesh, run_probe
    from dpu_operator_tpu_torch.parallel import fabric_probe as fp
    from dpu_operator_tpu_torch.parallel import ring_probe as rp

    counters = (rp.all_to_all_cuda, rp.ring_all_gather_cuda,
                rp.ring_reduce_scatter_cuda)
    for n in PROBE_MESHES:
        mesh = build_mesh(n)
        label = f"probe build_mesh({n}) = " + " x ".join(
            f"{a} {k}" for a, k in mesh.items())
        for c in counters:
            c.launches = 0
        t0 = time.monotonic()
        loss = run_probe(mesh, steps=2)
        wall = time.monotonic() - t0
        moved = [c.launches for c in counters]
        check(math.isfinite(loss), f"{label}: run_probe loss {loss}")
        check(not any(moved), f"{label}: run_probe launched ring kernels "
              f"{moved}")
        step = fp.make_probe_train_step(mesh)
        batch = fp.probe_example_batch(2, mesh)
        blocks = fp.shard_probe_batch(batch, mesh)
        runs = []
        for _ in range(2):
            params, losses = fp.init_probe_params(1), []
            for _ in range(PROBE_STEPS):
                params, lv = step(params, blocks)
                losses.append(float(lv))
            runs.append((losses, params))
        losses = runs[0][0]
        check(all(math.isfinite(x) for x in losses)
              and all(b < a for a, b in zip(losses, losses[1:])),
              f"{label}: losses {losses} do not descend")
        check(runs[1][0] == losses and all(
            same_bits(torch, runs[0][1][k], runs[1][1][k])
            for k in fp.PARAM_SPEC), f"{label}: repeated steps differ")
        p0 = fp.init_probe_params(1)
        p1, _ = step(p0, blocks)
        one = build_mesh(1)
        d1, _ = fp.make_probe_train_step(one)(
            p0, fp.shard_probe_batch(batch, one))
        tp = mesh["tp"]
        worst = 0.0
        for k in fp.PARAM_SPEC:
            got, want = p0[k] - p1[k], tp * (p0[k] - d1[k])
            bar = PROBE_UPDATE_RTOL * (want.abs() + want.abs().max())
            check(bool(((got - want).abs() <= bar).all()),
                  f"{label}: {k}'s update is not tp x LR x the one-rank "
                  f"gradient")
            worst = max(worst, float(((got - want).abs()
                                      / want.abs().max()).max()))
        ms = time_ms(torch, lambda: step(p0, blocks), n=10, warm=3, batch=5)
        log(f"{label}: batch {tuple(batch.shape)}, run_probe(steps=2) loss "
            f"{loss!r} in {wall:.3f} s (no kernel launched); {PROBE_STEPS} "
            f"steps {[round(x, 6) for x in losses]} descending, repeated "
            f"bitwise; update == {tp} x LR x the one-rank gradient within "
            f"rtol {PROBE_UPDATE_RTOL} (max |err| / max |update| "
            f"{worst:.3e}); a step {ms:.4f} ms by events [{card}]")


# -- phase 18: fabric-sharded serving -----------------------------------------

# The row model of phase 14 at E = 1, which every sharded slice needs (tp
# shards the dense contraction; the expert body replicates): Mixtral-8x7B's
# widths (mistralai/Mixtral-8x7B-v0.1 config.json: hidden_size 4096,
# intermediate_size 14336), depth cut to 4 of 32 layers (3.76 GB f32),
# seed-0 weights drawn once on the card and shared by every lane; 64 slots
# over tp = 8 ranks stacked on the card: the all-gather matmul's blocks are
# 8 slot rows, a rank's FFN columns 1792.
FAB_MODEL = dict(S=4, d=4096, h=14336, E=1)
FAB_WORLD = 8
FAB_SLOTS = 64
FAB_REQUESTS = 64
FAB_TOKENS = 32
FAB_HTTP = 8
# The mesh-stage form: steps held against TpShardSlice at world 1, and
# repeats of them. Its states against the slice's within the reference's
# own bar for this form (tests/test_sharded.py: rtol 1e-4, atol 1e-5): the
# same f32 function, kernel 11's split-TF32 products and the rank-ordered
# sum of the w2 partials against one cuBLAS product each.
FAB_STEPS = 3
FAB_REPEATS = 3
FAB_RTOL, FAB_ATOL = 1e-4, 1e-5
# The process lane: real shard_worker processes, each with its own CUDA
# context on the card, reducing over the fabric ring on loopback; depth 1
# of the same weights, so each worker loads a 0.94 GB npz.
FAB_PROC_WORLD = 2
FAB_PROC_S = 1
FAB_SPAWN_S = 300.0


def fabric_prompts(label, n):
    return [f"fabric {label} {i}" for i in range(n)]


def top_gap(x, row):
    """(first, second, gap) of the two largest values of ``x[row]``."""
    order = np.argsort(x[row])[::-1]
    a, b = float(x[row, order[0]]), float(x[row, order[1]])
    return int(order[0]), int(order[1]), a - b


def fabric_tokens_check(tag, step, got, x_want, want):
    """Tokens exactly ``want``; where one differs, the step, the row and
    the gap between the reference state's two largest values."""
    if got.tolist() == want.tolist():
        return
    row = int(np.nonzero(got != want)[0][0])
    a, b, gap = top_gap(x_want, row)
    raise AssertionError(
        f"{tag}: step {step} row {row}: token {int(got[row])} != "
        f"{int(want[row])} (the reference's top two: {a}, {b}, gap "
        f"{gap:.3e})")


def fabric_mesh_lane(torch, card, params, record):
    """(a) ``make_mesh_stage_fn`` at full width: each stage's w1 product on
    kernel 11. The main path (counts at 0): FAB_STEPS steps, S launches a
    step; every launch within ``cm_compare``'s bar of ``ag_matmul_plain``
    on its own inputs; tokens == ``TpShardSlice(params, 0, 1)``'s exactly
    and states within FAB_RTOL / FAB_ATOL, as for the ``kernel="torch"``
    and ``overlap=False`` forms; FAB_REPEATS repeats bitwise; ms a step by
    events; kernel 11 at this shape against plain, ``torch.matmul`` f32 and
    its bound. Adds ``mesh_stage_*`` to kernel 11's ``record``."""
    from dpu_operator_tpu_torch.parallel import burn
    from dpu_operator_tpu_torch.parallel import collective_matmul as cm
    from dpu_operator_tpu_torch.serving import encode_prompt
    from dpu_operator_tpu_torch.serving.sharded import shard_math as sm

    S, d, h = (FAB_MODEL[k] for k in ("S", "d", "h"))
    n, mesh = FAB_WORLD, {"tp": FAB_WORLD}
    x0 = np.stack([encode_prompt(p, d) for p in fabric_prompts(
        "mesh", FAB_SLOTS)]).astype(np.float32)
    seen, real = [], cm.ag_matmul_cuda

    def recording(x, w, k):
        y = real(x, w, k)
        seen.append((x, w, y))
        return y

    cm.ag_matmul_cuda = recording  # the factory binds its pick now
    try:
        step = sm.make_mesh_stage_fn(mesh, params)
    finally:
        cm.ag_matmul_cuda = real
    steps = {"torch": sm.make_mesh_stage_fn(mesh, params, kernel="torch"),
             "overlap=False": sm.make_mesh_stage_fn(mesh, params,
                                                   overlap=False)}
    tag = (f"fabric mesh-stage tp={n} slots {FAB_SLOTS} S={S} d {d} h {h} "
           f"f32")

    # The main path, counts at 0.
    cm.ag_matmul_cuda.launches = 0
    t0 = time.monotonic()
    x, run = x0, []
    for _ in range(FAB_STEPS):
        x, tok = step(x)
        run.append((x, tok))
    wall = time.monotonic() - t0
    launches = cm.ag_matmul_cuda.launches
    check(launches == FAB_STEPS * S and len(seen) == launches,
          f"{tag}: {launches} kernel-11 launches ({len(seen)} seen) for "
          f"{FAB_STEPS} steps (want {S} a step)")
    log(f"{tag} main path: {FAB_STEPS} steps of make_mesh_stage_fn, "
        f"{launches} all-gather matmul launches ({S} a step), {wall:.3f} s "
        f"wall (first call) [{card}]")
    errs = []
    for i, (xa, w, y) in enumerate(seen):
        errs.append(cm_compare(torch, burn, f"{tag} launch {i}", y,
                               cm.ag_matmul_plain(xa, w, n))[0])
    seen.clear()
    ref = sm.TpShardSlice(params, 0, 1, device="cuda")
    xr, want = x0, []
    for k in range(FAB_STEPS):
        xr, tr = ref.forward(xr, lambda p, s: p)
        want.append((xr, tr))
    state_err = {}
    for label, fn in (("kernel", None),) + tuple(steps.items()):
        xs = x0
        for k in range(FAB_STEPS):
            if fn is None:
                xs, tk = run[k]
            else:
                xs, tk = fn(xs)
            fabric_tokens_check(f"{tag} {label}", k + 1, tk, want[k][0],
                                want[k][1])
            check(np.allclose(xs, want[k][0], rtol=FAB_RTOL, atol=FAB_ATOL),
                  f"{tag} {label}: step {k + 1}'s state differs from "
                  f"TpShardSlice's by {np.abs(xs - want[k][0]).max()}")
            state_err[label] = max(state_err.get(label, 0.0), float(
                np.abs(xs - want[k][0]).max()))
    for i in range(FAB_REPEATS):
        x = x0
        for k in range(FAB_STEPS):
            x, tok = step(x)
            check(x.tobytes() == run[k][0].tobytes()
                  and tok.tolist() == run[k][1].tolist(),
                  f"{tag} repeat {i} step {k + 1}: differs from the first "
                  f"run's bits")
    ms = {"kernel": time_ms(torch, lambda: step(x0), n=5, warm=1, batch=1)}
    for label, fn in steps.items():
        ms[label] = time_ms(torch, lambda: fn(x0), n=5, warm=1, batch=1)
    ms["TpShardSlice world 1"] = time_ms(
        torch, lambda: ref.forward(x0, lambda p, s: p), n=5, warm=1, batch=1)
    log(f"{tag}: {FAB_STEPS} steps' tokens == TpShardSlice(world 1)'s in "
        f"every form, states within rtol {FAB_RTOL} / atol {FAB_ATOL} (max "
        f"|err| " + ", ".join(f"{k} {v:.3e}" for k, v in state_err.items())
        + f"); every launch == ag_matmul_plain within the bar (max |err| "
        f"{max(errs):.3e}); {FAB_REPEATS} repeats bitwise; ms a step "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" (CUDA events, host round trips included) [{card}]")

    # Kernel 11 at this shape: a rank's block is 8 rows of the 128-row tile.
    xd = torch.as_tensor(x0, device="cuda")
    w = params["w1"][0]
    k_ms = time_ms(torch, lambda: cm.ag_matmul_cuda(xd, w, n), n=10, warm=2,
                   batch=5)
    launch_ms, host_ms, how = device_ms(
        torch, lambda: cm.ag_matmul_cuda(xd, w, n), "ag_matmul_kernel",
        calls=10)
    plain_ms = time_ms(torch, lambda: cm.ag_matmul_plain(xd, w, n), n=5,
                       warm=1, batch=2)
    library_ms = time_ms(torch, lambda: torch.matmul(xd, w), n=10, warm=2,
                         batch=5)
    flops = 2 * FAB_SLOTS * d * h
    nbytes = (FAB_SLOTS * d + d * h + FAB_SLOTS * h) * 4
    t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"{tag} ag_matmul [{FAB_SLOTS}, {d}] @ [{d}, {h}] n={n} (blocks of "
        f"{FAB_SLOTS // n} rows): kernel {k_ms:.4f} ms ({launch_ms:.4f} ms "
        f"a launch on the card, {how}; {host_ms:.4f} ms of host time to "
        f"queue a call), plain {plain_ms:.4f} ms, torch.matmul f32 "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops} "
        f"flop x 3 split passes, {nbytes} B; "
        f"{max(flops / FP32_FLOP_PER_S * 1e3, t_bytes):.4f} ms on the f32 "
        f"FMA pipes) [{card}]")
    record.update(mesh_stage_launches=launches,
                  mesh_stage_max_abs_err=max(errs), mesh_stage_ms=k_ms,
                  mesh_stage_plain_ms=plain_ms, mesh_stage_bound_ms=bound_ms,
                  mesh_stage_bound_by=bound_by,
                  mesh_stage_library_ms=library_ms,
                  mesh_stage_step_ms=ms["kernel"])
    del xd, steps, step, ref


def fabric_watch(shards):
    """Record each collected step's per-rank compute and collective
    seconds off ``shards.collect``; returns (the list, an undo)."""
    steps, inner = [], shards.collect

    def collect(handle, timeout):
        out = inner(handle, timeout)
        steps.append((list(out.compute_s), list(out.collective_s)))
        return out

    shards.collect = collect
    return steps, lambda: vars(shards).pop("collect", None)


def fabric_stats(steps):
    """Medians over steps of the slowest rank's collective seconds, of
    the skew (slowest minus fastest rank's compute) and of the slowest
    rank's compute, in ms."""
    coll = [max(c) * 1e3 for _, c in steps]
    skew = [(max(p) - min(p)) * 1e3 for p, _ in steps]
    comp = [max(p) * 1e3 for p, _ in steps]
    return dict(collective_ms=statistics.median(coll),
                collective_max_ms=max(coll),
                skew_ms=statistics.median(skew), skew_max_ms=max(skew),
                compute_ms=statistics.median(comp))


def fabric_drive(torch, card, label, ex, prompts, close=True):
    """The reference's ``_drive``: every prompt as a ``GenerateRequest``
    of FAB_TOKENS tokens through ``AdmissionQueue`` and
    ``ContinuousBatcher`` on ``ex``, closed after unless ``close`` is
    False. Returns (streams, ms a step, steps)."""
    from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                                ContinuousBatcher,
                                                GenerateRequest,
                                                encode_prompt)

    count = [0]
    inner_submit, inner_step = ex.submit, ex.step

    def submit(*a, **kw):
        count[0] += 1
        return inner_submit(*a, **kw)

    def step(x):
        count[0] += 1
        return inner_step(x)

    ex.submit, ex.step = submit, step
    reqs = [GenerateRequest(prompt_vec=encode_prompt(p, FAB_MODEL["d"]),
                            max_tokens=FAB_TOKENS,
                            deadline=time.monotonic() + 900.0)
            for p in prompts]
    q = AdmissionQueue(max_depth=len(reqs) + 1)
    b = ContinuousBatcher(ex, q)
    for r in reqs:
        q.submit(r)
    t0 = time.monotonic()
    b.start()
    try:
        for i, r in enumerate(reqs):
            check(r.wait(timeout=900), f"fabric {label}: request {i} lost")
        wall = time.monotonic() - t0
    finally:
        b.stop()
        if close:
            ex.close()
        vars(ex).pop("submit", None)
        vars(ex).pop("step", None)
    streams = []
    for i, r in enumerate(reqs):
        check(r.error is None, f"fabric {label} request {i}: {r.error}")
        toks = list(r.tokens)
        check(len(toks) == FAB_TOKENS
              and all(0 <= t < FAB_MODEL["d"] for t in toks),
              f"fabric {label} request {i}: {len(toks)} tokens")
        streams.append(toks)
    torch.cuda.synchronize()
    return streams, wall / max(count[0], 1) * 1e3, count[0]


def fabric_shard_lanes(torch, card, params):
    """(b) ``FabricExecutor`` over ``SyntheticShardSet(world=8, slots=64,
    params, device=card)``: sync, pipelined, pipelined with overlap and
    pipelined with the int8 codec (twice) drive FAB_REQUESTS requests; the
    fp32 streams == ``LocalExecutor(params, mode="pipelined")``'s on the
    same weights, the int8 ones repeat; ms a step, the collective and
    skew series; then FAB_HTTP requests over HTTP through
    ``ServingServer([FabricExecutor(...)])``, profiled (the idle share),
    their streams == the driven ones for the same prompts;
    ``outstanding() == 0`` after every close."""
    from torch.profiler import ProfilerActivity, profile

    from dpu_operator_tpu_torch.serving import (FabricExecutor,
                                                LocalExecutor,
                                                ServingServer,
                                                SyntheticShardSet)
    from dpu_operator_tpu_torch.utils.metrics import Registry

    prompts = fabric_prompts("request", FAB_REQUESTS)
    local = LocalExecutor(params=params, slots=FAB_SLOTS, mode="pipelined",
                          S=FAB_MODEL["S"], d=FAB_MODEL["d"],
                          h=FAB_MODEL["h"], E=1, device="cuda")
    gold, local_ms, local_steps = fabric_drive(torch, card, "local", local,
                                               prompts)
    del local
    check(len({tuple(s) for s in gold}) > 1, "fabric: identical streams")
    log(f"fabric LocalExecutor pipelined (E=1, the reference streams): "
        f"{FAB_REQUESTS} requests x {FAB_TOKENS} tokens, {local_steps} steps"
        f", {local_ms:.3f} ms a step [{card}]")
    reg = Registry()
    int8 = []
    for label, mode, kw in (("sync", "sync", {}),
                            ("pipelined", "pipelined", {}),
                            ("pipelined overlap", "pipelined",
                             {"overlap": True}),
                            ("pipelined int8", "pipelined",
                             {"codec": "int8"}),
                            ("pipelined int8 again", "pipelined",
                             {"codec": "int8"})):
        shards = SyntheticShardSet(world=FAB_WORLD, slots=FAB_SLOTS,
                                   params=params, device="cuda", **kw)
        check(shards.params["moe_w1"].data_ptr()
              == params["moe_w1"].data_ptr(),
              f"fabric {label}: the shard set copied the weights")
        steps, undo = fabric_watch(shards)
        ex = FabricExecutor(shards, mode=mode, registry=reg,
                            name=label.replace(" ", "-"))
        streams, ms, n_steps = fabric_drive(torch, card, label, ex, prompts)
        undo()
        check(shards.outstanding() == 0,
              f"fabric {label}: {shards.outstanding()} steps outstanding "
              f"after close")
        if "int8" in label:
            int8.append(streams)
        else:
            check(streams == gold, f"fabric {label}: streams differ from "
                  f"LocalExecutor's first at {first_diff(streams, gold)}")
        st = fabric_stats(steps)
        labels = {"replica": ex.name, "codec": shards.codec_name}
        q = {p: reg.quantile("serving_shard_collective_seconds", p, labels)
             for p in (0.5, 0.99)}
        log(f"fabric {label} world={FAB_WORLD}: {n_steps} steps, {ms:.3f} ms "
            f"a step; the slowest rank's collective a step median "
            f"{st['collective_ms']:.3f} ms (max {st['collective_max_ms']:.3f}"
            f"; serving_shard_collective_seconds p50 {q[0.5]} p99 "
            f"{q[0.99]}), skew median {st['skew_ms']:.3f} ms (max "
            f"{st['skew_max_ms']:.3f}), the slowest rank's compute median "
            f"{st['compute_ms']:.3f} ms; streams "
            + ("== LocalExecutor's" if "int8" not in label else
               f"== fp32's: {streams == gold}") + f" [{card}]")
        del shards, ex
    check(int8[0] == int8[1], f"fabric int8: two runs differ first at "
          f"{first_diff(int8[0], int8[1])}")

    shards = SyntheticShardSet(world=FAB_WORLD, slots=FAB_SLOTS,
                               params=params, device="cuda")
    srv = ServingServer([FabricExecutor(shards)],
                        max_queue_depth=2 * FAB_HTTP,
                        max_tokens_cap=FAB_TOKENS,
                        pool_opts={"watchdog_s": 300.0}).start()
    bodies = [{"prompt": p, "max_tokens": FAB_TOKENS, "deadline_ms": 900000}
              for p in prompts[:FAB_HTTP]]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            results = post_all(srv.url, bodies)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        srv.stop()
    check(shards.outstanding() == 0, f"fabric HTTP: {shards.outstanding()} "
          f"steps outstanding after stop")
    for i, res in enumerate(results):
        check(res is not None and res[0] == 200,
              f"fabric HTTP request {i}: {res}")
        check(res[1]["tokens"] == gold[i], f"fabric HTTP request {i}: "
              f"stream differs from the driven one")
    rows, busy_ms = device_rows(prof)
    check(busy_ms > 0, "fabric HTTP profile: no device time recorded")
    log(f"fabric HTTP: {FAB_HTTP} requests x {FAB_TOKENS} tokens through "
        f"ServingServer([FabricExecutor(SyntheticShardSet(world="
        f"{FAB_WORLD}))]) == the driven streams; profiled: device busy "
        f"{busy_ms:.1f} ms of {wall_ms:.1f} ms wall (idle share "
        f"{1 - busy_ms / wall_ms:.3f}) in {sum(r[1] for r in rows)} device "
        f"operations [{card}]")
    for us, count, key in rows[:8]:
        log(f"  {us / 1e3:10.3f} ms {us / 1e3 / busy_ms:6.3f}  x{count:<6d} "
            f"{key[:90]}")
    del prof, srv, shards
    return gold


def fabric_process_lanes(torch, card, params):
    """(c) ``ShardProcessSet(world=2, jit=True)`` at depth FAB_PROC_S and
    full width: real ``shard_worker`` processes, each with its own CUDA
    context on the card, reducing over ``RingTransport`` on loopback. fp32
    streams == ``SyntheticShardSet(world=2)``'s on the same weights; int8
    with overlap after a reset with a step outstanding (a re-rendezvous:
    the old handle fails typed); ms a step, collective against compute
    seconds; ``outstanding() == 0`` after every close. The int8 lane
    drives twice on one worker set, before and after the re-rendezvous,
    and its two runs' streams must be identical."""
    from dpu_operator_tpu_torch.serving import (FabricExecutor,
                                                ShardProcessSet,
                                                SyntheticShardSet)
    from dpu_operator_tpu_torch.serving.sharded import ShardAborted

    # The workers import the package from this checkout.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    p1 = {k: v[:FAB_PROC_S] for k, v in params.items()}
    nbytes = sum(t.numel() * t.element_size() for t in p1.values())
    prompts = fabric_prompts("process", FAB_REQUESTS)
    want, ms, n_steps = fabric_drive(torch, card, "threads world 2",
                                     FabricExecutor(SyntheticShardSet(
                                         world=FAB_PROC_WORLD,
                                         slots=FAB_SLOTS, params=p1,
                                         device="cuda")), prompts)
    log(f"fabric SyntheticShardSet world={FAB_PROC_WORLD} S={FAB_PROC_S}: "
        f"{n_steps} steps, {ms:.3f} ms a step [{card}]")
    for label, kw in (("fp32", {}),
                      ("int8 overlap", {"codec": "int8", "overlap": True})):
        t0 = time.monotonic()
        procs = ShardProcessSet(world=FAB_PROC_WORLD, slots=FAB_SLOTS,
                                params=p1, jit=True,
                                spawn_timeout_s=FAB_SPAWN_S,
                                device="cuda", **kw)
        ex = FabricExecutor(procs, mode="pipelined", step_timeout_s=300.0)
        ex.reset()  # the spawn: the driven run's own reset is polite
        extra = ""
        if label != "fp32":
            t1 = time.monotonic()
            first, _, _ = fabric_drive(torch, card, f"processes {label}",
                                       ex, prompts, close=False)
            t0 += time.monotonic() - t1  # setup counts no driven run
            stale = procs.submit(1, [])
            procs.reset()
            check(procs.respawns == 1, f"fabric processes {label}: "
                  f"{procs.respawns} respawns after a reset with a step "
                  f"outstanding")
            try:
                procs.collect(stale, timeout=30.0)
            except ShardAborted:
                pass
            else:
                raise AssertionError(f"fabric processes {label}: a torn-down "
                                     f"generation's handle collected")
            ex.reset()
            extra = ("; a reset with a step outstanding re-rendezvoused; "
                     "streams == the run before it")
        setup = time.monotonic() - t0
        steps, undo = fabric_watch(procs)
        streams, ms, n_steps = fabric_drive(torch, card, f"processes {label}",
                                            ex, prompts)
        undo()
        check(procs.outstanding() == 0, f"fabric processes {label}: "
              f"{procs.outstanding()} steps outstanding after close")
        if label == "fp32":
            check(streams == want, f"fabric processes {label}: streams "
                  f"differ from the thread shards' first at "
                  f"{first_diff(streams, want)}")
        else:
            check(streams == first, f"fabric processes {label}: the runs "
                  f"before and after the re-rendezvous differ first at "
                  f"{first_diff(streams, first)}")
        st = fabric_stats(steps)
        log(f"fabric processes {label} world={FAB_PROC_WORLD} S={FAB_PROC_S} "
            f"({nbytes / 1e9:.3f} GB npz a worker): {n_steps} steps, "
            f"{ms:.3f} ms a step; the workers' own times a step: compute "
            f"median {st['compute_ms']:.3f} ms, collective median "
            f"{st['collective_ms']:.3f} ms (max {st['collective_max_ms']:.3f}"
            f"); streams == the thread shards': {streams == want}; spawn, "
            f"warm-up and hello {setup:.1f} s{extra} [{card}]")
        del procs, ex


def phase_fabric(torch, card, record):
    """Fabric-sharded serving at full width: (a) the mesh-stage form on
    kernel 11, (b) ``FabricExecutor`` over thread shards, (c) over
    ``shard_worker`` processes. ``record`` is kernel 11's."""
    from dpu_operator_tpu_torch.parallel import train_step as ts

    t0 = time.monotonic()
    S, d, h, E = (FAB_MODEL[k] for k in ("S", "d", "h", "E"))
    params = ts.init_params(S, d, h, E, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    log(f"fabric: weights {nbytes / 1e9:.3f} GB f32 ({S} stages of d {d}, "
        f"h {h}, E {E}), seed 0, on the card [{card}]")
    fabric_mesh_lane(torch, card, params, record)
    fabric_shard_lanes(torch, card, params)
    fabric_process_lanes(torch, card, params)
    del params
    torch.cuda.empty_cache()
    log(f"fabric: phase 18 in {time.monotonic() - t0:.1f} s [{card}]")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dpu_operator_tpu_torch import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: "
              f"{e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, capability "
        f"{torch.cuda.get_device_capability(0)})")

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.build, SOURCES))
    log(f"build: {', '.join(SOURCES)} in {time.monotonic() - t0:.1f} s")
    for src, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {src}: {line.strip()}")

    record = phase_kernel(torch, card)
    phase_small(torch)
    record["launches"], serve_streams = phase_serve(torch, card)
    phase_profile(torch, card)
    tiles = phase_tiles(torch, card)
    launches = phase_health(torch, card, name)
    for rec in tiles:
        rec["launches"] = launches[rec["name"]]
    ring = phase_ring(torch, card)
    collectives = phase_collectives(torch, card)
    a2a = phase_ulysses(torch, card)
    tp_mlp = phase_tp_mlp(torch, card)
    spec_gold = phase_spec(torch, card)
    record["sharded_launches"] = phase_shard(
        torch, card, {"int8": serve_streams, "fp32": spec_gold})
    phase_rows(torch, card, a2a)
    phase_train(torch, card, a2a)
    phase_train_1f1b(torch, card, a2a)
    phase_probe(torch, card)
    phase_fabric(torch, card, next(r for r in tp_mlp
                                   if r["name"] == "ag_matmul"))
    print(card)
    print(json.dumps({"kernels": [record] + tiles + [ring] + collectives
                      + [a2a] + tp_mlp}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
