// The one tile product of the port's matmul kernels, for Hopper (sm_90a).
//
// A CTA of kThreads threads computes one tile of C = A @ B and hands every
// finished group of values to an epilogue functor, which stores it where
// and as its caller wants: bf16, through tanh for the health burn
// (`tile_mma.cu`); the operands' own type (the all-gather matmul of
// `collective_matmul.cu`); f32 partial sums (its matmul reduce-scatter).
// Two forms:
//
//   * bf16 on Hopper's own path, `tile_product_wgmma` (the burn chain and
//     the burn tile, the benchmark matmul, the bf16 collective matmuls):
//     operands brought in by TMA through a ring of mbarrier-guarded stages
//     and multiplied by wgmma.mma_async; its note is at the form, further
//     down;
//   * f32, `tile_product_tf32x3` (the f32 collective matmuls): row-major
//     A [M, K] and B [K, N], each with its own row stride, staged in
//     shared memory by cp.async three stages deep, each value split into
//     TF32 hi and lo as a warp loads it and multiplied on the tensor cores
//     by mma.sync in three passes a product, for f32 accuracy; its note is
//     at the form, further down. The epilogue gets 4 neighbours of a row.
//
// Tails of the cp.async form: it takes M, N and K that are not multiples
// of its tile: a 16-byte unit of an operand that lies outside them is
// zero-filled (cp.async with a source size of 0) and the epilogue is
// called only for groups that lie inside C. The caller guarantees that
// every row of A, B and C that the product reads or writes, and every row
// stride, is a whole number of 16-byte units, so that a unit (and a group
// of 4 f32 outputs) is wholly inside or wholly outside.
//
// The cp.async form reads operands with cp.async.cg, through L2 only: a
// ring kernel's operand may be a slot that a CTA on another SM has just
// written, and L1 is not coherent across SMs. (TMA reads through L2 too.)
//
// Shared memory is the caller's: an `SmemTf32` on a 16-byte boundary
// (dynamic: it is above 48 KB), or a `SmemWgmma` on a 1024-byte one. The
// product leaves it free for the next call (every stage is read before
// the product's last barrier).

#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// 16 bytes from src, or 16 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N cp.async groups (the most recently committed) are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// -- epilogues: (row, col, v) stores v[0..W) at C[row, col ..] -----------------

// bf16, through tanh in f32 if kTanh: 8 values, one 16-byte store.
template <bool kTanh>
struct StoreBf16 {
  bf16* c;
  long long ldc;
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&v)[8]) const {
    float t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = kTanh ? tanhf(v[e]) : v[e];
    *reinterpret_cast<uint4*>(c + row * ldc + col) =
        make_uint4(pack_bf16x2(t[0], t[1]), pack_bf16x2(t[2], t[3]),
                   pack_bf16x2(t[4], t[5]), pack_bf16x2(t[6], t[7]));
  }
};

// f32, stored through L2 only (a ring kernel's partial block is read next
// by other threads through L2).
struct StoreF32 {
  float* c;
  long long ldc;
  template <int W>
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&v)[W]) const {
#pragma unroll
    for (int e = 0; e < W; e += 4) {
      __stcg(reinterpret_cast<float4*>(c + row * ldc + col + e),
             make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
    }
  }
};

// -- f32 on the TF32 tensor cores, split for f32 accuracy ----------------------
//
// Serves the f32 instances of TPU kernels 11 and 12 (parallel/
// collective_matmul.py of the JAX package: `_pallas_ag_matmul`,
// `_pallas_mm_rs`) through `collective_matmul.cu`; the split and its
// mma are ring attention's too (`ring_attn.cu`). What bounds those
// kernels is operations: 2.749e11 flop each at the tensor-parallel MLP's
// shapes. On the FMA pipes (67 TFLOP/s) that is 4.1 ms; the TF32 tensor
// cores (495 dense, about 315 by mma.sync on an H100) keep only 10
// mantissa bits, so each operand is split, x ~ hi + lo with hi = x
// rounded to TF32 and lo = x - hi rounded the same way, and a . b ~
// lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms first (the dropped
// lo_a lo_b and the residuals are ~2^-22 of a product): three passes,
// 8.25e11 flop of mma, 1.67 ms at the TF32 peak.
//
// The tensor cores' f32 sums truncate, so a sum carried over a long K in
// one accumulator drifts one way. Each 16-deep slice's passes therefore
// go into fresh accumulators, and the slice's result is added to the
// running f32 sums with one rounding to nearest.
//
// Layout: a CTA tile of 128 x BN, eight warps of 32 columns each (64 x
// 32 at BN = 128); K in stages of kTfBK = 32, landing in shared memory
// as f32 by cp.async, kTfStages deep (one barrier a stage). A caller may
// name fewer rows, other stages and deeper ones: at 64 x 128 (the
// all-gather matmul's gathered form, whose whole gathered x is 64 rows)
// the warps are 32 x 32, two m16 tiles each, no tensor-core work is spent
// on rows past M, and a stage's slices are unrolled. A warp
// splits each value as it loads it into a fragment: the planes of a
// split stage would double every fragment load and add a pass between
// two barriers, and shared memory, not the arithmetic, then sets the
// pace (1.3-1.4x slower on an H100, `PERF.md` §6). mma.sync.m16n8k8
// wants A's (row g, k t) and (g, k t + 4) and B's (k t, column g), g =
// lane / 4, t = lane % 4. The contraction index may be permuted as long
// as A and B agree: in a 16-deep slice, k = t stands for column 4t (4t +
// 2 in the slice's second mma) and k = t + 4 for 4t + 1 (4t + 3), so the
// A fragments of a row are one 16-byte load. Bank conflicts: A's 16-byte
// units are swizzled by the row's parity (rows g and g + 1 are read at
// once), B's by 2 * ((k / 4) mod 4) (rows 4t + i of four t are read at
// once, four columns apart). Registers: a warp's 64 x 32 running sums
// take 64 a thread, so the fresh sums are one m16 tile's (16) and a
// slice's passes are added to the running sums every 16 of K.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, the low 13 bits of the f32 pattern cleared), in two integer
// ops: ptxas expands the cvt into four, with a guard for NaN and inf
// that finite inputs never need (a NaN still propagates: its lo is NaN).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x's TF32 lo: x - hi rounded the same way.
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return tf32(x - __uint_as_float(hi));
}

// c += a . b on the tensor cores, one m16n8k8 TF32 product.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into TF32 hi and lo (lo left unset where exact).
template <bool kExact>
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ SplitA() {}
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    const float a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = tf32(a[i]);
      if (!kExact) lo[i] = tf32_lo(a[i], hi[i]);
    }
  }
};

// c += a . b with f32 accuracy, b given split (h, l): lo_a h + hi_a l +
// hi_a h, a pass dropped where its operand is exact in TF32.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void split_mma(float (&c)[4],
                                          const SplitA<kAExact>& a,
                                          uint32_t h0, uint32_t h1,
                                          uint32_t l0, uint32_t l1) {
  if (!kAExact) mma(c, a.lo, h0, h1);
  if (!kBExact) mma(c, a.hi, l0, l1);
  mma(c, a.hi, h0, h1);
}

constexpr int kTfBM = 128;
constexpr int kTfBK = 32;     // K depth of one stage
constexpr int kTfStages = 3;  // stages in flight

// kStages stages of a BM x BN tile, BK of K each, as cp.async lands
// them, f32, 16-byte units swizzled (note above). The tile's rows, its
// stages and their depth are the caller's: 128 rows, three stages of 32,
// unless it names others (the all-gather matmul's gathered form).
template <int BN, int BM = kTfBM, int kStages = kTfStages, int BK = kTfBK>
struct SmemTf32 {
  static_assert(BK % 16 == 0 && BK <= 64, "whole 16-deep slices, A's "
                "swizzle within a row of at most 16 units");
  float a[kStages][BM][BK];
  float b[kStages][BK][BN];
};

// Where A's unit kq of row r and B's unit nq of row k lie in their rows.
__device__ __forceinline__ int a_unit(int r, int kq) {
  return kq ^ 4 * (r & 1);
}
__device__ __forceinline__ int b_unit(int k, int nq) {
  return nq ^ 2 * ((k >> 2) & 3);
}

// Every thread: its 16-byte units of K stage k0 into stage s,
// zero-filled outside M, N and K.
template <int BN, int BM, int kStages, int BK>
__device__ __forceinline__ void load_stage_tf32(
    SmemTf32<BN, BM, kStages, BK>& sm, int s, const float* A, long long lda,
    const float* B, long long ldb, int M, int N, int K, int row0, int col0,
    int k0) {
  for (int e = threadIdx.x; e < BM * BK / 4; e += kThreads) {
    const int r = e / (BK / 4), kq = e % (BK / 4);
    const bool ok = row0 + r < M && k0 + 4 * kq < K;
    cp_async16_zfill(
        &sm.a[s][r][4 * a_unit(r, kq)],
        ok ? A + static_cast<long long>(row0 + r) * lda + k0 + 4 * kq : A, ok);
  }
  for (int e = threadIdx.x; e < BK * BN / 4; e += kThreads) {
    const int k = e / (BN / 4), nq = e % (BN / 4);
    const bool ok = k0 + k < K && col0 + 4 * nq < N;
    cp_async16_zfill(
        &sm.b[s][k][4 * b_unit(k, nq)],
        ok ? B + static_cast<long long>(k0 + k) * ldb + col0 + 4 * nq : B, ok);
  }
}

// out(C[row0:row0+BM, col0:col0+BN] = A[row0.., :K] @ B[:K, col0..]) at
// f32 accuracy for row-major f32 A [M, K] and B [K, N] with row strides
// lda and ldb; the epilogue is called for the groups of 4 inside C. All
// threads of the CTA call it. An element's arithmetic does not depend on
// BM, BN, the stages or where the element lies in its tile: the same
// passes, slices and additions in the same order.
template <int BN, int BM, int kStages, int BK, class Epilogue>
__device__ void tile_product_tf32x3(SmemTf32<BN, BM, kStages, BK>& sm,
                                    const float* A, long long lda,
                                    const float* B, long long ldb, int M,
                                    int N, int K, int row0, int col0,
                                    const Epilogue& out) {
  constexpr int kWarpsN = BN / 32;
  constexpr int WM = BM / (kWarps / kWarpsN);
  constexpr int MI = WM / 16;  // m16 tiles of a warp; four n8 tiles
  static_assert(kWarps % kWarpsN == 0 && WM % 16 == 0, "warp layout");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / kWarpsN * WM, wc = warp % kWarpsN * 32;

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_stage_tf32(sm, s, A, lda, B, ldb, M, N, K, row0, col0, s * BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread; stage kt - 1 is read by all
    const int next = kt + kStages - 1;
    if (next < nk) {
      load_stage_tf32(sm, next % kStages, A, lda, B, ldb, M, N, K, row0,
                      col0, next * BK);
    }
    cp_async_commit();  // possibly empty: keeps the group count right
    const int s = kt % kStages;
    // The 128-row tile keeps one slice's B fragments live at a time (its
    // running sums take 64 registers a thread); a smaller tile unrolls
    // the stage's slices, more independent work between barriers.
#pragma unroll(BM == kTfBM ? 1 : BK / 16)
    for (int d = 0; d < BK; d += 16) {
      // B: rows d + 4t + i, columns wc + 8j + g, split; [j][i].
      uint32_t bh[4][4], bl[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = d + 4 * t + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wc + 8 * j + g;
          const float v = sm.b[s][k][4 * b_unit(k, n >> 2) + (n & 3)];
          bh[j][i] = tf32(v);
          bl[j][i] = tf32_lo(v, bh[j][i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        // Rows g and g + 8 of the m16 tile, columns d + 4t .. + 3.
        const int r = wr + 16 * i + g;
        const int at = 4 * a_unit(r, d / 4 + t);
        const float4 x0 = *reinterpret_cast<const float4*>(&sm.a[s][r][at]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&sm.a[s][r + 8][at]);
        const SplitA<false> a0(x0.x, x1.x, x0.y, x1.y);  // first k8
        const SplitA<false> a1(x0.z, x1.z, x0.w, x1.w);  // second k8
        // The slice's passes into fresh sums, added to acc with one
        // rounding.
        float part[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
          split_mma<false, false>(part[j], a0, bh[j][0], bh[j][1], bl[j][0],
                                  bl[j][1]);
          split_mma<false, false>(part[j], a1, bh[j][2], bh[j][3], bl[j][2],
                                  bl[j][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is read: the next call may refill them

  // Epilogue: the accumulator holds (row g, columns 2t, 2t + 1) and (row
  // g + 8, the same); lanes t and t ^ 1 swap halves, so that an even t
  // hands over row g and an odd t row g + 8, columns 2 (t & ~1) .. + 3.
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* c = acc[i][j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const int row = row0 + wr + 16 * i + g + (odd ? 8 : 0);
      const int col = col0 + wc + 8 * j + 2 * (t & ~1);
      if (row < M && col < N) {
        const float v[4] = {odd ? r0 : c[0], odd ? r1 : c[1],
                            odd ? c[2] : r0, odd ? c[3] : r1};
        out(row, col, v);
      }
    }
}

// -- bf16 on wgmma, fed by TMA -----------------------------------------------
//
// Serves the bf16 instances of TPU kernels 11 and 12 (parallel/
// collective_matmul.py of the JAX package: `_pallas_ag_matmul`,
// `_pallas_mm_rs`), through `collective_matmul.cu`, TPU kernels 3-5 (the
// burn tile and the benchmark matmul), through `tile_mma.cu`'s tile
// kernel, whose operands are plain 2-D tensors read as views with one
// part, and TPU kernel 2 (the burn chain), through `tile_mma.cu`'s chain
// kernel, which reads the previous step's h as one part of a scratch
// view with two. What bounds the collective matmuls is operations: at the
// tensor-parallel MLP's shapes each does 2.749e11 flop, 0.2779 ms at the
// H100's 989 TFLOP/s bf16 peak, against 168 MB of operands and output.
// The form that came before, WMMA fragments (mma.sync) fed by per-thread
// cp.async two stages deep, reached 124 (all-gather matmul) and 81
// (reduce-scatter) TFLOP/s there, and ~188 on the benchmark matmul at
// 4096^3 (NVIDIA H100 80GB HBM3, 700 W): it cannot keep Hopper's tensor
// cores busy. So this form uses the two mechanisms that can:
//
//   * TMA. One thread asks for a whole A tile (BM x 64, one box) and the B
//     tile (64 x BN, BN / 64 boxes of 64 columns) of a K step; the copy
//     lands in shared memory in the 128-byte swizzle that wgmma reads, and
//     completes on the stage's `full` mbarrier, which carries the bytes.
//     kStages stages are in flight. A stage is refilled once all eight
//     warps have arrived on its `empty` mbarrier, after their wgmma reads
//     of it have retired;
//   * wgmma.mma_async, bf16 x bf16 -> f32, both operands from shared
//     memory: A K-major (row-major [M, K]), B MN-major (row-major [K, N],
//     the descriptor's transpose bit). The CTA's two warpgroups each own 64
//     rows of the tile and keep their 64 x BN accumulator in registers; one
//     K step's four k16 products run while the previous step's retire
//     (wait_group 1).
//
// Operands are tensor maps with three coordinates (`TmaView`): a coordinate
// that runs along K, one along the tile's rows (A) or columns (B), and one
// that picks a part (a rank's shard, a ring slot, a rank's slice of the
// contraction). Tails are TMA's: a box reaching past a dimension's extent
// is zero-filled, so a K extent that ends inside a tensor (kernel 12's
// contraction of k / n) is its own dimension, and the epilogue masks rows
// and columns outside C. The views are computed on the host (`tma_views`
// of `parallel/collective_matmul.py` and of `parallel/tile_mma.py`) and
// encoded per call.
//
// The mbarrier ring is the CTA's for the whole launch: a `WgmmaPipe` counts
// the K steps consumed and each `empty` barrier's phase, so the products a
// CTA runs one after another (several per ring step) carry the phases on.
// A wait that is not released after kWaitLimitNs traps: a wrong phase fails
// the launch instead of hanging the card.
//
// Epilogue: after the last wait_group 0 the stages are idle; the
// accumulators go there as an f32 tile (rows padded to BN + 8 floats), and
// each thread hands 8 neighbours of a row to `out`, as the other forms do.
//
// Generic writes by other CTAs (a ring slot, the chain's previous h) are
// read here by TMA, through the async proxy: the thread that issues the
// loads fences the proxies (fence.proxy.async.global) after the caller's
// acquire or grid-wide barrier and before its first load; the epilogue's
// generic use of the stages is fenced likewise
// (fence.proxy.async.shared::cta) before the next product's loads.

constexpr int kWgBM = 128;      // two warpgroups of 64 rows
constexpr int kWgBK = 64;       // K of one stage: one 128-byte swizzled row
constexpr int kWgPanel = 64;    // B columns of one TMA box (128 bytes)
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

// A stage: the A tile (BM rows of 128 bytes), then the B tile as BN / 64
// panels of 64 K rows of 128 bytes. Every part starts on 1024 bytes, the
// swizzle's period, so the descriptors need no base offset.
template <int BN>
struct WgStage {
  static constexpr int kABytes = kWgBM * kWgBK * 2;
  static constexpr int kPanelBytes = kWgBK * kWgPanel * 2;
  static constexpr int kBytes = kABytes + BN / kWgPanel * kPanelBytes;
  static constexpr int kLd = BN + 8;  // f32 staging row: 8 banks apart
};

template <int BN, int kStages>
struct alignas(1024) SmemWgmma {
  unsigned char stage[kStages][WgStage<BN>::kBytes];
  unsigned long long full[kStages];   // the stage's TMA bytes have landed
  unsigned long long empty[kStages];  // every warp is done reading it
};

// The mbarrier ring's place, the same in every thread of the CTA.
struct WgmmaPipe {
  unsigned used = 0;       // K steps this CTA has consumed, all products
  unsigned empty_par = 0;  // bit s: parity of empty[s]'s next completion
};

// One operand's tensor map (`tma_views`' coordinate roles: which of the
// three runs along K, along the tile, over the parts). In a kernel's
// parameters, declared __grid_constant__: TMA reads the map where it is.
struct alignas(64) TmaView {
  CUtensorMap map;
  int kdim, tdim, pdim;
};

// An operand of one product: part `part` of `view`, its tile coordinate
// starting at `tile0` (the product adds its row0 or col0).
struct TmaOperand {
  const TmaView* view;
  int part, tile0;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` has completed; traps after
// kWaitLimitNs.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = clock_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (clock_ns() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The box of `op` at K offset k0 and tile offset t, into dst.
__device__ __forceinline__ void tma_box(void* dst, const TmaOperand& op,
                                        unsigned long long* bar, int k0,
                                        int t) {
  const TmaView& v = *op.view;
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c[d] = (d == v.kdim ? k0 : 0) + (d == v.tdim ? op.tile0 + t : 0) +
           (d == v.pdim ? op.part : 0);
  }
  tma_load_3d(dst, &v.map, bar, c[0], c[1], c[2]);
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across a wgmma
// that is still in flight.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0..32) += A (64 x 16, K-major) @ B (16 x 64, MN-major), both read
// from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..64) += A (64 x 16, K-major) @ B (16 x 128, MN-major), both
// read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[0..128) += A (64 x 16, K-major) @ B (16 x 256, MN-major), both
// read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Thread 0: the TMA loads of K step k0 into stage s, on its full barrier.
template <int BN, int kStages>
__device__ __forceinline__ void wg_load(SmemWgmma<BN, kStages>& sm, int s,
                                        const TmaOperand& a,
                                        const TmaOperand& b, int row0,
                                        int col0, int k0) {
  using St = WgStage<BN>;
  mbar_expect_tx(&sm.full[s], St::kBytes);
  tma_box(sm.stage[s], a, &sm.full[s], k0, row0);
#pragma unroll
  for (int p = 0; p < BN / kWgPanel; ++p) {
    tma_box(sm.stage[s] + St::kABytes + p * St::kPanelBytes, b, &sm.full[s],
            k0, col0 + p * kWgPanel);
  }
}

// Once per launch, by all threads, before the first product.
template <int BN, int kStages>
__device__ void wgmma_init(SmemWgmma<BN, kStages>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// out(C[row0:row0+kWgBM, col0:col0+BN] = A @ B over K) for the operands
// `a` (rows along its tile coordinate) and `b` (columns along its). M and
// N mask the epilogue; K ends the loop, and TMA zero-fills past the views'
// extents. All threads of the CTA call it, the same products in the same
// order, with the one `pipe`.
template <int BN, int kStages, class Epilogue>
__device__ void tile_product_wgmma(SmemWgmma<BN, kStages>& sm,
                                   WgmmaPipe& pipe, const TmaOperand& a,
                                   const TmaOperand& b, int M, int N, int K,
                                   int row0, int col0, const Epilogue& out) {
  static_assert(kThreads == 256, "two consumer warpgroups");
  static_assert(BN == 64 || BN == 128 || BN == 256, "a wgmma width");
  using St = WgStage<BN>;
  static_assert(kWgBM * St::kLd * 4 <= kStages * St::kBytes,
                "the f32 tile fits in the stages");
  const int nk = (K + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const unsigned base = pipe.used;

  if (threadIdx.x == 0) {
    // Ring slots and the chain's h were written by other CTAs' generic
    // stores and released to this thread by the caller's acquire or
    // grid.sync(): order them before the async proxy's reads.
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    for (int j = 0; j < nk && j < kStages; ++j) {
      wg_load(sm, (base + j) % kStages, a, b, row0, col0, j * kWgBK);
    }
  }
  __syncwarp();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const unsigned u = base + j;
    const int s = u % kStages;
    mbar_wait(&sm.full[s], (u / kStages) & 1);
    const unsigned char* st = sm.stage[s];
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // A: this warpgroup's 64 rows, k16 slice kk (32 bytes into each
      // swizzled row; 8-row groups 1024 bytes apart). B: K rows
      // 16 kk .. of every panel (panels St::kPanelBytes apart).
      const uint64_t da =
          sw128_desc(st + wg * (kWgBM / 2) * 128 + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(st + St::kABytes + kk * 16 * 128,
                                     St::kPanelBytes, 1024);
      if constexpr (BN == 256) {
        wgmma_m64n256k16(acc, da, db);
      } else if constexpr (BN == 128) {
        wgmma_m64n128k16(acc, da, db);
      } else {
        wgmma_m64n64k16(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have retired
    fence_regs(acc);
    const int refill = j - 1 + kStages;  // the K step for that stage
    if (j >= 1 && refill < nk) {
      const int sp = (u - 1) % kStages;
      if (lane == 0) mbar_arrive(&sm.empty[sp]);
      if (threadIdx.x == 0) {
        mbar_wait(&sm.empty[sp], (pipe.empty_par >> sp) & 1);
        wg_load(sm, sp, a, b, row0, col0, refill * kWgBK);
      }
      __syncwarp();
      pipe.empty_par ^= 1u << sp;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  pipe.used = base + nk;

  // Epilogue through the idle stages: acc's fragment order (thread t of
  // warpgroup wg: warp w = t / 32 within it, rows wg * 64 + w * 16 +
  // lane / 4 (+ 8), columns 8 g + 2 (lane % 4) (+ 1) of group g).
  __syncthreads();  // both warpgroups are done with every stage
  float* tile = reinterpret_cast<float*>(sm.stage[0]);
  {
    const int r = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int c = 2 * (lane % 4);
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      *reinterpret_cast<float2*>(tile + r * St::kLd + 8 * g + c) =
          make_float2(acc[4 * g], acc[4 * g + 1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * St::kLd + 8 * g + c) =
          make_float2(acc[4 * g + 2], acc[4 * g + 3]);
    }
  }
  __syncthreads();
  constexpr int kGroups = BN / 8;  // groups of 8 in a tile row
  for (int e = threadIdx.x; e < kWgBM * kGroups; e += kThreads) {
    const int r = e / kGroups, c8 = e % kGroups * 8;
    const int row = row0 + r, col = col0 + c8;
    if (row < M && col < N) {
      const float* at = tile + r * St::kLd + c8;
      const float4 lo = *reinterpret_cast<const float4*>(at);
      const float4 hi = *reinterpret_cast<const float4*>(at + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      out(row, col, v);
    }
  }
  // The stages go back to TMA: order this thread's generic accesses
  // before the next product's async-proxy writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// -- host: a view's tensor map -----------------------------------------------

// cuTensorMapEncodeTiled, resolved through the runtime so that no source
// links libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Values of one view, as `tma_views` lays them out: extents (3, innermost
// first, in elements), strides of dimensions 1 and 2 (bytes), the box (3),
// the roles of the three coordinates (0 K, 1 tile, 2 part).
constexpr int kViewValues = 11;

// `out` = the bf16 view `v` of the tensor at `base`, in the 128-byte
// swizzle, zero-filled out of bounds. False where the view is refused.
inline bool encode_view(TmaView& out, const void* base, const long long* v) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(v[0]),
                              static_cast<cuuint64_t>(v[1]),
                              static_cast<cuuint64_t>(v[2])};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(v[3]),
                                 static_cast<cuuint64_t>(v[4])};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(v[5]),
                             static_cast<cuuint32_t>(v[6]),
                             static_cast<cuuint32_t>(v[7])};
  const cuuint32_t unit[3] = {1, 1, 1};
  out.kdim = out.tdim = out.pdim = -1;
  for (int d = 0; d < 3; ++d) {
    int& slot = v[8 + d] == 0 ? out.kdim : v[8 + d] == 1 ? out.tdim : out.pdim;
    if (v[8 + d] < 0 || v[8 + d] > 2 || slot >= 0) return false;
    slot = d;
  }
  return encode(&out.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tile
