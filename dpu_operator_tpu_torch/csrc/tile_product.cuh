// The one tile product of the port's matmul kernels, for Hopper (sm_90a).
//
// A CTA of kThreads threads computes one BM x BN tile of C = A @ B for
// row-major A [M, K] and B [K, N], each with its own row stride, and hands
// every finished group of values to an epilogue functor, which stores it
// where and as its caller wants: bf16, through tanh for the health burn
// (`tile_mma.cu`); the operands' own type (the all-gather matmul of
// `collective_matmul.cu`); f32 partial sums (its matmul reduce-scatter).
// Two forms, one per operand type:
//
//   * bf16, `tile_product`: a loop over K in steps of kBK = 32; the A and B
//     tiles of a step are staged in shared memory by cp.async, two stages
//     deep (the next step's copy is in flight while this one multiplies),
//     and multiplied on the tensor cores with nvcuda::wmma (bf16 operands,
//     f32 accumulator in registers). A fragment's element order is opaque,
//     so the epilogue goes through a per-warp f32 staging tile and hands
//     over 8 neighbours of one row at a time;
//   * f32, `tile_product_f32`: the same staging in steps of 16, and the
//     product on the FMA pipes in f32 (never TF32): 64 x 64 tiles, each
//     thread a register-blocked 4 x 4 patch (rows ty * 4 .., columns
//     tx * 4 ..) fed from shared memory as float4, one 16-byte load of A
//     and one of B feeding 16 FMAs. The epilogue gets 4 neighbours of a row.
//
// Tails. With kTails, M, N and K need not be multiples of the tile: a
// 16-byte unit of an operand that lies outside it is zero-filled (cp.async
// with a source size of 0) and the epilogue is called only for groups that
// lie inside C. The caller guarantees that every row of A, B and C that
// the product reads or writes, and every row stride, is a whole number of
// 16-byte units, so that a unit (and a group of 8 bf16 or 4 f32 outputs)
// is wholly inside or wholly outside. Without kTails the loop is
// unpredicated and the caller guarantees that M and N are multiples of the
// tile and K of the step.
//
// Operands are read with cp.async.cg, through L2 only: a ring kernel's
// operand may be a slot that a CTA on another SM has just written, and L1
// is not coherent across SMs.
//
// Shared memory is the caller's: a `Smem` or an `SmemF32` on a 128-byte
// boundary, static or dynamic. The product leaves it free for the next call
// (every stage is read before the loop's last barrier).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;  // K depth of one bf16 stage
constexpr int kPad = 8;  // bf16 of row padding: 16 bytes, fewer bank conflicts
constexpr int kF32Tile = 64;  // BM = BN of the f32 form
constexpr int kF32BK = 16;    // K depth of one f32 stage

// Row strides are multiples of 16 bytes (cp.async) and every fragment's
// first element lies on 32 bytes (wmma), given a 128-byte-aligned base.
template <int BM, int BN>
struct Smem {
  bf16 a[2][BM][kBK + kPad];
  bf16 b[2][kBK][BN + kPad];
  float stage[kWarps][16 * 16];  // one accumulator fragment per warp
};

// The A rows carry 4 floats of padding: the two 4-row groups that the two
// half-warps read at once then start 64 bytes apart, in other banks.
struct SmemF32 {
  float a[2][kF32Tile][kF32BK + 4];
  float b[2][kF32BK][kF32Tile];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes from src, or 16 zero bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

template <bool kTails>
__device__ __forceinline__ void cp_unit(void* dst, const void* src,
                                        const void* base, bool valid) {
  if (kTails) {
    cp_async16_zfill(dst, valid ? src : base, valid);
  } else {
    cp_async16(dst, src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group (the one most recently committed) is
// still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// -- bf16 on the tensor cores -------------------------------------------------

template <int BM, int BN, bool kTails>
__device__ __forceinline__ void load_stage(Smem<BM, BN>& sm, int s,
                                           const bf16* A, long long lda,
                                           const bf16* B, long long ldb,
                                           int M, int N, int K, int row0,
                                           int col0, int k0) {
  constexpr int kAChunks = kBK / 8;  // 16-byte chunks per A tile row
  for (int c = threadIdx.x; c < BM * kAChunks; c += kThreads) {
    const int r = c / kAChunks, kc = c % kAChunks * 8;
    cp_unit<kTails>(&sm.a[s][r][kc],
                    A + static_cast<long long>(row0 + r) * lda + k0 + kc, A,
                    row0 + r < M && k0 + kc < K);
  }
  constexpr int kBChunks = BN / 8;  // per B tile row
  for (int c = threadIdx.x; c < kBK * kBChunks; c += kThreads) {
    const int r = c / kBChunks, nc = c % kBChunks * 8;
    cp_unit<kTails>(&sm.b[s][r][nc],
                    B + static_cast<long long>(k0 + r) * ldb + col0 + nc, B,
                    k0 + r < K && col0 + nc < N);
  }
}

// out(C[row0:row0+BM, col0:col0+BN] = A[row0:row0+BM, :K] @ B[:K, col0:col0+BN])
// for row-major A [M, K] with row stride lda and B [K, N] with row stride
// ldb. All threads of the CTA call it.
template <int BM, int BN, bool kTails, class Epilogue>
__device__ void tile_product(Smem<BM, BN>& sm, const bf16* A, long long lda,
                             const bf16* B, long long ldb, int M, int N,
                             int K, int row0, int col0, const Epilogue& out) {
  using namespace nvcuda;
  constexpr int kWarpsN = BN / 32;  // each warp owns a WM x 32 sub-tile
  constexpr int kWarpsM = kWarps / kWarpsN;
  constexpr int WM = BM / kWarpsM;
  constexpr int FM = WM / 16;
  constexpr int FN = 2;
  static_assert(kWarpsM * kWarpsN == kWarps && WM % 16 == 0, "warp layout");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / kWarpsN * WM, wc = warp % kWarpsN * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = kTails ? (K + kBK - 1) / kBK : K / kBK;
  load_stage<BM, BN, kTails>(sm, 0, A, lda, B, ldb, M, N, K, row0, col0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    // Stage s ^ 1 was last read in step kt - 1, which every warp has
    // left (the barrier at the end of the loop body).
    if (kt + 1 < nk) {
      load_stage<BM, BN, kTails>(sm, s ^ 1, A, lda, B, ldb, M, N, K, row0,
                                 col0, (kt + 1) * kBK);
    }
    cp_async_commit();  // possibly empty: keeps "wait for all but one" right
    cp_async_wait_one();
    __syncthreads();  // stage s, copied by every thread, is in place
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::load_matrix_sync(fa[i], &sm.a[s][wr + 16 * i][kk], kBK + kPad);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::load_matrix_sync(fb[j], &sm.b[s][kk][wc + 16 * j], BN + kPad);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each fragment goes through the warp's own f32 staging tile;
  // a lane then hands 8 neighbours of one row to `out`.
  float* st = sm.stage[warp];
  const int r = lane / 2, c8 = lane % 2 * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = st[r * 16 + c8 + e];
      const int row = row0 + wr + 16 * i + r;
      const int col = col0 + wc + 16 * j + c8;
      if (!kTails || (row < M && col < N)) out(row, col, v);
      __syncwarp();  // the staging tile is read before the next store
    }
}

// -- f32 on the FMA pipes -----------------------------------------------------

template <bool kTails>
__device__ __forceinline__ void load_stage_f32(SmemF32& sm, int s,
                                               const float* A, long long lda,
                                               const float* B, long long ldb,
                                               int M, int N, int K, int row0,
                                               int col0, int k0) {
  static_assert(kThreads == kF32Tile * kF32BK / 4, "one A unit a thread");
  static_assert(kThreads == kF32BK * kF32Tile / 4, "one B unit a thread");
  {
    const int r = threadIdx.x / (kF32BK / 4);
    const int kc = threadIdx.x % (kF32BK / 4) * 4;
    cp_unit<kTails>(&sm.a[s][r][kc],
                    A + static_cast<long long>(row0 + r) * lda + k0 + kc, A,
                    row0 + r < M && k0 + kc < K);
  }
  {
    const int r = threadIdx.x / (kF32Tile / 4);
    const int nc = threadIdx.x % (kF32Tile / 4) * 4;
    cp_unit<kTails>(&sm.b[s][r][nc],
                    B + static_cast<long long>(k0 + r) * ldb + col0 + nc, B,
                    k0 + r < K && col0 + nc < N);
  }
}

// tile_product's function for f32 operands, in 64 x 64 tiles; every sum
// runs over k in order, one fmaf per product.
template <bool kTails, class Epilogue>
__device__ void tile_product_f32(SmemF32& sm, const float* A, long long lda,
                                 const float* B, long long ldb, int M, int N,
                                 int K, int row0, int col0,
                                 const Epilogue& out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = kTails ? (K + kF32BK - 1) / kF32BK : K / kF32BK;
  load_stage_f32<kTails>(sm, 0, A, lda, B, ldb, M, N, K, row0, col0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_stage_f32<kTails>(sm, s ^ 1, A, lda, B, ldb, M, N, K, row0, col0,
                             (kt + 1) * kF32BK);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&sm.a[s][ty * 4 + i][kk]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        b[c] = *reinterpret_cast<const float4*>(&sm.b[s][kk + c][tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][0] = fmaf(av[c], b[c].x, acc[i][0]);
          acc[i][1] = fmaf(av[c], b[c].y, acc[i][1]);
          acc[i][2] = fmaf(av[c], b[c].z, acc[i][2]);
          acc[i][3] = fmaf(av[c], b[c].w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    const int col = col0 + tx * 4;
    if (!kTails || (row < M && col < N)) {
      const float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      out(row, col, v);
    }
  }
}

}  // namespace tile
