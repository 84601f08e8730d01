// bf16 tile products on the tensor cores for Hopper (sm_90a): the health
// burn's chain and tile kernels and the benchmark matmul.
//
// Replaces three TPU kernels of the JAX package:
//   * parallel/pallas_burn.py `_burn_chain_kernel` (burn_chain_pallas):
//     `length` chained h = bf16(tanh(f32(h @ w))), h kept on chip;
//   * parallel/pallas_burn.py `_burn_kernel` (burn_step_pallas, tiled
//     branch): one bf16(tanh(f32(x @ w))) per launch;
//   * parallel/mxu_bench.py `_mm_kernel` and `_mm_kernel_fullk`
//     (pallas_matmul): bf16 x @ w with an f32 accumulator, bf16 out.
//
// One design serves all three. A CTA computes a BM x BN output tile as a
// loop over K in steps of 32: the A and B tiles of a step are staged in
// shared memory by cp.async, two stages deep (the next step's copy is in
// flight while this one multiplies), multiplied on the tensor cores with
// nvcuda::wmma (bf16 operands, f32 accumulator in registers), and an
// epilogue writes bf16, after tanhf in f32 for the burn. The TPU kernels'
// sequential K grid axis and VMEM accumulator become that loop; nothing
// is carried between CTAs, so the matmul's full-K and K-blocked routes
// launch the same kernel here.
//
// The chain. Each step needs all of the previous h (2 MB at 1024^2), more
// than one SM's shared memory, so h lives in L2 (50 MB). One cooperative
// launch, of no more CTAs than the card can hold at once, walks each
// step's output tiles and meets at a grid-wide barrier between steps.
// Steps alternate between two h buffers that the caller allocates (the
// TPU kernel updated h in place; here that would let one CTA overwrite
// rows another CTA is still reading), and the last step writes `out`.
// Operands are read with cp.async.cg, which caches in L2 only, so no CTA
// reads a stale line of h from its L1.
//
// What bounds them: operations. At the path's shapes (1024^2 x 8 steps,
// 2048^2, 4096^3) each does 680-2730 FLOP per byte it must move, above
// the card's ~295 FLOP/byte bf16 ridge. This first version multiplies
// with wmma (mma.sync), not wgmma fed by TMA, so it cannot reach the
// tensor cores' full rate.
//
// Rounding: f32 accumulation, the accurate tanhf (built without fast
// math), one round-to-nearest-even to bf16 per output element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBK = 32;    // K depth of one shared-memory stage
constexpr int kPad = 8;    // bf16 of row padding: 16 bytes, fewer bank conflicts
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChainBM = 128;  // 1024^2 in 128 x 64 tiles: 128 CTAs, <= 132 SMs
constexpr int kChainBN = 64;
constexpr int kTileBM = 128;
constexpr int kTileBN = 128;

// Row strides are multiples of 16 bytes (cp.async) and every fragment's
// first element lies on 32 bytes (wmma), given a 128-byte-aligned base.
template <int BM, int BN>
struct Smem {
  bf16 a[2][BM][kBK + kPad];
  bf16 b[2][kBK][BN + kPad];
  float stage[kWarps][16 * 16];  // one accumulator fragment per warp
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
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

template <int BM, int BN>
__device__ __forceinline__ void load_stage(Smem<BM, BN>& sm, int s,
                                           const bf16* A, const bf16* B,
                                           int K, int N, int row0, int col0,
                                           int k0) {
  constexpr int kAChunks = kBK / 8;  // 16-byte chunks per A tile row
  for (int c = threadIdx.x; c < BM * kAChunks; c += kThreads) {
    const int r = c / kAChunks, kc = c % kAChunks * 8;
    cp_async16(&sm.a[s][r][kc],
               A + static_cast<size_t>(row0 + r) * K + k0 + kc);
  }
  constexpr int kBChunks = BN / 8;  // per B tile row
  for (int c = threadIdx.x; c < kBK * kBChunks; c += kThreads) {
    const int r = c / kBChunks, nc = c % kBChunks * 8;
    cp_async16(&sm.b[s][r][nc],
               B + static_cast<size_t>(k0 + r) * N + col0 + nc);
  }
}

// C[row0:row0+BM, col0:col0+BN] = epilogue(A[row0:row0+BM, :] @ B[:, col0:col0+BN])
// for row-major A [., K], B [K, N], C [., N]. All threads of the CTA call it.
template <int BM, int BN, bool kTanh>
__device__ void tile_product(Smem<BM, BN>& sm, const bf16* A, const bf16* B,
                             bf16* C, int K, int N, int row0, int col0) {
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

  const int nk = K / kBK;
  load_stage(sm, 0, A, B, K, N, row0, col0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    // Stage s ^ 1 was last read in step kt - 1, which every warp has
    // left (the barrier at the end of the loop body).
    if (kt + 1 < nk) {
      load_stage(sm, s ^ 1, A, B, K, N, row0, col0, (kt + 1) * kBK);
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

  // Epilogue: a fragment's element order is opaque, so each goes through
  // the warp's own f32 staging tile; a lane then rounds 8 neighbours of one
  // row and writes them as one 16-byte store.
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
      for (int e = 0; e < 8; ++e) {
        v[e] = kTanh ? tanhf(st[r * 16 + c8 + e]) : st[r * 16 + c8 + e];
      }
      const uint4 packed =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                     pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      *reinterpret_cast<uint4*>(
          C + static_cast<size_t>(row0 + wr + 16 * i + r) * N + col0 + wc +
          16 * j + c8) = packed;
      __syncwarp();  // the staging tile is read before the next store
    }
}

template <bool kTanh>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                bf16* __restrict__ C, int K, int N) {
  using S = Smem<kTileBM, kTileBN>;
  __shared__ __align__(128) unsigned char raw[sizeof(S)];
  tile_product<kTileBM, kTileBN, kTanh>(*reinterpret_cast<S*>(raw), A, B, C,
                                        K, N, blockIdx.y * kTileBM,
                                        blockIdx.x * kTileBN);
}

// No __restrict__: h0 and h1 are written in one step and read in the next.
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const bf16* x, const bf16* w, bf16* h0, bf16* h1, bf16* out,
                 int n, int length) {
  using S = Smem<kChainBM, kChainBN>;
  __shared__ __align__(128) unsigned char raw[sizeof(S)];
  S& sm = *reinterpret_cast<S*>(raw);
  cg::grid_group grid = cg::this_grid();
  const int tiles_n = n / kChainBN;
  const int tiles = n / kChainBM * tiles_n;
  for (int step = 0; step < length; ++step) {
    // Step i reads x (i == 0) or the buffer step i - 1 wrote, and writes
    // h0 (even i), h1 (odd i) or, last, out.
    const bf16* src = step == 0 ? x : (step & 1 ? h0 : h1);
    bf16* dst = step == length - 1 ? out : (step & 1 ? h1 : h0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      tile_product<kChainBM, kChainBN, true>(sm, src, w, dst, n, n,
                                             t / tiles_n * kChainBM,
                                             t % tiles_n * kChainBN);
    }
    // Every tile of step i is written before any CTA starts step i + 1;
    // and no CTA writes a buffer of step i + 2 while one still reads it
    // in step i + 1.
    if (step + 1 < length) grid.sync();
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error
// code of its launch, 0 on success, launches on `stream` and does not
// synchronize. The caller checks shapes: m and n multiples of 128, k a
// multiple of 32, row-major contiguous operands on 16-byte boundaries.

// out [m, n] = bf16(x [m, k] @ w [k, n]), through tanh in f32 if
// `apply_tanh`.
extern "C" int tile_mma_launch(const void* x, const void* w, void* out, int m,
                               int k, int n, int apply_tanh, void* stream) {
  const dim3 grid(n / kTileBN, m / kTileBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(x);
  const bf16* b = static_cast<const bf16*>(w);
  bf16* c = static_cast<bf16*>(out);
  if (apply_tanh) {
    tile_kernel<true><<<grid, kThreads, 0, st>>>(a, b, c, k, n);
  } else {
    tile_kernel<false><<<grid, kThreads, 0, st>>>(a, b, c, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// `length` >= 1 chained h = bf16(tanh(h @ w)) from h = x, x and w [n, n],
// in ONE cooperative launch; h0 and h1 are [n, n] scratch, out [n, n] the
// last h. Refuses (an error code, never a fallback) where the card cannot
// hold one CTA of the kernel per SM or has no cooperative launch.
extern "C" int burn_chain_launch(const void* x, const void* w, void* h0,
                                 void* h1, void* out, int n, int length,
                                 void* stream) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_kernel,
                                                      kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int tiles = n / kChainBM * (n / kChainBN);
  // Co-resident by construction: at most per_sm CTAs on each SM.
  const int blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* h0p = static_cast<bf16*>(h0);
  bf16* h1p = static_cast<bf16*>(h1);
  bf16* outp = static_cast<bf16*>(out);
  void* args[] = {&xp, &wp, &h0p, &h1p, &outp, &n, &length};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chain_kernel),
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
