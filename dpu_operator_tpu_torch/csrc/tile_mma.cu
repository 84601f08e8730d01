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
// One design serves all three: the bf16 tile product of
// `tile_product.cuh` (cp.async staging two stages deep, nvcuda::wmma on the
// tensor cores, an f32 accumulator), here without tails, and an epilogue
// that writes bf16, after tanhf in f32 for the burn. The TPU kernels'
// sequential K grid axis and VMEM accumulator become the product's loop
// over K; nothing is carried between CTAs, so the matmul's full-K and
// K-blocked routes launch the same kernel here.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_product.cuh"

namespace {

namespace cg = cooperative_groups;
using tile::bf16;
using tile::kThreads;

constexpr int kChainBM = 128;  // 1024^2 in 128 x 64 tiles: 128 CTAs, <= 132 SMs
constexpr int kChainBN = 64;
constexpr int kTileBM = 128;
constexpr int kTileBN = 128;

template <bool kTanh>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                bf16* __restrict__ C, int K, int N) {
  using S = tile::Smem<kTileBM, kTileBN>;
  extern __shared__ __align__(128) unsigned char raw[];
  tile::tile_product<kTileBM, kTileBN, false>(
      *reinterpret_cast<S*>(raw), A, K, B, N, gridDim.y * kTileBM, N, K,
      blockIdx.y * kTileBM, blockIdx.x * kTileBN,
      tile::StoreBf16<kTanh>{C, N});
}

// No __restrict__: h0 and h1 are written in one step and read in the next.
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const bf16* x, const bf16* w, bf16* h0, bf16* h1, bf16* out,
                 int n, int length) {
  using S = tile::Smem<kChainBM, kChainBN>;
  extern __shared__ __align__(128) unsigned char raw[];
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
      tile::tile_product<kChainBM, kChainBN, false>(
          sm, src, n, w, n, n, n, n, t / tiles_n * kChainBM,
          t % tiles_n * kChainBN, tile::StoreBf16<true>{dst, n});
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
  const size_t smem = sizeof(tile::Smem<kTileBM, kTileBN>);  // < 48 KB
  if (apply_tanh) {
    tile_kernel<true><<<grid, kThreads, smem, st>>>(a, b, c, k, n);
  } else {
    tile_kernel<false><<<grid, kThreads, smem, st>>>(a, b, c, k, n);
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
  const size_t smem = sizeof(tile::Smem<kChainBM, kChainBN>);  // < 48 KB
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
                                                      kThreads, smem);
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
                                  dim3(blocks), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
