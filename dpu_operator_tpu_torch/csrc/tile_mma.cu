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
// The tile kernel (the burn step and both matmul routes) multiplies with
// `tile_product.cuh`'s TMA-fed wgmma form, `tile_product_wgmma`, the one
// the bf16 collective matmuls use: one thread loads each K step's tiles by
// TMA in the 128-byte swizzle through a ring of mbarrier-guarded stages,
// and two warpgroups multiply them with wgmma.mma_async into f32
// accumulators. x [m, k] and w [k, n] are read through 3-D tensor maps
// with a part extent of 1, x as (k, m, 1) and w as (n, k, 1), innermost
// first (`parallel/tile_mma.py` `tma_views`), encoded on the host for
// each call and passed as __grid_constant__ parameters. One CTA computes
// one 128 x BN output tile and hands it to `StoreBf16`, through tanhf in
// f32 for the burn. The TPU kernels' sequential K grid axis and VMEM
// accumulator become the product's loop over K; nothing is carried
// between CTAs, so the matmul's full-K and K-blocked routes launch the
// same kernel. TMA zero-fills a K tail past the last 64-wide box, so k
// need only be a multiple of 32 (the wrappers' contract); columns past n
// are zero-filled and not stored. Both widths are built, 128 x 256 (four
// stages, one CTA an SM) and 128 x 128 (three stages, two CTAs an SM);
// the wrappers launch 128 x 256, the faster at 4096^3 on an H100
// (`parallel/tile_mma.py` TILE_WIDTH, `PERF.md` §6).
//
// The chain keeps the wmma form of `tile_product.cuh` (cp.async staging
// two stages deep, nvcuda::wmma): each step needs all of the previous h
// (2 MB at 1024^2), more than one SM's shared memory, so h lives in L2
// (50 MB). One cooperative launch, of no more CTAs than the card can hold
// at once, walks each step's output tiles and meets at a grid-wide barrier
// between steps. Steps alternate between two h buffers that the caller
// allocates (the TPU kernel updated h in place; here that would let one
// CTA overwrite rows another CTA is still reading), and the last step
// writes `out`. Operands are read with cp.async.cg, which caches in L2
// only, so no CTA reads a stale line of h from its L1. Moving it to TMA
// would need tensor maps of the two h buffers and a proxy fence after
// every grid.sync(): later work (the chain has no library call to lose
// to).
//
// What bounds them: operations. At the path's shapes (1024^2 x 8 steps,
// 2048^2, 4096^3) each does 680-2730 FLOP per byte it must move, above
// the card's ~295 FLOP/byte bf16 ridge: the matmul at 4096^3 does 137.4
// GFLOP, 0.1390 ms at the H100's 989 TFLOP/s bf16 peak.
//
// Rounding: f32 accumulation, the accurate tanhf (built without fast
// math), one round-to-nearest-even to bf16 per output element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tile_product.cuh"

namespace {

namespace cg = cooperative_groups;
using tile::bf16;
using tile::kThreads;

constexpr int kChainBM = 128;  // 1024^2 in 128 x 64 tiles: 128 CTAs, <= 132 SMs
constexpr int kChainBN = 64;

// A tile kernel's operands and output: x [m, k] and w [k, n] as their
// tensor maps, out [m, n] row-major.
struct TileParams {
  tile::TmaView x_view, w_view;
  bf16* out;
  int m, k, n;
};

// The wgmma form's stages at each width: what fits one CTA an SM (256)
// or two (128).
template <int BN>
struct TileShape {
  static constexpr int kStages = BN == 256 ? 4 : 3;
  using Smem = tile::SmemWgmma<BN, kStages>;
  // Dynamic shared memory is placed on 16 bytes: room to move up to 1024.
  static constexpr size_t kSmemBytes = sizeof(Smem) + alignof(Smem);
};

// At 128 x 128 two CTAs share an SM, so each thread keeps to 128
// registers.
template <int BN, bool kTanh>
__global__ void __launch_bounds__(kThreads, 256 / BN)
    tile_kernel(const __grid_constant__ TileParams p) {
  using Smem = typename TileShape<BN>::Smem;
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(raw) + alignof(Smem) - 1) &
      ~static_cast<uintptr_t>(alignof(Smem) - 1));
  tile::wgmma_init(sm);
  tile::WgmmaPipe pipe;
  tile::tile_product_wgmma(sm, pipe, tile::TmaOperand{&p.x_view, 0, 0},
                           tile::TmaOperand{&p.w_view, 0, 0}, p.m, p.n, p.k,
                           blockIdx.y * tile::kWgBM, blockIdx.x * BN,
                           tile::StoreBf16<kTanh>{p.out, p.n});
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
      tile::tile_product<kChainBM, kChainBN>(
          sm, src, n, w, n, n, t / tiles_n * kChainBM,
          t % tiles_n * kChainBN, tile::StoreBf16<true>{dst, n});
    }
    // Every tile of step i is written before any CTA starts step i + 1;
    // and no CTA writes a buffer of step i + 2 while one still reads it
    // in step i + 1.
    if (step + 1 < length) grid.sync();
  }
}

// One launch of tile_kernel<BN, kTanh> over the output tiles of p. Its
// shared memory is above 48 KB, which a kernel gets only once asked for:
// the attribute is set on a device's first launch of each instance, and a
// refusal is returned.
template <int BN, bool kTanh>
int launch_tile(const TileParams& p, cudaStream_t stream) {
  constexpr size_t smem = TileShape<BN>::kSmemBytes;
  static std::atomic<unsigned> allowed{0};  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&tile_kernel<BN, kTanh>),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed.fetch_or(bit);
  }
  const dim3 grid((p.n + BN - 1) / BN, p.m / tile::kWgBM);
  tile_kernel<BN, kTanh><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error
// code of its launch, 0 on success, launches on `stream` and does not
// synchronize. The caller checks shapes: m and n multiples of 128, k a
// multiple of 32, row-major contiguous operands on 16-byte boundaries
// (whole 16-byte rows, as a tensor map's strides must be).

// out [m, n] = bf16(x [m, k] @ w [k, n]), through tanh in f32 if
// `apply_tanh`, in tiles of 128 x `width` (128 or 256). views holds
// tile::kViewValues values for x's tensor map, then as many for w's
// (`tma_views`). Refuses (an error code, never a fallback) a width it has
// no instance for, a view the encoder refuses, and a card that will not
// give the kernel its shared memory.
extern "C" int tile_mma_launch(const void* x, const void* w, void* out,
                               const long long* views, int m, int k, int n,
                               int apply_tanh, int width, void* stream) {
  TileParams p;
  if (views == nullptr || (width != 128 && width != 256) ||
      !tile::encode_view(p.x_view, x, views) ||
      !tile::encode_view(p.w_view, w, views + tile::kViewValues)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.k = k;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 256) {
    return apply_tanh ? launch_tile<256, true>(p, st)
                      : launch_tile<256, false>(p, st);
  }
  return apply_tanh ? launch_tile<128, true>(p, st)
                    : launch_tile<128, false>(p, st);
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
