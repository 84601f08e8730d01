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
// The chain multiplies with the same TMA-fed wgmma form, in 128 x 64
// tiles (`wgmma.m64n64k16`, four stages). Each step needs all of the
// previous h (2 MB at 1024^2), more than one SM's shared memory, so h
// lives in L2 (50 MB) between steps. One cooperative launch
// (`ring::launch_ring`, of no more CTAs than the card holds at once)
// walks each step's output tiles, grid-stride, and meets at a grid-wide
// barrier between steps. Steps alternate between the two parts of one
// [2, n, n] scratch that the caller allocates (the TPU kernel updated h
// in place; here that would let one CTA overwrite rows another CTA is
// still reading), and the last step writes `out`. x and w are read
// through the tile kernel's views, the scratch through one A view with a
// part extent of 2 (`parallel/tile_mma.py` `chain_views`); `out` is only
// stored to and has no map. Step i + 1 reads by TMA (the async proxy)
// what step i stored by generic stores: grid.sync() orders those stores
// before every thread of step i + 1, and the product's thread 0 fences
// the proxies (fence.proxy.async.global) before its first load. A step
// at 1024^2 is 128 tiles, one a CTA on an H100's 132 SMs. Its time goes
// to each SM's loads from L2, not to the tensor cores: with 128 x 128
// tiles (64 CTAs, 512 KB a CTA a step) a launch took 0.0904 ms and
// 0.0779 with the wgmma left out, and at 128 x 64 (384 KB a CTA, twice
// the SMs) 0.0753 and 0.0645 (NVIDIA H100 80GB HBM3, 700.00 W;
// `scripts/chain_variants.py`, `PERF.md` §6).
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

#include "ring_stream.cuh"
#include "tile_product.cuh"

namespace {

namespace cg = cooperative_groups;
using tile::bf16;
using tile::kThreads;

// A tile kernel's operands and output: x [m, k] and w [k, n] as their
// tensor maps, out [m, n] row-major.
struct TileParams {
  tile::TmaView x_view, w_view;
  bf16* out;
  int m, k, n;
};

// The wgmma form's stages at each width: what fits one CTA an SM (256),
// or two (128, and the chain's 64, whose stages are 24 KB).
template <int BN>
struct TileShape {
  static constexpr int kStages = BN == 128 ? 3 : 4;
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

// The chain's operands: x [n, n] and the scratch h [2, n, n] as A views
// (k, m, 1) and (k, m, 2), w [n, n] as the B view (n, k, 1); h and out
// [n, n] for the stores.
struct ChainParams {
  tile::TmaView x_view, w_view, h_view;
  bf16* h;
  bf16* out;
  int n, length;
};

// The chain's tile width: 128 x 64, four stages. At 1024^2 x 8 a launch
// took 0.0756 ms against 0.0902 at 128 x 128 (NVIDIA H100 80GB HBM3,
// 700.00 W; medians of 4 turns, `scripts/chain_variants.py`).
constexpr int kChainWidth = 64;

// Two CTAs an SM fit (four 24 KB stages each), so a chain of more tiles
// than SMs (n = 1152: 162) is still one wave. Larger n walk their tiles
// grid-stride.
__global__ void __launch_bounds__(kThreads, 2)
    chain_kernel(const __grid_constant__ ChainParams p) {
  using Smem = TileShape<kChainWidth>::Smem;
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(raw) + alignof(Smem) - 1) &
      ~static_cast<uintptr_t>(alignof(Smem) - 1));
  tile::wgmma_init(sm);
  tile::WgmmaPipe pipe;
  cg::grid_group grid = cg::this_grid();
  const int n = p.n;
  const int tiles_n = n / kChainWidth;
  const int tiles = n / tile::kWgBM * tiles_n;
  const tile::TmaOperand w{&p.w_view, 0, 0};
  for (int step = 0; step < p.length; ++step) {
    // Step i reads x (i == 0) or the part step i - 1 wrote, and writes
    // part i % 2 or, last, out.
    const tile::TmaOperand a =
        step == 0 ? tile::TmaOperand{&p.x_view, 0, 0}
                  : tile::TmaOperand{&p.h_view, (step - 1) & 1, 0};
    bf16* dst = step == p.length - 1
                    ? p.out
                    : p.h + static_cast<long long>(step & 1) * n * n;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      tile::tile_product_wgmma(sm, pipe, a, w, n, n, n,
                               t / tiles_n * tile::kWgBM,
                               t % tiles_n * kChainWidth,
                               tile::StoreBf16<true>{dst, n});
    }
    // Every tile of step i is stored before any CTA starts step i + 1,
    // whose products (never hoisted above this barrier) fence the
    // proxies before their first TMA load. And no CTA stores into a part
    // while another still reads it: step i + 2 writes what step i + 1
    // reads, and a CTA reaches this barrier only after every TMA load of
    // its products has completed on its `full` barrier (each product
    // consumes every stage it fills), so no read is in flight across it.
    if (step + 1 < p.length) grid.sync();
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
// in ONE cooperative launch; h is [2, n, n] scratch, out [n, n] the last
// h. views holds tile::kViewValues values for x's tensor map, then w's,
// then h's (`chain_views`). Refuses (an error code, never a fallback) a
// view the encoder refuses, a card that will not give the kernel its
// shared memory or hold one CTA of it, and one with no cooperative
// launch.
extern "C" int burn_chain_launch(const void* x, const void* w, void* h,
                                 void* out, const long long* views, int n,
                                 int length, void* stream) {
  ChainParams p;
  if (views == nullptr || length < 1 ||
      !tile::encode_view(p.x_view, x, views) ||
      !tile::encode_view(p.w_view, w, views + tile::kViewValues) ||
      !tile::encode_view(p.h_view, h, views + 2 * tile::kViewValues)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.h = static_cast<bf16*>(h);
  p.out = static_cast<bf16*>(out);
  p.n = n;
  p.length = length;
  const long long tiles =
      static_cast<long long>(n / tile::kWgBM) * (n / kChainWidth);
  // Sets the kernel's shared-memory limit before it asks the card how many
  // CTAs an SM holds; the grid is at most that many an SM, and walks the
  // tiles grid-stride.
  int ctas = 0;
  return ring::launch_ring(chain_kernel, p, ctas, 1, tiles,
                           TileShape<kChainWidth>::kSmemBytes,
                           static_cast<cudaStream_t>(stream));
}
