// The tensor-parallel collective matmuls for Hopper (sm_90a): the
// all-gather matmul and the matmul reduce-scatter.
//
// Replaces, in parallel/collective_matmul.py of the JAX package,
// `_ag_mm_kernel` (`_pallas_ag_matmul`) and `_mm_rs_kernel`
// (`_pallas_mm_rs`). The ring protocols are `ring_stream.cuh`'s and the
// products `tile_product.cuh`'s; this file holds the two kernels' ring
// consumers, their entry code and the C entry points.
//
// All-gather matmul. Rank r owns rows r * chunk .. of x [n * chunk, k] and
// columns r * f / n .. of w [k, f] and of y [n * chunk, f], and ends with
// y's columns = AllGather(x) @ w's columns: `run_ring_stream` with a
// consumer that multiplies the block in hand (x's rows idx * chunk ..: the
// rank's own shard, read in place, at step 0, else a slot) by the rank's
// columns of w and stores the product, rounded once to x's type, at y's
// rows idx * chunk ... The relay copy runs before the product, so the right
// neighbour waits on the copy only; the product only reads the block, and
// the rank's credit, granted after it, keeps the left neighbour from
// overwriting the slot meanwhile. The rank's CTAs deal the output tiles of
// each block round robin. A ring of one multiplies its own block.
//
// The all-gather matmul has a second form for f32 x whose rows all fit
// one 64-row tile, `ag_gathered_kernel`: the gather first, then one
// product a tile over the gathered rows (its section, further down). The
// wrapper picks the form from the shapes alone
// (`parallel/collective_matmul.py` `ag_form`); both give the same bits.
//
// Matmul reduce-scatter. x [n * chunk, k] is cut by columns and w [k, f]
// by rows, k / n each; rank j ends with y's rows j * chunk .. = the sum
// over ranks r of x[j * chunk .., r * k / n ..] @ w[r * k / n .., :]:
// `run_rs_ring` with a `produce` that computes, at its ring step, the f32
// product of the row-block the rank sends next, and a `finish` that adds
// the last arrival in f32 and rounds once to x's type. Partials circulate
// in f32 whatever the input type, as the reference's f32 scratch does;
// the adds run in the ring's order, so a result is the same bits on every
// call. A ring of one never comes here (its product is the answer).
//
// Ownership in the reduce-scatter. `run_rs_ring` needs every CTA of a rank
// to own the same part of every buffer, so that a part's produce -> send
// -> fold runs in one CTA's program order. A tile product writes BM x BN
// tiles, so the kernel hands the protocol a `TileMap` as its stripe: tile
// t of a [chunk, f] f32 block belongs to CTA t mod G, and the send, the
// fold and `finish` walk that CTA's tiles, the tiles its products wrote.
// No flag or barrier is added.
//
// Products: bf16 operands on `tile_product_wgmma` (TMA into a ring of
// swizzled stages, wgmma.mma_async, f32 accumulate, a 64-row half of the
// tile per warpgroup), f32 operands on `tile_product_tf32x3` (cp.async
// stages of f32, each value split into TF32 hi and lo as a warp loads
// it, mma.sync in three passes a product for f32 accuracy, each 16-deep
// slice's sum added to the running f32 sums with one rounding; 128 x 128
// tiles, one CTA an SM), both with tails, so chunk, k / n, f / n and f
// need not divide by a tile. The bf16
// tile is each kernel's own, the faster of the two widths for it when
// both were timed at the MLP's shapes on an H100: the all-gather matmul
// takes 128 x 256 (four stages, one CTA an SM), the reduce-scatter 128 x
// 128 (three stages, two CTAs an SM), whose f32 partials are copied and
// folded by the same CTAs and go faster with twice as many (`PERF.md`
// §6). The wrapper checks that every row the kernels read or write is
// whole 16-byte units (cp.async moves 16 bytes; a tensor map's strides
// are multiples of 16 bytes).
//
// bf16 operands are read through tensor maps that the host encodes for
// each call from `parallel/collective_matmul.py` `tma_views` (3-D views,
// so that every K extent is a dimension's own and TMA zero-fills past
// it): kernel 11's x as (k, chunk, n), its slots as (k, chunk, 2n), w as
// (f / n, n, k); kernel 12's x as (k / n, n, rows) and w as (f, k / n, n),
// innermost first. They travel in the kernel's parameters, which are
// __grid_constant__: a by-value parameter whose address is taken would be
// copied to local memory, where TMA cannot read a map.
//
// What bounds them: operations. At the tensor-parallel MLP's shapes
// (x [4096, 4096] @ w1 [4096, 8192]; relu(h) [4096, 8192] @ w2
// [8192, 4096]; n = 8) each does 2.7e11 flop against 168 MB (bf16) or
// 336 MB (f32) of operands and output, 800-1600 flop a byte: 0.2779 ms at
// the bf16 peak; in f32 the split's three passes take 8.2e11 flop, 1.67
// ms at the TF32 peak. With every rank on one card, the relay that the
// product hides is a copy within that card's memory, never a link.
//
// Layout: one cooperative launch (`ring::launch_ring`) of n x G CTAs of
// 256 threads; G is the output tiles of one block, capped by what the
// card holds at once with the product's shared memory (bf16 all-gather
// and both f32 kernels: one CTA an SM, 16 a rank at n = 8 on an H100's
// 132 SMs; at the MLP's shapes the bf16 all-gather has 4 x 4 tiles a
// block, one a CTA a step, the f32 one 4 x 8; bf16 reduce-scatter: 33 a
// rank, 4 x 32 tiles a block, as the f32 one over 16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_stream.cuh"
#include "tile_product.cuh"

namespace {

using ring::Ring;
using tile::bf16;
static_assert(tile::kThreads == ring::kThreads,
              "one CTA size for the ring and the tile product");

// The f32 tile's width, the same in both kernels: 128 x 128.
constexpr int kF32Width = 128;

// The tile product for operands of type T, and its epilogue that stores T;
// kWide is the bf16 tile's width (f32 has one, kF32Width). `State` is
// what a CTA keeps from one product to the next (its shared memory; for
// bf16 the mbarrier ring's place too), made once per launch by `begin`;
// `Operand` is how a product names A or B.
template <typename T, int kWide>
struct Product;

template <int kWide>
struct Product<bf16, kWide> {
  static constexpr bool kTma = true;
  static constexpr int BM = tile::kWgBM, BN = kWide;
  static constexpr int kStages = BN == 256 ? 4 : 3;
  using Smem = tile::SmemWgmma<BN, kStages>;
  using Store = tile::StoreBf16<false>;
  using Operand = tile::TmaOperand;
  struct State {
    Smem& sm;
    tile::WgmmaPipe pipe;
  };
  // Dynamic shared memory is placed on 16 bytes: room to move up to 1024.
  static constexpr size_t kSmemBytes = sizeof(Smem) + alignof(Smem);
  static __device__ State begin(unsigned char* raw) {
    const uintptr_t at = (reinterpret_cast<uintptr_t>(raw) + alignof(Smem) -
                          1) & ~static_cast<uintptr_t>(alignof(Smem) - 1);
    Smem& sm = *reinterpret_cast<Smem*>(at);
    tile::wgmma_init(sm);
    return State{sm, {}};
  }
  template <class E>
  static __device__ __forceinline__ void run(State& st, const Operand& a,
                                             const Operand& b, int m, int n,
                                             int k, int row0, int col0,
                                             const E& out) {
    tile::tile_product_wgmma(st.sm, st.pipe, a, b, m, n, k, row0, col0, out);
  }
};

template <int kWide>
struct Product<float, kWide> {
  static constexpr bool kTma = false;
  static constexpr int BM = tile::kTfBM, BN = kF32Width;
  using Smem = tile::SmemTf32<BN>;
  using Store = tile::StoreF32;
  struct Operand {
    const float* p;
    long long ld;  // row stride
  };
  struct State {
    Smem& sm;
  };
  static constexpr size_t kSmemBytes = sizeof(Smem);
  static __device__ State begin(unsigned char* raw) {
    return State{*reinterpret_cast<Smem*>(raw)};
  }
  template <class E>
  static __device__ __forceinline__ void run(State& st, const Operand& a,
                                             const Operand& b, int m, int n,
                                             int k, int row0, int col0,
                                             const E& out) {
    tile::tile_product_tf32x3(st.sm, a.p, a.ld, b.p, b.ld, m, n, k, row0,
                              col0, out);
  }
};

template <typename T>
using AgProduct = Product<T, 256>;
template <typename T>
using RsProduct = Product<T, 128>;

// BM x BN tiles of a [rows, cols] block, tile t owned by CTA t mod ctas.
// Also `run_rs_ring`'s stripe for an f32 block of rows of whole 16-byte
// units (cols a multiple of 4): `copy` and `add` walk this CTA's tiles.
template <int BM, int BN>
struct TileMap {
  int rows, cols, cta, ctas;

  static __host__ __device__ long long count(int rows, int cols) {
    return static_cast<long long>((rows + BM - 1) / BM) *
           ((cols + BN - 1) / BN);
  }

  // fn(row0, col0) for each of this CTA's tiles.
  template <class Fn>
  __device__ __forceinline__ void each_tile(Fn fn) const {
    const int across = (cols + BN - 1) / BN;
    const long long tiles = count(rows, cols);
    for (long long t = cta; t < tiles; t += ctas) {
      fn(static_cast<int>(t / across) * BM, static_cast<int>(t % across) * BN);
    }
  }

  // fn(u) for each 16-byte unit u (4 floats: an offset in units) of this
  // CTA's tiles of an f32 block, each thread its share.
  template <class Fn>
  __device__ __forceinline__ void each_unit(Fn fn) const {
    constexpr int kUnits = BN / 4;
    each_tile([&](int r0, int c0) {
      for (int e = threadIdx.x; e < BM * kUnits; e += blockDim.x) {
        const int r = r0 + e / kUnits, c = c0 + e % kUnits * 4;
        if (r < rows && c < cols) {
          fn((static_cast<long long>(r) * cols + c) / 4);
        }
      }
    });
  }

  __device__ void copy(char* dst, const char* src) const {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    each_unit([&](long long u) { __stcg(d + u, __ldcg(s + u)); });
  }

  __device__ void add(char* dst, const char* a, const char* b) const {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* pa = reinterpret_cast<const uint4*>(a);
    const uint4* pb = reinterpret_cast<const uint4*>(b);
    each_unit([&](long long u) {
      __stcg(d + u, ring::add_unit<ring::SumF32>(__ldcg(pa + u),
                                                 __ldcg(pb + u)));
    });
  }
};

__device__ __forceinline__ void store4(float* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, uint4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      tile::pack_bf16x2(__uint_as_float(v.x), __uint_as_float(v.y)),
      tile::pack_bf16x2(__uint_as_float(v.z), __uint_as_float(v.w)));
}

// -- all-gather matmul ---------------------------------------------------------

struct AgParams {
  Ring ring;
  const void* x;  // [n * chunk, k], contiguous: rank r's shard at rows r * chunk
  const void* w;  // [k, f]: rank r's columns r * f / n ..
  void* y;        // [n * chunk, f]: rank r's columns r * f / n ..
  char* slots;    // [n][2][chunk, k] of x's type
  int chunk, k, f;
  // bf16: x by shard, the slots by slot, w by rank (`tma_views`).
  tile::TmaView x_view, slot_view, w_view;
};

// y[idx * chunk .., rank's columns] = T(block @ w[:, rank's columns]) for
// this CTA's output tiles.
template <typename T>
struct AgConsumer {
  const AgParams& p;
  int rank, cta;
  typename AgProduct<T>::State& st;

  __device__ void operator()(int, int idx, const char* block) const {
    using P = AgProduct<T>;
    const int fn = p.f / p.ring.n;
    typename P::Operand a, b;
    if constexpr (P::kTma) {
      // The block in hand is the rank's own shard, read in place, or a
      // slot of this rank's.
      const long long bb = static_cast<long long>(p.chunk) * p.k * sizeof(T);
      const long long off = block - p.slots;
      a = off >= 0 && off < 2 * p.ring.n * bb
              ? tile::TmaOperand{&p.slot_view, static_cast<int>(off / bb), 0}
              : tile::TmaOperand{&p.x_view, idx, 0};
      b = tile::TmaOperand{&p.w_view, rank, 0};
    } else {
      a = {reinterpret_cast<const T*>(block), p.k};
      b = {static_cast<const T*>(p.w) + static_cast<long long>(rank) * fn, p.f};
    }
    const typename P::Store out{
        static_cast<T*>(p.y) + static_cast<long long>(idx) * p.chunk * p.f +
            static_cast<long long>(rank) * fn,
        p.f};
    TileMap<P::BM, P::BN>{p.chunk, fn, cta, p.ring.ctas}.each_tile(
        [&](int r0, int c0) {
          P::run(st, a, b, p.chunk, fn, p.k, r0, c0, out);
        });
  }
};

template <typename T>
__global__ void __launch_bounds__(ring::kThreads)
    ag_matmul_kernel(const __grid_constant__ AgParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int rank = blockIdx.x / g.ctas;
  const int cta = blockIdx.x % g.ctas;
  const long long bb = static_cast<long long>(p.chunk) * p.k * sizeof(T);
  ring::Rank r = ring::make_rank(g, rank, cta, 1, g.right[rank], g.left[rank],
                                 g.flags, p.slots, bb);
  r.local = static_cast<const char*>(p.x) + rank * bb;
  typename AgProduct<T>::State st = AgProduct<T>::begin(smem);
  AgConsumer<T> consume{p, rank, cta, st};
  ring::run_ring_stream(r, consume);
}

template <typename T>
int launch_ag(AgParams& p, cudaStream_t stream) {
  using P = AgProduct<T>;
  return ring::launch_ring(
      ag_matmul_kernel<T>, p, p.ring.ctas, p.ring.n,
      TileMap<P::BM, P::BN>::count(p.chunk, p.f / p.ring.n), P::kSmemBytes,
      stream);
}

// -- all-gather matmul, gathered form -----------------------------------------
//
// For a gathered x that fits one tile's rows (the mesh-stage serving form:
// x [64, 4096] on 8 ranks, blocks of 8 rows), the streamed form above
// spends its ring steps on tiles that are mostly zero fill, and every
// step reads the rank's whole column panel of w again. This form gathers
// first and multiplies once: each rank completes its gathered copy of x
// with `run_gather_relay` (the ring all-gather's relay from the output,
// no slots, each row written once) into its own [n * chunk, k] of
// scratch, then each CTA of the rank computes its output tiles of the
// rank's columns over the whole gathered M on a 64-row tile, so each
// column panel of w streams through shared memory once a call. K stays
// whole in one CTA: every output element takes the streamed form's
// passes, slices and additions in the same order, so y is the same bits.
// A ring of one reads x in place: it is the gathered copy.
//
// The tile: 64 x 128 (two warp rows of 32, 112 CTAs at the mesh shape),
// three cp.async stages 64 deep in K, a stage's four slices unrolled: the
// fastest of the variants timed on an H100 (`scripts/
// ag_gathered_variants.py`; 64 x 64 tiles, 32-deep stages and one slice
// at a time were each slower, `PERF.md` §6). With one CTA an SM and one
// tile each, the products are bound by how fast a warp issues its split
// and its mma.sync, not by w's bytes.

constexpr int kGatheredRows = 64;
constexpr int kGatheredWidth = 128;
constexpr int kGatheredStages = 3;
constexpr int kGatheredDepth = 64;
using GatheredSmem = tile::SmemTf32<kGatheredWidth, kGatheredRows,
                                    kGatheredStages, kGatheredDepth>;
using GatheredTiles = TileMap<kGatheredRows, kGatheredWidth>;

struct AgGatheredParams {
  Ring ring;
  const float* x;  // [n * chunk, k]: rank r's shard at rows r * chunk
  const float* w;  // [k, f]: rank r's columns r * f / n ..
  float* y;        // [n * chunk, f]: rank r's columns r * f / n ..
  char* gathered;  // [n][n * chunk, k]: rank r's gathered copy of x
  int chunk, k, f;
};

__global__ void __launch_bounds__(ring::kThreads)
    ag_gathered_kernel(const __grid_constant__ AgGatheredParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Ring& g = p.ring;
  const int rank = blockIdx.x / g.ctas;
  const int cta = blockIdx.x % g.ctas;
  const int rows = g.n * p.chunk, fn = p.f / g.n;
  const long long bb = static_cast<long long>(p.chunk) * p.k * sizeof(float);
  const float* a = p.x;
  if (g.n > 1) {
    ring::Rank r = ring::make_rank(g, rank, cta, 1, g.right[rank],
                                   g.left[rank], g.flags, p.gathered, bb);
    r.my_slots = r.right_slots = nullptr;  // the relay has no slots
    char* mine = p.gathered + rank * g.n * bb;
    ring::run_gather_relay(r, reinterpret_cast<const char*>(p.x) + rank * bb,
                           mine, p.gathered + g.right[rank] * g.n * bb, bb);
    // The relay's last wait leaves every block from the left landed. The
    // rank's own block is the stores of all its CTAs at step 0: the
    // rank's last signal to the right (tag + n - 1, raised once every CTA
    // of the rank has arrived after its last step) covers them.
    ring::wait_flag(&r.right->recv, r.epoch * ring::kTagSteps + g.n - 1);
    a = reinterpret_cast<const float*>(mine);
  }
  GatheredSmem& sm = *reinterpret_cast<GatheredSmem*>(smem);
  const float* b = p.w + static_cast<long long>(rank) * fn;
  const tile::StoreF32 out{p.y + static_cast<long long>(rank) * fn, p.f};
  GatheredTiles{rows, fn, cta, g.ctas}.each_tile([&](int r0, int c0) {
    tile::tile_product_tf32x3(sm, a, p.k, b, p.f, rows, fn, p.k, r0, c0, out);
  });
}

int launch_ag_gathered(AgGatheredParams& p, cudaStream_t stream) {
  return ring::launch_ring(
      ag_gathered_kernel, p, p.ring.ctas, p.ring.n,
      GatheredTiles::count(p.ring.n * p.chunk, p.f / p.ring.n),
      sizeof(GatheredSmem), stream);
}

// -- matmul reduce-scatter -----------------------------------------------------

struct RsParams {
  Ring ring;
  const void* x;  // [n * chunk, k]: rank r's columns r * k / n ..
  const void* w;  // [k, f]: rank r's rows r * k / n ..
  void* y;        // [n * chunk, f]: rank r's sum at rows r * chunk
  char* send;     // [n][2][chunk, f] f32
  char* recv;     // [n][2][chunk, f] f32, written by the left neighbour
  int chunk, k, f;
  // bf16: x and w by rank, each K extent k / n (`tma_views`).
  tile::TmaView x_view, w_view;
};

template <typename T>
__global__ void __launch_bounds__(ring::kThreads)
    mm_rs_kernel(const __grid_constant__ RsParams p) {
  using P = RsProduct<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  typename P::State st = P::begin(smem);
  const Ring& g = p.ring;
  const int rank = blockIdx.x / g.ctas;
  const int cta = blockIdx.x % g.ctas;
  const long long bb = static_cast<long long>(p.chunk) * p.f * sizeof(float);
  const ring::Rank r = ring::make_rank(g, rank, cta, 1, g.right[rank],
                                       g.left[rank], g.flags, p.recv, bb);
  const int kn = p.k / g.n;
  const TileMap<P::BM, P::BN> stripe{p.chunk, p.f, cta, g.ctas};
  // This CTA's tiles of the f32 product of row-block idx, into dst.
  auto produce = [&](int idx, char* dst) {
    typename P::Operand a, b;
    if constexpr (P::kTma) {
      a = tile::TmaOperand{&p.x_view, rank, idx * p.chunk};
      b = tile::TmaOperand{&p.w_view, rank, 0};
    } else {
      a = {static_cast<const T*>(p.x) +
               static_cast<long long>(idx) * p.chunk * p.k +
               static_cast<long long>(rank) * kn,
           p.k};
      b = {static_cast<const T*>(p.w) +
               static_cast<long long>(rank) * kn * p.f,
           p.f};
    }
    const tile::StoreF32 out{reinterpret_cast<float*>(dst), p.f};
    stripe.each_tile([&](int r0, int c0) {
      P::run(st, a, b, p.chunk, p.f, kn, r0, c0, out);
    });
  };
  T* result = static_cast<T*>(p.y) + static_cast<long long>(rank) * p.chunk * p.f;
  // result = T(arrival + own) over this CTA's tiles: the f32 add of the
  // ring's last hop, then the one rounding.
  auto finish = [&](const char* arrival, const char* own) {
    const uint4* pa = reinterpret_cast<const uint4*>(arrival);
    const uint4* pb = reinterpret_cast<const uint4*>(own);
    stripe.each_unit([&](long long u) {
      store4(result + 4 * u,
             ring::add_unit<ring::SumF32>(__ldcg(pa + u), __ldcg(pb + u)));
    });
  };
  ring::run_rs_ring(r, p.send + 2 * rank * bb, stripe, produce, finish);
}

template <typename T>
int launch_rs(RsParams& p, cudaStream_t stream) {
  using P = RsProduct<T>;
  return ring::launch_ring(mm_rs_kernel<T>, p, p.ring.ctas, p.ring.n,
                           TileMap<P::BM, P::BN>::count(p.chunk, p.f),
                           P::kSmemBytes, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error
// code of the launch, 0 on success; launches on `stream` and does not
// synchronize. dtype: 0 f32, 1 bf16, the type of x, w and y. The caller
// checks types, shapes and contiguity, that every base pointer is 16-byte
// aligned, and that every row the kernel reads or writes (k, k / n, f / n
// and f values) is whole 16-byte units. flags points at 8 ring::Flags that
// live across calls (zeroed once); epoch grows by at least one from one
// call to the next on the same flags. right[r] and left[r] are rank r's
// neighbours on the ring. f is the row length (leading dimension) of w
// and y. views (bf16 only; f32 passes none) holds tile::kViewValues values
// for each tensor map the kernel reads, in the order `tma_views` gives.

// y [n * chunk, f] = AllGather(x [n * chunk, k]) @ w [k, f], rank r's
// columns f / n wide; slots is scratch of 2 * n * chunk * k values of x's
// type. 1 <= n <= 8.
// Views: x, slots, w.
extern "C" int ag_matmul_launch(const void* x, const void* w, void* y,
                                void* slots, void* flags,
                                const long long* right, const long long* left,
                                const long long* views, int n, int chunk,
                                int k, int f, int dtype,
                                unsigned long long epoch, void* stream) {
  AgParams p;
  if (!ring::make_ring(p.ring, flags, right, left, n, 1, epoch) ||
      dtype < 0 || dtype > 1 || chunk < 1 || k < 1 || f < n || f % n ||
      (dtype == 1 &&
       (views == nullptr ||
        !tile::encode_view(p.x_view, x, views) ||
        !tile::encode_view(p.slot_view, slots, views + tile::kViewValues) ||
        !tile::encode_view(p.w_view, w, views + 2 * tile::kViewValues)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = x;
  p.w = w;
  p.y = y;
  p.slots = static_cast<char*>(slots);
  p.chunk = chunk;
  p.k = k;
  p.f = f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_ag<bf16>(p, st) : launch_ag<float>(p, st);
}

// The same function for f32 in the gathered form: the all-gather first,
// then one product a tile over all n * chunk rows. gathered is scratch of
// n * n * chunk * k floats, rank r's copy of x at r * n * chunk * k; a
// ring of one reads x in place and may pass none. 1 <= n <= 8.
extern "C" int ag_gathered_launch(const void* x, const void* w, void* y,
                                  void* gathered, void* flags,
                                  const long long* right,
                                  const long long* left, int n, int chunk,
                                  int k, int f, unsigned long long epoch,
                                  void* stream) {
  AgGatheredParams p;
  if (!ring::make_ring(p.ring, flags, right, left, n, 1, epoch) ||
      chunk < 1 || k < 1 || f < n || f % n ||
      (n > 1 && gathered == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.y = static_cast<float*>(y);
  p.gathered = static_cast<char*>(gathered);
  p.chunk = chunk;
  p.k = k;
  p.f = f;
  return launch_ag_gathered(p, static_cast<cudaStream_t>(stream));
}

// y [n * chunk, f], rank j's rows j * chunk .. = the sum over ranks r of
// x[j * chunk .., r * k / n ..] @ w[r * k / n .., :], added in f32 in the
// ring's order and rounded once; send and recv are f32 scratch of
// 2 * n * chunk * f values each. 2 <= n <= 8: a ring of one is a plain
// product and the caller's.
// Views: x, w.
extern "C" int mm_rs_launch(const void* x, const void* w, void* y, void* send,
                            void* recv, void* flags, const long long* right,
                            const long long* left, const long long* views,
                            int n, int chunk, int k, int f, int dtype,
                            unsigned long long epoch, void* stream) {
  RsParams p;
  if (!ring::make_ring(p.ring, flags, right, left, n, 2, epoch) ||
      dtype < 0 || dtype > 1 || chunk < 1 || k < n || k % n || f < 1 ||
      (dtype == 1 &&
       (views == nullptr || !tile::encode_view(p.x_view, x, views) ||
        !tile::encode_view(p.w_view, w, views + tile::kViewValues)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = x;
  p.w = w;
  p.y = y;
  p.send = static_cast<char*>(send);
  p.recv = static_cast<char*>(recv);
  p.chunk = chunk;
  p.k = k;
  p.f = f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype ? launch_rs<bf16>(p, st) : launch_rs<float>(p, st);
}
