// Sequence-parallel ring attention for Hopper (sm_90a).
//
// Replaces parallel/ring_attention.py `_ring_attn_kernel`
// (`_pallas_ring_attention`) of the JAX package: each of n ranks keeps
// its query shard q [sq, dk] and folds every K/V shard, which circulates
// the ring packed as one [sk, dk + dv] block, into an f32 online softmax
// under the global-position causal mask; one divide at the end. The ring
// is `ring_stream.cuh`, the one protocol body; this file is its consumer
// and the C entry point.
//
// Layout. One cooperative launch (`ring::launch_ring`) holds every rank:
// n x G CTAs of 256 threads, G per rank, one per 128-row tile up to what
// the card holds at once (one CTA an SM: a tile's shared memory is 209
// KiB at d = 128 with f32 K/V, and o takes 64 registers a thread). A
// rank's query rows are cut into 128-row tiles, dealt round-robin to its
// G CTAs, and each of the eight warps owns 16 rows. Where a step brings
// a block, a CTA folds it into each of its tiles in turn, one key tile
// at a time (64 keys; 16 where dk or dv exceeds 128, the second
// instance, whose o takes 128 registers). The tile's Q rows sit in
// shared memory as f32; each key tile's K and V are split once, as they
// are loaded, into TF32 hi and lo planes (bf16 K/V: hi only), so the
// eight warps that read them do not split them again. Each warp
// multiplies on the tensor cores with mma.sync m16n8k8. Between steps a
// tile's running max m, denominator l and accumulator o live in an f32
// scratch in device memory (the TPU kept them in VMEM), written and read
// back by the same CTA; after the last step the CTA divides from there.
//
// Arithmetic. The recurrence is the reference's: s = (q . k) *
// (1 / sqrt(dk)), masked to -1e30 where a key's global position
// idx * sk + c exceeds the row's my_id * sq + r, the online update
// m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
// l' = l * alpha + sum p, o' = o * alpha + p v with the accurate expf,
// and out = o / (l == 0 ? 1 : l), rounded once to q's type. Both
// products keep f32 accuracy on the TF32 tensor cores by the split of
// `tile_product.cuh` (`tf32`, `split_mma`, shared with the f32 collective
// matmuls): hi = x rounded as cvt.rna.tf32.f32 rounds it, lo = x - hi
// rounded the same way, and a . b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
// the small terms first (the dropped lo_a lo_b and the residuals are
// ~2^-22 of a product). A pass is dropped only where its lo is zero by type: a bf16
// value is exact in TF32 (8 mantissa bits within 10). So q . k takes 3
// passes, 2 where q or K is bf16, 1 where both are; p . v takes 3, 2
// where V is bf16 (p, from expf, is always f32). The tensor cores'
// sums truncate, so a long run of them into one accumulator drifts (o
// over a 32 768-key ring missed the bf16 bar by an ulp): a key tile's
// p . v goes into fresh accumulators, folded into o by one fmaf,
// o * alpha + acc. The scores' 3 x dk / 8 passes run into one
// accumulator. The sums run in a fixed order, so a result is the same
// bit for bit on every call.
//
// Fragments. The m16n8k8 accumulator holds (row g, cols 2t, 2t+1) and
// (row g + 8, the same cols) of an 8-key group, g = lane / 4, t = lane %
// 4; its A operand wants (g, t) and (g, t + 4). The contraction index
// may be permuted as long as A and B agree, so p . v takes A's k = t as
// key 2t and k = t + 4 as key 2t + 1: the score fragment is p's A
// fragment as it stands, with no pass through shared memory, and B reads
// V's rows 2t and 2t + 1 at once from a tile stored in row pairs (hi,
// hi, lo, lo: one 16-byte read). Likewise q . k takes, in a 16-wide
// slice of dk, k = t as column 4t (4t + 2 in the slice's second mma)
// and k = t + 4 as 4t + 1 (4t + 3), so a Q fragment, a K hi fragment and
// a K lo fragment are one float4 each. Strides: Q and K rows are dk
// zero-padded to 16, plus 16 mod 32 words, so a quarter-warp's 16-byte
// reads hit 8 distinct 16-byte bank groups; V's pair rows are dv
// zero-padded to 8, plus 2 mod 8 16-byte units (bf16 V, 8-byte units: 4
// mod 16), likewise.
//
// Causal skipping. A key tile that lies wholly above a row tile's last
// row is not loaded, and the tiles after it neither; a warp skips the
// tiles wholly above its own last row, and masks only the tiles that
// cross its rows or hold padding. That is exact: every row has seen a
// valid key before any fully masked tile reaches it (the first block
// folded is the rank's own, whose first key tile holds a key at or below
// every row), and a fully masked tile then adds exp(-1e30 - m) = 0 and
// rescales by exp(0) = 1. A skipped block is still relayed. Keys past sk
// in the last tile are padding, not masked keys: their score is -inf, so
// they weigh 0 even in a row that has not yet seen a valid key.
//
// What bounds it: operations, 2 (dk + dv) flops per (row, key) pair
// attended, times the passes, at the TF32 tensor-core peak (495 TFLOP/s
// dense on the H100; mma.sync m16n8k8 alone reaches about 315 there; the
// FMA form this replaced was held to the f32 peak, 67 TFLOP/s); the
// bytes (q, k, v, out and the relay) are two orders below. Still to do:
// the causal imbalance (rank n - 1 attends nearly n blocks, rank 0 one,
// and every rank has G CTAs), overlapping the relay and the next key
// tile's loads with the fold (with one CTA an SM, the loads stall the
// tensor cores), and a wgmma/TMA form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ring_stream.cuh"
#include "tile_product.cuh"  // the TF32 split and its mma

namespace {

using bf16 = __nv_bfloat16;
using tile::split_mma;
using tile::SplitA;
using tile::tf32;
using tile::tf32_lo;

constexpr int kThreads = ring::kThreads;
static_assert(kThreads == 256, "eight warps of 16 query rows");
constexpr int kBM = 16 * kThreads / 32;  // query rows of a tile: 128
constexpr int kMaxRanks = ring::kMaxRanks;
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;  // not -inf: (-inf) - (-inf) is NaN

struct Params {
  const void* q;    // [n * sq, dk], QT
  const void* kv;   // [n * sk, dk + dv], KT: rank r's shard at rows r * sk
  void* out;        // [n * sq, dv], QT
  char* slots;      // [n][2][sk, dk + dv], KT
  float* m;         // [n * sq]
  float* l;         // [n * sq]
  float* o;         // [n * sq, dv]
  ring::Flags* flags;  // [n]
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n, sq, sk, dk, dv, causal, ctas;
  float scale;
  unsigned long long epoch;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride (words) of the Q and K tiles: dk padded to 16, then to 16
// mod 32.
__host__ __device__ inline int qk_stride(int dk) {
  const int w = round_up(dk, 16);
  return w + ((16 - w) & 31);
}

// Pair-row stride of the V tile, in float2s (bf16 V: one value of each
// row) or in uint4s (f32 V: hi and lo of each row): dv padded to 8, then
// to 4 mod 16 or 2 mod 8.
__host__ __device__ inline int v_stride(int dv, bool exact) {
  const int w = round_up(dv, 8);
  return exact ? w + ((4 - w) & 15) : w + ((2 - w) & 7);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

template <typename T>
struct Raw;  // how four values of T are loaded bit for bit
template <>
struct Raw<float> {
  using type = float;
  using vec = uint4;
};
template <>
struct Raw<bf16> {
  using type = unsigned short;
  using vec = uint2;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Columns c .. c + 3 of a row as f32, 0 past `cols`. Read through L2
// only (ld.global.cg), as one 8- or 16-byte load where `vec` allows it.
template <typename T>
__device__ __forceinline__ float4 load4(const T* row, int c, int cols,
                                        bool vec) {
  using R = typename Raw<T>::type;
  using V = typename Raw<T>::vec;
  const R* s = reinterpret_cast<const R*>(row) + c;
  if (vec && c + 4 <= cols) {
    const V raw = __ldcg(reinterpret_cast<const V*>(s));
    const R* v = reinterpret_cast<const R*>(&raw);
    return make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]),
                       to_f32(v[3]));
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = c + i < cols ? to_f32(__ldcg(s + i)) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Calls put(r, c, a, b) with a = columns c .. c + 3 of row r and b those
// of row r + 1 (kPairs; r even) or zero, as f32, for every r < nrows and
// c < cols_pad (a multiple of 4); rows from `rows` on and columns from
// `cols` on read as 0. All threads of the CTA call it; each issues its
// next kBatch loads before it stores any.
template <bool kPairs, int kBatch, typename T, typename Put>
__device__ __forceinline__ void load_tile(const T* src, long long src_ld,
                                          int rows, int nrows, int cols,
                                          int cols_pad, Put put) {
  const bool vec = cols % 4 == 0 && src_ld % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(T) - 1)) ==
                       0;
  const int chunks = cols_pad / 4;
  const int total = (kPairs ? nrows / 2 : nrows) * chunks;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kThreads) {
    float4 a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / chunks * (kPairs ? 2 : 1), c = e % chunks * 4;
      a[u] = e < total && r < rows ? load4(src + r * src_ld, c, cols, vec)
                                   : zero;
      if (kPairs) {
        b[u] = e < total && r + 1 < rows
                   ? load4(src + (r + 1) * src_ld, c, cols, vec)
                   : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) {
        put(e / chunks * (kPairs ? 2 : 1), e % chunks * 4, a[u], b[u]);
      }
    }
  }
}

// Folds each block into every row tile this CTA owns. kBN keys a tile;
// NT 8-column groups of o a warp: dv <= 8 * NT.
template <typename QT, typename KT, int kBN, int NT>
struct AttnConsumer {
  static constexpr bool kQExact = std::is_same<QT, bf16>::value;
  static constexpr bool kKExact = std::is_same<KT, bf16>::value;
  static constexpr int kJ = kBN / 8;  // 8-key groups of a tile
  static constexpr int kC = 4;        // o column groups a p . v pass
  // Loads a thread issues before it stores: fewer where o takes 128
  // registers.
  static constexpr int kBatch = NT > 16 ? 2 : 8;

  const Params& p;
  int rank;
  int cta;
  float* smem;

  __device__ void operator()(int k, int idx, const char* block_bytes) {
    const KT* block = reinterpret_cast<const KT*>(block_bytes);
    const QT* q = static_cast<const QT*>(p.q);
    const int dk = p.dk, dv = p.dv, sq = p.sq, sk = p.sk;
    const int width = dk + dv;
    const int dkp = round_up(dk, 16), dvp = round_up(dv, 8);
    const int ldq = qk_stride(dk), ldv = v_stride(dv, kKExact);
    // [kBM][ldq] f32 q; [kBN][ldq] K hi, then (f32 K) lo; V pair rows
    float* qs = smem;
    uint32_t* kh = reinterpret_cast<uint32_t*>(qs + kBM * ldq);
    uint32_t* kl = kh + kBN * ldq;
    uint32_t* vs = kh + (kKExact ? 1 : 2) * kBN * ldq;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int tiles = (sq + kBM - 1) / kBM;
    const long long k_base = static_cast<long long>(idx) * sk;
    const long long q_base = static_cast<long long>(rank) * sq;
    const float* qa = qs + (16 * warp + g) * ldq + 4 * t;
    const int kb = g * ldq + 4 * t;
    const int vb = (t * ldv + g) * (kKExact ? 2 : 4);
    const int cols[2] = {(dv - 2 * t + 7) / 8, (dv - 2 * t + 6) / 8};

    for (int tile = cta; tile < tiles; tile += p.ctas) {
      const int r0 = tile * kBM;
      const int w0 = r0 + 16 * warp;  // this warp's first row
      __syncthreads();  // the previous tile is done with shared memory
      load_tile<false, kBatch>(
          q + (q_base + r0) * dk, dk, min(kBM, sq - r0), kBM, dk, dkp,
          [&](int r, int c, float4 a, float4) {
            *reinterpret_cast<float4*>(qs + r * ldq + c) = a;
          });

      // Rows w0 + g (i = 0) and w0 + g + 8 (i = 1); o[j][2i + e] holds
      // column 8j + 2t + e, which is below dv where j < cols[e].
      float m[2], l[2], o[NT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = w0 + g + 8 * i;
        const bool live = k > 0 && row < sq;
        const long long at = q_base + row;
        const float* src = p.o + at * dv + 2 * t;
        m[i] = live ? p.m[at] : kNegInf;
        l[i] = live ? p.l[at] : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            o[j][2 * i + e] = live && j < cols[e] ? src[8 * j + e] : 0.f;
          }
      }

      int key_tiles = (sk + kBN - 1) / kBN;
      int warp_tiles = w0 < sq ? key_tiles : 0;
      if (p.causal) {  // tiles that start at or below the last row
        const long long last = q_base + min(r0 + kBM, sq) - 1 - k_base;
        key_tiles = last < 0 ? 0 : min(key_tiles,
                                       static_cast<int>(last / kBN) + 1);
        const long long mine = q_base + min(w0 + 16, sq) - 1 - k_base;
        warp_tiles = mine < 0 ? 0 : min(warp_tiles,
                                        static_cast<int>(mine / kBN) + 1);
      }
      for (int kt = 0; kt < key_tiles; ++kt) {
        const int c0 = kt * kBN;
        __syncthreads();  // q in place; the last tile's K and V read
        const KT* rows = block + static_cast<long long>(c0) * width;
        const int keys = min(kBN, sk - c0);
        load_tile<false, kBatch>(rows, width, keys, kBN, dk, dkp,
                            [&](int r, int c, float4 a, float4) {
          const float x[4] = {a.x, a.y, a.z, a.w};
          uint32_t h[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h[i] = tf32(x[i]);
            if (!kKExact) lo[i] = tf32_lo(x[i], h[i]);
          }
          *reinterpret_cast<uint4*>(kh + r * ldq + c) =
              make_uint4(h[0], h[1], h[2], h[3]);
          if (!kKExact) {
            *reinterpret_cast<uint4*>(kl + r * ldq + c) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        });
        load_tile<true, kBatch / 2>(rows + dk, width, keys, kBN, dv, dvp,
                           [&](int r, int c, float4 a, float4 b) {
          const float x[4] = {a.x, a.y, a.z, a.w};
          const float y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int at = r / 2 * ldv + c + i;
            const uint32_t hx = tf32(x[i]), hy = tf32(y[i]);
            if (kKExact) {
              *reinterpret_cast<uint2*>(vs + 2 * at) = make_uint2(hx, hy);
            } else {
              *reinterpret_cast<uint4*>(vs + 4 * at) = make_uint4(
                  hx, hy, tf32_lo(x[i], hx), tf32_lo(y[i], hy));
            }
          }
        });
        __syncthreads();
        if (kt >= warp_tiles) continue;  // wholly masked for this warp

        float s[kJ][4];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        for (int d = 0; d < dkp; d += 16) {
          const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
          const float4 x1 = *reinterpret_cast<const float4*>(qa + 8 * ldq + d);
          const SplitA<kQExact> a0(x0.x, x1.x, x0.y, x1.y);
          const SplitA<kQExact> a1(x0.z, x1.z, x0.w, x1.w);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int at = kb + 8 * j * ldq + d;
            const uint4 h = *reinterpret_cast<const uint4*>(kh + at);
            uint4 lo = h;
            if (!kKExact) lo = *reinterpret_cast<const uint4*>(kl + at);
            split_mma<kQExact, kKExact>(s[j], a0, h.x, h.y, lo.x, lo.y);
            split_mma<kQExact, kKExact>(s[j], a1, h.z, h.w, lo.z, lo.w);
          }
        }

        const long long q_pos = q_base + w0 + g;
        const bool masked = c0 + kBN > sk ||
                            (p.causal && k_base + c0 + kBN - 1 > q_pos - g);
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = s[j][e] * p.scale;
            if (masked) {
              const int key = c0 + 8 * j + 2 * t + (e & 1);
              if (key >= sk) {
                v = -INFINITY;
              } else if (p.causal && k_base + key > q_pos + 8 * (e >> 1)) {
                v = kNegInf;
              }
            }
            s[j][e] = v;
            mt[e >> 1] = fmaxf(mt[e >> 1], v);
          }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], off));
          }
          const float m_new = fmaxf(m[i], mt[i]);
          alpha[i] = expf(m[i] - m_new);
          m[i] = m_new;
        }
        // p's A fragments: group j's scores as they stand (keys 8j + 2t
        // and 8j + 2t + 1 at k = t and t + 4).
        SplitA<false> pa[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          float e4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            e4[e] = expf(s[j][e] - m[e >> 1]);
            sum[e >> 1] += e4[e];
          }
          pa[j] = SplitA<false>(e4[0], e4[2], e4[1], e4[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
          }
          l[i] = l[i] * alpha[i] + sum[i];
        }

        // o = o * alpha + p . v, kC column groups at a time: the tile's
        // product in fresh accumulators (the tensor cores' sums truncate,
        // so a long run of them into o would drift), folded into o with
        // one rounding.
#pragma unroll
        for (int jc = 0; jc < NT; jc += kC) {
          if (8 * jc < dvp) {
            float acc[kC][4];
#pragma unroll
            for (int jj = 0; jj < kC; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll
            for (int j = 0; j < kJ; ++j)
#pragma unroll
              for (int jj = 0; jj < kC; ++jj) {
                if (8 * (jc + jj) >= dvp) continue;
                const int at = vb + (4 * j * ldv + 8 * (jc + jj)) *
                                        (kKExact ? 2 : 4);
                if (kKExact) {
                  const uint2 h = *reinterpret_cast<const uint2*>(vs + at);
                  split_mma<false, true>(acc[jj], pa[j], h.x, h.y, 0, 0);
                } else {
                  const uint4 h = *reinterpret_cast<const uint4*>(vs + at);
                  split_mma<false, false>(acc[jj], pa[j], h.x, h.y, h.z, h.w);
                }
              }
#pragma unroll
            for (int jj = 0; jj < kC; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                o[jc + jj][e] = fmaf(o[jc + jj][e], alpha[e >> 1], acc[jj][e]);
              }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = w0 + g + 8 * i;
        if (row >= sq) continue;
        const long long at = q_base + row;
        if (t == 0) {
          p.m[at] = m[i];
          p.l[at] = l[i];
        }
        float* dst = p.o + at * dv + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j < cols[e]) dst[8 * j + e] = o[j][2 * i + e];
          }
      }
      if (k == p.n - 1) {
        // The one divide, from the scratch: out of the registers that
        // hold o, where the division's slow path would spill them.
        __syncthreads();
        const long long at0 = q_base + r0;
        const int n_out = min(kBM, sq - r0) * dv;
        QT* out = static_cast<QT*>(p.out) + at0 * dv;
        for (int e = threadIdx.x; e < n_out; e += kThreads) {
          const float l_row = p.l[at0 + e / dv];
          store(out + e, p.o[at0 * dv + e] / (l_row == 0.f ? 1.f : l_row));
        }
      }
    }
  }
};

template <typename QT, typename KT, int kBN, int NT>
__global__ void __launch_bounds__(kThreads, 1) ring_attn_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x / p.ctas;
  const int cta = blockIdx.x % p.ctas;
  const long long block_bytes =
      static_cast<long long>(p.sk) * (p.dk + p.dv) * sizeof(KT);
  ring::Rank r;
  r.my_id = rank;
  r.n = p.n;
  r.ctas = p.ctas;
  r.cta = cta;
  r.epoch = p.epoch;
  r.block_bytes = block_bytes;
  r.local = static_cast<const char*>(p.kv) + rank * block_bytes;
  r.my_slots = p.slots + 2 * rank * block_bytes;
  r.right_slots = p.slots + 2 * p.right[rank] * block_bytes;
  r.me = p.flags + rank;
  r.left = p.flags + p.left[rank];
  r.right = p.flags + p.right[rank];
  AttnConsumer<QT, KT, kBN, NT> consume{p, rank, cta, smem};
  ring::run_ring_stream(r, consume);
}

template <typename QT, typename KT, int kBN, int NT>
int launch_typed(Params& p, cudaStream_t stream) {
  void (*fn)(Params) = ring_attn_kernel<QT, KT, kBN, NT>;
  constexpr bool exact = std::is_same<KT, bf16>::value;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(kBM + (exact ? 1 : 2) * kBN) * qk_stride(p.dk) +
       static_cast<size_t>(kBN) * (exact ? 1 : 2) * v_stride(p.dv, exact));
  // At most one CTA per 128-row tile: a second would idle.
  return ring::launch_ring(fn, p, p.ctas, p.n, (p.sq + kBM - 1) / kBM, smem,
                           stream);
}

// Two instances: 64-key tiles and o in 16 column groups where dk and dv
// are at most 128 (209 KiB of shared memory at 128 with f32 K/V), else
// 16-key tiles and 32 groups (202 KiB at 256).
template <typename QT, typename KT>
int launch_width(Params& p, cudaStream_t stream) {
  return p.dk <= 128 && p.dv <= 128 ? launch_typed<QT, KT, 64, 16>(p, stream)
                                    : launch_typed<QT, KT, 16, 32>(p, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the CUDA error code of
// the launch, 0 on success; launches on `stream` and does not
// synchronize. The caller checks dtypes, shapes and contiguity.
//
// q [n * sq, dk] and out [n * sq, dv] are f32 (q_bf16 = 0) or bf16; kv
// [n * sk, dk + dv] is f32 (kv_bf16 = 0) or bf16, rank r's K/V shard at
// rows r * sk. Scratch the caller allocates per call: slots [n, 2, sk,
// dk + dv] of kv's type, m and l [n * sq] f32, o [n * sq, dv] f32. flags
// points at n ring::Flags that live across calls (zeroed once); epoch
// grows by at least one from one call to the next on the same flags.
// right[r] and left[r] are rank r's neighbours on the ring.
extern "C" int ring_attn_launch(const void* q, const void* kv, void* out,
                                void* slots, void* m, void* l, void* o,
                                void* flags, const long long* right,
                                const long long* left, int n, int sq, int sk,
                                int dk, int dv, int q_bf16, int kv_bf16,
                                int causal, float scale,
                                unsigned long long epoch, void* stream) {
  if (n < 1 || n > kMaxRanks || sq < 1 || sk < 1 || dk < 1 ||
      dk > kMaxDim || dv < 1 || dv > kMaxDim || epoch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.kv = kv;
  p.out = out;
  p.slots = static_cast<char*>(slots);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.o = static_cast<float*>(o);
  p.flags = static_cast<ring::Flags*>(flags);
  for (int r = 0; r < kMaxRanks; ++r) {
    p.right[r] = r < n ? static_cast<int>(right[r]) : 0;
    p.left[r] = r < n ? static_cast<int>(left[r]) : 0;
    if (r < n && (p.right[r] < 0 || p.right[r] >= n || p.left[r] < 0 ||
                  p.left[r] >= n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  p.n = n;
  p.sq = sq;
  p.sk = sk;
  p.dk = dk;
  p.dv = dv;
  p.causal = causal;
  p.ctas = 1;
  p.scale = scale;
  p.epoch = epoch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16 ? launch_width<bf16, bf16>(p, st)
                   : launch_width<bf16, float>(p, st);
  }
  return kv_bf16 ? launch_width<float, bf16>(p, st)
                 : launch_width<float, float>(p, st);
}
