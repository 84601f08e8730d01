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
// n x G CTAs of 256 threads, G per rank, one per 64-row tile up to what
// the card holds at once (the occupancy query decides). A rank's query rows are cut into 64-row tiles, dealt
// round-robin to its G CTAs. Where a step brings a block, a CTA folds it
// into each of its tiles in turn: the tile's Q rows and 64-key tiles of
// K and V go through shared memory as f32, each thread computes a 4 x 4
// patch of the scores (rows ty*4.., keys tx + 16j) and keeps a 4-row
// patch of o in registers (columns tx*4 + 64g ..+3). Between steps a
// tile's running max m, denominator l and accumulator o live in an f32
// scratch in device memory (the TPU kept them in VMEM; 2 MiB of o per
// rank at sq = 4096, dv = 128), written and read back by the same CTA.
//
// Arithmetic is the reference's: every product in f32, bf16 inputs
// included (the reference casts q and the block to f32 before its dots),
// s = (q . k) * (1 / sqrt(dk)), masked to -1e30 where a key's global
// position idx * sk + c exceeds the row's my_id * sq + r, the online
// update m' = max(m, max s), p = exp(s - m'), alpha = exp(m - m'),
// l' = l * alpha + sum p, o' = o * alpha + p v with the accurate expf,
// and out = o / (l == 0 ? 1 : l), rounded once to q's type. The sums run
// in a fixed order, so a result is the same bit for bit on every call.
//
// Causal skipping. A key tile that lies wholly above a row tile's last
// row is skipped, and the tiles after it too. That is exact: every row
// has seen a valid key before any fully masked tile reaches it (the
// first block folded is the rank's own, whose first key tile holds a key
// at or below every row), and a fully masked tile then adds
// exp(-1e30 - m) = 0 and rescales by exp(0) = 1. A skipped block is
// still relayed. Keys past sk in the last tile are padding, not masked
// keys: their score is -inf, so they weigh 0 even in a row that has not
// yet seen a valid key.
//
// What bounds it: operations, 2 (dk + dv) flops per (row, key) pair
// attended, in f32 outside the tensor cores (67 TFLOP/s on the H100);
// the bytes (q, k, v, out and the relay) are two orders below. So the
// design keeps the FMA pipes fed from shared memory: operands are read
// as float4 (one 16-byte load feeds 16 FMAs of the score patch and 16 of
// the o patch), row strides rotate by 16 bytes so the 16 key rows of a
// load fall in distinct banks, and the probability tile reuses the K
// tile's space, which lets two CTAs share an SM at d = 128. Still to do:
// tensor cores, overlapping the relay and the next tile's loads with the
// fold, and the causal imbalance (rank n - 1 attends nearly n blocks,
// rank 0 one, and every rank has G CTAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ring_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 256 = 16 x 16: ty picks 4 rows, tx columns.
constexpr int kThreads = ring::kThreads;
static_assert(kThreads == 256, "the 16 x 16 thread layout");
constexpr int kBM = 64;        // query rows of a tile
constexpr int kBN = 64;        // keys of a tile
constexpr int kLdp = kBN + 4;  // row stride of the probability tile
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

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Row stride (floats) of the Q and K tiles: 16-byte rows whose starts
// rotate through the eight 16-byte bank groups.
__host__ __device__ inline int q_stride(int dk) {
  const int d4 = round4(dk);
  return (d4 / 4) % 2 ? d4 : d4 + 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

template <typename T>
struct Raw;  // how a value of T is loaded bit for bit
template <>
struct Raw<float> {
  using type = float;
};
template <>
struct Raw<bf16> {
  using type = unsigned short;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst[r * ld + c] = f32(src[r * src_ld + c]) for r < kBN rows and
// c < cols_pad (a multiple of 4), 0 where r >= rows or c >= cols. Read
// through L2 only (ld.global.cg), 16 bytes at a time where the rows
// allow it. All threads of the CTA call it.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long src_ld, int rows,
                                          int cols, int cols_pad) {
  using R = typename Raw<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  const R* s = reinterpret_cast<const R*>(src);
  if (cols % kVec == 0 && src_ld % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = cols / kVec;
    for (int e = threadIdx.x; e < kBN * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks * kVec;
      float* d = dst + r * ld + c;
      if (r >= rows) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = 0.f;
        continue;
      }
      const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
          s + static_cast<long long>(r) * src_ld + c));
      const R* v = reinterpret_cast<const R*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(d + i) =
            make_float4(to_f32(v[i]), to_f32(v[i + 1]), to_f32(v[i + 2]),
                        to_f32(v[i + 3]));
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBN * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] =
          r < rows ? to_f32(__ldcg(s + static_cast<long long>(r) * src_ld + c))
                   : 0.f;
    }
  }
  for (int e = threadIdx.x; e < kBN * (cols_pad - cols); e += kThreads) {
    const int w = cols_pad - cols;
    dst[e / w * ld + cols + e % w] = 0.f;
  }
}

// Folds each block into every row tile this CTA owns. NG groups of four
// o columns per thread: dv <= 64 * NG.
template <typename QT, typename KT, int NG>
struct AttnConsumer {
  const Params& p;
  int rank;
  int cta;
  float* smem;

  __device__ void operator()(int k, int idx, const char* block_bytes) {
    const KT* block = reinterpret_cast<const KT*>(block_bytes);
    const QT* q = static_cast<const QT*>(p.q);
    const int dk = p.dk, dv = p.dv, sq = p.sq, sk = p.sk;
    const int width = dk + dv;
    const int dkp = round4(dk), ldq = q_stride(dk);
    constexpr int kLdv = 64 * NG;
    float* qs = smem;                 // [kBM][ldq]
    float* ks = qs + kBM * ldq;       // [kBN][ldq], then the p tile
    float* ps = ks;                   // [kBM][kLdp]
    float* vs = ks + max(kBN * ldq, kBM * kLdp);  // [kBN][kLdv]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int tiles = (sq + kBM - 1) / kBM;
    const long long k_base = static_cast<long long>(idx) * sk;
    const long long q_base = static_cast<long long>(rank) * sq;

    for (int t = cta; t < tiles; t += p.ctas) {
      const int r0 = t * kBM;
      __syncthreads();  // the previous tile is done with shared memory
      load_tile(qs, ldq, q + (q_base + r0) * dk, dk, min(kBM, sq - r0), dk,
                dkp);

      float m[4], l[4], o[4][4 * NG];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        const bool live = k > 0 && row < sq;
        const long long at = q_base + row;
        m[i] = live ? p.m[at] : kNegInf;
        l[i] = live ? p.l[at] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4 * NG; ++jj) {
          const int col = tx * 4 + 64 * (jj / 4) + jj % 4;
          o[i][jj] = live && col < dv ? p.o[at * dv + col] : 0.f;
        }
      }

      int key_tiles = (sk + kBN - 1) / kBN;
      if (p.causal) {  // tiles that start at or below the tile's last row
        const long long last = q_base + min(r0 + kBM, sq) - 1 - k_base;
        key_tiles = last < 0 ? 0 : min(key_tiles,
                                       static_cast<int>(last / kBN) + 1);
      }
      for (int kt = 0; kt < key_tiles; ++kt) {
        const int c0 = kt * kBN;
        const int keys = min(kBN, sk - c0);
        __syncthreads();  // q in place; the last tile's p and v read
        const KT* rows = block + static_cast<long long>(c0) * width;
        load_tile(ks, ldq, rows, width, keys, dk, dkp);
        load_tile(vs, kLdv, rows + dk, width, keys, dv, kLdv);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < dkp; d += 4) {
          float4 a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = *reinterpret_cast<const float4*>(
                qs + (ty * 4 + i) * ldq + d);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = *reinterpret_cast<const float4*>(
                ks + (tx + 16 * j) * ldq + d);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
              s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
              s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
              s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
            }
        }
        __syncthreads();  // every thread is done with the K tile

#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long q_pos = q_base + r0 + ty * 4 + i;
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = c0 + tx + 16 * j;
            float v = s[i][j] * p.scale;
            if (key >= sk) {
              v = -INFINITY;
            } else if (p.causal && k_base + key > q_pos) {
              v = kNegInf;
            }
            s[i][j] = v;
            mt = fmaxf(mt, v);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
          }
          const float m_new = fmaxf(m[i], mt);
          const float alpha = expf(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float e = expf(s[i][j] - m_new);
            ps[(ty * 4 + i) * kLdp + tx + 16 * j] = e;
            sum += e;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) {
            sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
          }
          l[i] = l[i] * alpha + sum;
          m[i] = m_new;
#pragma unroll
          for (int jj = 0; jj < 4 * NG; ++jj) o[i][jj] *= alpha;
        }
        __syncthreads();  // the probability tile is complete

        // Padding keys have p = 0 and zero V rows, so whole groups of
        // four keys may be folded.
        const int keys4 = round4(keys);
        for (int c = 0; c < keys4; c += 4) {
          float4 pr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pr[i] = *reinterpret_cast<const float4*>(
                ps + (ty * 4 + i) * kLdp + c);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(
                  vs + (c + cc) * kLdv + tx * 4 + 64 * g);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float w = cc == 0   ? pr[i].x
                                : cc == 1 ? pr[i].y
                                : cc == 2 ? pr[i].z
                                          : pr[i].w;
                o[i][4 * g] = fmaf(w, v.x, o[i][4 * g]);
                o[i][4 * g + 1] = fmaf(w, v.y, o[i][4 * g + 1]);
                o[i][4 * g + 2] = fmaf(w, v.z, o[i][4 * g + 2]);
                o[i][4 * g + 3] = fmaf(w, v.w, o[i][4 * g + 3]);
              }
            }
          }
        }
      }

      const bool last_step = k == p.n - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= sq) continue;
        const long long at = q_base + row;
        if (last_step) {
          const float denom = l[i] == 0.f ? 1.f : l[i];
          QT* out = static_cast<QT*>(p.out);
#pragma unroll
          for (int jj = 0; jj < 4 * NG; ++jj) {
            const int col = tx * 4 + 64 * (jj / 4) + jj % 4;
            if (col < dv) store(out + at * dv + col, o[i][jj] / denom);
          }
        } else {
          if (tx == 0) {
            p.m[at] = m[i];
            p.l[at] = l[i];
          }
#pragma unroll
          for (int jj = 0; jj < 4 * NG; ++jj) {
            const int col = tx * 4 + 64 * (jj / 4) + jj % 4;
            if (col < dv) p.o[at * dv + col] = o[i][jj];
          }
        }
      }
    }
  }
};

template <typename QT, typename KT, int NG>
__global__ void __launch_bounds__(kThreads, NG == 2 ? 2 : 1)
    ring_attn_kernel(Params p) {
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
  AttnConsumer<QT, KT, NG> consume{p, rank, cta, smem};
  ring::run_ring_stream(r, consume);
}

template <typename QT, typename KT, int NG>
int launch_typed(Params& p, cudaStream_t stream) {
  void (*fn)(Params) = ring_attn_kernel<QT, KT, NG>;
  const int ldq = q_stride(p.dk);
  const int kp = kBN * ldq > kBM * kLdp ? kBN * ldq : kBM * kLdp;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBM) * ldq + kp + kBN * 64 * NG);
  // At most one CTA per 64-row tile: a second would idle.
  return ring::launch_ring(fn, p, p.ctas, p.n, (p.sq + kBM - 1) / kBM, smem,
                           stream);
}

template <typename QT, typename KT>
int launch_dv(Params& p, cudaStream_t stream) {
  return p.dv <= 128 ? launch_typed<QT, KT, 2>(p, stream)
                     : launch_typed<QT, KT, 4>(p, stream);
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
    return kv_bf16 ? launch_dv<bf16, bf16>(p, st) : launch_dv<bf16, float>(p, st);
  }
  return kv_bf16 ? launch_dv<float, bf16>(p, st) : launch_dv<float, float>(p, st);
}
