// Fused paged-attention decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel `make_paged_attn_step` of the JAX package
// (parallel/pallas_paged_attn.py): in ONE launch per decode step it
//   1. quantizes the step's new K/V rows (int8 pools) and appends them in
//      place at pool[tables[s, pos / bs], pos % bs];
//   2. gathers each slot's pages through its block table;
//   3. runs per-row causal online-softmax attention over them, with the
//      valid-block guard: K/V at positions >= ctx + n_new are never
//      loaded, their staging rows are zero-filled, before any arithmetic.
//
// Design: the context is split across CTAs (flash-decoding's split-K).
//   * Grid (H, S, Z), Z = ceil(B / kChunkBlocks): CTA (h, s, z) owns the
//     block-table entries [z * kChunkBlocks, (z + 1) * kChunkBlocks) of
//     slot s, head h. A slot has L = max(1, ceil(nblk / kChunkBlocks))
//     live chunks (nblk: the table entries holding a position below its
//     limit); chunks past L exit at once. Chunk 0 always lives, so an idle
//     slot still writes its zero rows. kChunkBlocks is fixed, never taken
//     from the card, so the same inputs give the same bits on any card.
//   * The append stays inside the CTA that reads the rows: an appended
//     row belongs to the chunk of its CLIPPED block index min(pos / bs,
//     B - 1) (the plain version's clip); that chunk appends it, then
//     __syncthreads(), then gathers. No append -> gather order crosses
//     CTAs. Slots own disjoint blocks (the allocator's invariant) and
//     prefix-shared blocks lie wholly below ctx, so no CTA reads bytes
//     another CTA writes.
//   * Inside a chunk, passes of kPositions positions (64 int8, 32 f32):
//     the pass's K/V rows of head h are staged into shared memory by
//     cp.async (`tile_product.cuh`'s, zero-filled past the limit),
//     double-buffered with one barrier a pass, so the next pass's pages
//     load while this one is folded; the chunk's table entries and block
//     scales are read into shared memory once. A warp owns kRows = 4
//     query rows: for q.k each lane takes kPositions / 32 positions (q
//     read as a broadcast, its K row at a swizzled offset), the row max
//     is a warp shuffle, each lane keeps its own part of the normalizer;
//     for p.v each lane takes 4 head dims of the 4 rows. Scores are kept
//     in base 2 (log2 e folded into the key scale, exp2f). int8 codes
//     become floats by a byte permute and one add (`codes4`), not by the
//     quarter-rate conversion unit. CUDA-core FMAs: at ~2 flop per pool
//     byte the kernel is bound by bytes, not by tensor-core rate; at the
//     served shapes it is held back by the FMA and conversion work of all
//     C rows (padding rows included), not by the bytes.
//   * One live chunk: the CTA writes o itself. Several: each writes its
//     (m, l, acc[dh]) per row in f32 to a scratch, then stores ->
//     __syncthreads() -> __threadfence() -> an atomic on the (slot, head)
//     arrival word. The last arriver fences, reads the partials with
//     ld.global.cg and combines them in chunk order (so repeats are
//     bitwise equal whichever CTA is last), divides by l once, writes o,
//     and resets the arrival word to 0: every word is 0 between launches
//     (zeroed once by the caller, reset by each launch's last arriver).
//     The step stays one launch.
//
// What bounds it: bytes. A decode step does ~2 FLOP per K/V byte read
// (int8 pages), far below the card's ~300 FLOP/byte ridge: each needed
// page is read once, the [S, H, C, T] score tensor never exists. The
// partials add ~2 (C x dh x 4) bytes per live chunk of a long slot.
//
// Bit-exact quantization (the plain PyTorch version must produce the same
// codes): IEEE division (__fdiv_rn), rintf (round half to even), clip to
// +/-127. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_product.cuh"  // cp.async with zero-fill

namespace {

constexpr int kChunkBlocks = 32;  // block-table entries a CTA owns
constexpr int kRows = 4;          // query rows a warp owns
constexpr int kMaxRows = 64;      // the chunk width C a launch takes
constexpr int kMaxThreads = 32 * kMaxRows / kRows;
constexpr int kMaxHeadDim = 256;  // 4 dims x 32 lanes x 2
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Positions a pass stages: a lane takes kPositions / 32 of them in q.k.
template <class PoolT>
struct Pass;
template <>
struct Pass<int8_t> {
  static constexpr int kPositions = 64;
};
template <>
struct Pass<float> {
  static constexpr int kPositions = 32;
};

struct Params {
  const int* tables;      // [S, B]
  const int* ctx;         // [S]
  const int* n_new;       // [S]
  const float* q;         // [S, C, H, dh]
  const float* k_new;     // [S, C, H, dh]
  const float* v_new;     // [S, C, H, dh]
  const float* ksc_rows;  // [S, C]
  const float* vsc_rows;  // [S, C]
  const float* ksc_tbl;   // [S, B]
  const float* vsc_tbl;   // [S, B]
  void* kpool;            // [N, bs, H, dh]
  void* vpool;
  float* o;               // [S, C, H, dh]
  float* part_acc;        // [S, H, Z, C, dh]
  float* part_ml;         // [S, H, Z, C, 2]: max (base 2), normalizer
  unsigned* arrivals;     // [S, H], 0 between launches
  int C, B, bs, H, dh, Z;
  float inv_sqrt_dh;
};

__device__ __forceinline__ int8_t quantize(float x, float scale, int8_t*) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ float quantize(float x, float, float*) {
  return x;  // fp32 pools store rows as they are
}

// `bytes` (16 or 4) of a K/V row from global to shared memory; where !ok
// nothing is read and the destination is zero-filled. 16-byte units go by
// cp.async (through L2 only), the 4-byte units of rows that are no whole
// number of 16-byte ones (narrow int8 heads) by a plain load and store.
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           int bytes, bool ok) {
  if (bytes == 16) {
    tile::cp_async16_zfill(dst, src, ok);
  } else {
    *static_cast<unsigned*>(dst) =
        ok ? *static_cast<const unsigned*>(src) : 0u;
  }
}

// Byte offset of byte `b` of staged row `t`: the row's 16-byte units are
// swizzled by (t & swz), so lanes reading one unit of 8 consecutive rows
// hit 8 different bank groups.
__device__ __forceinline__ int staged(int t, int b, int row_bytes, int swz) {
  return t * row_bytes + ((((b >> 4) ^ (t & swz)) << 4) | (b & 15));
}

// Four int8 codes (one 32-bit word) as exact floats without the
// conversion unit, which runs at a quarter of the FMA rate: each byte,
// its sign bit flipped, becomes the low byte of 2^23's bit pattern
// (2^23 + b + 128, exact), and 2^23 + 128 is subtracted.
__device__ __forceinline__ float4 codes4(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                         kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                         kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) -
                         kBias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) -
                         kBias);
}

// E elements of a staged row as floats, from one shared-memory load.
template <class PoolT, int E>
struct Unit;
template <>
struct Unit<int8_t, 16> {
  static constexpr int kBytes = 16;
  __device__ static void load(const char* p, float (&f)[16]) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 c = codes4(ws[i]);
      f[4 * i + 0] = c.x;
      f[4 * i + 1] = c.y;
      f[4 * i + 2] = c.z;
      f[4 * i + 3] = c.w;
    }
  }
};
template <>
struct Unit<int8_t, 4> {
  static constexpr int kBytes = 4;
  __device__ static void load(const char* p, float (&f)[4]) {
    const float4 c = codes4(*reinterpret_cast<const unsigned*>(p));
    f[0] = c.x;
    f[1] = c.y;
    f[2] = c.z;
    f[3] = c.w;
  }
};
template <>
struct Unit<float, 4> {
  static constexpr int kBytes = 16;
  __device__ static void load(const char* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

__device__ __forceinline__ float4 load4(const char* p, int8_t*) {
  return codes4(*reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ float4 load4(const char* p, float*) {
  return *reinterpret_cast<const float4*>(p);
}

// x / d and x % d for x >= 0, by shifts where d is a power of two (the
// block size and the copy units a row at the deploy shapes).
struct Div {
  int d, shift;
  bool pow2;
  __device__ explicit Div(int d_)
      : d(d_), shift(0), pow2((d_ & (d_ - 1)) == 0) {
    while ((1 << shift) < d) ++shift;
  }
  __device__ int div(int x) const { return pow2 ? x >> shift : x / d; }
  __device__ int mod(int x) const { return pow2 ? x & (d - 1) : x % d; }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

// Raw q.k dots of this lane's J staged positions against the warp's
// kRows query rows (q_rows: [kRows][dh4] in shared memory).
template <class PoolT, int E, int J>
__device__ __forceinline__ void qk(const float4* q_rows, int dh4,
                                   const char* kst, int row_bytes, int swz,
                                   int lane, float (&sc)[J][kRows]) {
  using U = Unit<PoolT, E>;
  const int units = row_bytes / U::kBytes;
  for (int u = 0; u < units; ++u) {
    float kf[J][E];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = lane + 32 * j;
      U::load(kst + staged(t, u * U::kBytes, row_bytes, swz), kf[j]);
    }
#pragma unroll
    for (int e4 = 0; e4 < E / 4; ++e4) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = q_rows[r * dh4 + u * (E / 4) + e4];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          float s = sc[j][r];
          s = fmaf(qv.x, kf[j][4 * e4 + 0], s);
          s = fmaf(qv.y, kf[j][4 * e4 + 1], s);
          s = fmaf(qv.z, kf[j][4 * e4 + 2], s);
          s = fmaf(qv.w, kf[j][4 * e4 + 3], s);
          sc[j][r] = s;
        }
      }
    }
  }
}

template <class PoolT, int E, int DPL>
__global__ void __launch_bounds__(kMaxThreads)
    paged_attn_kernel(const Params p) {
  constexpr int P = Pass<PoolT>::kPositions;
  constexpr int J = P / 32;
  // Heads vary fastest: the CTAs that run together read every head's
  // row of the same positions, whole pool rows.
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int C = p.C, B = p.B, bs = p.bs, H = p.H, dh = p.dh;
  const int dh4 = dh / 4;
  const int ctx = p.ctx[s];
  const int n_new = p.n_new[s];
  const int limit = ctx + n_new;
  const int nblk = min((limit + bs - 1) / bs, B);
  const int live = max(1, (nblk + kChunkBlocks - 1) / kChunkBlocks);
  if (z >= live) return;
  const int* tbl = p.tables + static_cast<size_t>(s) * B;
  const int row_bytes = dh * static_cast<int>(sizeof(PoolT));
  const size_t head_row = static_cast<size_t>(H) * row_bytes;  // a position
  char* kpool = static_cast<char*>(p.kpool);
  char* vpool = static_cast<char*>(p.vpool);

  // ---- 1. append head h's slice of the rows whose clipped block is ours
  for (int i = tid; i < n_new * dh; i += nthreads) {
    const int c = i / dh, d = i % dh;
    const int pos = ctx + c;
    const int bi = min(pos / bs, B - 1);  // the plain version's clip
    if (bi / kChunkBlocks != z) continue;
    const size_t dst = (static_cast<size_t>(tbl[bi]) * bs + pos % bs) *
                           head_row +
                       static_cast<size_t>(h) * row_bytes +
                       d * sizeof(PoolT);
    const size_t src = ((static_cast<size_t>(s) * C + c) * H + h) * dh + d;
    PoolT* kd = reinterpret_cast<PoolT*>(kpool + dst);
    PoolT* vd = reinterpret_cast<PoolT*>(vpool + dst);
    *kd = quantize(p.k_new[src], p.ksc_rows[s * C + c], kd);
    *vd = quantize(p.v_new[src], p.vsc_rows[s * C + c], vd);
  }

  // ---- shared memory: q rows, each warp's p tile, two K/V stages --------
  extern __shared__ float4 smem4[];
  const int rows = nthreads / 32 * kRows;  // >= C; rows past C are 0
  float4* q_s = smem4;                     // [rows][dh4]
  float4* p_s = q_s + rows * dh4;  // [warps][P][kRows / 4]
  char* stage = reinterpret_cast<char*>(p_s + rows / 4 * P);
  const int stage_bytes = 2 * P * row_bytes;  // K rows, then V rows
  const int unit = row_bytes % 16 == 0 ? 16 : 4;
  const int swz = row_bytes % 128 == 0 ? 7 : 0;
  const int upr = row_bytes / unit;

  for (int i = tid; i < rows * dh4; i += nthreads) {
    const int c = i / dh4, d4 = i % dh4;
    q_s[i] = c < C ? *reinterpret_cast<const float4*>(
                         p.q + ((static_cast<size_t>(s) * C + c) * H + h) *
                                   dh +
                         4 * d4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The chunk's table entries and block scales (the keys' with the
  // softmax's 1/sqrt(dh) and log2(e) folded in), read once.
  __shared__ int tbl_s[kChunkBlocks];
  __shared__ float ksc_s[kChunkBlocks], vsc_s[kChunkBlocks];
  const int zb = z * kChunkBlocks;
  for (int i = tid; i < kChunkBlocks; i += nthreads) {
    const bool held = zb + i < nblk;
    tbl_s[i] = held ? tbl[zb + i] : 0;
    ksc_s[i] =
        held ? p.ksc_tbl[s * B + zb + i] * p.inv_sqrt_dh * kLog2e : 0.f;
    vsc_s[i] = held ? p.vsc_tbl[s * B + zb + i] : 0.f;
  }

  // Positions of this chunk that hold K/V: below the limit and within the
  // chunk's own table entries (the table holds B * bs positions).
  const int first = zb * bs;
  const int vend =
      min(limit, min((z + 1) * kChunkBlocks, nblk) * bs);
  const int passes = vend > first ? (vend - first + P - 1) / P : 0;

  const Div by_upr(upr), by_bs(bs);
  auto stage_pass = [&](int pass) {
    char* buf = stage + (pass & 1) * stage_bytes;
    const int base = first + pass * P;
    for (int i = tid; i < P * upr; i += nthreads) {
      const int t = by_upr.div(i);
      const int u = by_upr.mod(i);
      const int pos = base + t;
      const bool ok = pos < vend;  // the valid-block guard: zero-fill
      const size_t at =
          ok ? (static_cast<size_t>(tbl_s[by_bs.div(pos) - zb]) * bs +
                by_bs.mod(pos)) * head_row +
                   static_cast<size_t>(h) * row_bytes + u * unit
             : 0;
      char* dst = buf + staged(t, u * unit, row_bytes, swz);
      stage_copy(dst, kpool + at, unit, ok);
      stage_copy(dst + P * row_bytes, vpool + at, unit, ok);
    }
    tile::cp_async_commit();
  };

  // Orders the appends above before the stage copies below (global
  // memory is visible CTA-wide after the barrier) and publishes q and
  // the chunk's table.
  __syncthreads();
  if (passes > 0) stage_pass(0);

  const int row0 = warp * kRows;
  const float4* q_rows = q_s + row0 * dh4;
  // Where this lane's dims lie in a staged V row, by the row's t % 8.
  int v_at[DPL][8];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v_at[i][k] = staged(k, (lane + 32 * i) * 4 * static_cast<int>(
                                                      sizeof(PoolT)),
                          row_bytes, swz) - k * row_bytes;
    }
  }
  float4* p_w = p_s + warp * P * (kRows / 4);
  float m_run[kRows], l_part[kRows];
  float4 acc[DPL][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = kNeg;
    l_part[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int pass = 0; pass < passes; ++pass) {
    tile::cp_async_wait<0>();
    // This pass's stage has landed for every thread, and every warp is
    // done with the last pass's stage (and its p tile): the next pass's
    // copy may refill it while this one is folded.
    __syncthreads();
    if (pass + 1 < passes) stage_pass(pass + 1);
    const char* kst = stage + (pass & 1) * stage_bytes;
    const char* vst = kst + P * row_bytes;
    const int base = first + pass * P;

    // The block scales of this lane's positions.
    float kscale[J], vscale[J];
    bool ok[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int pos = base + lane + 32 * j;
      ok[j] = pos < vend;
      const int b = ok[j] ? by_bs.div(pos) - zb : 0;
      kscale[j] = ok[j] ? ksc_s[b] : 0.f;
      vscale[j] = ok[j] ? vsc_s[b] : 0.f;
    }
    float sc[J][kRows];
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[j][r] = 0.f;
    }
    qk<PoolT, E, J>(q_rows, dh4, kst, row_bytes, swz, lane, sc);

    // Scale, per-row causal mask, running max over the warp's positions.
    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = kNeg;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int pos = base + lane + 32 * j;
        const bool allowed = ok[j] && pos <= ctx + row0 + r;
        sc[j][r] = allowed ? sc[j][r] * kscale[j] : kNeg;
        m = fmaxf(m, sc[j][r]);
      }
      const float m_new = fmaxf(m_run[r], warp_max(m));
      alpha[r] = exp2f(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int pos = base + lane + 32 * j;
        const bool allowed = ok[j] && pos <= ctx + row0 + r;
        const float e = allowed ? exp2f(sc[j][r] - m_new) : 0.f;
        sum += e;
        sc[j][r] = e * vscale[j];  // the p.v weight, V's scale folded in
      }
      l_part[r] = l_part[r] * alpha[r] + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i][r] = scale4(acc[i][r], alpha[r]);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int r4 = 0; r4 < kRows / 4; ++r4) {
        p_w[(lane + 32 * j) * (kRows / 4) + r4] =
            make_float4(sc[j][4 * r4], sc[j][4 * r4 + 1], sc[j][4 * r4 + 2],
                        sc[j][4 * r4 + 3]);
      }
    }
    __syncwarp();

    // p.v: this lane's 4 dims (and 4 more at +128) of the warp's rows.
    for (int t0 = 0; t0 < P; t0 += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int t = t0 + k;
        float4 v[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          v[i] = lane + 32 * i < dh4
                     ? load4(vst + t * row_bytes + v_at[i][k],
                             static_cast<PoolT*>(nullptr))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 w = p_w[t * (kRows / 4) + r4];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            acc[i][4 * r4 + 0] = axpy4(w.x, v[i], acc[i][4 * r4 + 0]);
            acc[i][4 * r4 + 1] = axpy4(w.y, v[i], acc[i][4 * r4 + 1]);
            acc[i][4 * r4 + 2] = axpy4(w.z, v[i], acc[i][4 * r4 + 2]);
            acc[i][4 * r4 + 3] = axpy4(w.w, v[i], acc[i][4 * r4 + 3]);
          }
        }
      }
    }
  }

  float l_row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) l_row[r] = warp_sum(l_part[r]);

  if (live == 1) {
    // An idle slot (limit == 0) attends nothing: its rows are 0, as in the
    // plain version, where a fully masked softmax averages zeroed V rows.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = row0 + r;
      if (c >= C) continue;
      const float l = l_row[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d4 = lane + 32 * i;
        if (d4 >= dh4) continue;
        const float4 a = acc[i][r];
        *reinterpret_cast<float4*>(
            p.o + ((static_cast<size_t>(s) * C + c) * H + h) * dh + 4 * d4) =
            l > 0.f ? make_float4(a.x / l, a.y / l, a.z / l, a.w / l)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // ---- several live chunks: partials, then the last arriver combines ----
  const size_t sh = static_cast<size_t>(s) * H + h;
  const size_t part0 = sh * p.Z * C;  // row (z, c) at part0 + z * C + c
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = row0 + r;
    if (c >= C) continue;
    const size_t at = part0 + static_cast<size_t>(z) * C + c;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d4 = lane + 32 * i;
      if (d4 < dh4) {
        *reinterpret_cast<float4*>(p.part_acc + at * dh + 4 * d4) = acc[i][r];
      }
    }
    if (lane == 0) {
      *reinterpret_cast<float2*>(p.part_ml + 2 * at) =
          make_float2(m_run[r], l_row[r]);
    }
  }
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned prev = atomicAdd(p.arrivals + sh, 1u);
    last = prev == static_cast<unsigned>(live - 1);
    if (last) {
      atomicExch(p.arrivals + sh, 0u);  // ready for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;

  float top[kRows], l[kRows];
  float4 a[DPL][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    top[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int rows_here = min(kRows, C - row0);  // rows of this warp in C
#pragma unroll 4
  for (int k = 0; k < live; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows_here) {
        top[r] = fmaxf(top[r], __ldcg(p.part_ml + 2 * (part0 +
                                                       static_cast<size_t>(
                                                           k) * C +
                                                       row0 + r)));
      }
    }
  }
#pragma unroll 2
  for (int k = 0; k < live; ++k) {  // in chunk order
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows_here) continue;
      const size_t at = part0 + static_cast<size_t>(k) * C + row0 + r;
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(p.part_ml + 2 * at));
      const float w = exp2f(ml.x - top[r]);
      l[r] = fmaf(ml.y, w, l[r]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d4 = lane + 32 * i;
        if (d4 < dh4) {
          a[i][r] = axpy4(w,
                          __ldcg(reinterpret_cast<const float4*>(
                              p.part_acc + at * dh + 4 * d4)),
                          a[i][r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows_here) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d4 = lane + 32 * i;
      if (d4 >= dh4) continue;
      *reinterpret_cast<float4*>(
          p.o + ((static_cast<size_t>(s) * C + row0 + r) * H + h) * dh +
          4 * d4) = l[r] > 0.f ? make_float4(a[i][r].x / l[r],
                                             a[i][r].y / l[r],
                                             a[i][r].z / l[r],
                                             a[i][r].w / l[r])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <class PoolT, int E, int DPL>
int launch(const Params& p, int S, cudaStream_t stream) {
  constexpr int P = Pass<PoolT>::kPositions;
  const int warps = (p.C + kRows - 1) / kRows;
  const int threads = 32 * warps;
  const size_t smem =
      sizeof(float4) * static_cast<size_t>(warps) * (kRows / 4) *
          (p.dh + P) +
      2 * 2 * static_cast<size_t>(P) * p.dh * sizeof(PoolT);
  auto kernel = paged_attn_kernel<PoolT, E, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(p.H, S, p.Z), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class PoolT, int E>
int launch_dpl(const Params& p, int S, cudaStream_t stream) {
  return p.dh <= 128 ? launch<PoolT, E, 1>(p, S, stream)
                     : launch<PoolT, E, 2>(p, S, stream);
}

}  // namespace

// The block-table entries one CTA owns: the caller sizes the partials'
// scratch by it ([S, H, ceil(B / it), C, dh] and [.., 2]) and checks it.
extern "C" int paged_attn_chunk_blocks() { return kChunkBlocks; }

// Plain C entry point (bound with ctypes). Returns the CUDA error code of
// the launch, 0 on success. Launches on `stream` and does not synchronize.
// part_acc [S, H, Z, C, dh] and part_ml [S, H, Z, C, 2] f32 are scratch,
// Z = ceil(B / paged_attn_chunk_blocks()); arrivals [S, H] u32 must be 0
// before the first launch and are 0 again after each. C <= 64, dh <= 256
// and a multiple of 4.
extern "C" int paged_attn_step_launch(
    const void* tables, const void* ctx, const void* n_new, const void* q,
    const void* k_new, const void* v_new, const void* ksc_rows,
    const void* vsc_rows, const void* ksc_tbl, const void* vsc_tbl,
    void* kpool, void* vpool, void* o, void* part_acc, void* part_ml,
    void* arrivals, int S, int C, int B, int bs, int H, int dh,
    int pool_int8, float inv_sqrt_dh, void* stream) {
  if (S < 1 || C < 1 || C > kMaxRows || B < 1 || bs < 1 || H < 1 || dh < 4 ||
      dh % 4 || dh > kMaxHeadDim || part_acc == nullptr ||
      part_ml == nullptr || arrivals == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.tables = static_cast<const int*>(tables);
  p.ctx = static_cast<const int*>(ctx);
  p.n_new = static_cast<const int*>(n_new);
  p.q = static_cast<const float*>(q);
  p.k_new = static_cast<const float*>(k_new);
  p.v_new = static_cast<const float*>(v_new);
  p.ksc_rows = static_cast<const float*>(ksc_rows);
  p.vsc_rows = static_cast<const float*>(vsc_rows);
  p.ksc_tbl = static_cast<const float*>(ksc_tbl);
  p.vsc_tbl = static_cast<const float*>(vsc_tbl);
  p.kpool = kpool;
  p.vpool = vpool;
  p.o = static_cast<float*>(o);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.arrivals = static_cast<unsigned*>(arrivals);
  p.C = C;
  p.B = B;
  p.bs = bs;
  p.H = H;
  p.dh = dh;
  p.Z = (B + kChunkBlocks - 1) / kChunkBlocks;
  p.inv_sqrt_dh = inv_sqrt_dh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_int8) {
    return dh % 16 == 0 ? launch_dpl<int8_t, 16>(p, S, st)
                        : launch_dpl<int8_t, 4>(p, S, st);
  }
  return launch_dpl<float, 4>(p, S, st);
}
