// Fused paged-attention decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel `make_paged_attn_step` of the JAX package
// (parallel/pallas_paged_attn.py): in ONE launch per decode step it
//   1. quantizes the step's new K/V rows (int8 pools) and appends them in
//      place at pool[tables[s, pos / bs], pos % bs];
//   2. gathers each slot's pages through its block table;
//   3. runs per-row causal online-softmax attention over them, with the
//      valid-block guard: K/V at positions >= ctx + n_new are zeroed
//      before any arithmetic touches them.
//
// Design. Grid (S, H): one CTA per (slot, head). The CTA for head h
// appends only head h's slice of the new rows, then __syncthreads(), then
// gathers and attends over head h alone, so the append -> gather
// dependency never crosses CTAs (the TPU kernel needed a static head loop
// and DMA waits for the same guarantee). Slots own disjoint blocks (the
// allocator's invariant) and prefix-shared blocks lie wholly below ctx, so
// no CTA reads bytes another CTA writes. Blocks past the slot's limit
// are never loaded: their softmax weight would be exactly 0.
//
// What bounds it: bytes. A decode step does ~2 FLOP per K/V byte read
// (int8 pages), far below the card's ~300 FLOP/byte ridge, so the
// kernel's job is to read each needed page once: it reads K/V pages of
// head h once into shared memory (dequantized to f32) and keeps the
// score tile and the online-softmax carries in shared memory; the
// [S, H, C, T] score tensor never exists. This first version is simple
// (CUDA-core FMAs, one block of bs positions per iteration, no async
// copies); wgmma/TMA and splitting long contexts across CTAs come later.
//
// Bit-exact quantization (the plain PyTorch version must produce the same
// codes): IEEE division (__fdiv_rn), rintf (round half to even), clip to
// +/-127. Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ int8_t quantize(float x, float scale, int8_t*) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(r);
}

__device__ __forceinline__ float quantize(float x, float, float*) {
  return x;  // fp32 pools store rows as they are
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 scale_or_zero(float4 v, float s, bool ok) {
  // A select, not a multiply by 0: 0 * NaN would still be NaN.
  return ok ? make_float4(v.x * s, v.y * s, v.z * s, v.w * s)
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename PoolT>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const int* __restrict__ tables,    // [S, B]
                  const int* __restrict__ ctx_arr,   // [S]
                  const int* __restrict__ nnew_arr,  // [S]
                  const float* __restrict__ q,       // [S, C, H, dh]
                  const float* __restrict__ k_new,   // [S, C, H, dh]
                  const float* __restrict__ v_new,   // [S, C, H, dh]
                  const float* __restrict__ ksc_rows,  // [S, C]
                  const float* __restrict__ vsc_rows,  // [S, C]
                  const float* __restrict__ ksc_tbl,   // [S, B]
                  const float* __restrict__ vsc_tbl,   // [S, B]
                  PoolT* kpool, PoolT* vpool,          // [N, bs, H, dh]
                  float* __restrict__ o,               // [S, C, H, dh]
                  int C, int B, int bs, int H, int dh,
                  float inv_sqrt_dh) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ctx = ctx_arr[s];
  const int n_new = nnew_arr[s];
  const int limit = ctx + n_new;
  const int* tbl = tables + static_cast<size_t>(s) * B;
  const size_t row = static_cast<size_t>(H) * dh;  // pool elements per position
  const int dh4 = dh / 4;

  // ---- 1. append head h's slice of the new rows ---------------------------
  for (int i = tid; i < n_new * dh; i += kThreads) {
    const int c = i / dh, d = i % dh;
    const int pos = ctx + c;
    const int bi = min(pos / bs, B - 1);  // the plain version's clip
    const size_t dst = (static_cast<size_t>(tbl[bi]) * bs + pos % bs) * row +
                       static_cast<size_t>(h) * dh + d;
    const size_t src = ((static_cast<size_t>(s) * C + c) * H + h) * dh + d;
    kpool[dst] = quantize(k_new[src], ksc_rows[s * C + c], kpool);
    vpool[dst] = quantize(v_new[src], vsc_rows[s * C + c], vpool);
  }

  // ---- shared memory carve-up (all float4-aligned) -------------------------
  extern __shared__ float4 smem4[];
  const int kst4 = dh4 + 1;               // padded K row: conflict-free reads
  float4* q_s = smem4;                     // [C][dh4]
  float4* acc_s = q_s + C * dh4;           // [C][dh4]
  float4* k_s = acc_s + C * dh4;           // [bs][kst4]
  float4* v_s = k_s + bs * kst4;           // [bs][dh4]
  float* p_s = reinterpret_cast<float*>(v_s + bs * dh4);  // [C][bs]
  float* m_s = p_s + C * bs;               // [C] running max
  float* l_s = m_s + C;                    // [C] running normalizer
  float* a_s = l_s + C;                    // [C] rescale of this block

  for (int i = tid; i < C * dh4; i += kThreads) {
    const int c = i / dh4, d4 = i % dh4;
    q_s[i] = load4(q + ((static_cast<size_t>(s) * C + c) * H + h) * dh + 4 * d4);
    acc_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = tid; c < C; c += kThreads) {
    m_s[c] = kNeg;
    l_s[c] = 0.f;
  }
  // Orders the appends above before the gathers below (global memory is
  // visible CTA-wide after the barrier) and publishes q/acc/m/l.
  __syncthreads();

  // ---- 2+3. gather the slot's pages, online softmax ------------------------
  // Blocks holding a position < limit (the table has B of them at most).
  const int nblk = min((limit + bs - 1) / bs, B);
  for (int b = 0; b < nblk; ++b) {
    const size_t base = static_cast<size_t>(tbl[b]) * bs * row +
                        static_cast<size_t>(h) * dh;
    const float ks = ksc_tbl[s * B + b];
    const float vs = vsc_tbl[s * B + b];
    for (int i = tid; i < bs * dh4; i += kThreads) {
      const int t = i / dh4, d4 = i % dh4;
      const bool ok = b * bs + t < limit;  // the valid-block guard
      const size_t src = base + static_cast<size_t>(t) * row + 4 * d4;
      k_s[t * kst4 + d4] = scale_or_zero(load4(kpool + src), ks, ok);
      v_s[t * dh4 + d4] = scale_or_zero(load4(vpool + src), vs, ok);
    }
    __syncthreads();

    for (int i = tid; i < C * bs; i += kThreads) {
      const int c = i / bs, t = i % bs;
      const float4* qr = q_s + c * dh4;
      const float4* kr = k_s + t * kst4;
      float dot = 0.f;
      for (int d4 = 0; d4 < dh4; ++d4) {
        const float4 a = qr[d4], k = kr[d4];
        dot = fmaf(a.x, k.x, dot);
        dot = fmaf(a.y, k.y, dot);
        dot = fmaf(a.z, k.z, dot);
        dot = fmaf(a.w, k.w, dot);
      }
      const int tpos = b * bs + t;
      const bool allowed = tpos <= ctx + c && tpos < limit;  // per-row causal
      p_s[i] = allowed ? dot * inv_sqrt_dh : kNeg;
    }
    __syncthreads();

    // One row per thread: C is the chunk width (16 at deploy shape).
    for (int c = tid; c < C; c += kThreads) {
      float* pr = p_s + c * bs;
      const float m_old = m_s[c];
      float m_new = m_old;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, pr[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[c] = l_s[c] * alpha + sum;
      m_s[c] = m_new;
      a_s[c] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < C * dh4; i += kThreads) {
      const int c = i / dh4, d4 = i % dh4;
      const float* pr = p_s + c * bs;
      const float alpha = a_s[c];
      float4 acc = acc_s[i];
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
      for (int t = 0; t < bs; ++t) {
        const float p = pr[t];
        const float4 v = v_s[t * dh4 + d4];
        acc.x = fmaf(p, v.x, acc.x);
        acc.y = fmaf(p, v.y, acc.y);
        acc.z = fmaf(p, v.z, acc.z);
        acc.w = fmaf(p, v.w, acc.w);
      }
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // An idle slot (limit == 0) attends nothing: its rows are 0, as in the
  // plain version, where a fully masked softmax averages zeroed V rows.
  for (int i = tid; i < C * dh4; i += kThreads) {
    const int c = i / dh4, d4 = i % dh4;
    const float l = l_s[c];
    const float4 a = acc_s[i];
    const float4 r = l > 0.f ? make_float4(a.x / l, a.y / l, a.z / l, a.w / l)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(
        o + ((static_cast<size_t>(s) * C + c) * H + h) * dh + 4 * d4) = r;
  }
}

template <typename PoolT>
int launch(const void* tables, const void* ctx, const void* n_new,
           const void* q, const void* k_new, const void* v_new,
           const void* ksc_rows, const void* vsc_rows, const void* ksc_tbl,
           const void* vsc_tbl, void* kpool, void* vpool, void* o, int S,
           int C, int B, int bs, int H, int dh, float inv_sqrt_dh,
           cudaStream_t stream) {
  const int dh4 = dh / 4;
  const size_t smem = sizeof(float4) * (2 * C * dh4 + bs * (dh4 + 1) +
                                        bs * dh4) +
                      sizeof(float) * (C * bs + 3 * C);
  auto kernel = paged_attn_kernel<PoolT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(S, H), kThreads, smem, stream>>>(
      static_cast<const int*>(tables), static_cast<const int*>(ctx),
      static_cast<const int*>(n_new), static_cast<const float*>(q),
      static_cast<const float*>(k_new), static_cast<const float*>(v_new),
      static_cast<const float*>(ksc_rows), static_cast<const float*>(vsc_rows),
      static_cast<const float*>(ksc_tbl), static_cast<const float*>(vsc_tbl),
      static_cast<PoolT*>(kpool), static_cast<PoolT*>(vpool),
      static_cast<float*>(o), C, B, bs, H, dh, inv_sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns the CUDA error code of
// the launch, 0 on success. Launches on `stream` and does not synchronize.
extern "C" int paged_attn_step_launch(
    const void* tables, const void* ctx, const void* n_new, const void* q,
    const void* k_new, const void* v_new, const void* ksc_rows,
    const void* vsc_rows, const void* ksc_tbl, const void* vsc_tbl,
    void* kpool, void* vpool, void* o, int S, int C, int B, int bs, int H,
    int dh, int pool_int8, float inv_sqrt_dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_int8) {
    return launch<int8_t>(tables, ctx, n_new, q, k_new, v_new, ksc_rows,
                          vsc_rows, ksc_tbl, vsc_tbl, kpool, vpool, o, S, C,
                          B, bs, H, dh, inv_sqrt_dh, st);
  }
  return launch<float>(tables, ctx, n_new, q, k_new, v_new, ksc_rows,
                       vsc_rows, ksc_tbl, vsc_tbl, kpool, vpool, o, S, C, B,
                       bs, H, dh, inv_sqrt_dh, st);
}
