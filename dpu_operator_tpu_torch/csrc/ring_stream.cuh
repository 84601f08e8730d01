// The ring protocols, device side, for Hopper (sm_90a).
//
// `run_ring_stream` is the counterpart of parallel/ring_probe.py
// `_run_ring_stream` in the JAX package: the one protocol body that the
// streaming ring kernels share, here a template over a consumer,
// `consume(k, idx, block)`, called with each block as it passes through
// this rank (k the ring step, idx the rank that owns the block). The
// fused all-gather matmul's consumer multiplies it, ring attention's
// folds it into an online softmax; a fix to the protocol lands in both at
// once.
// `run_rs_ring`, further down, is the counterpart of `_run_rs_ring`: the
// reduce-scatter ring, a template over what produces a rank's
// contribution and where the finished sum goes; `run_rs_fold_send` is the
// same ring for contributions that already lie in memory, each step's add
// stored straight into the neighbour's slot; `run_gather_relay`, at the
// end of the device side, is the ring all-gather with no slots, each
// block relayed from where it landed in the rank's own output.
//
// What the TPU's primitives become:
//   * a rank is `ctas` CTAs of one cooperative launch (all of them
//     resident at once, so a spin wait cannot starve the CTA it waits
//     for), not one program. A rank-level event (its copy of a block is
//     complete; it has finished reading a slot; it has entered) is an
//     arrival counter: each CTA adds one after its own part, and the last
//     to arrive resets the counter and raises the peer's flag;
//   * DMA semaphores become 64-bit flag words in device memory. A flag
//     only grows (atomicMax), and every value written is tagged with the
//     call's epoch (`epoch * kTagSteps + step`), a counter the caller
//     passes in that grows with every call: no flag needs clearing, and
//     no flag left by an earlier call can release a wait of this one;
//   * remote copies become plain stores into the right neighbour's slot,
//     reached through a pointer. Within one card all ranks live in one
//     launch; across cards only where the pointers come from changes.
//
// Memory ordering. A writer's stores, then __syncthreads(), then one
// thread's __threadfence() and atomic arrival; the last arriver fences
// again and raises the flag. A waiter spins on the flag with
// ld.acquire.gpu, fences, and releases its CTA with __syncthreads().
// Slot contents are read with ld.global.cg (L2 only): L1 is not coherent
// across SMs, and a slot is rewritten every other step.
//
// The credit. Waiting on one's own receive flag bounds nothing about the
// neighbours' progress: around an n-ring a neighbour could run up to
// n - 1 steps ahead and overwrite a slot whose contents this rank has
// not yet forwarded. The step-k copy targets the right neighbour's slot
// (k + 1) % 2, which is free once that neighbour has finished step k - 1
// with it; so each rank grants its left neighbour a credit after each
// step (k < n - 2) and waits for one before every send after the first.
// Skew is bounded to one step, which the two slots absorb.
//
// The rank's own shard is the block in hand at step 0 and is read in
// place (the reference copied it into slot 0 because its remote copy
// could start only from a slot).
//
// A wait that has not been released after kSpinLimitNs traps: a broken
// protocol then fails the launch instead of hanging the card.
//
// The host side, at the end: `Ring` (what a ring kernel's launch carries),
// `make_ring` (it from the C arguments), `make_rank` (a CTA's `Rank` from
// it) and `launch_ring`, the one cooperative launcher that every kernel
// built on these primitives uses (the ring collectives, ring attention,
// the all-to-all, the collective matmuls).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace ring {

constexpr unsigned long long kTagSteps = 16;  // > the largest ring, 8
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;
constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;  // threads of every CTA that launch_ring starts
// A CTA's share of a copied block before another CTA is worth its flag
// traffic: about four 16-byte units a thread.
constexpr long long kBytesPerCta = 4ll * 16 * kThreads;

// One rank's control words, in device memory that lives across calls
// (zeroed once when allocated). Flags are raised by peers; arrival
// counters are this rank's own and are back at 0 after every call.
struct alignas(128) Flags {
  unsigned long long bar_from_left;   // the left neighbour has entered
  unsigned long long bar_from_right;  // the right neighbour has entered
  unsigned long long recv;            // blocks that have landed in my slots
  unsigned long long credit;          // credits from the right neighbour
  unsigned int bar_arrive;
  unsigned int send_arrive[2];        // by step parity
  unsigned int credit_arrive[2];      // by step parity
};

// What one CTA knows of its rank and the rank's neighbours.
struct Rank {
  int my_id;      // position on the ring
  int dir = 1;    // +1: blocks travel towards higher positions; -1: the
                  // ring runs the other way, and `right`/`right_slots`
                  // name the neighbour at my_id - 1, `left` the one at
                  // my_id + 1 (downstream and upstream)
  int n;          // ring size
  int ctas;       // CTAs that make up this rank
  int cta;        // this CTA's index within the rank
  unsigned long long epoch;
  long long block_bytes;     // one block, [rows, width] of the payload type
  const char* local;         // this rank's own shard
  char* my_slots;            // [2][block_bytes], this rank's
  char* right_slots;         // the right neighbour's
  Flags* me;
  Flags* left;
  Flags* right;
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All threads of the CTA: return once *flag >= target.
__device__ __forceinline__ void wait_flag(const unsigned long long* flag,
                                          unsigned long long target) {
  if (threadIdx.x == 0) {
    if (ld_acquire(flag) < target) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(flag) < target) {
        __nanosleep(64);
        if (global_ns() - t0 > kSpinLimitNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void raise_flag(unsigned long long* flag,
                                           unsigned long long value) {
  atomicMax(flag, value);
}

// All threads of the CTA, after their part of a rank-level event: the
// last of the rank's CTAs to arrive resets the counter and calls
// `signal()` (on thread 0).
template <class Signal>
__device__ __forceinline__ void arrive(unsigned int* counter, int ctas,
                                       Signal signal) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counter, 1u) == static_cast<unsigned>(ctas - 1)) {
      atomicExch(counter, 0u);
      __threadfence();
      signal();
    }
  }
}

// This CTA's stripe of a block copy, `bytes` from src to dst: 16-byte
// units where both ends allow, else units of `Unit` (2 bytes unless the
// caller names the payload's own width: every payload type is at least
// 2 bytes wide). Unit i belongs to thread i % blockDim.x of CTA
// (i / blockDim.x) % ctas. The source is read through L2 only.
template <class Unit = unsigned short>
__device__ __forceinline__ void copy_stripe(char* dst, const char* src,
                                            long long bytes, int cta,
                                            int ctas) {
  const long long first = static_cast<long long>(cta) * blockDim.x +
                          threadIdx.x;
  const long long stride = static_cast<long long>(ctas) * blockDim.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(bytes)) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = first; i < bytes / 16; i += stride) {
      __stcg(d + i, __ldcg(s + i));
    }
  } else {
    const Unit* s = reinterpret_cast<const Unit*>(src);
    Unit* d = reinterpret_cast<Unit*>(dst);
    const long long units = bytes / static_cast<long long>(sizeof(Unit));
    for (long long i = first; i < units; i += stride) {
      __stcg(d + i, __ldcg(s + i));
    }
  }
}

// The protocol, run by every CTA of every rank. `consume(k, idx, block)`
// is called by all threads of the CTA for k = 0 .. n-1 with the block
// owned by rank idx = (my_id - dir * k) mod n, the rank k hops upstream;
// it must only read the block.
template <class Consumer>
__device__ void run_ring_stream(const Rank& r, Consumer& consume) {
  const unsigned long long tag = r.epoch * kTagSteps;
  // Neighbour barrier: both neighbours have entered the kernel.
  arrive(&r.me->bar_arrive, r.ctas, [&] {
    raise_flag(&r.left->bar_from_right, tag);
    raise_flag(&r.right->bar_from_left, tag);
  });
  wait_flag(&r.me->bar_from_left, tag);
  wait_flag(&r.me->bar_from_right, tag);

  for (int k = 0; k < r.n; ++k) {
    const char* block =
        k == 0 ? r.local : r.my_slots + (k & 1) * r.block_bytes;
    if (k > 0) wait_flag(&r.me->recv, tag + k);  // the block has landed
    if (k < r.n - 1) {
      if (k > 0) wait_flag(&r.me->credit, tag + k);  // its target is free
      copy_stripe(r.right_slots + ((k + 1) & 1) * r.block_bytes, block,
                  r.block_bytes, r.cta, r.ctas);
      arrive(&r.me->send_arrive[k & 1], r.ctas,
             [&] { raise_flag(&r.right->recv, tag + k + 1); });
    }
    consume(k, (r.my_id - r.dir * k + r.n) % r.n, block);
    if (k < r.n - 2) {
      // Done with this slot: the left neighbour may overwrite it.
      arrive(&r.me->credit_arrive[k & 1], r.ctas,
             [&] { raise_flag(&r.left->credit, tag + k + 1); });
    }
  }
}

// -- the reduce-scatter ring --------------------------------------------------
//
// Chunk j starts at rank (j + 1) mod n and travels towards higher
// positions, gathering each rank's contribution on the way, and is
// complete when it lands on rank j after n - 1 hops. A rank keeps two
// send buffers of its own (the sum it forwards next) and two receive
// slots that its left neighbour writes (`my_slots`; `right_slots` are
// the right neighbour's). Step k, for k = 0 .. n-2:
//   * (k > 1) wait for one credit: the target slot (k + 1) % 2 of the
//     right neighbour last held the arrival of step k - 2, which that
//     neighbour has folded. Step 0's target was never written and step
//     1's neither, so they need none;
//   * copy send[k % 2] into the right neighbour's slot (k + 1) % 2 and
//     raise its receive flag;
//   * produce the NEXT block's contribution, row-block
//     (my_id - k - 2) mod n, into send[(k + 1) % 2] (the reference did
//     this while its copy was in flight);
//   * wait for this step's own arrival in slot (k + 1) % 2 and
//     (k < n - 2) fold it: send[(k + 1) % 2] += slot[(k + 1) % 2];
//   * (k < n - 3) grant the left neighbour a credit: a later grant would
//     have no send left to use it.
// The last arrival (step n - 2) is not folded in the loop: by then
// send[(n - 1) % 2] holds this rank's contribution to its own chunk, and
// `finish(slot[(n - 1) % 2], send[(n - 1) % 2])` stores their sum. Rings
// of 2 and 3 grant no credit; a ring of 1 must not come here (the
// reduction is the identity, and the loop would add an unwritten slot).
//
// Within a rank every CTA owns the same part of every buffer at every
// step: `produce`, the fold, the send and `finish` all cut a block by one
// ownership map, the `Stripe`, so one part's produce -> fold -> send runs
// in one CTA's program order, behind its __syncthreads(). Only the two
// cross-rank events (a block has landed, a slot is free) go through the
// rank's arrival counters. A `Stripe` has `copy(dst, src)` and
// `add(dst, a, b)` (dst = a + b) over this CTA's part of a block; the
// caller's `produce` and `finish` write exactly that part. The ring
// collectives' map is `ByteStripe`, copy_stripe's units; the matmul
// reduce-scatter's is a map of output tiles, the tile product's own
// (`collective_matmul.cu`).
//
// A `Sum` has `Raw`, a value's bit pattern (unsigned short or unsigned
// int), and `add(a, b)`, the sum in the payload's own type, rounded there
// at every hop as the reference's scratch of the input's type rounds. The
// adds run in a fixed order, so a result is the same on every call.

// Sums in the payload's own type, on bit patterns.
struct SumF32 {
  using Raw = unsigned int;
  static __device__ __forceinline__ Raw add(Raw a, Raw b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};

struct SumI32 {
  using Raw = unsigned int;  // two's complement: wraps as int32 does
  static __device__ __forceinline__ Raw add(Raw a, Raw b) { return a + b; }
};

// bf16 and f16: the exact operands added in f32 and rounded once to the
// type, to nearest even, which is PyTorch's own bf16 and f16 add.
struct SumBF16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw add(Raw a, Raw b) {
    const float fa = __uint_as_float(static_cast<unsigned>(a) << 16);
    const float fb = __uint_as_float(static_cast<unsigned>(b) << 16);
    return __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(fa, fb)));
  }
};

struct SumF16 {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw add(Raw a, Raw b) {
    const float fa = __half2float(__ushort_as_half(a));
    const float fb = __half2float(__ushort_as_half(b));
    return __half_as_ushort(__float2half_rn(__fadd_rn(fa, fb)));
  }
};

// a + b lane by lane over one 16-byte unit of Sum's values.
template <class Sum>
__device__ __forceinline__ uint4 add_unit(uint4 a, uint4 b) {
  using Raw = typename Sum::Raw;
  constexpr int kLanes = 16 / static_cast<int>(sizeof(Raw));
  union Vec {
    uint4 v;
    Raw lane[kLanes];
  };
  Vec x, y;
  x.v = a;
  y.v = b;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) x.lane[j] = Sum::add(x.lane[j], y.lane[j]);
  return x.v;
}

// dst = a + b over this CTA's stripe; the units of copy_stripe<Raw>.
template <class Sum>
__device__ __forceinline__ void add_stripe(char* dst, const char* a,
                                           const char* b, long long bytes,
                                           int cta, int ctas) {
  using Raw = typename Sum::Raw;
  const long long first = static_cast<long long>(cta) * blockDim.x +
                          threadIdx.x;
  const long long stride = static_cast<long long>(ctas) * blockDim.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(a) |
        reinterpret_cast<uintptr_t>(b) | static_cast<uintptr_t>(bytes)) &
       15) == 0) {
    const uint4* pa = reinterpret_cast<const uint4*>(a);
    const uint4* pb = reinterpret_cast<const uint4*>(b);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = first; i < bytes / 16; i += stride) {
      __stcg(d + i, add_unit<Sum>(__ldcg(pa + i), __ldcg(pb + i)));
    }
  } else {
    const Raw* pa = reinterpret_cast<const Raw*>(a);
    const Raw* pb = reinterpret_cast<const Raw*>(b);
    Raw* d = reinterpret_cast<Raw*>(dst);
    const long long units = bytes / static_cast<long long>(sizeof(Raw));
    for (long long i = first; i < units; i += stride) {
      __stcg(d + i, Sum::add(__ldcg(pa + i), __ldcg(pb + i)));
    }
  }
}

// The ring collectives' ownership map: copy_stripe's units of a block of
// `bytes` (16 bytes where pointers and size allow, else one value). The
// caller keeps its promise by giving every buffer a 16-byte-aligned base
// and blocks of whole values.
template <class Sum>
struct ByteStripe {
  long long bytes;
  int cta, ctas;
  __device__ __forceinline__ void copy(char* dst, const char* src) const {
    copy_stripe<typename Sum::Raw>(dst, src, bytes, cta, ctas);
  }
  __device__ __forceinline__ void add(char* dst, const char* a,
                                      const char* b) const {
    add_stripe<Sum>(dst, a, b, bytes, cta, ctas);
  }
};

// The protocol, run by every CTA of every rank of a ring of n >= 2.
// `send` is this rank's [2][block_bytes] of send buffers. All threads of
// the CTA call `produce(idx, dst)`, which writes this CTA's part (by
// `stripe`) of the rank's contribution to row-block idx into dst, and
// `finish(a, b)`, which stores this CTA's part of a + b where the
// completed block goes. `r.local` is not used.
template <class Stripe, class Produce, class Finish>
__device__ void run_rs_ring(const Rank& r, char* send, const Stripe& stripe,
                            Produce& produce, Finish& finish) {
  const unsigned long long tag = r.epoch * kTagSteps;
  arrive(&r.me->bar_arrive, r.ctas, [&] {
    raise_flag(&r.left->bar_from_right, tag);
    raise_flag(&r.right->bar_from_left, tag);
  });
  wait_flag(&r.me->bar_from_left, tag);
  wait_flag(&r.me->bar_from_right, tag);

  produce((r.my_id - 1 + r.n) % r.n, send);
  __syncthreads();
  for (int k = 0; k < r.n - 1; ++k) {
    char* cur = send + (k & 1) * r.block_bytes;
    char* next = send + ((k + 1) & 1) * r.block_bytes;
    const char* arrival = r.my_slots + ((k + 1) & 1) * r.block_bytes;
    if (k > 1) wait_flag(&r.me->credit, tag + k - 1);  // the target is free
    stripe.copy(r.right_slots + ((k + 1) & 1) * r.block_bytes, cur);
    arrive(&r.me->send_arrive[k & 1], r.ctas,
           [&] { raise_flag(&r.right->recv, tag + k + 1); });
    produce((r.my_id - k - 2 + 2 * r.n) % r.n, next);
    wait_flag(&r.me->recv, tag + k + 1);  // this step's arrival has landed
    if (k < r.n - 2) {
      stripe.add(next, next, arrival);
      __syncthreads();
    }
    if (k < r.n - 3) {
      // The arrival is folded: the left neighbour may overwrite its slot.
      arrive(&r.me->credit_arrive[k & 1], r.ctas,
             [&] { raise_flag(&r.left->credit, tag + k + 1); });
    }
  }
  finish(r.my_slots + ((r.n - 1) & 1) * r.block_bytes,
         send + ((r.n - 1) & 1) * r.block_bytes);
}

// -- the fold-and-send reduce-scatter ring ------------------------------------
//
// `run_rs_fold_send` is the reduce-scatter of contributions that already
// lie in device memory (the ring collectives' x), with `run_rs_ring`'s
// order of adds but no send buffer: a step reads the arrival and the
// rank's own part of the block once and stores their sum straight into
// the right neighbour's slot. Chunk j starts at rank (j + 1) mod n and is
// complete on rank j, as above. The first arrival needs no copy: it is
// the left neighbour's own part of row-block (r - 2) mod n, which rank r
// reads where it lies. Rank r:
//   * step k = 1 .. n-2: wait (k >= 2) for the arrival of step k - 1, in
//     slot k % 2, and (k >= 3) for one credit; store own part of
//     row-block (r - k - 1) mod n + arrival into the right neighbour's
//     slot (k + 1) % 2; raise its receive flag and, while 2 <= k < n - 2,
//     grant the left neighbour a credit: slot k % 2 has been read;
//   * last: wait (n > 2) for the arrival of step n - 2, in slot
//     (n - 1) % 2, and store arrival + own part of row-block r into
//     `result` (n = 2: the left neighbour's part of row-block r, read in
//     place, + own).
// The credit. The store of step k (k >= 3) reuses the right neighbour's
// slot that this rank filled at step k - 2; the right neighbour read that
// arrival in its own step k - 1, whose grant (tag + k - 1) this step
// waits for. Step 2 writes slot 1 for the first time, so grants come from
// steps 2 .. n-3 and waits from steps 3 .. n-2, and none is left over;
// rings of 2, 3 and 4 neither grant nor wait. One arrival counter serves
// both events of a step (the stores have landed; the arrival has been
// read), and its last arriver raises the right neighbour's receive flag
// and the left one's credit.
//
// Bytes per rank: 3 blocks a step and at the last (two reads, a write),
// 3(n - 1) blocks, against `run_rs_ring`'s 2n + 2(n - 1) + 3(n - 2) + 3
// for the same function. Every CTA owns the same stripe of every buffer,
// by `stripe` (a `ByteStripe`), though no step reads what an earlier step
// of the same rank wrote: every dependency between steps crosses ranks,
// behind a flag. `own` and `left_own` are this rank's and the left
// neighbour's [n][block_bytes] contributions; n >= 2.
template <class Stripe>
__device__ void run_rs_fold_send(const Rank& r, const char* own,
                                 const char* left_own, char* result,
                                 const Stripe& stripe) {
  const unsigned long long tag = r.epoch * kTagSteps;
  const long long bb = r.block_bytes;
  arrive(&r.me->bar_arrive, r.ctas, [&] {
    raise_flag(&r.left->bar_from_right, tag);
    raise_flag(&r.right->bar_from_left, tag);
  });
  wait_flag(&r.me->bar_from_left, tag);
  wait_flag(&r.me->bar_from_right, tag);

  const char* first = left_own + (r.my_id - 2 + 2 * r.n) % r.n * bb;
  for (int k = 1; k < r.n - 1; ++k) {
    if (k > 1) wait_flag(&r.me->recv, tag + k);  // the arrival of step k - 1
    if (k > 2) wait_flag(&r.me->credit, tag + k - 1);  // the target is free
    stripe.add(r.right_slots + ((k + 1) & 1) * bb,
               own + (r.my_id - k - 1 + r.n) % r.n * bb,
               k == 1 ? first : r.my_slots + (k & 1) * bb);
    arrive(&r.me->send_arrive[k & 1], r.ctas, [&] {
      raise_flag(&r.right->recv, tag + k + 1);
      if (k > 1 && k < r.n - 2) raise_flag(&r.left->credit, tag + k);
    });
  }
  if (r.n > 2) wait_flag(&r.me->recv, tag + r.n - 1);
  stripe.add(result, r.n > 2 ? r.my_slots + ((r.n - 1) & 1) * bb : first,
             own + r.my_id * bb);
}

// -- the relay-from-output all-gather ring ------------------------------------

// This CTA's stripe of `bytes` from src into both dst_a and dst_b, each
// unit loaded once: copy_stripe's units and ownership.
template <class Unit = unsigned short>
__device__ __forceinline__ void copy_stripe_twice(char* dst_a, char* dst_b,
                                                  const char* src,
                                                  long long bytes, int cta,
                                                  int ctas) {
  const long long first = static_cast<long long>(cta) * blockDim.x +
                          threadIdx.x;
  const long long stride = static_cast<long long>(ctas) * blockDim.x;
  if (((reinterpret_cast<uintptr_t>(dst_a) |
        reinterpret_cast<uintptr_t>(dst_b) |
        reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes)) &
       15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* a = reinterpret_cast<uint4*>(dst_a);
    uint4* b = reinterpret_cast<uint4*>(dst_b);
    for (long long i = first; i < bytes / 16; i += stride) {
      const uint4 v = __ldcg(s + i);
      __stcg(a + i, v);
      __stcg(b + i, v);
    }
  } else {
    const Unit* s = reinterpret_cast<const Unit*>(src);
    Unit* a = reinterpret_cast<Unit*>(dst_a);
    Unit* b = reinterpret_cast<Unit*>(dst_b);
    const long long units = bytes / static_cast<long long>(sizeof(Unit));
    for (long long i = first; i < units; i += stride) {
      const Unit v = __ldcg(s + i);
      __stcg(a + i, v);
      __stcg(b + i, v);
    }
  }
}

// `run_gather_relay` is the ring all-gather of blocks that end in every
// rank's output: no slots, each block relayed from where it landed, the
// rank's own output. Every output row of every rank is written exactly
// once a call and nothing is overwritten. Rank r, whose blocks travel
// towards `r.dir` (the block of step k is row idx = (r - dir * k) mod n):
//   * step 0: read the own block once and store it twice, into the rank's
//     own row r and into the right neighbour's row r (n = 1: the own row
//     only, and nothing else happens); raise the right neighbour's receive
//     flag to tag + 1;
//   * step k = 1 .. n-2: wait for the receive flag tag + k (row idx has
//     landed), read row idx from the rank's own output and store it into
//     the right neighbour's row idx; raise its receive flag to tag + k + 1;
//   * step n - 1: wait for tag + n - 1, so that the kernel ends with the
//     rank's output complete. Nothing is copied.
// The barrier. Within one card the launch already makes every output
// valid; across cards, where a peer's output may still be in use by that
// peer's earlier work, it is what makes the first remote store safe.
// No credit: no row is written twice, so no store waits for a reader.
// The arrival counters are by step parity, though, and with no credit
// nothing keeps one CTA from running two steps ahead of a slow CTA of its
// own rank (a receive flag is raised by the left neighbour's chain, which
// does not wait for this rank), so that its step-k arrival would count
// towards step k - 2's event. From step 2 on a CTA therefore waits, before
// its stores, until its own rank's step k - 2 has been signalled: the
// right neighbour's receive flag at tag + k - 1, which only this rank
// raises, after the counter's reset. It is released at once unless a CTA
// has fallen two steps behind.
//
// Bytes per rank: 2n - 1 blocks (step 0 a read and two writes, each relay
// a read and a write). `own` is the rank's block; `mine` and `right` are
// row 0 of this rank's and the right neighbour's output at the stream's
// offset, rows `row_bytes` apart, blocks of `r.block_bytes`. `r.local`
// and the slot pointers are not used.
__device__ void run_gather_relay(const Rank& r, const char* own, char* mine,
                                 char* right, long long row_bytes) {
  const unsigned long long tag = r.epoch * kTagSteps;
  const long long bb = r.block_bytes;
  arrive(&r.me->bar_arrive, r.ctas, [&] {
    raise_flag(&r.left->bar_from_right, tag);
    raise_flag(&r.right->bar_from_left, tag);
  });
  wait_flag(&r.me->bar_from_left, tag);
  wait_flag(&r.me->bar_from_right, tag);

  const long long at = r.my_id * row_bytes;
  if (r.n == 1) {
    copy_stripe(mine + at, own, bb, r.cta, r.ctas);
    return;
  }
  copy_stripe_twice(mine + at, right + at, own, bb, r.cta, r.ctas);
  arrive(&r.me->send_arrive[0], r.ctas,
         [&] { raise_flag(&r.right->recv, tag + 1); });
  for (int k = 1; k < r.n - 1; ++k) {
    wait_flag(&r.me->recv, tag + k);  // row idx has landed
    // This rank's step k - 2 has been signalled: its counter is free.
    if (k > 1) wait_flag(&r.right->recv, tag + k - 1);
    const long long row = (r.my_id - r.dir * k + r.n) % r.n * row_bytes;
    copy_stripe(right + row, mine + row, bb, r.cta, r.ctas);
    arrive(&r.me->send_arrive[k & 1], r.ctas,
           [&] { raise_flag(&r.right->recv, tag + k + 1); });
  }
  wait_flag(&r.me->recv, tag + r.n - 1);  // the output is complete
}

// -- the host side ------------------------------------------------------------

// What a ring kernel's launch carries: the ranks' flag words, each rank's
// neighbours, the ring size, the CTAs of one rank (set by launch_ring) and
// the call's epoch.
struct Ring {
  Flags* flags;  // [streams][kMaxRanks]
  int right[kMaxRanks];
  int left[kMaxRanks];
  int n;
  int ctas;  // CTAs of one rank on one stream
  unsigned long long epoch;
};

// Fill `g` from the C arguments; false where they name no ring.
inline bool make_ring(Ring& g, void* flags, const long long* right,
                      const long long* left, int n, int min_n,
                      unsigned long long epoch) {
  if (n < min_n || n > kMaxRanks || epoch < 1) return false;
  g.flags = static_cast<Flags*>(flags);
  g.n = n;
  g.ctas = 1;
  g.epoch = epoch;
  for (int r = 0; r < kMaxRanks; ++r) {
    g.right[r] = r < n ? static_cast<int>(right[r]) : 0;
    g.left[r] = r < n ? static_cast<int>(left[r]) : 0;
    if (g.right[r] < 0 || g.right[r] >= n || g.left[r] < 0 ||
        g.left[r] >= n) {
      return false;
    }
  }
  return true;
}

// The Rank of CTA `cta` of ring `g`'s rank `rank`, whose blocks travel to
// `down` and come from `up` (dir +1: towards higher positions), on the
// flag words `flags` ([n]) and the slots `slots` ([n][2][block_bytes]).
__device__ __forceinline__ Rank make_rank(const Ring& g, int rank, int cta,
                                          int dir, int down, int up,
                                          Flags* flags, char* slots,
                                          long long block_bytes) {
  Rank r;
  r.my_id = rank;
  r.dir = dir;
  r.n = g.n;
  r.ctas = g.ctas;
  r.cta = cta;
  r.epoch = g.epoch;
  r.block_bytes = block_bytes;
  r.local = nullptr;
  r.my_slots = slots + 2 * rank * block_bytes;
  r.right_slots = slots + 2 * down * block_bytes;
  r.me = flags + rank;
  r.left = flags + up;
  r.right = flags + down;
  return r;
}

// The CTAs a rank wants for copies of `block_bytes`.
inline long long ctas_for(long long block_bytes) {
  return (block_bytes + kBytesPerCta - 1) / kBytesPerCta;
}

// What a cooperative launch of `fn` with `smem` bytes of dynamic shared
// memory may use on the current device: its SM count and how many CTAs
// of kThreads threads an SM holds at once. Asked of the card once per
// (kernel, shared memory, device), then kept: the queries (device
// attributes, the occupancy) cost more host time than the launch. The
// kernel's dynamic shared-memory limit is raised to `smem` where the
// last limit set for it on the device is lower, and never lowered, so a
// kept answer for a smaller `smem` stays launchable. One table for the
// process, under a lock: any thread may launch. Returns the CUDA error
// code, 0 on success; cudaErrorNotSupported where the card has no
// cooperative launch.
inline int launch_shape(const void* fn, size_t smem, int& sms,
                        int& per_sm) {
  struct Shape {
    const void* fn;
    size_t smem;
    int dev, sms, per_sm;
  };
  struct Limit {  // the dynamic shared memory last allowed `fn` on `dev`
    const void* fn;
    int dev;
    size_t smem;
  };
  constexpr int kKept = 64;
  static std::mutex lock;
  static Shape shapes[kKept];
  static Limit limits[kKept];
  static int n_shapes = 0, n_limits = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> held(lock);
  if (smem > 0) {
    Limit* limit = nullptr;
    for (int i = 0; i < n_limits && i < kKept; ++i) {
      if (limits[i].fn == fn && limits[i].dev == dev) limit = &limits[i];
    }
    if (limit == nullptr || limit->smem < smem) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (limit == nullptr) limit = &limits[n_limits++ % kKept];
      *limit = Limit{fn, dev, smem};
    }
  }
  for (int i = 0; i < n_shapes && i < kKept; ++i) {
    if (shapes[i].fn == fn && shapes[i].smem == smem &&
        shapes[i].dev == dev) {
      sms = shapes[i].sms;
      per_sm = shapes[i].per_sm;
      return 0;
    }
  }
  int coop = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  shapes[n_shapes++ % kKept] = Shape{fn, smem, dev, sms, per_sm};
  return 0;
}

// One cooperative launch of `groups` x G CTAs of kThreads threads, each
// with `smem` bytes of dynamic shared memory. G is `want`, capped by what
// the card holds at once: all CTAs are co-resident by construction, so a
// spin wait cannot starve the CTA it waits for. G is stored in `ctas`, a
// field of `p`, before the launch copies `p`. Returns the CUDA error code,
// 0 on success.
template <class Params>
int launch_ring(void (*fn)(Params), Params& p, int& ctas, int groups,
                long long want, size_t smem, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const int err = launch_shape(reinterpret_cast<const void*>(fn), smem, sms,
                               per_sm);
  if (err) return err;
  const int room = per_sm * sms / groups;
  if (room < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  ctas = static_cast<int>(want < room ? want : room);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fn), dim3(groups * ctas), dim3(kThreads),
      args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring
