// The all-to-all over one mesh axis for Hopper (sm_90a).
//
// Replaces parallel/ring_probe.py `_a2a_kernel` (`_pallas_all_to_all`) of
// the JAX package: each of n ranks holds [n * chunk, width], n blocks of
// `chunk` rows; rank s's block r goes to rank r's output block s. It is
// the exchange behind Ulysses attention (four launches per call) and the
// probe's `make_all_to_all`.
//
// No ring, no slots and no credits: every write lands in its own region
// of a peer's output, indexed by the SOURCE rank, so nothing is reused
// within a call. Per rank, as in the reference:
//   1. an entry barrier over all n ranks: the rank's CTAs arrive
//      (`ring::arrive`); the last raises this rank's `entered` word on
//      every peer; every CTA waits until each of its n - 1 peers'
//      `entered` words holds this call's tag (a peer may store into this
//      rank's output only once the rank has entered);
//   2. the own block to the own output at rows my_id * chunk, then the
//      n - 1 stores of block dst into rank dst's output at rows
//      my_id * chunk, dst = (my_id + k) mod n for k = 1 .. n - 1, all
//      started before any wait;
//   3. completion: stores, __syncthreads(), __threadfence(), the rank's
//      arrival; the last arriver raises this rank's `landed` word on every
//      peer, and every CTA waits until its n - 1 peers have landed before
//      it exits. On one card the end of the launch already implies this;
//      it is the reference's contract, and what a launch across cards
//      needs.
//
// Flags. One tagged 64-bit word per source rank and event (`A2AFlags`),
// raised with atomicMax to `epoch * ring::kTagSteps`: a word only grows,
// so a word left by an earlier call, at any n, can never release a wait
// of this one. (A shared counter of n - 1 arrivals would break the first
// time two calls on the same words used different n.) The words are the
// all-to-all's own, not the rings' `ring::Flags`; their size per rank is
// exported (`all_to_all_flag_words`) and checked by the caller.
//
// Layout. One cooperative launch (`ring::launch_ring`) of n x G CTAs of
// 256 threads, G from the card: the n ranks' CTAs fill two CTAs an SM
// (fewer where a block has fewer units than a rank's threads). Each CTA
// owns one stripe of every block: 16-byte units where every base and the
// block allow, else 2-byte units, so a block is any whole number of
// 2-byte units. The copy is the all-to-all's own (`exchange_stripe`):
// for each unit of its stripe a thread first loads that unit of all n
// blocks into registers, then stores them in the order above, so n
// loads are in flight a thread and no load waits behind a store.
// Output pointers are per rank (`Params::out[r]`): across cards only
// where they come from changes (CUDA IPC or symmetric memory).
//
// What bounds it: bytes. The function reads each block once and writes it
// once, 2 x the payload over the card's memory rate; the kernel moves
// exactly that, plus 2 (n - 1) flag words a rank. With all ranks on one
// card every store is a copy within its memory, not a link. Still to do:
// bulk (TMA) copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_stream.cuh"

namespace {

using ring::kMaxRanks;

// One rank's control words, in device memory that lives across calls
// (zeroed once). entered[s] and landed[s] are raised by rank s; the
// arrival counters are this rank's own and are back at 0 after a call.
struct alignas(128) A2AFlags {
  unsigned long long entered[kMaxRanks];  // rank s has entered this call
  unsigned long long landed[kMaxRanks];   // rank s's block is in my output
  unsigned int enter_arrive;
  unsigned int land_arrive;
};

struct Params {
  const char* x;            // [n][n][block_bytes]: rank r's shard, its blocks
  char* out[kMaxRanks];     // rank r's output, [n][block_bytes]
  A2AFlags* flags;          // [n]
  long long block_bytes;
  int n;
  int ctas;                 // CTAs of one rank
  int wide;                 // 16-byte units (else 2-byte ones)
  unsigned long long epoch;
};

// This CTA's stripe of every block of rank `me`: unit i (of `Unit`) of
// block dst goes to rank dst's output at block `me`. Unit i belongs to
// thread i % kThreads of CTA (i / kThreads) % ctas. For each of its
// units a thread loads the unit of all n blocks, own block first, and
// then stores them in the same order. Sources are read through L2 only.
template <class Unit>
__device__ __forceinline__ void exchange_stripe(const Params& p, int me,
                                                int cta) {
  const int n = p.n;
  const long long units = p.block_bytes / static_cast<long long>(sizeof(Unit));
  const Unit* src = reinterpret_cast<const Unit*>(p.x) + me * n * units;
  // Both ends of the k-th copy in registers: the output array indexed by
  // a rank known only at run time would go through local memory.
  const Unit* from[kMaxRanks];
  Unit* to[kMaxRanks];
#pragma unroll
  for (int k = 0; k < kMaxRanks; ++k) {
    const int dst = (me + k) % n;
    char* out = p.out[0];
#pragma unroll
    for (int r = 1; r < kMaxRanks; ++r) {
      if (r == dst) out = p.out[r];
    }
    from[k] = src + dst * units;
    to[k] = reinterpret_cast<Unit*>(out) + me * units;
  }
  const long long stride = static_cast<long long>(p.ctas) * blockDim.x;
  for (long long i = static_cast<long long>(cta) * blockDim.x + threadIdx.x;
       i < units; i += stride) {
    Unit v[kMaxRanks];
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      if (k < n) v[k] = __ldcg(from[k] + i);
    }
#pragma unroll
    for (int k = 0; k < kMaxRanks; ++k) {
      if (k < n) __stcg(to[k] + i, v[k]);
    }
  }
}

__global__ void __launch_bounds__(ring::kThreads)
    all_to_all_kernel(Params p) {
  const int n = p.n;
  const int me = blockIdx.x / p.ctas;
  const int cta = blockIdx.x % p.ctas;
  const unsigned long long tag = p.epoch * ring::kTagSteps;
  A2AFlags* mine = p.flags + me;

  // 1. Every peer has entered.
  ring::arrive(&mine->enter_arrive, p.ctas, [&] {
    for (int k = 1; k < n; ++k) {
      ring::raise_flag(&p.flags[(me + k) % n].entered[me], tag);
    }
  });
  for (int k = 1; k < n; ++k) {
    ring::wait_flag(&mine->entered[(me + k) % n], tag);
  }

  // 2. The own block, then every peer's, before any wait.
  if (p.wide) {
    exchange_stripe<uint4>(p, me, cta);
  } else {
    exchange_stripe<unsigned short>(p, me, cta);
  }

  // 3. Every peer's block has landed here.
  ring::arrive(&mine->land_arrive, p.ctas, [&] {
    for (int k = 1; k < n; ++k) {
      ring::raise_flag(&p.flags[(me + k) % n].landed[me], tag);
    }
  });
  for (int k = 1; k < n; ++k) {
    ring::wait_flag(&mine->landed[(me + k) % n], tag);
  }
}

}  // namespace

// The 64-bit words of one rank's A2AFlags: the caller allocates n of them.
extern "C" int all_to_all_flag_words() {
  return static_cast<int>(sizeof(A2AFlags) / sizeof(unsigned long long));
}

// Plain C entry point (bound with ctypes). Returns the CUDA error code of
// the launch, 0 on success; launches on `stream` and does not synchronize.
// x [n][n * chunk, width] of any type, rank r's shard at
// r * n * block_bytes and its block j at + j * block_bytes, block_bytes
// the bytes of one [chunk, width] block (even); outs[r] is rank r's
// output [n * chunk, width], whose block s gets rank s's block r. The
// caller checks types, shapes and contiguity, and gives 16-byte-aligned
// bases where it wants 16-byte copies. flags points at n A2AFlags that
// live across calls (zeroed once); epoch grows by at least one from one
// call to the next on the same flags.
extern "C" int all_to_all_launch(const void* x, void* const* outs,
                                 void* flags, int n, long long block_bytes,
                                 unsigned long long epoch, void* stream) {
  if (n < 1 || n > kMaxRanks || block_bytes < 2 || block_bytes % 2 ||
      epoch < 1 || x == nullptr || flags == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const char*>(x);
  uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                    static_cast<uintptr_t>(block_bytes);
  for (int r = 0; r < kMaxRanks; ++r) {
    p.out[r] = r < n ? static_cast<char*>(outs[r]) : nullptr;
    if (r < n && p.out[r] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bases |= reinterpret_cast<uintptr_t>(p.out[r]);
  }
  p.flags = static_cast<A2AFlags*>(flags);
  p.block_bytes = block_bytes;
  p.n = n;
  p.ctas = 1;
  p.wide = (bases & 15) == 0;
  p.epoch = epoch;
  int sms = 0, per_sm = 0;
  const int err = ring::launch_shape(
      reinterpret_cast<const void*>(all_to_all_kernel), 0, sms, per_sm);
  if (err) return err;
  // Two CTAs an SM over all ranks, and no CTA without a unit to move.
  const long long units = block_bytes / (p.wide ? 16 : 2);
  const long long busy = (units + ring::kThreads - 1) / ring::kThreads;
  const long long fill = 2 * sms / n > 1 ? 2 * sms / n : 1;
  return ring::launch_ring(all_to_all_kernel, p, p.ctas, n,
                           busy < fill ? busy : fill, 0,
                           static_cast<cudaStream_t>(stream));
}
