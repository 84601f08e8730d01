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
// 256 threads, G from the block's bytes; each CTA owns one stripe of
// every block (`ring::copy_stripe`: 16-byte units where both ends allow,
// else 2-byte units), so a block is any whole number of 2-byte units.
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
  unsigned long long epoch;
};

__global__ void __launch_bounds__(ring::kThreads)
    all_to_all_kernel(Params p) {
  const int n = p.n;
  const int me = blockIdx.x / p.ctas;
  const int cta = blockIdx.x % p.ctas;
  const long long bb = p.block_bytes;
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
  const char* local = p.x + static_cast<long long>(me) * n * bb;
  for (int k = 0; k < n; ++k) {
    const int dst = (me + k) % n;
    ring::copy_stripe(p.out[dst] + me * bb, local + dst * bb, bb, cta,
                      p.ctas);
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
  for (int r = 0; r < kMaxRanks; ++r) {
    p.out[r] = r < n ? static_cast<char*>(outs[r]) : nullptr;
    if (r < n && p.out[r] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  p.flags = static_cast<A2AFlags*>(flags);
  p.block_bytes = block_bytes;
  p.n = n;
  p.ctas = 1;
  p.epoch = epoch;
  return ring::launch_ring(all_to_all_kernel, p, p.ctas, n,
                           ring::ctas_for(block_bytes), 0,
                           static_cast<cudaStream_t>(stream));
}
