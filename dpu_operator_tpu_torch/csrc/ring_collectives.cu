// The ring collectives of the fabric probe for Hopper (sm_90a): one-way
// and bidirectional ring all-gather and the ring reduce-scatter (sum).
//
// Replaces, in parallel/ring_probe.py of the JAX package, `_ring_kernel`
// (`_pallas_all_gather`), `_ring_kernel_bidir`
// (`_pallas_all_gather_bidir`) and `_rs_kernel`
// (`_pallas_reduce_scatter`). The protocols are `ring_stream.cuh`'s; this
// file holds the kernels' entry code and the C entry points.
//
// All-gather. Rank r owns rows r * chunk .. of x [n * chunk, width] and
// ends with a copy of all of x: `run_gather_relay`, which writes every
// row of every rank's output once, in place, and relays each block from
// where it landed in the rank's own output. No slots and no credits: the
// wrapper allocates nothing but the output. The bidirectional form is two
// such streams in one launch, each with its own flag words: half of a
// rank's CTAs carry the top half of every chunk towards higher positions,
// the other half carry the bottom half the other way (`Rank::dir = -1`,
// the neighbours swapped), so a block arrives after at most n - 1 hops of
// half the bytes each way. Each stream writes its half of the rank's own
// chunk at step 0, so the own chunk reaches the output whole.
//
// Reduce-scatter. Rank r contributes x_r [n * chunk, width] and ends with
// the sum over ranks of row-block r: `run_rs_fold_send`, whose every step
// reads the arrival and x_r's row-block once and stores their sum straight
// into the right neighbour's slot (the first arrival is the left
// neighbour's row-block, read from its x), on the byte stripes of
// `ring::ByteStripe`. The adds run in the payload's own type
// (`ring::SumF32`, `SumBF16`, `SumF16`, `SumI32`), in the ring's order
// (own + arrival; the last hop arrival + own), rounding at every hop: the
// order of `run_rs_ring`, so the bits of the plain version.
//
// Layout. One cooperative launch (`ring::launch_ring`) holds every rank:
// n x streams x G CTAs of 256 threads, all resident at once (the
// occupancy query decides; the
// kernels use no shared memory, so the card holds many), G chosen so
// that a thread moves about four 16-byte units of a block. A rank's CTAs
// stripe every copy and every add between them.
//
// What bounds them: bytes. The function itself reads x once and writes
// each rank's result once: at the probe's 16 MiB and n = 8, the
// all-gather reads 16 MiB and writes 128 MiB, the reduce-scatter reads
// 128 MiB and writes 16 MiB, 0.0451 ms each at the H100's 3.35 TB/s. The
// protocols move more. The all-gather reads a block once and writes it
// twice at step 0, then relays n - 2 blocks, a read and a write each:
// 2n - 1 blocks a rank, 240 MiB at 2 MiB blocks and n = 8
// (`run_ring_stream` with a consumer that copied each block out, both
// through the neighbour's slots and into the output, moved 2(2n - 1),
// 480 MiB). The reduce-scatter reads two blocks and writes one, n - 1
// times: 3(n - 1) blocks a rank, 336 MiB (`run_rs_ring`, with a send
// buffer filled by a copy, a separate send and an in-place fold, moved
// 816 MiB; a first step that copied the own block into the neighbour's
// slot instead of letting the neighbour read it in place, 368 MiB). With
// all ranks on one card these are copies within that card's memory: the
// kernels' time measures the protocol and the copies, not a link. Still
// to do: bulk (TMA) copies; flags per CTA, so that CTA c waits only for
// the stripe it relays and not for the neighbour's whole block; fewer
// hops for the reduce-scatter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_stream.cuh"

namespace {

using ring::Ring;
using ring::kMaxRanks;
using ring::kThreads;

struct GatherParams {
  Ring ring;
  const char* x;  // [n * chunk, width]: rank r's shard at r * chunk_bytes
  char* out;      // [n][n * chunk, width]: every rank's gathered copy
  int streams;    // 1: one way; 2: the halves of every chunk, one each way
  long long chunk_bytes;
};

struct ScatterParams {
  Ring ring;
  const char* x;  // [n][n * chunk, width]: rank r's contribution
  char* out;      // [n * chunk, width]: rank r's sum at r * block_bytes
  char* slots;    // [n][2][block_bytes], written by the left neighbour
  long long block_bytes;
};

__global__ void __launch_bounds__(kThreads)
    ring_all_gather_kernel(GatherParams p) {
  const Ring& g = p.ring;
  const int per_rank = p.streams * g.ctas;
  const int rank = blockIdx.x / per_rank;
  const int stream = blockIdx.x % per_rank / g.ctas;
  const int cta = blockIdx.x % g.ctas;
  const long long block_bytes = p.chunk_bytes / p.streams;
  const long long half = stream * block_bytes;
  const bool up_ring = stream == 0;
  const int down = up_ring ? g.right[rank] : g.left[rank];
  ring::Rank r = ring::make_rank(
      g, rank, cta, up_ring ? 1 : -1, down,
      up_ring ? g.left[rank] : g.right[rank], g.flags + stream * kMaxRanks,
      p.out, block_bytes);
  r.my_slots = r.right_slots = nullptr;  // the relay has no slots
  const long long rank_bytes = g.n * p.chunk_bytes;
  ring::run_gather_relay(r, p.x + rank * p.chunk_bytes + half,
                         p.out + rank * rank_bytes + half,
                         p.out + down * rank_bytes + half, p.chunk_bytes);
}

template <class Sum>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(ScatterParams p) {
  const Ring& g = p.ring;
  const int rank = blockIdx.x / g.ctas;
  const int cta = blockIdx.x % g.ctas;
  const long long bb = p.block_bytes;
  const ring::Rank r = ring::make_rank(g, rank, cta, 1, g.right[rank],
                                       g.left[rank], g.flags, p.slots, bb);
  ring::run_rs_fold_send(r, p.x + rank * g.n * bb,
                         p.x + g.left[rank] * g.n * bb, p.out + rank * bb,
                         ring::ByteStripe<Sum>{bb, cta, g.ctas});
}

template <class Sum>
int launch_scatter(ScatterParams& p, cudaStream_t stream) {
  return ring::launch_ring(ring_reduce_scatter_kernel<Sum>, p, p.ring.ctas,
                           p.ring.n, ring::ctas_for(p.block_bytes), 0,
                           stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error
// code of the launch, 0 on success; launches on `stream` and does not
// synchronize. The caller checks types, shapes, contiguity and that
// every base pointer is 16-byte aligned. flags points at 2 x 8
// ring::Flags that live across calls (zeroed once); epoch grows by at
// least one from one call to the next on the same flags. right[r] and
// left[r] are rank r's neighbours on the ring.

// x [n * chunk, width] of any type, chunk_bytes the bytes of one rank's
// shard (even; a multiple of 4 when bidirectional, so that each half is
// even too); out [n][n * chunk, width] gets every rank's gathered copy.
extern "C" int ring_all_gather_launch(const void* x, void* out, void* flags,
                                      const long long* right,
                                      const long long* left, int n,
                                      long long chunk_bytes,
                                      int bidirectional,
                                      unsigned long long epoch,
                                      void* stream) {
  GatherParams p;
  const int streams = bidirectional ? 2 : 1;
  if (!ring::make_ring(p.ring, flags, right, left, n, 1, epoch) ||
      chunk_bytes < 2 * streams || chunk_bytes % (2 * streams)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const char*>(x);
  p.out = static_cast<char*>(out);
  p.streams = streams;
  p.chunk_bytes = chunk_bytes;
  return ring::launch_ring(ring_all_gather_kernel, p, p.ring.ctas,
                           n * streams,
                           ring::ctas_for(chunk_bytes / streams), 0,
                           static_cast<cudaStream_t>(stream));
}

// x [n][n * chunk, width], rank r's contribution at r * n * block_bytes,
// block_bytes the bytes of one [chunk, width] row-block; out
// [n * chunk, width] gets rank r's sum at r * block_bytes; slots is
// scratch of 2 * n * block_bytes. dtype: 0 f32, 1 bf16, 2 f16, 3 int32.
// n >= 2: a ring of one is the identity and the caller's.
extern "C" int ring_reduce_scatter_launch(const void* x, void* out,
                                          void* slots, void* flags,
                                          const long long* right,
                                          const long long* left, int n,
                                          long long block_bytes, int dtype,
                                          unsigned long long epoch,
                                          void* stream) {
  ScatterParams p;
  const long long item = dtype == 1 || dtype == 2 ? 2 : 4;
  if (!ring::make_ring(p.ring, flags, right, left, n, 2, epoch) ||
      dtype < 0 || dtype > 3 || block_bytes < item || block_bytes % item) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const char*>(x);
  p.out = static_cast<char*>(out);
  p.slots = static_cast<char*>(slots);
  p.block_bytes = block_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_scatter<ring::SumF32>(p, st);
    case 1:
      return launch_scatter<ring::SumBF16>(p, st);
    case 2:
      return launch_scatter<ring::SumF16>(p, st);
    default:
      return launch_scatter<ring::SumI32>(p, st);
  }
}
