// Kernel D: all-reduce along one axis of a rank mesh. Two forms:
//   - the table form (`ring_reduce_launch`), one launch for all the rings of
//     the mesh: every rank on one card; or the ranks of several processes
//     sharing one card, each process launching once over a table whose
//     entries for the other processes' inputs are peer pointers (CUDA IPC);
//   - the owner form (`ring_reduce_owned_launch`), for ranks spread over
//     several cards (in one process, or one process a card): each card
//     launches once over the chunks it owns, reads them from every rank (its
//     peers' over NVLink), and stores each sum into every rank's output (its
//     peers' as remote stores), the cards ordering themselves in the kernel.
//
// Replaces the TPU kernel stereovision_slam_tpu/parallel/ring_reduce.py
// `_ring_kernel`: a unidirectional ring reduce-scatter (n - 1 hops) then
// all-gather (n - 1 hops) of an (R, 128) float32 payload per rank, over
// inter-chip RDMA into a two-slot mailbox with credit semaphores and a
// barrier semaphore. The TPU hops between neighbours because its links join
// only neighbours. On one card every SM reaches every rank's buffer at L2 or
// HBM speed, and NVLink joins every card of a host to every other, so the
// hops are not replayed: each output element is computed in one pass.
//
// Function (bit-equal to the reference's ring): take one ring (one
// combination of the other mesh axes), rank(q) its rank at ring position q,
// chunk c the rows [c * R / n, (c + 1) * R / n) of each rank's payload and i
// a float4 index in it. Then
//     acc = x[rank(c)][c][i];
//     for k = 1 .. n - 1: acc = acc + x[rank((c + k) mod n)][c][i];
//     for q = 0 .. n - 1: out[rank(q)][c][i] = acc;
// which is the left fold the reduce-scatter performs on chunk c (it starts
// at ring position c and every hop adds the next rank's chunk, own +
// incoming; IEEE addition commutes), followed by the all-gather's copies.
// Only additions: `--fmad=false` has nothing to fuse. Both forms run this
// fold (`fold_store`), so they agree bit for bit.
//
// What bounds it on an H100: bytes. On one card the function reads each
// input once and writes each output once (8 ranks x 2.5 MB in and out at the
// sharded BA's payload: 0.0118 ms at 3.35 TB/s); it does n - 1 additions
// per output element of a ring, far below the float32 rate. Across cards,
// NVLink: an all-reduce that adds at the end points moves at least
// 2 (M - 1) / M of a rank into and out of each of a ring's M cards (a
// reduce-scatter and an all-gather); at 4 cards of one rank each that is
// 3.71 MB each way at the sharded BA's payload, 0.0082 ms at 450 GB/s.
//
// Table form: an ordinary launch with no communication between blocks (no
// mailbox, flag, spin or memset). Grid (float4 slices, chunks, rings); each
// thread owns kVec float4s of one chunk of one ring, strided by the block
// size so that a warp's 16-byte accesses are contiguous, and issues the
// loads of up to kGroup ranks for all of them before the additions, so that
// kVec * kGroup loads are in flight together. The ranks' base pointers come
// in a kernel-parameter table, not as a base and a stride, so ranks in other
// processes need only peer pointers, not a new kernel. Across processes on
// one card each process writes only its own ranks' outputs: the table's
// output entry of every other rank is null, the store to it is skipped, and
// a block whose ring has no output in the table returns at once. That check
// is a template flag, set only where the table has a null output: the
// one-process launch keeps the code without it (with the check it took
// 0.0126 ms warm against 0.0123 on an H100 80GB HBM3 at 700 W, by
// tests/torch_kernel_d_times.py). The processes sharing the card order
// themselves on the host (contexts on one card are time-sliced, so a kernel
// that spun for a peer could wait a whole time slice).
//
// Owner form: chunk c of a ring is owned by the card that holds the ring's
// rank at position c (the TPU kernel's reduce-scatter placement, up to a
// rotation); a card holding several ranks of a ring owns all their
// positions. Grid (float4 slices, chunks this card owns). A block folds its
// chunk from every rank and stores the sum into that chunk of every rank's
// output: the reduce-scatter is loads of the peers' chunks, the all-gather
// posted stores, and each card moves 2 (n - 1) / n of a rank each way at one
// rank a card (against (n - 1) whole ranks read into each card when every
// card folded every chunk of its own ranks). Each output element is written
// once, by its chunk's owner. With one owner of every chunk it runs the
// table form's blocks and fold; the table form stays for the one-card launch
// and for processes sharing a card (its null outputs), and chip_smoke phase
// 10 times the two kernels against each other.
//
// The handshake that orders the cards (the TPU kernel's barrier and credit
// semaphores): every card has a flag block of 2 kMaxCards + 1 64-bit words:
// slot j of `arrived` and of `done` for card j of the set, and a block
// counter. The host passes an epoch that grows by one every call, so no flag
// is reset. Every block first stores "arrived at e" into every peer's slot for
// its card (a release store at system scope; idempotent, so blocks need not be
// co-resident), then spins (acquire loads of its own flag block) until every
// peer arrived at e. A peer's kernel starts only after the earlier work of its
// stream, so its arrival means its inputs are written and its outputs
// allocated and free to be written. After its stores every thread fences at
// system scope, and the block's first thread counts the block on the card's
// counter; the last block stores "done e" into every peer and spins until
// every peer is done e. So the launch ends only when no peer will read this
// card's inputs or write its outputs again in this call, and the next work of
// its stream (the caller rewriting an input, reusing an output's memory) is
// safe. Every spin gives up after `timeout_ns` of the card's global timer
// (the host's SPIN_TIMEOUT_S, 30 s) with `__trap()`: a peer that never
// launched makes the next synchronize raise instead of hanging the card. The
// bound detects a dead peer; it is not a latency budget, so processes may
// reach a call up to that far apart (one still building the library, or busy
// on its host). With no flag block (the owner form on one card, launched
// once per owner in turn on one stream) the handshake is compiled out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;          // float4s per thread
constexpr int kGroup = 8;        // ranks loaded before they are added
constexpr int kMaxRanks = 64;
constexpr int kMaxCards = 16;
// flag block: arrived[kMaxCards], done[kMaxCards], the block counter
constexpr int kArrived = 0;
constexpr int kDone = kMaxCards;
constexpr int kCounter = 2 * kMaxCards;

struct RankTable {
  const float4* x[kMaxRanks];
  float4* out[kMaxRanks];
};

// One card's launch of the owner form; `flags[j]` is card j's flag block as
// this card addresses it (null on one card: no handshake). The layout is
// parallel/ring_reduce.py's `_OwnedTable`.
struct OwnedTable {
  const float4* x[kMaxRanks];
  float4* out[kMaxRanks];
  unsigned long long* flags[kMaxCards];
  int owned[kMaxRanks];          // ring * n + c of each chunk this card owns
  int n_owned;
  int me;                        // this card's index in the set
  int n_cards;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until every peer's slot of `slots` (this card's own flag block)
// reached `epoch`; trap after `timeout_ns`.
__device__ void wait_for_peers(const unsigned long long* slots, int n_cards,
                               int me, unsigned long long epoch,
                               unsigned long long timeout_ns) {
  const unsigned long long start = global_ns();
  for (int j = 0; j < n_cards; ++j) {
    if (j == me) continue;
    while (load_acquire(slots + j) < epoch) {
      if (global_ns() - start > timeout_ns) __trap();
      __nanosleep(64);
    }
  }
}

// The fold of chunk c of the ring whose rank at position q is
// base + q * ring_stride, stored into every rank's output (kPartial: null
// outputs skipped). kLdg: the inputs go through the read-only cache, for
// launches whose inputs no other card or process writes while they run.
template <bool kPartial, bool kLdg, class Table>
__device__ __forceinline__ void fold_store(const Table& t, int n,
                                           int ring_stride, int base, int c,
                                           int chunk4) {
  const size_t off = (size_t)c * chunk4;
  const int i0 = blockIdx.x * (kThreads * kVec) + threadIdx.x;
  bool live[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) live[j] = i0 + j * kThreads < chunk4;

  float4 acc[kVec] = {};
  for (int k0 = 0; k0 < n; k0 += kGroup) {
    float4 v[kGroup][kVec];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k0 + k >= n) break;
      int q = c + k0 + k;
      q = q >= n ? q - n : q;
      const float4* src = t.x[base + q * ring_stride] + off + i0;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (live[j]) v[k][j] = kLdg ? __ldg(src + j * kThreads)
                                    : src[j * kThreads];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k0 + k >= n) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = (k0 + k == 0) ? v[k][j] : add4(acc[j], v[k][j]);
    }
  }
  for (int q = 0; q < n; ++q) {
    if (kPartial && t.out[base + q * ring_stride] == nullptr) continue;
    float4* dst = t.out[base + q * ring_stride] + off + i0;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (live[j]) dst[j * kThreads] = acc[j];
  }
}

template <bool kPartial>
__global__ void __launch_bounds__(kThreads)
ring_reduce_kernel(const RankTable t, int n, int ring_stride, int chunk4) {
  const int c = blockIdx.y;
  const int ring = blockIdx.z;
  // rank(q) = base + q * ring_stride: the ring axis varies, the others fixed
  const int base = (ring / ring_stride) * (n * ring_stride) + ring % ring_stride;
  if (kPartial) {
    bool mine = false;
    for (int q = 0; q < n; ++q)
      mine |= t.out[base + q * ring_stride] != nullptr;
    if (!mine) return;
  }
  fold_store<kPartial, true>(t, n, ring_stride, base, c, chunk4);
}

template <bool kHandshake>
__global__ void __launch_bounds__(kThreads)
ring_owned_kernel(const OwnedTable t, int n, int ring_stride, int chunk4,
                  unsigned long long epoch, unsigned long long timeout_ns) {
  unsigned long long* const own = t.flags[t.me];
  if (kHandshake) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < t.n_cards; ++j)
        if (j != t.me) store_release(t.flags[j] + kArrived + t.me, epoch);
      wait_for_peers(own + kArrived, t.n_cards, t.me, epoch, timeout_ns);
    }
    __syncthreads();
  }
  const int id = t.owned[blockIdx.y];
  const int ring = id / n;
  const int c = id - ring * n;
  const int base = (ring / ring_stride) * (n * ring_stride) + ring % ring_stride;
  fold_store<false, !kHandshake>(t, n, ring_stride, base, c, chunk4);
  if (kHandshake) {
    __threadfence_system();      // this thread's stores, before the count
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long blocks =
          (unsigned long long)gridDim.x * gridDim.y;
      if (atomicAdd(own + kCounter, 1ull) == blocks - 1) {
        atomicExch(own + kCounter, 0ull);
        __threadfence_system();
        for (int j = 0; j < t.n_cards; ++j)
          if (j != t.me) store_release(t.flags[j] + kDone + t.me, epoch);
        wait_for_peers(own + kDone, t.n_cards, t.me, epoch, timeout_ns);
      }
    }
  }
}

bool bad_ring(int n_ranks, int n, int ring_stride, int chunk4) {
  return n < 2 || ring_stride < 1 || n_ranks < 1 || n_ranks > kMaxRanks
      || n_ranks % (n * ring_stride) != 0 || chunk4 < 1;
}

}  // namespace

// x_ptrs, out_ptrs: n_ranks device addresses of (n * chunk4) float4s each,
// 16-byte aligned, in the mesh's row-major rank order; the ring runs along
// the axis of stride `ring_stride` and size n. An output address of 0 is a
// rank whose output another process writes; the inputs of a ring with an
// output in the table must all be given.
extern "C" int ring_reduce_launch(const unsigned long long* x_ptrs,
                                  const unsigned long long* out_ptrs,
                                  int n_ranks, int n, int ring_stride,
                                  int chunk4, void* stream) {
  if (bad_ring(n_ranks, n, ring_stride, chunk4))
    return (int)cudaErrorInvalidValue;
  RankTable t;
  bool partial = false;
  for (int r = 0; r < n_ranks; ++r) {
    t.x[r] = reinterpret_cast<const float4*>(x_ptrs[r]);
    t.out[r] = reinterpret_cast<float4*>(out_ptrs[r]);
    partial |= out_ptrs[r] == 0;
  }
  const dim3 grid((chunk4 + kThreads * kVec - 1) / (kThreads * kVec), n,
                  n_ranks / n);
  if (partial)
    ring_reduce_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        t, n, ring_stride, chunk4);
  else
    ring_reduce_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        t, n, ring_stride, chunk4);
  return (int)cudaGetLastError();
}

// Launches of the owner form, one a card, in one call: tables[i] (the
// address of an `OwnedTable`, its `out` entries ignored) on device
// devices[i] and stream streams[i], all with the outputs out_ptrs (every
// rank's, as this process addresses them). A table holds every rank's input
// as its card addresses it, the chunks that card owns and every card's flag
// block; with flags[me] null the launch runs without the handshake (every
// rank on one card, the owners launched in turn on one stream). `epoch`
// must grow by one every call of the set; a spin for a peer traps after
// `timeout_ns`. The caller's current device is restored.
extern "C" int ring_reduce_owned_launch(const unsigned long long* tables,
                                        const int* devices,
                                        const unsigned long long* streams,
                                        int n_launch,
                                        const unsigned long long* out_ptrs,
                                        int n_ranks, int n, int ring_stride,
                                        int chunk4, unsigned long long epoch,
                                        unsigned long long timeout_ns) {
  if (bad_ring(n_ranks, n, ring_stride, chunk4) || n_launch < 1
      || n_launch > kMaxCards)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_ranks; ++r)
    if (out_ptrs[r] == 0) return (int)cudaErrorInvalidValue;
  // every table checked before the first launch: a launch whose peer is
  // then refused would spin until it traps
  OwnedTable ts[kMaxCards];
  for (int i = 0; i < n_launch; ++i) {
    OwnedTable& t = ts[i];
    t = *reinterpret_cast<const OwnedTable*>(tables[i]);
    if (t.n_owned < 1 || t.n_owned > n_ranks || t.n_cards < 1
        || t.n_cards > kMaxCards || t.me < 0 || t.me >= t.n_cards)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < t.n_owned; ++j)
      if (t.owned[j] < 0 || t.owned[j] >= n_ranks)
        return (int)cudaErrorInvalidValue;
    for (int r = 0; r < n_ranks; ++r) {
      if (t.x[r] == nullptr) return (int)cudaErrorInvalidValue;
      t.out[r] = reinterpret_cast<float4*>(out_ptrs[r]);
    }
    if (t.flags[t.me] != nullptr) {
      if (t.n_cards < 2 || epoch == 0 || timeout_ns == 0)
        return (int)cudaErrorInvalidValue;
      for (int j = 0; j < t.n_cards; ++j)
        if (t.flags[j] == nullptr) return (int)cudaErrorInvalidValue;
    }
  }
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < n_launch && e == cudaSuccess; ++i) {
    e = cudaSetDevice(devices[i]);
    if (e != cudaSuccess) break;
    const dim3 grid((chunk4 + kThreads * kVec - 1) / (kThreads * kVec),
                    ts[i].n_owned);
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(streams[i]);
    if (ts[i].flags[ts[i].me] != nullptr)
      ring_owned_kernel<true><<<grid, kThreads, 0, stream>>>(
          ts[i], n, ring_stride, chunk4, epoch, timeout_ns);
    else
      ring_owned_kernel<false><<<grid, kThreads, 0, stream>>>(
          ts[i], n, ring_stride, chunk4, epoch, timeout_ns);
    e = cudaGetLastError();
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}

// Let `device` read `peer`'s memory (kernel D across cards reads its peers'
// inputs in place and stores into their outputs). "Already enabled" is
// success. The caller's current device is restored.
extern "C" int ring_reduce_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();   // clear it: it is not a failure here
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}
