// Kernel D: all-reduce along one axis of a rank mesh, one launch for all the
// rings of the mesh: every rank of the mesh on one card; or ranks on
// several cards of one process, each card launching once over a table whose
// entries for the other cards' inputs point into their memory (read over
// NVLink with peer access); or the ranks of several processes, each process
// launching once over a table whose entries for the other processes' inputs
// are peer pointers (CUDA IPC).
//
// Replaces the TPU kernel stereovision_slam_tpu/parallel/ring_reduce.py
// `_ring_kernel`: a unidirectional ring reduce-scatter (n - 1 hops) then
// all-gather (n - 1 hops) of an (R, 128) float32 payload per rank, over
// inter-chip RDMA into a two-slot mailbox with credit semaphores. The TPU
// hops between neighbours because its links join only neighbours. On one
// card every SM reaches every rank's buffer at L2 or HBM speed, so the hops
// are not replayed: each output element is computed in one pass.
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
// Only additions: `--fmad=false` has nothing to fuse.
//
// What bounds it on an H100: bytes. The function reads each input once and
// writes each output once (8 ranks x 2.5 MB in and out at the sharded BA's
// payload: 0.0118 ms at 3.35 TB/s); it does n - 1 additions per output
// element of a ring, far below the float32 rate. Across processes a launch
// reads every rank of the rings that hold its ranks and writes its own
// ranks only (two processes of 4 ranks at that payload: 8 x 2.5 MB in, 4
// x 2.5 MB out, 0.0089 ms).
//
// Design: an ordinary launch with no communication between blocks (no
// mailbox, flag, spin or memset). Grid (float4 slices, chunks, rings);
// each thread owns kVec float4s of one chunk of one ring, strided by the
// block size so that a warp's 16-byte accesses are contiguous, and issues
// the loads of up to kGroup ranks for all of them before the additions, so
// that kVec * kGroup loads are in flight together. The ranks' base
// pointers come in a kernel-parameter table, not as a base and a stride,
// so ranks in other processes or on other cards need only peer pointers
// (loads over NVLink where the cards differ), not a new kernel. Across
// processes each process writes only its own ranks' outputs: the table's
// output entry of every other rank is null, the store to it is skipped,
// and a block whose ring has no output in the table returns at once. So no
// two processes write the same bytes, and each output element is still the
// one fold above, bit for bit the one-process launch. That check is a
// template flag, set only where the table has a null output: the
// one-process launch keeps the code without it (with the check it took
// 0.0126 ms warm against 0.0123 on an H100 80GB HBM3 at 700 W, by
// tests/torch_kernel_d_times.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;          // float4s per thread
constexpr int kGroup = 8;        // ranks loaded before they are added
constexpr int kMaxRanks = 64;

struct RankTable {
  const float4* x[kMaxRanks];
  float4* out[kMaxRanks];
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
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
        if (live[j]) v[k][j] = __ldg(src + j * kThreads);
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
  if (n < 2 || ring_stride < 1 || n_ranks > kMaxRanks
      || n_ranks % (n * ring_stride) != 0 || chunk4 < 1)
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

// Let `device` read `peer`'s memory (kernel D across cards reads its peers'
// inputs in place). "Already enabled" is success. The caller's current
// device is restored.
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
