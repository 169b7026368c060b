// Kernel D: ring all-reduce along one axis of a rank mesh, every rank of
// the mesh on one card, one launch for all the rings of the mesh.
//
// Replaces the TPU kernel stereovision_slam_tpu/parallel/ring_reduce.py
// `_ring_kernel`: a unidirectional ring reduce-scatter (n - 1 hops) then
// all-gather (n - 1 hops) of an (R, 128) float32 payload per rank, over
// inter-chip RDMA into a two-slot mailbox, with credit semaphores for flow
// control. Here a rank is a row of blocks of this launch and the RDMA is a
// store into the right neighbour's mailbox in device memory; the semaphores
// become flags and credit counters read with acquire and written with
// release at GPU scope. The device code is written per rank over a table of
// mailboxes, so ranks on several cards would need peer pointers, not a new
// kernel.
//
// Schedule (that of the TPU kernel, so every element is summed in the same
// order and the result equals the plain version bit for bit): hop g uses
// mailbox slot g % 2. Reduce-scatter step s = g sends chunk (me - s) mod n
// and folds chunk (me - s - 1) mod n as own + incoming; all-gather step
// s = g - (n - 1) sends chunk (me + 1 - s) mod n and replaces chunk
// (me - s) mod n. Only additions: `--fmad=false` has nothing to fuse.
//
// What bounds it on an H100: bytes and latency. Each hop reads a chunk
// (R / n rows) of the rank's output, writes it into the neighbour's
// mailbox, and the neighbour reads the mailbox and read-modify-writes its
// owned chunk: about 5 chunk-sized transfers per hop and rank, 2(n - 1)
// hops, where the function itself needs each input read once and each
// output written once (the bound chip_smoke.py reports). At the sharded
// BA's payload (8 ranks x 2.5 MB) that traffic stays in the 50 MB L2;
// each hop also waits one flag round trip through L2 (a few microseconds).
//
// Design:
//  * grid (blocks_per_rank, n_ranks), 256 threads; block j of rank r owns
//    float4 slice j of every chunk, with its own mailbox flags per
//    (rank, block, slot) and its own credit counter, so no block waits on
//    another block of its rank; the slice is walked with 16-byte accesses;
//  * the blocks spin on flags that other blocks set, so all of them must be
//    resident at once: the launch is cooperative, which CUDA refuses
//    rather than run a grid that does not fit;
//  * sender: all threads store the slice into the right neighbour's slot
//    (st.cg), __syncthreads, then thread 0 fences and release-stores the
//    slot's flag = g + 1. Receiver: thread 0 acquire-spins until its flag
//    reaches g + 1, fences, __syncthreads, and the threads read the mailbox
//    with ld.cg (L2; L1 is not coherent across SMs). After the fold
//    __syncthreads, and thread 0 fences and adds one credit to its left
//    neighbour, which waits for g - 1 credits before reusing a slot at hop
//    g >= 2;
//  * flags and credits count up from 0 within a launch and are zeroed by a
//    stream-ordered memset before each launch, so nothing leaks from one
//    call into the next. That also makes the TPU kernel's neighbour barrier
//    unnecessary: the mailboxes exist before the launch, and a receiver
//    reads a slot only after its flag says it is full. The final credit
//    drain is not needed either: the launch ends when every block has;
//  * every spin is bounded (about 1 s of clock64 cycles): on timeout the
//    block writes an error word and returns, its neighbours then time out
//    as well, and the wrapper raises on the word. A protocol bug fails the
//    run instead of hanging it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSpinLimit = 2000000000LL;  // clock64 cycles, ~1 s

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int wrap(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// Thread 0 waits until *p >= want; every thread gets false on a timeout,
// after `code` went into the error word.
__device__ bool wait_at_least(const int* p, int want, int* err, int code) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int good = 1;
    const long long t0 = clock64();
    while (ld_acquire(p) < want) {
      if (clock64() - t0 > kSpinLimit) {
        atomicCAS(err, 0, code);
        good = 0;
        break;
      }
      __nanosleep(64);
    }
    __threadfence();
    ok = good;
  }
  __syncthreads();
  const bool r = ok;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
ring_reduce_kernel(const float* __restrict__ x_, float* __restrict__ out_,
                   float* __restrict__ mbox_, int* __restrict__ flags,
                   int* __restrict__ err, int n, int ring_stride, int chunk4,
                   int bpr) {
  const int j = blockIdx.x;
  const int r = blockIdx.y;
  const int n_ranks = gridDim.y;
  const int me = (r / ring_stride) % n;
  const int base = r - me * ring_stride;
  const int right = base + ((me + 1) % n) * ring_stride;
  const int left = base + ((me + n - 1) % n) * ring_stride;
  const int lo = (int)((long long)chunk4 * j / bpr);
  const int hi = (int)((long long)chunk4 * (j + 1) / bpr);

  const size_t rank4 = (size_t)n * chunk4;
  const float4* x = reinterpret_cast<const float4*>(x_) + r * rank4;
  float4* out = reinterpret_cast<float4*>(out_) + r * rank4;
  float4* mbox = reinterpret_cast<float4*>(mbox_);
  const float4* my_box = mbox + (size_t)r * 2 * chunk4;
  float4* right_box = mbox + (size_t)right * 2 * chunk4;
  int* full_me = flags + ((size_t)r * bpr + j) * 2;
  int* full_right = flags + ((size_t)right * bpr + j) * 2;
  int* credits = flags + (size_t)n_ranks * bpr * 2;
  const int* credit_me = credits + (size_t)r * bpr + j;
  int* credit_left = credits + (size_t)left * bpr + j;

  for (int k = 0; k < n; ++k)
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      out[(size_t)k * chunk4 + i] = x[(size_t)k * chunk4 + i];
  __syncthreads();

  for (int g = 0; g < 2 * (n - 1); ++g) {
    const bool reduce = g < n - 1;
    const int s = reduce ? g : g - (n - 1);
    const int send = reduce ? wrap(me - s, n) : wrap(me + 1 - s, n);
    const int recv = reduce ? wrap(me - s - 1, n) : wrap(me - s, n);
    const int slot = g & 1;

    // the receiver has folded what this block put in `slot` at hop g - 2
    if (g >= 2 && !wait_at_least(credit_me, g - 1, err, 1)) return;
    float4* dst = right_box + (size_t)slot * chunk4;
    const float4* src = out + (size_t)send * chunk4;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads)
      __stcg(dst + i, src[i]);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(full_right + slot, g + 1);
    }

    // the left neighbour's chunk of this hop
    if (!wait_at_least(full_me + slot, g + 1, err, 2)) return;
    const float4* inc = my_box + (size_t)slot * chunk4;
    float4* own = out + (size_t)recv * chunk4;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      float4 v = __ldcg(inc + i);
      if (reduce) {
        const float4 o = own[i];
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      own[i] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      red_release_add(credit_left, 1);
    }
  }
}

}  // namespace

// x, out: (n_ranks, n * chunk4) float4s; mbox: (n_ranks, 2, chunk4) float4s;
// flags: n_ranks * bpr * 3 ints, zero; err: one int. Ranks are linear in the
// mesh's row-major order; the ring runs along the axis of stride
// `ring_stride` and size n.
extern "C" int ring_reduce_launch(const float* x, float* out, float* mbox,
                                  int* flags, int* err, int n_ranks, int n,
                                  int ring_stride, int chunk4, int bpr,
                                  void* stream) {
  if (n < 2 || ring_stride < 1 || n_ranks % (n * ring_stride) != 0
      || chunk4 < 1 || bpr < 1)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&out, (void*)&mbox, (void*)&flags,
                  (void*)&err, (void*)&n, (void*)&ring_stride,
                  (void*)&chunk4, (void*)&bpr};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ring_reduce_kernel, dim3(bpr, n_ranks), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
