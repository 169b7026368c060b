// The per-point window gather: out[n] = imgs[group[n], cy[n] + r, cx[n] + c]
// for r, c in [0, P).
//
// Replaces the TPU kernel benchmarks/probe_gather.py `_dynslice_kernel`
// (and the one-hot matmul gather `_gather_patches_mxu` of
// stereovision_slam_tpu/ops/image.py that the windowed LK level uses): on
// the TPU a per-point dynamic window needed a probe of gather strategies,
// because its vector unit has no per-lane gather. Here it is a plain copy.
//
// What bounds it on an H100: bytes. It writes N * P * P floats (8.4 MB for
// N = 2048, P = 32) and reads about as much from the level images, most of
// it from L2 (neighbouring points' windows overlap); it does no arithmetic.
//
// Design: one block per point, 256 threads walking the P * P window in
// row-major order, so consecutive threads read consecutive pixels of a row
// and write consecutive floats. The callers clip the corners into the image;
// the indices are clamped as well so a read never leaves it, which makes the
// result bit-equal to the plain version's clamped indexing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const float* __restrict__ imgs,
                      const int* __restrict__ group,
                      const int* __restrict__ cy, const int* __restrict__ cx,
                      float* __restrict__ out, int H, int W, int P) {
  const int n = blockIdx.x;
  const float* img = imgs + (size_t)group[n] * H * W;
  const int y0 = cy[n], x0 = cx[n];
  float* o = out + (size_t)n * P * P;
  for (int k = threadIdx.x; k < P * P; k += kThreads) {
    const int r = k / P, c = k - r * P;
    const int y = min(max(y0 + r, 0), H - 1);
    const int x = min(max(x0 + c, 0), W - 1);
    o[k] = __ldg(img + (size_t)y * W + x);
  }
}

}  // namespace

extern "C" int gather_windows_launch(const float* imgs, const int* group,
                                     const int* cy, const int* cx, float* out,
                                     int N, int H, int W, int P,
                                     void* stream) {
  if (P < 1 || P > H || P > W) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  gather_windows_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      imgs, group, cy, cx, out, H, W, P);
  return (int)cudaGetLastError();
}
