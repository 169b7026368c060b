// Kernel C: the windowed Lucas-Kanade Gauss-Newton loop over pre-gathered
// windows, for N points of one pyramid level.
//
// Replaces the TPU kernel stereovision_slam_tpu/ops/lk_pallas.py
// `_iterate_kernel` (called by `lk_iterate_window`). Same function: each
// point starts at its guess with its template and gradient patches (R x R,
// R = S - 1) and structure-tensor coefficients precomputed, and runs at most
// max_iters steps, sampling its current patch bilinearly from its (P, P)
// window of the current level whose top-left corner in the padded level is
// (cx, cy). A step is taken when the point is solvable and its patch lies
// in the padded image and in the window; the point freezes on convergence
// (eps), when unsolvable, or when out of bounds; left_win is set when the
// patch leaves the window while the point is live.
//
// What bounds it on an H100: bytes in principle (the windows are 4 KB a
// point, 8.4 MB for N = 2048, against a few MFLOP of work), in practice the
// latency of the dependent Gauss-Newton chain of each point.
//
// Design: one warp per point, four points per block. The warp copies its
// point's window into shared memory once (rows padded to 33 floats, so the
// lanes reading one column of different rows hit different banks). Lane i
// < R owns patch row i: its template and gradient rows live in registers,
// and per iteration it forms the 4-term bilinear sum of its row and the row
// sums of diff * gx and diff * gy, columns in order. The row sums are then
// added row by row through warp shuffles, the reference kernel's
// row-streamed order, so every lane holds the same bits and the warp
// branches uniformly. Each point leaves the loop on its own: frozen points
// never move, which makes this equal to the TPU kernel's tile-wide exit.
// Built with --fmad=false, so it rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxR = 15;   // patch side (win) at most 15
constexpr int kMaxP = 32;   // window side at most 32
constexpr int kPitch = kMaxP + 1;
constexpr int kWarpsPerBlock = 4;
constexpr int kOutCols = 5;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_iterate_kernel(const float* __restrict__ win,
                  const float* __restrict__ tmpl,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ coef,
                  const float* __restrict__ flags,
                  const float* __restrict__ pts,
                  const float* __restrict__ corner, float* __restrict__ out,
                  int N, int S, int P, int max_iters, int W, int H,
                  float eps2) {
  __shared__ float sm[kWarpsPerBlock][kMaxP * kPitch];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;

  const int R = S - 1;
  float* w = sm[warp];
  const float* wg = win + (size_t)n * P * P;
  for (int k = lane; k < P * P; k += 32) {
    const int r = k / P, c = k - r * P;
    w[r * kPitch + c] = wg[k];
  }
  __syncwarp();

  // lane `lane` < R owns patch row `lane`
  float t[kMaxR], ax[kMaxR], ay[kMaxR];
  const size_t prow = (size_t)n * R * R + (size_t)lane * R;
#pragma unroll
  for (int c = 0; c < kMaxR; ++c) {
    const bool on = lane < R && c < R;
    t[c] = on ? tmpl[prow + c] : 0.0f;
    ax[c] = on ? gx[prow + c] : 0.0f;
    ay[c] = on ? gy[prow + c] : 0.0f;
  }
  const float gxx = coef[4 * n], gxy = coef[4 * n + 1];
  const float gyy = coef[4 * n + 2], det_safe = coef[4 * n + 3];
  const bool solvable = flags[2 * n] > 0.5f;
  bool frozen = flags[2 * n + 1] > 0.5f;
  float px = pts[2 * n], py = pts[2 * n + 1];
  const float cx = corner[2 * n], cy = corner[2 * n + 1];
  const float half = (float)(S - 2) / 2.0f;

  bool left_win = false;
  int it = 0;
  for (; it < max_iters && !frozen; ++it) {
    const float tlx = px - half, tly = py - half;
    const bool g_ok = (tlx >= 0.0f) && (tly >= 0.0f)
                      && (tlx + (float)R < (float)W) && (tly + (float)R < (float)H);
    const float locx = tlx - cx, locy = tly - cy;
    const bool in_win = (locx >= 0.0f) && (locy >= 0.0f)
                        && (locx + (float)S <= (float)P)
                        && (locy + (float)S <= (float)P);
    const float bx0 = floorf(locx), by0 = floorf(locy);
    const float fx = locx - bx0, fy = locy - by0;
    const int x0 = min(max((int)bx0, 0), P - S);
    const int y0 = min(max((int)by0, 0), P - S);
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    float sx = 0.0f, sy = 0.0f;
    if (lane < R) {
      const float* r0 = w + (y0 + lane) * kPitch + x0;
      const float* r1 = r0 + kPitch;
#pragma unroll
      for (int c = 0; c < kMaxR; ++c) {
        if (c < R) {
          const float v = w00 * r0[c] + w01 * r0[c + 1] + w10 * r1[c]
                          + w11 * r1[c + 1];
          const float d = v - t[c];
          sx = sx + d * ax[c];
          sy = sy + d * ay[c];
        }
      }
    }
    float bx = 0.0f, by = 0.0f;
    for (int i = 0; i < R; ++i) {
      bx = bx + __shfl_sync(0xffffffffu, sx, i);
      by = by + __shfl_sync(0xffffffffu, sy, i);
    }
    const float dx = (gyy * bx - gxy * by) / det_safe;
    const float dy = (gxx * by - gxy * bx) / det_safe;
    const bool inb = g_ok && in_win;
    const bool step_ok = solvable && inb;
    if (step_ok) {
      px = px - dx;
      py = py - dy;
    }
    const bool converged = dx * dx + dy * dy < eps2;
    left_win = left_win || !in_win;
    frozen = (converged && step_ok) || !(solvable && inb);
  }
  if (lane == 0) {
    float* o = out + (size_t)n * kOutCols;
    o[0] = px;
    o[1] = py;
    o[2] = frozen ? 1.0f : 0.0f;
    o[3] = left_win ? 1.0f : 0.0f;
    o[4] = (float)it;
  }
}

}  // namespace

extern "C" int lk_iterate_launch(const float* win, const float* tmpl,
                                 const float* gx, const float* gy,
                                 const float* coef, const float* flags,
                                 const float* pts, const float* corner,
                                 float* out, int N, int S, int P,
                                 int max_iters, int W, int H, float eps2,
                                 void* stream) {
  if (S < 2 || S - 1 > kMaxR || P > kMaxP || P < S)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_iterate_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      win, tmpl, gx, gy, coef, flags, pts, corner, out, N, S, P, max_iters, W,
      H, eps2);
  return (int)cudaGetLastError();
}
