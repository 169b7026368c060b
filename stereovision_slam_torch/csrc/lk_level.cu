// Kernel A: one pyramid level of lane-style Lucas-Kanade for n points.
//
// Replaces the TPU kernel stereovision_slam_tpu/ops/lk_lanes.py
// `_level_kernel` (launched by `lk_level_lanes`). Same function: for each
// point, (1) the bilinear win x win template and its Scharr gradients from a
// (win+3)^2 window of the edge-padded previous image whose right/bottom
// overhang past the padded image is ZERO (not clamped), at corner
// (twx, twy) with the in-window sample start fixed at 1; (2) the 2x2
// structure tensor with the min-eigenvalue and determinant solvability test;
// (3) at most max_iters Gauss-Newton steps, sampling the current patch from a
// (Py, Px) search window whose corner (cx, cy) the caller clipped to the
// padded image. A point freezes on convergence (eps), when unsolvable, or
// when out of bounds; left_win is set when it leaves the search window.
//
// What bounds it on an H100: neither bytes nor operations. One level moves
// about 2 MB of images (under a microsecond at 3.35 TB/s) and does a few
// MFLOP; the time is the latency of the dependent Gauss-Newton chain (a warp
// reduction and a division per iteration) and launch overhead.
//
// Design: one warp per point, four points per 128-thread block. The TPU
// version gathered per-point windows with one-hot matmuls because its vector
// unit has no per-lane gather; here every lane reads the edge-padded level
// images straight from global memory (index clamping stands in for the pad,
// so no padded copy is made). Each lane holds <= MAXP of the win*win
// template pixels and their gradients in registers; the sums bx, by and the
// structure tensor are xor-butterfly warp reductions, so every lane ends
// with the same bits and the warp branches uniformly. Each point leaves the
// loop on its own: frozen points never move, which makes this equal to the
// TPU kernel's chunk-wide exit. Built with --fmad=false so products and sums
// round as the plain PyTorch version's separate operations do; only the
// order of the reductions differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWin = 15;
constexpr int kMaxP = (kMaxWin * kMaxWin + 31) / 32;
constexpr int kTwMax = kMaxWin + 3;
constexpr int kWarpsPerBlock = 4;
constexpr int kMetaCols = 9;
constexpr int kOutCols = 6;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Edge-padded image value at padded coordinates (yp, xp).
__device__ __forceinline__ float padded_at(const float* img, int H, int W,
                                           int pad, int yp, int xp) {
  int y = min(max(yp - pad, 0), H - 1);
  int x = min(max(xp - pad, 0), W - 1);
  return __ldg(img + (size_t)y * W + x);
}

__global__ void lk_level_kernel(const float* __restrict__ prev_img,
                                const float* __restrict__ cur_img,
                                const float* __restrict__ meta,
                                float* __restrict__ out, int n, int N, int H,
                                int W, int pad, int Py, int Px, int win,
                                int max_iters, float eps2, float min_eig_thr) {
  __shared__ float tw_smem[kWarpsPerBlock][kTwMax * kTwMax];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;

  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int S = win + 1;
  const int tw = win + 3;
  const int npix = win * win;
  const size_t img_off = (size_t)(i / N) * H * W;
  const float* prev = prev_img + img_off;
  const float* cur = cur_img + img_off;
  const float* m = meta + (size_t)i * kMetaCols;
  float px = m[0], py = m[1];
  const int cx = (int)m[2], cy = (int)m[3];
  bool frozen = m[4] > 0.5f;
  const float tfx = m[5], tfy = m[6];
  const int twx = (int)m[7], twy = (int)m[8];

  // (1) template window, zero past the padded image's right/bottom edge
  float* X = tw_smem[warp];
  for (int k = lane; k < tw * tw; k += 32) {
    int r = k / tw, c = k - r * tw;
    int yp = twy + r, xp = twx + c;
    X[k] = (yp < Hp && xp < Wp) ? padded_at(prev, H, W, pad, yp, xp) : 0.0f;
  }
  __syncwarp();

  const float c0 = 3.0f / 32.0f, c1 = 10.0f / 32.0f;
  const float t00 = (1.0f - tfy) * (1.0f - tfx), t01 = (1.0f - tfy) * tfx;
  const float t10 = tfy * (1.0f - tfx), t11 = tfy * tfx;
  float tmpl[kMaxP], gxv[kMaxP], gyv[kMaxP];
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxP; ++k) {
    const int p = lane + 32 * k;
    tmpl[k] = gxv[k] = gyv[k] = 0.0f;
    if (p >= npix) continue;
    const int r = p / win, c = p - r * win;
    auto x = [&](int a, int b) { return X[a * tw + b]; };
    // Scharr at template-grid cell (a, b): the separable association of
    // the whole-image filter (row difference, then 3/10/3 column taps)
    auto ix = [&](int a, int b) {
      return (x(a, b + 2) - x(a, b)) * c0 + (x(a + 1, b + 2) - x(a + 1, b)) * c1
             + (x(a + 2, b + 2) - x(a + 2, b)) * c0;
    };
    auto srow = [&](int a, int b) {
      return x(a, b) * c0 + x(a, b + 1) * c1 + x(a, b + 2) * c0;
    };
    auto iy = [&](int a, int b) { return srow(a + 2, b) - srow(a, b); };
    tmpl[k] = t00 * x(1 + r, 1 + c) + t01 * x(1 + r, 2 + c)
              + t10 * x(2 + r, 1 + c) + t11 * x(2 + r, 2 + c);
    gxv[k] = t00 * ix(r, c) + t01 * ix(r, c + 1) + t10 * ix(r + 1, c)
             + t11 * ix(r + 1, c + 1);
    gyv[k] = t00 * iy(r, c) + t01 * iy(r, c + 1) + t10 * iy(r + 1, c)
             + t11 * iy(r + 1, c + 1);
    sxx += gxv[k] * gxv[k];
    sxy += gxv[k] * gyv[k];
    syy += gyv[k] * gyv[k];
  }
  // (2) structure tensor and solvability
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float tr_half = 0.5f * (gxx + gyy);
  const float min_eig =
      (tr_half - sqrtf(fmaxf(tr_half * tr_half - det, 0.0f))) / (float)(win * win);
  const bool solvable = (min_eig > min_eig_thr) && (det > 1e-12f);
  const float det_safe = det > 1e-12f ? det : 1.0f;

  // (3) Gauss-Newton inside the search window
  const float half = (float)(win - 1) / 2.0f;
  bool left_win = false;
  int it = 0;
  for (; it < max_iters && !frozen; ++it) {
    const float tlx = px - half, tly = py - half;
    const bool g_ok = (tlx >= 0.0f) && (tly >= 0.0f) && (tlx + win < (float)Wp)
                      && (tly + win < (float)Hp);
    const float locx = tlx - (float)cx, locy = tly - (float)cy;
    const bool in_win = (locx >= 0.0f) && (locy >= 0.0f)
                        && (locx + S <= (float)Px) && (locy + S <= (float)Py);
    const float bx0 = floorf(locx), by0 = floorf(locy);
    const float fx = locx - bx0, fy = locy - by0;
    const int x0 = min(max((int)bx0, 0), Px - S);
    const int y0 = min(max((int)by0, 0), Py - S);
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxP; ++k) {
      const int p = lane + 32 * k;
      if (p >= npix) continue;
      const int r = p / win, c = p - r * win;
      const int yp = cy + y0 + r, xp = cx + x0 + c;
      const float v = w00 * padded_at(cur, H, W, pad, yp, xp)
                      + w01 * padded_at(cur, H, W, pad, yp, xp + 1)
                      + w10 * padded_at(cur, H, W, pad, yp + 1, xp)
                      + w11 * padded_at(cur, H, W, pad, yp + 1, xp + 1);
      const float diff = v - tmpl[k];
      bx += diff * gxv[k];
      by += diff * gyv[k];
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
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
    float* o = out + (size_t)i * kOutCols;
    o[0] = px;
    o[1] = py;
    o[2] = frozen ? 1.0f : 0.0f;
    o[3] = left_win ? 1.0f : 0.0f;
    o[4] = solvable ? 1.0f : 0.0f;
    o[5] = (float)it;
  }
}

}  // namespace

extern "C" int lk_level_launch(const float* prev_img, const float* cur_img,
                               const float* meta, float* out, int n, int N,
                               int H, int W, int pad, int Py, int Px, int win,
                               int max_iters, float eps2, float min_eig_thr,
                               void* stream) {
  if (win > kMaxWin || win < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lk_level_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      prev_img, cur_img, meta, out, n, N, H, W, pad, Py, Px, win, max_iters,
      eps2, min_eig_thr);
  return (int)cudaGetLastError();
}
