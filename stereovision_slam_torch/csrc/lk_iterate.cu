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
// Design: one warp per point, four points per block, instantiated per
// patch size R (1 to 31) with the (R + 21)-pixel windows `ops/lk.py`
// gathers (margin 10 each side), so every index is a compile-time
// constant. The warp stages its point's window in shared memory with
// 16-byte loads, all of them in flight at once, under a row pitch chosen
// at compile time so that the lanes' rows fall in distinct banks. Up to
// R = 16 two lanes share each patch row: lane i + 16h owns columns
// [h * ceil(R/2), ...) of row i, with its template and gradient half-rows
// in registers, so 2R lanes work (22 of 32 at R = 11); above 16, lane i
// owns the whole row i. Per step each lane forms the 4-term bilinear sums
// of its columns and its sums of diff * gx and diff * gy, columns in
// order; a 5-round __shfl_xor_sync butterfly then adds the two halves of
// each row and the rows as a pairwise tree (rows padded to 16 with zeros),
// or above R = 16 the rows as a pairwise tree over 32. XOR partners add
// the same two numbers, so every lane ends with the same bits and the warp
// branches uniformly. Each point leaves the loop on its own: frozen points
// never move, which makes this equal to the TPU kernel's tile-wide exit.
// Built with --fmad=false, so it rounds as the plain PyTorch version does,
// which sums in the same order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxR = 31;   // patch side (win) at most 31: windows of 52
constexpr int kMargin = 10;
constexpr int kWarpsPerBlock = 4;
constexpr int kOutCols = 5;

// Two lanes per patch row up to R = 16, one above.
__host__ __device__ constexpr bool split_rows(int R) { return R <= 16; }

// Worst bank multiplicity of the lanes' row starts i * pitch + h * H0.
__host__ __device__ constexpr int row_conflicts(int R, int pitch) {
  const int H0 = split_rows(R) ? (R + 1) / 2 : R;
  int worst = 0;
  for (int bank = 0; bank < 32; ++bank) {
    int n = 0;
    for (int i = 0; i < R; ++i)
      for (int h = 0; h < 2; ++h)
        if ((h == 0 || R - H0 > 0) && ((i * pitch + h * H0) & 31) == bank) ++n;
    worst = n > worst ? n : worst;
  }
  return worst;
}

// The least pitch >= P whose row starts conflict least.
__host__ __device__ constexpr int row_pitch(int R, int P) {
  int best = P, fewest = 1 << 30;
  for (int p = P; p < P + 32; ++p) {
    const int c = row_conflicts(R, p);
    if (c < fewest) {
      fewest = c;
      best = p;
    }
  }
  return best;
}

template <int R, int P>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_iterate_kernel(const float* __restrict__ win,
                  const float* __restrict__ tmpl,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ coef,
                  const float* __restrict__ flags,
                  const float* __restrict__ pts,
                  const float* __restrict__ corner, float* __restrict__ out,
                  int N, int max_iters, int W, int H, float eps2) {
  constexpr int S = R + 1;
  constexpr int kPitch = row_pitch(R, P);
  constexpr bool kSplit = split_rows(R);
  constexpr int H0 = kSplit ? (R + 1) / 2 : R;   // columns of half 0
  constexpr int H1 = R - H0;                     // columns of half 1
  static_assert(kWarpsPerBlock * P * kPitch * 4 <= 48 * 1024,
                "a block's windows exceed 48 KB of static shared memory");
  __shared__ float sm[kWarpsPerBlock][P * kPitch];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;

  float* w = sm[warp];
  const float* wg = win + (size_t)n * P * P;
  if constexpr ((P * P) % 4 == 0) {
    // every lane's 16-byte loads issued before the first store
    constexpr int kQuads = P * P / 4;
    constexpr int kPer = (kQuads + 31) / 32;
    float4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = lane + 32 * j;
      if (q < kQuads) v[j] = __ldg(reinterpret_cast<const float4*>(wg) + q);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int q = lane + 32 * j;
      if (q < kQuads) {
        const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = 4 * q + m, r = k / P;
          w[r * kPitch + (k - r * P)] = e[m];
        }
      }
    }
  } else {
    constexpr int kPer = (P * P + 31) / 32;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = lane + 32 * j;
      if (k < P * P) v[j] = __ldg(wg + k);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = lane + 32 * j, r = k / P;
      if (k < P * P) w[r * kPitch + (k - r * P)] = v[j];
    }
  }
  __syncwarp();

  // lane i + 16h owns columns [h * H0, h * H0 + (h ? H1 : H0)) of row i;
  // above R = 16 lane i owns row i
  const int row = kSplit ? lane & 15 : lane, half = kSplit ? lane >> 4 : 0;
  const int c0 = half * H0, ncols = half ? H1 : H0;
  const bool live_lane = row < R;
  float t[H0], ax[H0], ay[H0];
  const size_t prow = (size_t)n * R * R + (size_t)row * R + c0;
#pragma unroll
  for (int c = 0; c < H0; ++c) {
    const bool on = live_lane && c < ncols;
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
  const float half_w = (float)(S - 2) / 2.0f;

  bool left_win = false;
  int it = 0;
  for (; it < max_iters && !frozen; ++it) {
    const float tlx = px - half_w, tly = py - half_w;
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
    if (live_lane && ncols > 0) {
      const float* r0 = w + (y0 + row) * kPitch + x0 + c0;
      const float* r1 = r0 + kPitch;
#pragma unroll
      for (int c = 0; c < H0; ++c) {
        if (c < ncols) {
          const float v = w00 * r0[c] + w01 * r0[c + 1] + w10 * r1[c]
                          + w11 * r1[c + 1];
          const float d = v - t[c];
          sx = c == 0 ? d * ax[c] : sx + d * ax[c];
          sy = c == 0 ? d * ay[c] : sy + d * ay[c];
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      sx = sx + __shfl_xor_sync(0xffffffffu, sx, o);
      sy = sy + __shfl_xor_sync(0xffffffffu, sy, o);
    }
    const float dx = (gyy * sx - gxy * sy) / det_safe;
    const float dy = (gxx * sy - gxy * sx) / det_safe;
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

// The launch for patch size R, found among R0 .. kMaxR.
template <int R0>
int launch(int R, int P, int blocks, cudaStream_t stream, const float* win,
           const float* tmpl, const float* gx, const float* gy,
           const float* coef, const float* flags, const float* pts,
           const float* corner, float* out, int N, int max_iters, int W,
           int H, float eps2) {
  if constexpr (R0 < kMaxR) {
    if (R != R0)
      return launch<R0 + 1>(R, P, blocks, stream, win, tmpl, gx, gy, coef,
                            flags, pts, corner, out, N, max_iters, W, H, eps2);
  }
  if (R != R0 || P != R0 + 1 + 2 * kMargin) return (int)cudaErrorInvalidValue;
  lk_iterate_kernel<R0, R0 + 1 + 2 * kMargin>
      <<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
          win, tmpl, gx, gy, coef, flags, pts, corner, out, N, max_iters, W,
          H, eps2);
  return (int)cudaGetLastError();
}

}  // namespace

// win must be 16-byte aligned; S - 1 in [1, 31] and P = S + 20.
extern "C" int lk_iterate_launch(const float* win, const float* tmpl,
                                 const float* gx, const float* gy,
                                 const float* coef, const float* flags,
                                 const float* pts, const float* corner,
                                 float* out, int N, int S, int P,
                                 int max_iters, int W, int H, float eps2,
                                 void* stream) {
  const int R = S - 1;
  if (R < 1 || R > kMaxR || P != S + 2 * kMargin
      || (reinterpret_cast<size_t>(win) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return launch<1>(R, P, blocks, (cudaStream_t)stream, win, tmpl, gx, gy,
                   coef, flags, pts, corner, out, N, max_iters, W, H, eps2);
}
