// Kernel A: lane-style pyramidal Lucas-Kanade for n points, every pyramid
// level in one launch.
//
// Replaces the TPU kernel stereovision_slam_tpu/ops/lk_lanes.py
// `_level_kernel` (launched once per level by `lk_level_lanes`, driven by
// `track_grouped_lanes`). Same function, level by level from coarse to
// fine, for each point:
//  (0) the level's meta, as `ops/lk_lanes._prep_level` builds it: the
//      template corner max(floor(tl) - 1, 0) and bilinear fractions of the
//      template point pts * 0.5^level + pad, the search-window corner
//      clipped to [0, Wp - Px] x [0, Hp - Py], non-finite coordinates of
//      masked slots read as 0 (`image.floor_int`);
//  (1) the bilinear win x win template and its Scharr gradients from a
//      (win+3)^2 window of the edge-padded previous image whose right/bottom
//      overhang past the padded image is ZERO (not clamped), in-window
//      sample start fixed at 1;
//  (2) the 2x2 structure tensor with the min-eigenvalue and determinant
//      solvability test;
//  (3) at most max_iters Gauss-Newton steps, sampling the current patch from
//      the (Py, Px) search window. A point freezes on convergence (eps), when
//      unsolvable, or when out of bounds; left_win is set when it leaves the
//      search window;
//  (4) the guess handed to the next finer level, ((x - pad) * 2) + pad, in
//      the float32 steps of the Python loop, and at level 0 the status:
//      tmpl_ok, solvable, in bounds in padded coordinates, not left_win, then
//      in bounds in unpadded coordinates.
// Every level's rows [x, y, frozen, left_win, solvable, iterations] are
// written out as well, so that each level can be held to its plain version.
//
// What bounds it on an H100: neither bytes nor operations. One call moves
// about 2 MB of images (under a microsecond at 3.35 TB/s) and does a few
// MFLOP; the time is the latency of each level's dependent Gauss-Newton
// chain (two warp reductions and a division per iteration).
//
// Design: one warp per point, two points per 64-thread block, and one
// launch per call instead of one per level with ~25 eager ops of prep and
// status logic between them. The kernel is instantiated for each window
// size (1-31), so the patch's loops and index arithmetic are constants. The
// level table (image pointers, H, W, Py, Px per level) is a
// kernel-parameter struct; the guess stays in registers from one level to
// the next. The warp's global reads are asynchronous copies into its
// shared memory (cp.async), issued together and waited for once, so that a
// level pays one memory latency and not one per row: at the start the
// template windows of every level (their corners depend on the points
// only) and the coarsest level's search window, then each finer level's
// (Py, Px) search window once its guess is known. Rows are read coalesced
// (index clamping stands in for the edge pad, so no padded copy is made:
// the clamped row address once per row, the clamped column offsets once per
// lane). A warp's shared memory grows with the window and the depth (31 KB
// at win 15 and 8 levels, 76 KB at win 31): above 48 KB a block is one warp
// and opts in to the larger dynamic shared memory. The Scharr gradients are
// computed once per cell of the (win+1)^2
// template grid into shared memory, then each template pixel blends its
// four cells, as the plain version blends its gradient images. The row
// strides of the search window and of the gradient cells are congruent to
// win mod 32, so the 32 lanes, which hold consecutive pixels p of the
// row-major win x win patch, hit 32 distinct banks. The Gauss-Newton loop
// then reads shared memory, not L2. Each lane holds its <= 8 template
// pixels and gradients in registers; the sums are xor-butterfly warp
// reductions, so every lane ends with the same bits and the warp branches
// uniformly. Built with --fmad=false, the float operations are those of the
// plain version (`lk_level_plain` under the Python level loop) in the same
// order; only the order of the reductions differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWin = 31;
constexpr int kWarpsPerBlock = 2;   // one where the windows are large
constexpr int kMaxLevels = 8;
constexpr int kMaxCols = 3;         // search-window columns per lane, Px <= 96
constexpr int kStaticSmem = 48 * 1024;      // without opting in
constexpr int kMaxSmem = 227 * 1024;        // a block's most, opted in
constexpr int kOutCols = 6;

struct Level {
  const float* prev;   // (G, H, W), unpadded
  const float* cur;
  int H, W, Py, Px;
};

struct Params {
  Level lv[kMaxLevels];
  const float* pts;              // (n, 2) level-0 template points
  const float* init;             // (n, 2) level-0 initial guesses
  const unsigned char* masks;    // n bytes, 0 = masked
  float* uv;                     // (n, 2) out
  unsigned char* status;         // n bytes out
  float* rows;                   // (levels, n, 6) out
  int levels, n, N, pad, max_iters, warp_floats;
  float init_scale, eps2, min_eig_thr;
};

__host__ __device__ __forceinline__ int window_stride(int Px, int win) {
  return Px + ((win - Px) % 32 + 32) % 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// floor(v), non-finite read as 0 and the rest clamped to +-1e9 first
// (`image.floor_int`)
__device__ __forceinline__ long long floor_int(float v) {
  if (!isfinite(v)) return 0;
  return (long long)floorf(fminf(fmaxf(v, -1e9f), 1e9f));
}

__device__ __forceinline__ int clampi(long long v, long long lo, long long hi) {
  return (int)(v < lo ? lo : (v > hi ? hi : v));
}

// Address of the edge-padded image's value at padded coordinates (yp, xp).
__device__ __forceinline__ const float* padded_ptr(const float* img, int H,
                                                   int W, int pad, int yp,
                                                   int xp) {
  const int y = min(max(yp - pad, 0), H - 1);
  const int x = min(max(xp - pad, 0), W - 1);
  return img + (size_t)y * W + x;
}

// Asynchronous 4-byte copy global -> shared (completes at cp_async_wait).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

// This lane's copies have landed; then __syncwarp for the other lanes'.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Template point of `level` (padded) minus half, as `_prep_level` forms it.
__device__ __forceinline__ float template_tl(float p, int level, int pad,
                                             float half) {
  return (p * ldexpf(1.0f, -level) + (float)pad) - half;
}

template <int WIN>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_pyramid_kernel(const Params P) {
  constexpr int S = WIN + 1;            // side of the sampled patch
  constexpr int TW = WIN + 3;           // side of the template window
  constexpr int NPIX = WIN * WIN;
  constexpr int KP = (NPIX + 31) / 32;  // template pixels per lane
  constexpr int CS = WIN + 32;          // row stride of the gradient cells
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= P.n) return;
  const int pad = P.pad;
  const float half = (float)(WIN - 1) / 2.0f;
  const float c0 = 3.0f / 32.0f, c1 = 10.0f / 32.0f;
  const size_t grp = (size_t)(i / P.N);
  const float p0x = P.pts[2 * i], p0y = P.pts[2 * i + 1];
  const bool frozen0 = P.masks[i] == 0;
  // the guess in the current level's unpadded coordinates
  float gx = P.init[2 * i] * P.init_scale, gy = P.init[2 * i + 1] * P.init_scale;
  float* Xs = smem + (size_t)warp * P.warp_floats;  // template windows, per level
  float* IX = Xs + P.levels * TW * TW;              // Scharr x at the grid cells
  float* IY = IX + S * CS;                          // Scharr y
  float* Wn = IY + S * CS;                          // search window

  // every level's template window, zero past the padded image's
  // right/bottom edge (a corner at or past that edge reads only zeros, as
  // any larger one would)
  for (int level = 0; level < P.levels; ++level) {
    const Level L = P.lv[level];
    const int Hp = L.H + 2 * pad, Wp = L.W + 2 * pad;
    const int twx = clampi(floor_int(template_tl(p0x, level, pad, half)) - 1, 0, Wp);
    const int twy = clampi(floor_int(template_tl(p0y, level, pad, half)) - 1, 0, Hp);
    const float* prev = L.prev + grp * L.H * L.W;
    float* X = Xs + level * TW * TW;
    for (int k = lane; k < TW * TW; k += 32) {
      const int r = k / TW, c = k - r * TW;
      const int yp = twy + r, xp = twx + c;
      if (yp < Hp && xp < Wp)
        cp_async4(X + k, padded_ptr(prev, L.H, L.W, pad, yp, xp));
      else
        X[k] = 0.0f;
    }
  }

  for (int level = P.levels - 1; level >= 0; --level) {
    const Level L = P.lv[level];
    const int H = L.H, W = L.W, Py = L.Py, Px = L.Px;
    const int Hp = H + 2 * pad, Wp = W + 2 * pad;
    const int st = window_stride(Px, WIN);
    const float* cur = L.cur + grp * H * W;
    const float* X = Xs + level * TW * TW;

    // (0) the level's meta
    const float tlx = template_tl(p0x, level, pad, half);
    const float tly = template_tl(p0y, level, pad, half);
    const float tfx = tlx - floorf(tlx), tfy = tly - floorf(tly);
    const bool tmpl_ok = (tlx >= 0.0f) && (tly >= 0.0f)
                         && (tlx + (float)WIN < (float)Wp)
                         && (tly + (float)WIN < (float)Hp);
    float px = gx + (float)pad, py = gy + (float)pad;
    const int cx = clampi(floor_int(px - half) - (Px - S) / 2, 0, max(Wp - Px, 0));
    const int cy = clampi(floor_int(py - half) - (Py - S) / 2, 0, max(Hp - Py, 0));
    bool frozen = frozen0;
    if (!frozen) {   // stage the (Py, Px) search window at (cy, cx)
      int xo[kMaxCols];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        xo[j] = min(max(cx + lane + 32 * j - pad, 0), W - 1);
      for (int r = 0; r < Py; ++r) {
        const float* row = cur + (size_t)min(max(cy + r - pad, 0), H - 1) * W;
        float* dst = Wn + r * st + lane;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (lane + 32 * j < Px) cp_async4(dst + 32 * j, row + xo[j]);
      }
    }
    cp_async_wait();   // this level's window (and at the top the templates)

    // (1) Scharr gradients at the S x S cells of the template grid (the
    // separable association of the whole-image filter: row difference, then
    // 3/10/3 column taps), then the template and its gradients, each pixel
    // blending its four cells with the bilinear weights
    for (int k = lane; k < S * S; k += 32) {
      const int a = k / S, b = k - a * S;
      const float* x = X + a * TW + b;
      auto srow = [&](int da) {
        return x[da * TW] * c0 + x[da * TW + 1] * c1 + x[da * TW + 2] * c0;
      };
      IX[a * CS + b] = (x[2] - x[0]) * c0 + (x[TW + 2] - x[TW]) * c1
                       + (x[2 * TW + 2] - x[2 * TW]) * c0;
      IY[a * CS + b] = srow(2) - srow(0);
    }
    __syncwarp();
    const float t00 = (1.0f - tfy) * (1.0f - tfx), t01 = (1.0f - tfy) * tfx;
    const float t10 = tfy * (1.0f - tfx), t11 = tfy * tfx;
    float tmpl[KP], gxv[KP], gyv[KP];
    int off[KP];
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = lane + 32 * k;
      tmpl[k] = gxv[k] = gyv[k] = 0.0f;
      off[k] = 0;
      if (p >= NPIX) continue;
      const int r = p / WIN, c = p - r * WIN;
      off[k] = r * st + c;
      const float* x = X + (1 + r) * TW + 1 + c;
      const float* ix = IX + r * CS + c;
      const float* iy = IY + r * CS + c;
      tmpl[k] = t00 * x[0] + t01 * x[1] + t10 * x[TW] + t11 * x[TW + 1];
      gxv[k] = t00 * ix[0] + t01 * ix[1] + t10 * ix[CS] + t11 * ix[CS + 1];
      gyv[k] = t00 * iy[0] + t01 * iy[1] + t10 * iy[CS] + t11 * iy[CS + 1];
      sxx += gxv[k] * gxv[k];
      sxy += gxv[k] * gyv[k];
      syy += gyv[k] * gyv[k];
    }
    // (2) structure tensor and solvability
    const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
    const float det = gxx * gyy - gxy * gxy;
    const float tr_half = 0.5f * (gxx + gyy);
    const float min_eig =
        (tr_half - sqrtf(fmaxf(tr_half * tr_half - det, 0.0f))) / (float)NPIX;
    const bool solvable = (min_eig > P.min_eig_thr) && (det > 1e-12f);
    const float det_safe = det > 1e-12f ? det : 1.0f;

    // (3) Gauss-Newton inside the search window, staged in shared memory
    bool left_win = false;
    int it = 0;
    for (; it < P.max_iters && !frozen; ++it) {
      const float qx = px - half, qy = py - half;
      const bool g_ok = (qx >= 0.0f) && (qy >= 0.0f) && (qx + WIN < (float)Wp)
                        && (qy + WIN < (float)Hp);
      const float locx = qx - (float)cx, locy = qy - (float)cy;
      const bool in_win = (locx >= 0.0f) && (locy >= 0.0f)
                          && (locx + S <= (float)Px) && (locy + S <= (float)Py);
      const float bx0 = floorf(locx), by0 = floorf(locy);
      const float fx = locx - bx0, fy = locy - by0;
      const int x0 = min(max((int)bx0, 0), Px - S);
      const int y0 = min(max((int)by0, 0), Py - S);
      const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
      const float w10 = fy * (1.0f - fx), w11 = fy * fx;
      const float* base = Wn + y0 * st + x0;
      float bx = 0.0f, by = 0.0f;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int p = lane + 32 * k;
        if (p >= NPIX) continue;
        const float* q = base + off[k];
        const float v = w00 * q[0] + w01 * q[1] + w10 * q[st] + w11 * q[st + 1];
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
      const bool converged = dx * dx + dy * dy < P.eps2;
      left_win = left_win || !in_win;
      frozen = (converged && step_ok) || !(solvable && inb);
    }
    if (lane == 0) {
      float* o = P.rows + ((size_t)level * P.n + i) * kOutCols;
      o[0] = px;
      o[1] = py;
      o[2] = frozen ? 1.0f : 0.0f;
      o[3] = left_win ? 1.0f : 0.0f;
      o[4] = solvable ? 1.0f : 0.0f;
      o[5] = (float)it;
    }
    __syncwarp();   // the next level rewrites Wn, IX and IY

    // (4) the guess for the next level; the status at level 0
    gx = px - (float)pad;
    gy = py - (float)pad;
    if (level > 0) {
      gx = gx * 2.0f;
      gy = gy * 2.0f;
    } else if (lane == 0) {
      const float fx = px - half, fy = py - half;
      const bool final_inb = (fx >= 0.0f) && (fy >= 0.0f)
                             && (fx + (float)WIN < (float)Wp)
                             && (fy + (float)WIN < (float)Hp);
      const bool in_image = (gx >= 0.0f) && (gx < (float)W) && (gy >= 0.0f)
                            && (gy < (float)H);
      P.uv[2 * i] = gx;
      P.uv[2 * i + 1] = gy;
      P.status[i] = (tmpl_ok && solvable && final_inb && !left_win && in_image)
                        ? 1 : 0;
    }
  }
}

// The launch for window size `win`, found among WIN .. kMaxWin.
template <int WIN>
int launch(int win, const Params& P, int blocks, int threads, int bytes,
           cudaStream_t stream) {
  if constexpr (WIN < kMaxWin) {
    if (win != WIN) return launch<WIN + 1>(win, P, blocks, threads, bytes, stream);
  }
  if (bytes > kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_pyramid_kernel<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  lk_pyramid_kernel<WIN><<<blocks, threads, bytes, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// prev, cur: `levels` device addresses of (G, H, W) float32 images, level 0
// finest; dims: (H, W, Py, Px) per level; pts, init: (n, 2) float32; masks:
// n bytes (0 = masked); uv (n, 2), status n bytes, rows (levels, n, 6).
extern "C" int lk_pyramid_launch(const unsigned long long* prev,
                                 const unsigned long long* cur,
                                 const int* dims, int levels,
                                 const float* pts, const float* init,
                                 const unsigned char* masks, float* uv,
                                 unsigned char* status, float* rows, int n,
                                 int N, int pad, int win, int max_iters,
                                 float init_scale, float eps2,
                                 float min_eig_thr, void* stream) {
  if (win < 1 || win > kMaxWin || levels < 1 || levels > kMaxLevels || N < 1
      || pad < 0)
    return (int)cudaErrorInvalidValue;
  Params P;
  int win_floats = 0;   // the largest search window
  for (int l = 0; l < levels; ++l) {
    const int H = dims[4 * l], W = dims[4 * l + 1];
    const int Py = dims[4 * l + 2], Px = dims[4 * l + 3];
    if (H < 1 || W < 1 || Py < win + 1 || Px < win + 1 || Py > H + 2 * pad
        || Px > W + 2 * pad || Px > 32 * kMaxCols)
      return (int)cudaErrorInvalidValue;
    P.lv[l] = Level{reinterpret_cast<const float*>(prev[l]),
                    reinterpret_cast<const float*>(cur[l]), H, W, Py, Px};
    win_floats = max(win_floats, Py * window_stride(Px, win));
  }
  if (n == 0) return 0;
  // per warp: every level's template window, the gradient cells, then the
  // search window (at most 8 x 18^2 + 2 x 16 x 47 + 48 x 79 floats, 31 KB,
  // at win 15; 8 x 34^2 + 2 x 32 x 63 + 64 x 95, 76 KB, at win 31); two
  // warps a block where they fit in 48 KB, else one, opted in above 48 KB
  const int warp_floats = levels * (win + 3) * (win + 3)
                          + 2 * (win + 1) * (win + 32) + win_floats;
  const int warp_bytes = (int)sizeof(float) * warp_floats;
  if (warp_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int warps = warp_bytes * kWarpsPerBlock <= kStaticSmem ? kWarpsPerBlock : 1;
  P.pts = pts;
  P.init = init;
  P.masks = masks;
  P.uv = uv;
  P.status = status;
  P.rows = rows;
  P.levels = levels;
  P.n = n;
  P.N = N;
  P.pad = pad;
  P.max_iters = max_iters;
  P.warp_floats = warp_floats;
  P.init_scale = init_scale;
  P.eps2 = eps2;
  P.min_eig_thr = min_eig_thr;
  return launch<1>(win, P, (n + warps - 1) / warps, 32 * warps,
                   warp_bytes * warps, (cudaStream_t)stream);
}
