// The keyframe window's bundle adjustment, one launch per pass: the whole
// of `slam/backend.py:optimize_window_plain` (landmark compaction, `iters`
// Levenberg-Marquardt steps over the Schur complement, the adaptive outlier
// threshold, the unlinking of outliers and the statistics).
//
// Replaces no Pallas kernel: the JAX package's
// stereovision_slam_tpu/slam/backend.py `optimize_window` is plain XLA
// (one-hot matmuls for the scatters, a dense solve). The port's plain
// PyTorch version of it dispatched some 3,000 small kernels a pass (at
// K = 16, F = 256, 1,024 landmarks, 6 steps), ~2.8 us each on the card.
//
// What bounds it on an H100: latency, not bytes or operations. A pass
// touches a few hundred KB and does tens of MFLOP (~5,000 live
// observations, ~1,000 landmarks with 3x3 blocks, a reduced camera system
// of at most 6 (K - 1) unknowns), but every LM step is a chain of
// dependent stages: residuals, per-landmark blocks, the Schur sums across
// landmarks, a dense factorization, back-substitution, the candidate's
// cost and the accept test; each stage is a few dependent L2 round trips.
// At the benchmark cell's shapes a pass takes ~0.5 ms against a bound of
// ~0.3 us by its operations: ~70 us an LM step, of which the Schur sums
// ~25, the per-landmark blocks ~16, the solve ~15, and the back-
// substitution and the candidate's residuals ~5 each (PERF.md).
//
// Design: one thread-block cluster (kCluster = 8 blocks of 512 threads, the
// portable cluster size) keeps the whole pass on the chip; the cluster's hardware barrier
// separates the stages, and the blocks exchange their stages' results
// through a workspace in global memory read and written at L2
// (ld.global.cg / st.global.cg). All sums are in a fixed order and no
// floating-point atomic is used, so two launches on one input agree bit
// for bit:
//   * once a pass, observations are grouped by compacted landmark (a count
//     and a placement with integer atomics, then each landmark's list
//     sorted by (keyframe, flat index)), so duplicate (landmark, keyframe)
//     links are adjacent and sum into one block, as the plain version's
//     `index_add_` on lm * K + kf does;
//   * per landmark (a thread each, the landmarks dealt round the blocks):
//     H_ll, b_l and the G row over the keyframes it is seen in, summed in
//     float64 and rounded once to float32; the damped adjugate inverse;
//     G H_ll^-1 per observed keyframe;
//   * per pair of free keyframes (a warp each): the Schur block summed only
//     over the landmarks both observe (a keyframe bit mask per landmark),
//     lane partials reduced by a butterfly; beside them, warps sum H_pp
//     and b_p over eighths of each free keyframe's rows in float64;
//   * block 0 assembles the damped reduced system over the free keyframes
//     in shared memory and solves it by Gauss-Jordan elimination over its
//     6x6 blocks (symmetric positive definite: no pivoting; three
//     barriers a block), then forms the candidate poses exp(dx) T;
//   * per landmark the back-substitution; per observation the candidate's
//     residuals, Jacobians and robust cost (per block a fixed tree, then
//     the blocks' partials in block order). Every thread takes the accept
//     decision and lambda's schedule itself from the same sums. An
//     accepted candidate's residuals are the next step's: one residual
//     pass per step.
// Precise math, built with --fmad=false like the other kernels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;               // keyframe slots: a 32-bit mask
constexpr int kMaxN = 6 * (kMaxK - 1);  // unknowns of the reduced system
constexpr int kMaxPairs = kMaxK * (kMaxK - 1) / 2;
constexpr int kMaxRounds = 32;
constexpr int kCluster = 8;          // blocks in the launch's one cluster
constexpr int kRec = 24;  // floats per observation record:
// r0 r1 c w in_front rho | J_pose (2x6) | J_point (2x3)
constexpr int kG = 20;    // floats per 6x3 block (18, padded to float4s)
constexpr int kHp = 27;   // H_pp (upper 21) and b_p (6), float64
constexpr int kChunks = 8;  // row chunks of a keyframe's H_pp sum
constexpr int kSortLocal = 32;  // landmark segments sorted in registers
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  size_t inv, sel, act, lc, cnt, cur, off, list, dec, mask, ipart, bins,
      fpart, obs, lmp, kfp, G, GH, Hinv, bl, S, gb, hp, dx, plist, pcnt,
      total;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int K, int F, int L, int La, int R) {
  constexpr size_t C = kCluster;
  const size_t M = 2 * (size_t)K * F;
  const size_t La4 = ((size_t)La + 3) & ~size_t(3);
  Layout y;
  size_t o = 0;
  auto take = [&o](size_t bytes) { const size_t at = o; o += round16(bytes); return at; };
  y.inv = take(4 * (size_t)L);
  y.sel = take(4 * (size_t)La);
  y.act = take(4 * (size_t)La);
  y.lc = take(4 * M);
  y.cnt = take(4 * (size_t)La);
  y.cur = take(4 * (size_t)La);
  y.off = take(4 * ((size_t)La + 1));
  y.list = take(4 * M);
  y.dec = take(4 * (size_t)La);
  y.mask = take(4 * La4);
  y.ipart = take(8 * 4 * C);
  y.bins = take(4 * C * (R + 2));
  y.fpart = take(4 * 2 * C);
  y.obs = take(4 * 2 * M * kRec);
  y.lmp = take(4 * 2 * 3 * (size_t)La);
  y.kfp = take(4 * 2 * 12 * (size_t)K);
  y.G = take(4 * kG * M);
  y.GH = take(4 * kG * M);
  y.Hinv = take(4 * 9 * (size_t)La);
  y.bl = take(4 * 3 * (size_t)La);
  y.S = take(4 * 36 * (size_t)(K * (K + 1) / 2));
  y.gb = take(4 * 6 * (size_t)K);
  y.hp = take(8 * kHp * kChunks * (size_t)K);
  y.dx = take(4 * 6 * (size_t)K);
  y.plist = take(8 * La4 * (size_t)(K * (K + 1) / 2));
  y.pcnt = take(4 * (size_t)(K * (K + 1) / 2));
  y.total = o;
  return y;
}

struct Args {
  const float* camp;          // (2, 16) fx fy cx cy R (9) t (3), left, right
  const float* kf_pose;       // (K, 3, 4)
  const int* kf_id;           // (K,)
  const unsigned char* kf_valid;
  const float* lm_pos;        // (L, 3)
  const unsigned char* lm_valid;
  const int* lm_obs_count;    // (L,)
  const float* uv_l;          // (K, F, 2)
  const float* uv_r;
  const int* obs_lm;          // (K, F)
  const unsigned char* obs_has_r;
  const unsigned char* obs_valid;
  float* o_kf_pose;
  float* o_lm_pos;
  int* o_obs_lm;
  unsigned char* o_has_r;
  int* o_count;
  long long* o_stats;         // num_obs, num_outliers, lm_overflow, landmarks
  float* o_th;
  char* work;
  int K, F, L, La, compact, iters, rounds;
  float chi2_th, huber_d2;
};

struct Work {
  int *inv, *sel, *act, *lc, *cnt, *cur, *off, *list, *dec;
  unsigned* mask;
  long long* ipart;
  int* bins;
  float *fpart, *obs, *lmp, *kfp, *G, *GH, *Hinv, *bl, *S, *gb, *dx;
  double* hp;
  int2* plist;
  int* pcnt;
};

// Workspace traffic between blocks goes through L2.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned ld(const unsigned* p) { return __ldcg(p); }
__device__ __forceinline__ long long ld(const long long* p) { return __ldcg(p); }
__device__ __forceinline__ double ld(const double* p) { return __ldcg(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void st(int* p, int v) { __stcg(p, v); }
__device__ __forceinline__ void st(unsigned* p, unsigned v) { __stcg(p, v); }
__device__ __forceinline__ void st(long long* p, long long v) { __stcg(p, v); }
__device__ __forceinline__ void st(double* p, double v) { __stcg(p, v); }

// N4 float4s from / to a 16-byte aligned address
template <int N4>
__device__ __forceinline__ void ld4(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

template <int N4>
__device__ __forceinline__ void st4(float* p, const float* in) {
#pragma unroll
  for (int i = 0; i < N4; ++i)
    __stcg(reinterpret_cast<float4*>(p) + i,
           make_float4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]));
}

__device__ __forceinline__ void sync_all() { cg::this_cluster().sync(); }

// Sum over the block, the same value in every thread, in a fixed order.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < kWarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__device__ long long block_count(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = lane < kWarps ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// Exclusive prefix of `v` over the block; *total gets the block's sum.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? red[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) red[32 + lane] = t;
  }
  __syncthreads();
  *total = red[32 + kWarps - 1];
  return x - v + (warp > 0 ? red[32 + warp - 1] : 0);
}

// Keyframe slot of flat observation m (left rows, then right rows).
__device__ __forceinline__ int kf_of(int m, int KF, int F) {
  return (m >= KF ? m - KF : m) / F;
}

// Residual, Jacobians, cost terms of one observation at pose T (3x4, row
// major) and point P, written to its record; returns its robust cost term
// (jacobians.reprojection_residual_jac, huber_weight and optimize_window's
// rho, in their order of operations).
__device__ float observe(const float* cam, const float* T, const float* P,
                         float mu, float mv, float d2, float* rec) {
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
  const float* Re = cam + 4;
  const float* te = cam + 13;
  float q[3], pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = (T[4 * i] * P[0] + T[4 * i + 1] * P[1] + T[4 * i + 2] * P[2])
           + T[4 * i + 3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = (Re[3 * i] * q[0] + Re[3 * i + 1] * q[1] + Re[3 * i + 2] * q[2])
            + te[i];
  const float X = pc[0], Y = pc[1], Z = pc[2];
  const float Zs = fabsf(Z) < 1e-8f ? 1e-8f : Z;
  const float iz = 1.f / Zs;
  const float iz2 = iz * iz;
  const float r0 = (fx * X * iz + cx) - mu;
  const float r1 = (fy * Y * iz + cy) - mv;
  const float j00 = fx * iz, j02 = -fx * X * iz2;
  const float j11 = fy * iz, j12 = -fy * Y * iz2;
  // dq/dxi = [I | -hat(q)], then R_ext dq/dxi (3x6) and R_ext R_T (3x3)
  const float D[3][6] = {{1.f, 0.f, 0.f, 0.f, q[2], -q[1]},
                         {0.f, 1.f, 0.f, -q[2], 0.f, q[0]},
                         {0.f, 0.f, 1.f, q[1], -q[0], 0.f}};
  float A[3][6], B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
      A[i][j] = Re[3 * i] * D[0][j] + Re[3 * i + 1] * D[1][j]
                + Re[3 * i + 2] * D[2][j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[i][j] = Re[3 * i] * T[j] + Re[3 * i + 1] * T[4 + j]
                + Re[3 * i + 2] * T[8 + j];
  }
  const float c = r0 * r0 + r1 * r1;
  const bool front = Z > 1e-6f;
  const float w = front ? (c <= d2 ? 1.f : sqrtf(d2 / fmaxf(c, 1e-20f))) : 0.f;
  const float rho = front ? (c <= d2 ? c : 2.f * sqrtf(d2 * c) - d2) : 0.f;
  rec[0] = r0;
  rec[1] = r1;
  rec[2] = c;
  rec[3] = w;
  rec[4] = front ? 1.f : 0.f;
  rec[5] = rho;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    rec[6 + j] = j00 * A[0][j] + 0.f * A[1][j] + j02 * A[2][j];
    rec[12 + j] = 0.f * A[0][j] + j11 * A[1][j] + j12 * A[2][j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rec[18 + j] = j00 * B[0][j] + 0.f * B[1][j] + j02 * B[2][j];
    rec[21 + j] = 0.f * B[0][j] + j11 * B[1][j] + j12 * B[2][j];
  }
  return rho;
}

// Records of every live observation of the stride at (kfp, lmp); returns
// the thread's sum of their robust costs.
__device__ float observe_all(const Args& a, const Work& w, const float* cams,
                             const float* kfp, const float* lmp, float* obs,
                             int gt, int GT) {
  const int KF = a.K * a.F, M = 2 * KF;
  float sum = 0.f;
  for (int m = gt; m < M; m += GT) {
    const int lc = ld(w.lc + m);
    if (lc < 0) continue;
    const bool right = m >= KF;
    const int km = right ? m - KF : m;
    const int k = km / a.F;
    float T[12], P[3], rec[kRec];
    ld4<3>(kfp + 12 * k, T);
#pragma unroll
    for (int i = 0; i < 3; ++i) P[i] = ld(lmp + 3 * lc + i);
    const float* uv = right ? a.uv_r : a.uv_l;
    sum += observe(cams + (right ? 16 : 0), T, P, uv[2 * km], uv[2 * km + 1],
                   a.huber_d2, rec);
    st4<kRec / 4>(obs + (size_t)kRec * m, rec);
  }
  return sum;
}

// exp(dx) T (se3.se3_exp then se3.se3_compose, as the plain version).
__device__ void exp_compose(const float* dx, const float* T, float* out) {
  const float v0 = dx[0], v1 = dx[1], v2 = dx[2];
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = t2 < 1e-8f;
  const float t2s = small ? 1.f : t2;
  const float t = sqrtf(t2s);
  const float s = sinf(t), co = cosf(t);
  const float A = small ? 1.f - t2 / 6.f : s / t;
  const float B = small ? 0.5f - t2 / 24.f : (1.f - co) / t2s;
  const float Cc = small ? 1.f / 6.f - t2 / 120.f : (t - s) / (t2s * t);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3], R[3][3], J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      R[i][j] = e + A * W[i][j] + B * W2[i][j];
      J[i][j] = e + B * W[i][j] + Cc * W2[i][j];
    }
  float tt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) tt[i] = J[i][0] * v0 + J[i][1] * v1 + J[i][2] * v2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[4 * i + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j];
    out[4 * i + 3] = (R[i][0] * T[3] + R[i][1] * T[7] + R[i][2] * T[11]) + tt[i];
  }
}

__device__ __forceinline__ int sym6(int r, int c) {  // packed upper 6x6
  const int a = r < c ? r : c, b = r < c ? c : r;
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

__global__ void __launch_bounds__(kThreads, 1) ba_window_kernel(Args a) {
  extern __shared__ float smat[];  // block 0's reduced system
  __shared__ float cams[32];
  __shared__ int sfree[kMaxK];
  __shared__ unsigned char spa[kMaxPairs + kMaxK], spb[kMaxPairs + kMaxK];
  __shared__ float spinv[36];
  __shared__ float surow[6 * (kMaxN + 1)];
  __shared__ float wacc[kWarps][42];
  __shared__ int sbins[kMaxRounds + 2];
  __shared__ int ired[64];
  __shared__ float fred[32];
  __shared__ long long lred[32];
  __shared__ int s_nf;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int C = kCluster;
  const int cr = blockIdx.x;
  const int gt = cr * kThreads + tid, GT = C * kThreads;
  const int gw = cr * kWarps + warp, GW = C * kWarps;
  const int K = a.K, F = a.F, L = a.L, La = a.La, KF = K * F, M = 2 * KF;
  const int La4 = (La + 3) & ~3;
  const int R = a.rounds;
  // landmarks dealt round the blocks: block cr takes cr, cr + C, ...
  const int lj0 = cr + C * tid, ljs = GT;
  const Layout y = layout(K, F, L, La, R);
  Work w;
  w.inv = (int*)(a.work + y.inv);
  w.sel = (int*)(a.work + y.sel);
  w.act = (int*)(a.work + y.act);
  w.lc = (int*)(a.work + y.lc);
  w.cnt = (int*)(a.work + y.cnt);
  w.cur = (int*)(a.work + y.cur);
  w.off = (int*)(a.work + y.off);
  w.list = (int*)(a.work + y.list);
  w.dec = (int*)(a.work + y.dec);
  w.mask = (unsigned*)(a.work + y.mask);
  w.ipart = (long long*)(a.work + y.ipart);
  w.bins = (int*)(a.work + y.bins);
  w.fpart = (float*)(a.work + y.fpart);
  w.obs = (float*)(a.work + y.obs);
  w.lmp = (float*)(a.work + y.lmp);
  w.kfp = (float*)(a.work + y.kfp);
  w.G = (float*)(a.work + y.G);
  w.GH = (float*)(a.work + y.GH);
  w.Hinv = (float*)(a.work + y.Hinv);
  w.bl = (float*)(a.work + y.bl);
  w.S = (float*)(a.work + y.S);
  w.gb = (float*)(a.work + y.gb);
  w.hp = (double*)(a.work + y.hp);
  w.dx = (float*)(a.work + y.dx);
  w.plist = (int2*)(a.work + y.plist);
  w.pcnt = (int*)(a.work + y.pcnt);

  // ---- set-up 1: cameras, the gauge, the free keyframes, compaction ----
  if (tid < 32) cams[tid] = a.camp[tid];
  if (warp == 0) {
    const bool v = lane < K && a.kf_valid[lane];
    int id = v ? a.kf_id[lane] : 2147483647;
    for (int o = 16; o > 0; o >>= 1) id = min(id, __shfl_xor_sync(kFull, id, o));
    const unsigned fm = __ballot_sync(kFull, v && a.kf_id[lane] != id);
    if (lane == 0) {
      int n = 0;
      for (int k = 0; k < K; ++k)
        if ((fm >> k) & 1u) sfree[n++] = k;
      s_nf = n;
      int t = 0;
      for (int i = 0; i < n; ++i)
        for (int j = i; j < n; ++j) {
          spa[t] = (unsigned char)i;
          spb[t] = (unsigned char)j;
          ++t;
        }
    }
  }
  int n_active = 0;
  for (int base = 0; base < L; base += kThreads) {
    const int l = base + tid;
    const int on = l < L && a.lm_valid[l] && a.lm_obs_count[l] > 0;
    int tile;
    const int rank = n_active + block_scan(on, ired, &tile);
    if ((base / kThreads) % C == cr && l < L) {
      if (a.compact) {
        const bool kept = on && rank < La;
        st(w.inv + l, kept ? rank : -1);
        if (kept) {
          st(w.sel + rank, l);
          st(w.act + rank, 1);
#pragma unroll
          for (int i = 0; i < 3; ++i) st(w.lmp + 3 * rank + i, a.lm_pos[3 * l + i]);
        }
      } else {
        st(w.inv + l, l);
        st(w.sel + l, l);
        st(w.act + l, on);
#pragma unroll
        for (int i = 0; i < 3; ++i) st(w.lmp + 3 * l + i, a.lm_pos[3 * l + i]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) a.o_lm_pos[3 * l + i] = a.lm_pos[3 * l + i];
    }
    n_active += tile;
  }
  const int n_sel = a.compact ? min(n_active, La) : La;
  for (int j = gt; j < La4; j += GT) {
    if (j >= n_sel && j < La) {
      st(w.sel + j, -1);
      st(w.act + j, 0);
#pragma unroll
      for (int i = 0; i < 3; ++i) st(w.lmp + 3 * j + i, 0.f);
    }
    if (j < La) {
      st(w.cnt + j, 0);
      st(w.cur + j, 0);
      st(w.dec + j, 0);
    } else {
      st(w.mask + j, 0u);  // the padding of the masks' 16-byte loads
    }
  }
  if (cr == 0)
    for (int i = tid; i < 12 * K; i += kThreads) st(w.kfp + i, a.kf_pose[i]);
  sync_all();

  // ---- set-up 2: each observation's compacted landmark, counted; the
  // records of the others zero (their weight reads 0) ----
  {
    long long nobs = 0, nlive = 0;
    for (int m = gt; m < M; m += GT) {
      const int km = m >= KF ? m - KF : m;
      const int lm = a.obs_lm[km];
      bool valid = a.obs_valid[km] && lm >= 0 && a.kf_valid[km / F];
      if (m >= KF) valid = valid && a.obs_has_r[km];
      nobs += valid;
      int lc = -1;
      if (valid && lm < L) lc = a.compact ? ld(w.inv + lm) : lm;
      st(w.lc + m, lc);
      if (lc >= 0) {
        atomicAdd(w.cnt + lc, 1);
        ++nlive;
      } else {
        float zero[kRec];
#pragma unroll
        for (int i = 0; i < kRec; ++i) zero[i] = 0.f;
        st4<kRec / 4>(w.obs + (size_t)kRec * m, zero);
        st4<kRec / 4>(w.obs + (size_t)kRec * (M + m), zero);
      }
    }
    nobs = block_count(nobs, lred);
    nlive = block_count(nlive, lred);
    if (tid == 0) {
      st(w.ipart + 4 * cr, nobs);
      st(w.ipart + 4 * cr + 1, nlive);
    }
  }
  sync_all();

  // ---- set-up 3: each landmark's segment of the observation list ----
  {
    int run = 0;
    for (int base = 0; base < La; base += kThreads) {
      const int j = base + tid;
      const int n = j < La ? ld(w.cnt + j) : 0;
      int tile;
      const int o = run + block_scan(n, ired, &tile);
      if ((base / kThreads) % C == cr && j < La) st(w.off + j, o);
      run += tile;
    }
    if (cr == 0 && tid == 0) st(w.off + La, run);
  }
  sync_all();
  for (int m = gt; m < M; m += GT) {
    const int lc = ld(w.lc + m);
    if (lc < 0) continue;
    const int p = atomicAdd(w.cur + lc, 1);
    st(w.list + ld(w.off + lc) + p, m);
  }
  sync_all();

  // ---- set-up 4: segments sorted by (keyframe, index); first residuals ----
  for (int j = lj0; j < La; j += ljs) {
    const int s = ld(w.off + j), e = ld(w.off + j + 1);
    unsigned mask = 0;
    if (e - s <= kSortLocal) {
      // load the segment, sort it in the thread's own memory, store it
      long long key[kSortLocal];
      for (int i = 0; i < e - s; ++i) {
        const int m = ld(w.list + s + i);
        key[i] = (long long)kf_of(m, KF, F) * M + m;
      }
      for (int i = 1; i < e - s; ++i) {
        const long long v = key[i];
        int q = i;
        for (; q > 0 && key[q - 1] > v; --q) key[q] = key[q - 1];
        key[q] = v;
      }
      for (int i = 0; i < e - s; ++i) {
        st(w.list + s + i, (int)(key[i] % M));
        mask |= 1u << (int)(key[i] / M);
      }
    } else {
      for (int i = s; i < e; ++i) {
        const int m = ld(w.list + i);
        const long long key = (long long)kf_of(m, KF, F) * M + m;
        int q = i;
        while (q > s) {
          const int pm = ld(w.list + q - 1);
          if ((long long)kf_of(pm, KF, F) * M + pm <= key) break;
          st(w.list + q, pm);
          --q;
        }
        st(w.list + q, m);
        mask |= 1u << kf_of(m, KF, F);
      }
    }
    st(w.mask + j, ld(w.act + j) ? mask : 0u);
  }
  {
    const float part = block_sum(
        observe_all(a, w, cams, w.kfp, w.lmp, w.obs, gt, GT), fred);
    if (tid == 0) st(w.fpart + cr, part);
  }
  sync_all();

  const int nf = s_nf, n = 6 * nf, np = nf * (nf + 1) / 2;
  // ---- set-up 5: per pair of free keyframes, the landmarks both see, as
  // (G H_ll^-1 block of the first, G block of the second) or, on the
  // diagonal, (block, landmark); in a fixed order. No barrier: the first
  // reader follows the next one ----
  for (int t = gw; t < np; t += GW) {
    const int k = sfree[spa[t]], k2 = sfree[spb[t]];
    const bool diag = k == k2;
    const unsigned below = (1u << k) - 1u, below2 = (1u << k2) - 1u;
    const unsigned both = (1u << k) | (1u << k2);
    int2* ent = w.plist + (size_t)La * t;
    int count = 0;
    for (int l4 = 4 * lane; l4 - 4 * lane < La4; l4 += 128) {
      uint4 m4 = make_uint4(0u, 0u, 0u, 0u);
      if (l4 < La4) m4 = __ldcg(reinterpret_cast<const uint4*>(w.mask + l4));
      const unsigned mks[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool hit = (mks[u] & both) == both;
        const unsigned ball = __ballot_sync(kFull, hit);
        if (hit) {
          const int l = l4 + u, o = ld(w.off + l);
          const int gk = o + __popc(mks[u] & below);
          __stcg(ent + count + __popc(ball & ((1u << lane) - 1u)),
                 make_int2(gk, diag ? l : o + __popc(mks[u] & below2)));
        }
        count += __popc(ball);
      }
    }
    if (lane == 0) st(w.pcnt + t, count);
  }
  int cur = 0;
  float cost = 0.f;
  for (int c = 0; c < C; ++c) cost += ld(w.fpart + c);
  float lam = 1e-4f;

  for (int it = 0; it < a.iters; ++it) {
    const float* obs = w.obs + (size_t)cur * M * kRec;
    const float* lmp = w.lmp + (size_t)cur * 3 * La;
    const float* kfp = w.kfp + (size_t)cur * 12 * K;
    const int nxt = 1 - cur;

    // (1) per landmark: H_ll, b_l, G, the damped inverse, G H_ll^-1
    for (int j = lj0; j < La; j += ljs) {
      const int act = ld(w.act + j), s = ld(w.off + j), e = ld(w.off + j + 1);
      if (!act) continue;
      double hl[6] = {0, 0, 0, 0, 0, 0}, bl[3] = {0, 0, 0};
      double g[18];
#pragma unroll
      for (int i = 0; i < 18; ++i) g[i] = 0.0;
      int ng = 0, kprev = -1;
      int ms[8];
      for (int i = s; i < e; ++i) {
        if ((i - s) % 8 == 0)  // the next eight entries, loaded together
#pragma unroll
          for (int u = 0; u < 8; ++u) ms[u] = i + u < e ? ld(w.list + i + u) : 0;
        const int m = ms[(i - s) % 8];
        const int k = kf_of(m, KF, F);
        float rec[kRec];
        ld4<kRec / 4>(obs + (size_t)kRec * m, rec);
        if (k != kprev && kprev >= 0) {
          float Gf[kG];
#pragma unroll
          for (int q = 0; q < 18; ++q) {
            Gf[q] = (float)g[q];
            g[q] = 0.0;
          }
          Gf[18] = Gf[19] = 0.f;
          st4<kG / 4>(w.G + (size_t)kG * (s + ng), Gf);
          ++ng;
        }
        kprev = k;
        const float wt = rec[3];
        if (wt == 0.f) continue;
        const float r0 = rec[0], r1 = rec[1];
        float wJp[2][6], wJl[2][3];
        const float* Jp = rec + 6;   // rows of 6
        const float* Jl = rec + 18;  // rows of 3
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          wJp[0][q] = Jp[q] * wt;
          wJp[1][q] = Jp[6 + q] * wt;
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          wJl[0][q] = Jl[q] * wt;
          wJl[1][q] = Jl[3 + q] * wt;
        }
        int t = 0;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int q = p; q < 3; ++q)
            hl[t++] += (double)(wJl[0][p] * Jl[q] + wJl[1][p] * Jl[3 + q]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          bl[p] += (double)(wJl[0][p] * r0 + wJl[1][p] * r1);
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            g[3 * p + q] += (double)(wJp[0][p] * Jl[q] + wJp[1][p] * Jl[3 + q]);
      }
      float H[3][3];
      {
        int t = 0;
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int q = p; q < 3; ++q) {
            H[p][q] = H[q][p] = (float)hl[t];
            ++t;
          }
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) H[p][p] = H[p][p] + lam * fmaxf(H[p][p], 1e-6f);
      const float A_ = H[0][0], B_ = H[0][1], C_ = H[0][2];
      const float D_ = H[1][0], E_ = H[1][1], F_ = H[1][2];
      const float G_ = H[2][0], H_ = H[2][1], I_ = H[2][2];
      const float A11 = E_ * I_ - F_ * H_;
      const float A21 = F_ * G_ - D_ * I_;
      const float A31 = D_ * H_ - E_ * G_;
      const float det = A_ * A11 + B_ * A21 + C_ * A31;
      const float idet = fabsf(det) > 1e-30f ? 1.f / det : 0.f;
      const float Hi[9] = {A11 * idet, (C_ * H_ - B_ * I_) * idet,
                           (B_ * F_ - C_ * E_) * idet,
                           A21 * idet, (A_ * I_ - C_ * G_) * idet,
                           (C_ * D_ - A_ * F_) * idet,
                           A31 * idet, (B_ * G_ - A_ * H_) * idet,
                           (A_ * E_ - B_ * D_) * idet};
#pragma unroll
      for (int q = 0; q < 9; ++q) st(w.Hinv + 9 * j + q, Hi[q]);
#pragma unroll
      for (int q = 0; q < 3; ++q) st(w.bl + 3 * j + q, (float)bl[q]);
      // the last group is still in g; the earlier ones are read back
      for (int gi = 0; gi < ng + (kprev >= 0); ++gi) {
        float Gv[kG], GHv[kG];
        if (gi < ng) {
          ld4<kG / 4>(w.G + (size_t)kG * (s + gi), Gv);
        } else {
#pragma unroll
          for (int q = 0; q < 18; ++q) Gv[q] = (float)g[q];
          Gv[18] = Gv[19] = 0.f;
          st4<kG / 4>(w.G + (size_t)kG * (s + gi), Gv);
        }
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            GHv[3 * p + q] = Gv[3 * p] * Hi[q] + Gv[3 * p + 1] * Hi[3 + q]
                             + Gv[3 * p + 2] * Hi[6 + q];
        GHv[18] = GHv[19] = 0.f;
        st4<kG / 4>(w.GH + (size_t)kG * (s + gi), GHv);
      }
    }
    sync_all();

    // (2) warps: per pair of free keyframes the Schur block (diagonal
    // pairs also G H_ll^-1 b_l); per eighth of a free keyframe's rows
    // its H_pp and b_p in float64
    for (int t = gw; t < np + kChunks * nf; t += GW) {
      if (t >= np) {
        const int fi = (t - np) / kChunks, qi = (t - np) % kChunks;
        const int k = sfree[fi];
        const int f0 = (2 * F) * qi / kChunks;
        const int f1 = (2 * F) * (qi + 1) / kChunks;
        double hp[21], bp[6];
#pragma unroll
        for (int q = 0; q < 21; ++q) hp[q] = 0.0;
#pragma unroll
        for (int q = 0; q < 6; ++q) bp[q] = 0.0;
        for (int f = f0 + lane; f < f1; f += 32) {
          const int m = f < F ? k * F + f : KF + k * F + (f - F);
          float rec[20];
          ld4<5>(obs + (size_t)kRec * m, rec);  // r, c, w, ..., J_pose
          const float wt = rec[3];
          if (wt == 0.f) continue;
          float wJp[2][6];
          const float* Jp = rec + 6;
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            wJp[0][q] = Jp[q] * wt;
            wJp[1][q] = Jp[6 + q] * wt;
          }
          int u = 0;
#pragma unroll
          for (int p = 0; p < 6; ++p)
#pragma unroll
            for (int q = p; q < 6; ++q)
              hp[u++] += (double)(wJp[0][p] * Jp[q] + wJp[1][p] * Jp[6 + q]);
#pragma unroll
          for (int p = 0; p < 6; ++p)
            bp[p] += (double)(wJp[0][p] * rec[0] + wJp[1][p] * rec[1]);
        }
#pragma unroll
        for (int q = 0; q < 21; ++q)
          for (int o = 16; o > 0; o >>= 1) hp[q] += __shfl_xor_sync(kFull, hp[q], o);
#pragma unroll
        for (int q = 0; q < 6; ++q)
          for (int o = 16; o > 0; o >>= 1) bp[q] += __shfl_xor_sync(kFull, bp[q], o);
        if (lane == 0) {
          double* out = w.hp + (size_t)kHp * (kChunks * k + qi);
#pragma unroll
          for (int q = 0; q < 21; ++q) st(out + q, hp[q]);
#pragma unroll
          for (int q = 0; q < 6; ++q) st(out + 21 + q, bp[q]);
        }
        continue;
      }
      const int k = sfree[spa[t]];
      const bool diag = spa[t] == spb[t];
      float acc[36], accb[6];
#pragma unroll
      for (int q = 0; q < 36; ++q) acc[q] = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) accb[q] = 0.f;
      // the pair's (G H_ll^-1 block, G block or landmark) entries
      const int cnt = ld(w.pcnt + t);
      const int2* ent = w.plist + (size_t)La * t;
      for (int i = lane; i < cnt; i += 32) {
        const int2 e = __ldcg(ent + i);
        float x[kG], z[kG];
        ld4<kG / 4>(w.GH + (size_t)kG * e.x, x);
        ld4<kG / 4>(w.G + (size_t)kG * (diag ? e.x : e.y), z);
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int q = 0; q < 6; ++q)
            acc[6 * p + q] += x[3 * p] * z[3 * q] + x[3 * p + 1] * z[3 * q + 1]
                              + x[3 * p + 2] * z[3 * q + 2];
        if (diag) {
          const float b0 = ld(w.bl + 3 * e.y), b1 = ld(w.bl + 3 * e.y + 1),
                      b2 = ld(w.bl + 3 * e.y + 2);
#pragma unroll
          for (int p = 0; p < 6; ++p)
            accb[p] += x[3 * p] * b0 + x[3 * p + 1] * b1 + x[3 * p + 2] * b2;
        }
      }
#pragma unroll
      for (int q = 0; q < 36; ++q)
        for (int o = 16; o > 0; o >>= 1) acc[q] += __shfl_xor_sync(kFull, acc[q], o);
#pragma unroll
      for (int q = 0; q < 6; ++q)
        for (int o = 16; o > 0; o >>= 1) accb[q] += __shfl_xor_sync(kFull, accb[q], o);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 36; ++q) wacc[warp][q] = acc[q];
#pragma unroll
        for (int q = 0; q < 6; ++q) wacc[warp][36 + q] = accb[q];
      }
      __syncwarp();
      for (int q = lane; q < 36; q += 32) st(w.S + (size_t)36 * t + q, -wacc[warp][q]);
      if (diag && lane < 6) st(w.gb + 6 * k + lane, wacc[warp][36 + lane]);
      __syncwarp();
    }
    sync_all();

    // (3) block 0: the damped reduced system, its solve, the candidate
    // poses
    if (cr == 0) {
      const int ldm = n + 1;
      for (int idx = tid; idx < 36 * np; idx += kThreads) {
        const int t = idx / 36, e = idx % 36, p = e / 6, q = e % 6;
        const int ra = 6 * spa[t] + p, cb = 6 * spb[t] + q;
        float v = ld(w.S + idx);
        if (spa[t] == spb[t]) {
          // S_kk = -sum G H_ll^-1 G^T + (H_pp + lam diag(H_pp))
          const double* hq = w.hp + (size_t)kHp * kChunks * sfree[spa[t]];
          double h = 0.0;
          for (int qi = 0; qi < kChunks; ++qi) h += ld(hq + kHp * qi + sym6(p, q));
          const float hf = (float)h;
          v = v + (hf + (p == q ? lam * fmaxf(hf, 1e-6f) : 0.f));
        }
        smat[ra * ldm + cb] = v;
        if (spa[t] != spb[t]) smat[cb * ldm + ra] = v;
      }
      for (int i = tid; i < n; i += kThreads) {
        const int k = sfree[i / 6], r = i % 6;
        const double* hq = w.hp + (size_t)kHp * kChunks * k;
        double b = 0.0;
        for (int qi = 0; qi < kChunks; ++qi) b += ld(hq + kHp * qi + 21 + r);
        smat[i * ldm + n] = -((float)b - ld(w.gb + 6 * k + r));
      }
      __syncthreads();
      // block Gauss-Jordan over the 6x6 blocks: warp 0 inverts the pivot
      // block, the pivot block row is multiplied by that inverse, and its
      // block column is cleared from every other row; three barriers a
      // block. No pivoting: the damped system is symmetric positive
      // definite (the Schur complement of a damped Gauss-Newton system)
      for (int kb = 0; kb < nf; ++kb) {
        const int r0 = 6 * kb, c0 = r0 + 6, wc = n + 1 - c0;
        if (warp == 0) {
          // lane r < 6 holds row r of [P | I]
          float row[12];
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            row[c] = lane < 6 ? smat[(r0 + lane) * ldm + r0 + c] : 0.f;
            row[6 + c] = lane == c ? 1.f : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            float pr[12];
#pragma unroll
            for (int q = 0; q < 12; ++q) pr[q] = __shfl_sync(kFull, row[q], c);
            const float inv = 1.f / pr[c];
            const float f = row[c] * inv;
#pragma unroll
            for (int q = 0; q < 12; ++q)
              row[q] = lane == c ? row[q] * inv : row[q] - f * pr[q];
          }
          if (lane < 6)
#pragma unroll
            for (int c = 0; c < 6; ++c) spinv[6 * lane + c] = row[6 + c];
        }
        __syncthreads();
        for (int idx = tid; idx < 6 * wc; idx += kThreads) {
          const int t = idx / wc, c = c0 + idx % wc;
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < 6; ++q) v += spinv[6 * t + q] * smat[(r0 + q) * ldm + c];
          surow[t * (kMaxN + 1) + c] = v;
        }
        __syncthreads();
        for (int idx = tid; idx < n * wc; idx += kThreads) {
          const int i = idx / wc, c = c0 + idx % wc;
          if (i >= r0 && i < c0) {
            smat[i * ldm + c] = surow[(i - r0) * (kMaxN + 1) + c];
          } else {
            float v = smat[i * ldm + c];
#pragma unroll
            for (int q = 0; q < 6; ++q)
              v -= smat[i * ldm + r0 + q] * surow[q * (kMaxN + 1) + c];
            smat[i * ldm + c] = v;
          }
        }
        __syncthreads();
      }
      if (tid < 6 * K) st(w.dx + tid, 0.f);
      __syncthreads();
      for (int i = tid; i < n; i += kThreads)
        st(w.dx + 6 * sfree[i / 6] + i % 6, smat[i * ldm + n]);
      __syncthreads();
      if (tid < K) {
        float T[12], out[12], d[6];
        ld4<3>(kfp + 12 * tid, T);
        bool is_free = false;
        for (int i = 0; i < nf; ++i) is_free = is_free || sfree[i] == tid;
        if (is_free) {
#pragma unroll
          for (int i = 0; i < 6; ++i) d[i] = ld(w.dx + 6 * tid + i);
          exp_compose(d, T, out);
        } else {
#pragma unroll
          for (int i = 0; i < 12; ++i) out[i] = T[i];
        }
        st4<3>(w.kfp + (size_t)nxt * 12 * K + 12 * tid, out);
      }
    }
    sync_all();

    // (4) per landmark: back-substitution, the candidate position
    {
      float* lmn = w.lmp + (size_t)nxt * 3 * La;
      for (int j = lj0; j < La; j += ljs) {
        // every load the landmark needs at once, its groups' after
        float P[3], v[3], Hi[9];
        const int act = ld(w.act + j), o = ld(w.off + j);
        const unsigned mk = ld(w.mask + j);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          P[q] = ld(lmp + 3 * j + q);
          v[q] = -ld(w.bl + 3 * j + q);
        }
#pragma unroll
        for (int q = 0; q < 9; ++q) Hi[q] = ld(w.Hinv + 9 * j + q);
        if (act) {
          float gx[3] = {0.f, 0.f, 0.f};
          int gi = 0;
          for (int k = 0; k < K; ++k) {
            if (!((mk >> k) & 1u)) continue;
            float Gv[kG], d[6];
            ld4<kG / 4>(w.G + (size_t)kG * (o + gi), Gv);
#pragma unroll
            for (int p = 0; p < 6; ++p) d[p] = ld(w.dx + 6 * k + p);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              float s = 0.f;
#pragma unroll
              for (int p = 0; p < 6; ++p) s += Gv[3 * p + q] * d[p];
              gx[q] += s;
            }
            ++gi;
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) v[q] = v[q] - gx[q];
#pragma unroll
          for (int q = 0; q < 3; ++q)
            P[q] = P[q] + (Hi[3 * q] * v[0] + Hi[3 * q + 1] * v[1] + Hi[3 * q + 2] * v[2]);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) st(lmn + 3 * j + q, P[q]);
      }
    }
    sync_all();

    // (5) the candidate's residuals and robust cost
    {
      const float part = block_sum(
          observe_all(a, w, cams, w.kfp + (size_t)nxt * 12 * K,
                      w.lmp + (size_t)nxt * 3 * La,
                      w.obs + (size_t)nxt * M * kRec, gt, GT),
          fred);
      if (tid == 0) st(w.fpart + nxt * C + cr, part);
    }
    sync_all();
    float cand = 0.f;
    for (int c = 0; c < C; ++c) cand += ld(w.fpart + nxt * C + c);
    const bool better = cand < cost;
    if (better) {
      cur = nxt;
      cost = cand;
    }
    lam = better ? fmaxf(lam * 0.5f, 1e-9f) : fminf(lam * 4.f, 1e4f);
  }

  // ---- the outlier threshold: inliers counted per doubling ----
  const float* obs = w.obs + (size_t)cur * M * kRec;
  if (tid < R + 2) sbins[tid] = 0;
  __syncthreads();
  for (int m = gt; m < M; m += GT) {
    if (ld(w.lc + m) < 0) continue;
    const float c = ld(obs + (size_t)kRec * m + 2);
    int b = R + 1;
    if (ld(obs + (size_t)kRec * m + 4) != 0.f) {
      float th = a.chi2_th;
      for (int i = 0; i <= R; ++i, th *= 2.f)
        if (c <= th) {
          b = i;
          break;
        }
    }
    atomicAdd(sbins + b, 1);
  }
  __syncthreads();
  if (tid < R + 2) st(w.bins + cr * (R + 2) + tid, sbins[tid]);
  {
    const float* lmp = w.lmp + (size_t)cur * 3 * La;
    for (int j = lj0; j < La; j += ljs) {
      if (a.compact && !ld(w.act + j)) continue;
      const int l = ld(w.sel + j);
#pragma unroll
      for (int q = 0; q < 3; ++q) a.o_lm_pos[3 * l + q] = ld(lmp + 3 * j + q);
    }
    if (cr == 0)
      for (int i = tid; i < 12 * K; i += kThreads)
        a.o_kf_pose[i] = ld(w.kfp + (size_t)cur * 12 * K + i);
  }
  sync_all();

  long long live = 0;
  for (int c = 0; c < C; ++c) live += ld(w.ipart + 4 * c + 1);
  const long long total = live > 1 ? live : 1;
  int level = 0;
  for (int r = 0; r < R; ++r) {
    long long inl = 0;
    for (int b = 0; b <= level; ++b)
      for (int c = 0; c < C; ++c) inl += ld(w.bins + c * (R + 2) + b);
    if (2 * inl <= total) ++level;
  }
  float th = a.chi2_th;
  for (int i = 0; i < level; ++i) th *= 2.f;
  {
    long long nout = 0;
    for (int km = gt; km < KF; km += GT) {
      bool sever = false;
      int lcs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = km + h * KF;
        lcs[h] = ld(w.lc + m);
        if (lcs[h] < 0) continue;
        const float* rec = obs + (size_t)kRec * m;
        const bool out = ld(rec + 4) == 0.f || ld(rec + 2) > th;
        nout += out;
        sever = sever || out;
      }
      a.o_obs_lm[km] = sever ? -1 : a.obs_lm[km];
      a.o_has_r[km] = a.obs_has_r[km] && !sever;
      if (sever)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (lcs[h] >= 0) atomicAdd(w.dec + lcs[h], 1);
    }
    nout = block_count(nout, lred);
    if (tid == 0) st(w.ipart + 4 * cr + 2, nout);
  }
  sync_all();

  for (int l = gt; l < L; l += GT) {
    const int j = ld(w.inv + l);
    const int d = j >= 0 ? ld(w.dec + j) : 0;
    a.o_count[l] = max(a.lm_obs_count[l] - d, 0);
  }
  if (cr == 0 && tid == 0) {
    long long nobs = 0, nout = 0;
    for (int c = 0; c < C; ++c) {
      nobs += ld(w.ipart + 4 * c);
      nout += ld(w.ipart + 4 * c + 2);
    }
    a.o_stats[0] = nobs;
    a.o_stats[1] = nout;
    a.o_stats[2] = a.compact ? n_active - n_sel : 0;
    a.o_stats[3] = a.compact ? n_sel : n_active;
    *a.o_th = th;
  }
}

}  // namespace

// Bytes of the launch's workspace (-1 past 2 GB).
extern "C" int ba_window_workspace(int K, int F, int L, int La, int rounds) {
  const size_t n = layout(K, F, L, La, rounds).total;
  return n < (size_t)2147483647 ? (int)n : -1;
}


// camp (2, 16); kf_pose (K, 3, 4); kf_id (K,) int32; kf_valid (K,) bytes;
// lm_pos (L, 3); lm_valid (L,) bytes; lm_obs_count (L,) int32; uv_l, uv_r
// (K, F, 2); obs_lm (K, F) int32; obs_has_r, obs_valid (K, F) bytes. Outputs
// of the same shapes, stats (4,) int64 and th (1,) float32; work holds
// ba_window_workspace(...) bytes, 16-byte aligned. One launch of one
// cluster of kCluster blocks.
extern "C" int ba_window_launch(
    const float* camp, const float* kf_pose, const int* kf_id,
    const unsigned char* kf_valid, const float* lm_pos,
    const unsigned char* lm_valid, const int* lm_obs_count, const float* uv_l,
    const float* uv_r, const int* obs_lm, const unsigned char* obs_has_r,
    const unsigned char* obs_valid, float* o_kf_pose, float* o_lm_pos,
    int* o_obs_lm, unsigned char* o_has_r, int* o_count, long long* o_stats,
    float* o_th, void* work, int K, int F, int L, int La, int compact,
    int iters, int rounds, float chi2_th, float huber_d2,
    void* stream) {
  if (K < 1 || K > kMaxK || F < 1 || L < 1 || La < 1 || La > L || iters < 0
      || rounds < 0 || rounds > kMaxRounds || ((uintptr_t)work & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{camp, kf_pose, kf_id, kf_valid, lm_pos, lm_valid, lm_obs_count,
         uv_l, uv_r, obs_lm, obs_has_r, obs_valid, o_kf_pose, o_lm_pos,
         o_obs_lm, o_has_r, o_count, o_stats, o_th, (char*)work,
         K, F, L, La, compact, iters, rounds, chi2_th, huber_d2};
  // block 0's reduced system at its largest, 6 (K - 1) unknowns; the
  // attributes are set once a device, before any stream capture
  const int nmax = 6 * (kMaxK - 1);
  const int smem = (int)sizeof(float) * nmax * (nmax + 1);
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(ba_window_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  const int nk = 6 * (K - 1);  // this window's largest system
  cfg.dynamicSmemBytes = sizeof(float) * (nk > 0 ? nk * (nk + 1) : 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ba_window_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
