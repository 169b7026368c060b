// Kernel B: the whole multi-start stereo Levenberg-Marquardt pose solve,
// and the choice of the best start.
//
// Replaces the TPU kernel stereovision_slam_tpu/ops/pose_pallas.py
// `_pose_kernel` (called by `solve_pose_multi_lr`, which also takes the
// argmin over the starts). Same function: for each start, rounds x iters LM
// steps over 2F observations (left and right camera, each with its own
// intrinsics and rig->camera extrinsic) with a graduated Huber threshold
// chi2_th * 2^(rounds-1-rnd) (none in the last round), the damped 6x6
// normal equations (H + lam diag(H) + 1e-10 I) solved by an unrolled
// Cholesky, T <- exp(dx) T, acceptance when the robust cost drops (lam *
// 0.3, else lam * 5), and inlier re-levelling between rounds. Outputs per
// start: T, the inlier mask and the final robust cost; then the start of
// least cost (the first on ties or NaN, as torch.argmin): its T, its
// [left; right] inlier mask and its count of left inliers. A launch solves
// B streams at once (the reference's `jax.vmap` of the solve in
// multi-stream serving), with the cameras shared. On request it also writes
// its decisions (each LM step's acceptance, each round's inlier set), so
// that the plain version can replay them.
//
// What bounds it on an H100: latency. The inputs are ~10 KB and the work
// ~20 MFLOP for S = 3, F = 256, 3 x 6 steps; every LM step is a chain of a
// pass over the observations, a block reduction, a 6x6 solve and exp(dx).
//
// Design: one block per stream, a group of four warps per start (S <= 8).
// Each thread owns observations f = t, t + 128, ... of both cameras. Up to
// 1024 points the stream's points and observations are staged once in
// shared memory and each thread keeps its inlier flags as bits of a
// register; above that (any F) the threads read their observations from
// global memory (L1/L2) and keep their inlier flags in their own bytes of
// the inlier output, which no other thread touches. The two layouts are
// template instances of one kernel: the arithmetic and its order per
// observation and per sum are the same in both. One pass over the
// observations per LM step, at the candidate exp(dx) T: it sums the robust
// cost and the 21 H and 6 b entries together. Accepted, those sums are the
// incumbent's for the next step; rejected, T and the inliers are unchanged,
// so the incumbent's saved sums serve again (the next step would compute
// the same values): a round costs iters + 1 passes, the re-levelling of the
// inliers is folded into the first pass of the next round (and the final
// cost into the last). Each warp reduces its 28 sums by recursive halving
// (31 shuffles, each lane ends with one sum), writes them to one of three
// rotating shared buffers, and the block meets at ONE barrier per pass. The
// incumbent's sums stay in their buffer; a pass writes into the one buffer
// that no thread may still read. After the barrier every thread sums its
// start's partials in the same fixed order, solves the damped system (one
// reciprocal per diagonal entry) and forms exp(dx) T (sincosf) itself, so
// all threads of a start hold the same T and lambda in registers and take
// the same branches: no broadcast and no second barrier. Precise math (no
// fast-math), built with --fmad=false like the other kernels: each
// observation's terms round as the plain version's do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroupWarps = 4;                  // warps per start
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMaxPoints = 1024;               // staged in shared memory
constexpr int kMaxStarts = 8;
constexpr int kSlots = 32;                      // 21 H + 6 b + cost, padded
constexpr int kCost = 27;

struct Cam {
  float fx, fy, cx, cy, R[9], t[3];
};

struct Proj {
  float qx, qy, qz, X, Y, iz, Z, ru, rv;
};

__device__ __forceinline__ Proj project(const float (&T)[12], const Cam& c,
                                        float4 p, float uo, float vo) {
  Proj q;
  q.qx = T[0] * p.x + T[1] * p.y + T[2] * p.z + T[3];
  q.qy = T[4] * p.x + T[5] * p.y + T[6] * p.z + T[7];
  q.qz = T[8] * p.x + T[9] * p.y + T[10] * p.z + T[11];
  q.X = c.R[0] * q.qx + c.R[1] * q.qy + c.R[2] * q.qz + c.t[0];
  q.Y = c.R[3] * q.qx + c.R[4] * q.qy + c.R[5] * q.qz + c.t[1];
  q.Z = c.R[6] * q.qx + c.R[7] * q.qy + c.R[8] * q.qz + c.t[2];
  const float Zs = fabsf(q.Z) < 1e-8f ? 1e-8f : q.Z;
  q.iz = 1.0f / Zs;
  q.ru = c.fx * q.X * q.iz + c.cx - uo;
  q.rv = c.fy * q.Y * q.iz + c.cy - vo;
  return q;
}

// 12 pose-Jacobian columns (a, i) -> a*6+i, the reference's contraction
// order: J_proj (2x3, structural zeros skipped) times [R_ext | R_ext -hat(q)].
__device__ __forceinline__ void jac_cols(const Proj& p, const Cam& c,
                                         float J[12]) {
  const float iz2 = p.iz * p.iz;
  const float j00 = c.fx * p.iz, j02 = -c.fx * p.X * iz2;
  const float j11 = c.fy * p.iz, j12 = -c.fy * p.Y * iz2;
  float rdq[6][3];
  for (int i = 0; i < 3; ++i)
    for (int r = 0; r < 3; ++r) rdq[i][r] = c.R[3 * r + i];
  for (int r = 0; r < 3; ++r) {
    const float* Rr = c.R + 3 * r;
    rdq[3][r] = Rr[1] * (-p.qz) + Rr[2] * p.qy;
    rdq[4][r] = Rr[0] * p.qz + Rr[2] * (-p.qx);
    rdq[5][r] = Rr[0] * (-p.qy) + Rr[1] * p.qx;
  }
  for (int i = 0; i < 6; ++i) {
    J[i] = j00 * rdq[i][0] + j02 * rdq[i][2];
    J[6 + i] = j11 * rdq[i][1] + j12 * rdq[i][2];
  }
}

__device__ __forceinline__ float robust(float c, bool huber, float th) {
  return (!huber || c <= th) ? c : 2.0f * sqrtf(th * c) - th;
}

// Raw chi2 with a point behind the camera at 1e12 (the re-levelling test).
__device__ __forceinline__ float chi2(const Proj& p) {
  return p.Z > 1e-6f ? p.ru * p.ru + p.rv * p.rv : 1e12f;
}

// Recursive halving over the warp: round o (16, 8, 4, 2, 1) keeps the half
// of the live slots that lane bit o selects and adds the partner lane's copy
// of it, so lane L ends with the warp's sum of slot L after 16 + 8 + 4 + 2 +
// 1 = 31 shuffles. Each sum is a fixed tree: the result is deterministic.
// The rounds are template instances, so every slot index is a constant and
// the vector stays in registers.
template <int O>
__device__ __forceinline__ void halving_round(float (&v)[kSlots], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) halving_round<O / 2>(v, lane);
}

__device__ __forceinline__ float warp_halving(float (&v)[kSlots]) {
  halving_round<16>(v, threadIdx.x & 31);
  return v[0];
}

// Solve (H + lam diag(H) + 1e-10 I) dx = -b, H given by its 21 lower-triangle
// sums in row order, by Cholesky with one reciprocal per diagonal entry.
__device__ __forceinline__ void damped_solve(const float (&tot)[kSlots],
                                             float lam, float dx[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0, q = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j, ++q) {
      float s = tot[q];
      if (i == j) s = (s + lam * s) + 1e-10f;
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        const float d = sqrtf(fmaxf(s, 1e-30f));
        L[i][i] = d;
        inv[i] = 1.0f / d;
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -tot[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * dx[k];
    dx[i] = s * inv[i];
  }
}

// Tn = exp([v, w]) T with the reference's Rodrigues / left-Jacobian forms.
__device__ __forceinline__ void se3_exp_compose(const float dx[6],
                                                const float (&T)[12],
                                                float (&Tn)[12]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const bool small = t2 < 1e-8f;
  const float t2s = small ? 1.0f : t2;
  const float th = sqrtf(t2s);
  float st, ct;
  sincosf(th, &st, &ct);
  // one reciprocal for the three quotients
  const float ith = 1.0f / th, it2 = ith * ith;
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) : st * ith;
  const float b = small ? 0.5f - t2 * (1.0f / 24.0f) : (1.0f - ct) * it2;
  const float c = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f)
                        : (th - st) * (it2 * ith);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (i != k && k != j) w2 = w2 + W[i][k] * W[k][j];
      const float e = (i == j) ? 1.0f : 0.0f;
      R[i][j] = (i == j) ? (e + 0.0f) + b * w2 : (e + a * W[i][j]) + b * w2;
      V[i][j] = (i == j) ? (e + 0.0f) + c * w2 : (e + b * W[i][j]) + c * w2;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float tr = ((0.0f + V[i][0] * dx[0]) + V[i][1] * dx[1]) + V[i][2] * dx[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = ((0.0f + R[i][0] * T[j]) + R[i][1] * T[4 + j]) + R[i][2] * T[8 + j];
      if (j == 3) s = s + tr;
      Tn[4 * i + j] = s;
    }
  }
}

struct Args {
  const float* camp;       // (2, 16)
  const float* pts;        // (B, F, 3)
  const float* uv_l;       // (B, F, 2)
  const float* uv_r;       // (B, F, 2)
  const unsigned char* valid_l;   // (B, F) bool
  const unsigned char* valid_r;
  const float* T0;         // (B, S, 3, 4)
  float* T_all;            // (B, S, 3, 4)
  unsigned char* inl_all;  // (B, S, 2, F) bool
  float* cost_all;         // (B, S)
  float* T_best;           // (B, 3, 4)
  unsigned char* inl_best; // (B, 2F) bool, [left; right]
  int* n_best;             // (B,) left inliers of the chosen start
  unsigned char* tr_acc;   // (B, S, rounds, iters) bool or null: accepted
  unsigned char* tr_lev;   // (B, S, rounds, 2, F) bool or null: inliers
  int F, S, rounds, iters;
  float chi2_th;
};

template <int kStarts, bool kStaged>
struct Smem {
  static constexpr int kObs = kStaged ? kMaxPoints : 1;
  Cam cams[2];
  float4 pts[kObs];                  // (x, y, z, 0)
  float4 uv[kObs];                   // (ul, vl, ur, vr)
  unsigned char valid[2][kObs];
  float4 part[3][kStarts][kGroupWarps][kSlots / 4];  // rotating partials
  float2 fin[kStarts][kGroupWarps];   // the final pass: cost, left inliers
};

// A thread's observations: point, (ul, vl, ur, vr) and validity of
// observation f of the stream (bF = b * F), from shared memory where they
// are staged, else from global memory.
template <int kStarts, bool kStaged>
__device__ __forceinline__ void observation(const Smem<kStarts, kStaged>& sm,
                                            const Args& a, size_t bF, int f,
                                            float4& p, float4& o) {
  if constexpr (kStaged) {
    p = sm.pts[f];
    o = sm.uv[f];
  } else {
    const size_t bf = bF + f;
    p = make_float4(a.pts[3 * bf], a.pts[3 * bf + 1], a.pts[3 * bf + 2], 0.0f);
    const float2 l = reinterpret_cast<const float2*>(a.uv_l)[bf];
    const float2 r = reinterpret_cast<const float2*>(a.uv_r)[bf];
    o = make_float4(l.x, l.y, r.x, r.y);
  }
}

template <int kStarts, bool kStaged>
__device__ __forceinline__ bool obs_valid(const Smem<kStarts, kStaged>& sm,
                                          const Args& a, size_t bF, int h,
                                          int f) {
  if constexpr (kStaged) return sm.valid[h][f] != 0;
  else return (h ? a.valid_r : a.valid_l)[bF + f] != 0;
}

// A thread's inlier flags, observation (k-th of the thread, camera h, index
// f): bits 2k + h of a register where the points are staged, else the
// thread's own bytes of its start's rows of the inlier output.
template <bool kStaged>
struct Inliers;

template <>
struct Inliers<true> {
  unsigned bits = 0;
  __device__ __forceinline__ Inliers(unsigned char*, int) {}
  __device__ __forceinline__ bool get(int k, int h, int) const {
    return (bits >> (2 * k + h)) & 1u;
  }
  __device__ __forceinline__ void set(int k, int h, int, bool on) {
    const unsigned bit = 1u << (2 * k + h);
    bits = on ? (bits | bit) : (bits & ~bit);
  }
};

template <>
struct Inliers<false> {
  unsigned char* rows;   // (2, F) of this start
  int F;
  __device__ __forceinline__ Inliers(unsigned char* r, int n) : rows(r), F(n) {}
  __device__ __forceinline__ bool get(int, int h, int f) const {
    return rows[h * F + f] != 0;
  }
  __device__ __forceinline__ void set(int, int h, int f, bool on) {
    rows[h * F + f] = on ? 1 : 0;
  }
};

// One pass of a start's threads over their observations at pose Tp.
// kRelevel: first set each observation's inlier bit from its raw chi2 at
// Tp (valid and chi2 <= lev_th). kFinal: sum the final cost (valid: min(chi2,
// chi2_th), else chi2_th) into slot 0 and the left inliers into slot 1;
// otherwise the robust cost into slot kCost and H, b into slots 0-26, over
// the inliers in front of the camera.
template <int kStarts, bool kStaged, bool kRelevel, bool kFinal>
__device__ __forceinline__ void pass(const Smem<kStarts, kStaged>& sm,
                                     const Args& a, size_t bF,
                                     const Cam (&cams)[2], int t, int F,
                                     const float (&Tp)[12], bool huber,
                                     float th, float lev_th, float chi2_th,
                                     Inliers<kStaged>& inl,
                                     float (&acc)[kSlots]) {
#pragma unroll
  for (int q = 0; q < kSlots; ++q) acc[q] = 0.0f;
  for (int f = t, k = 0; f < F; f += kGroupThreads, ++k) {
    float4 p, o;
    observation(sm, a, bF, f, p, o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!kRelevel && !inl.get(k, h, f)) continue;
      const Proj pr = project(Tp, cams[h], p, h ? o.z : o.x, h ? o.w : o.y);
      if (kRelevel) {
        const bool val = obs_valid(sm, a, bF, h, f);
        const float cr = chi2(pr);
        const bool on = val && cr <= lev_th;
        inl.set(k, h, f, on);
        if (kFinal) {
          acc[0] += val ? fminf(cr, chi2_th) : chi2_th;
          if (h == 0 && on) acc[1] += 1.0f;
          continue;
        }
        if (!on) continue;
      }
      if (!(pr.Z > 1e-6f)) continue;
      const float c = pr.ru * pr.ru + pr.rv * pr.rv;
      float w = 1.0f;
      if (huber && !(c <= th)) w = sqrtf(th / fmaxf(c, 1e-20f));
      float J[12];
      jac_cols(pr, cams[h], J);
      int q = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float wu = w * J[i], wv = w * J[6 + i];
#pragma unroll
        for (int j = 0; j <= i; ++j, ++q) acc[q] += wu * J[j] + wv * J[6 + j];
        acc[21 + i] += wu * pr.ru + wv * pr.rv;
      }
      acc[kCost] += robust(c, huber, th);
    }
  }
}

// The block's sums of start s from the partials of buffer `buf`, in every
// lane: lane q < 28 adds slot q's warp partials in warp order, then the
// sums are broadcast by shuffles, so every thread holds the same bits.
template <int kStarts, bool kStaged>
__device__ __forceinline__ void start_sums(const Smem<kStarts, kStaged>& sm,
                                           int buf,
                                           int s, float (&tot)[kSlots]) {
  const int lane = threadIdx.x & 31;
  const float* p = reinterpret_cast<const float*>(sm.part[buf][s][0]);
  float mine = p[lane];
#pragma unroll
  for (int w = 1; w < kGroupWarps; ++w) mine += p[w * kSlots + lane];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) tot[q] = __shfl_sync(0xffffffffu, mine, q);
}

template <int kStarts, bool kStaged>
__device__ __forceinline__ float slot_sum(const Smem<kStarts, kStaged>& sm,
                                          int buf,
                                          int s, int q) {
  const float* p = reinterpret_cast<const float*>(sm.part[buf][s][0]);
  float v = p[q];
#pragma unroll
  for (int w = 1; w < kGroupWarps; ++w) v += p[w * kSlots + q];
  return v;
}

// The rotating buffer that no thread of the start may still read: neither
// the incumbent's nor the one written last.
__device__ __forceinline__ int free_buffer(int inc, int last) {
  return (inc != 0 && last != 0) ? 0 : (inc != 1 && last != 1) ? 1 : 2;
}

// Reduce acc over the block into buffer `buf` and wait for every warp: the
// pass's one barrier.
template <int kStarts, bool kStaged>
__device__ __forceinline__ void publish(Smem<kStarts, kStaged>& sm, int buf,
                                        int s,
                                        float (&acc)[kSlots]) {
  const float v = warp_halving(acc);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
  reinterpret_cast<float*>(sm.part[buf][s][warp])[lane] = v;
  __syncthreads();
}

template <int kStarts, bool kStaged>
__global__ void __launch_bounds__(kGroupThreads * kStarts)
pose_lm_kernel(const Args a) {
  __shared__ Smem<kStarts, kStaged> sm;
  const int b = blockIdx.x, F = a.F, S = a.S;
  const int s = threadIdx.x / kGroupThreads, t = threadIdx.x % kGroupThreads;
  const int bs = b * S + s;

  if (threadIdx.x < 2) {
    const float* cp = a.camp + 16 * threadIdx.x;
    Cam c;
    c.fx = cp[0]; c.fy = cp[1]; c.cx = cp[2]; c.cy = cp[3];
    for (int k = 0; k < 9; ++k) c.R[k] = cp[4 + k];
    for (int k = 0; k < 3; ++k) c.t[k] = cp[13 + k];
    sm.cams[threadIdx.x] = c;
  }
  const size_t bF = (size_t)b * F;
  if constexpr (kStaged) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      const size_t bf = bF + f;
      sm.pts[f] = make_float4(a.pts[3 * bf], a.pts[3 * bf + 1], a.pts[3 * bf + 2], 0.0f);
      const float2 l = reinterpret_cast<const float2*>(a.uv_l)[bf];
      const float2 r = reinterpret_cast<const float2*>(a.uv_r)[bf];
      sm.uv[f] = make_float4(l.x, l.y, r.x, r.y);
      sm.valid[0][f] = a.valid_l[bf];
      sm.valid[1][f] = a.valid_r[bf];
    }
  }
  float T[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = a.T0[12 * bs + q];
  __syncthreads();
  const Cam cams[2] = {sm.cams[0], sm.cams[1]};

  // inliers start as the valid observations (round 0 does not re-level)
  Inliers<kStaged> inl(a.inl_all + (size_t)bs * 2 * F, F);
  for (int f = t, k = 0; f < F; f += kGroupThreads, ++k)
    for (int h = 0; h < 2; ++h) inl.set(k, h, f, obs_valid(sm, a, bF, h, f));
  // the decisions, where asked for: round rnd's inlier set after its
  // re-levelling, and each step's acceptance
  auto trace_level = [&](int rnd) {
    if (a.tr_lev == nullptr) return;
    unsigned char* row = a.tr_lev + ((size_t)bs * a.rounds + rnd) * 2 * F;
    for (int f = t, k = 0; f < F; f += kGroupThreads, ++k)
      for (int h = 0; h < 2; ++h) row[(size_t)h * F + f] = inl.get(k, h, f);
  };
  trace_level(0);

  // The incumbent's sums stay in shared memory, in buffer `inc`: a pass
  // writes into the one buffer that no thread of its start may still read.
  float acc[kSlots];
  int inc = 0, last = 0;
  for (int rnd = 0; rnd < a.rounds; ++rnd) {
    const bool huber = rnd < a.rounds - 1;
    const float th = a.chi2_th * (float)(1 << (a.rounds - 1 - rnd));
    // the incumbent's sums, after re-levelling on the previous round's
    // threshold
    const float lev_th = a.chi2_th * (float)(1 << max(a.rounds - 1 - rnd, 0));
    if (rnd == 0)
      pass<kStarts, kStaged, false, false>(sm, a, bF, cams, t, F, T, huber, th, 0.0f, a.chi2_th, inl, acc);
    else
      pass<kStarts, kStaged, true, false>(sm, a, bF, cams, t, F, T, huber, th, lev_th, a.chi2_th, inl, acc);
    if (rnd > 0) trace_level(rnd);
    inc = last = free_buffer(inc, last);
    publish(sm, inc, s, acc);
    float inc_cost = slot_sum(sm, inc, s, kCost);
    float lam = 1e-6f;
    for (int itr = 0; itr < a.iters; ++itr) {
      float dx[6], Tn[12];
      {
        float tot[kSlots];
        start_sums(sm, inc, s, tot);
        damped_solve(tot, lam, dx);
      }
      se3_exp_compose(dx, T, Tn);
      pass<kStarts, kStaged, false, false>(sm, a, bF, cams, t, F, Tn, huber, th, 0.0f, a.chi2_th, inl, acc);
      last = free_buffer(inc, last);
      publish(sm, last, s, acc);
      const float cand = slot_sum(sm, last, s, kCost);
      if (a.tr_acc != nullptr && t == 0)
        a.tr_acc[((size_t)bs * a.rounds + rnd) * a.iters + itr] = cand < inc_cost;
      if (cand < inc_cost) {
#pragma unroll
        for (int q = 0; q < 12; ++q) T[q] = Tn[q];
        inc = last;
        inc_cost = cand;
        lam = fmaxf(lam * 0.3f, 1e-9f);
      } else {
        lam = fminf(lam * 5.0f, 1e5f);
      }
    }
  }
  // the last re-levelling (on chi2_th) and the final cost, then the argmin
  pass<kStarts, kStaged, true, true>(sm, a, bF, cams, t, F, T, false, 0.0f, a.chi2_th, a.chi2_th, inl, acc);
  {
    const float v = warp_halving(acc);
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
    if (lane < 2) reinterpret_cast<float*>(&sm.fin[s][warp])[lane] = v;
    __syncthreads();
  }
  float my_cost = 0.0f, best_cost = 0.0f, n_left = 0.0f;
  int best = 0;
  for (int u = 0; u < S; ++u) {
    float c = sm.fin[u][0].x, n = sm.fin[u][0].y;
#pragma unroll
    for (int w = 1; w < kGroupWarps; ++w) {
      c += sm.fin[u][w].x;
      n += sm.fin[u][w].y;
    }
    if (u == s) my_cost = c;
    // torch.argmin: the first NaN, else the first least cost
    if (u == 0 || (!isnan(best_cost) && (isnan(c) || c < best_cost))) {
      best = u;
      best_cost = c;
      n_left = n;
    }
  }

  for (int f = t, k = 0; f < F; f += kGroupThreads, ++k) {
    for (int h = 0; h < 2; ++h) {
      const unsigned char on = inl.get(k, h, f) ? 1 : 0;
      if constexpr (kStaged) a.inl_all[((size_t)bs * 2 + h) * F + f] = on;
      if (s == best) a.inl_best[((size_t)b * 2 + h) * F + f] = on;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < 12; ++q) a.T_all[12 * bs + q] = T[q];
    a.cost_all[bs] = my_cost;
    if (s == best) {
#pragma unroll
      for (int q = 0; q < 12; ++q) a.T_best[12 * b + q] = T[q];
      a.n_best[b] = (int)n_left;
    }
  }
}

}  // namespace

template <int kStarts, bool kStaged>
int launch_kernel(const Args& a, int B, cudaStream_t stream) {
  pose_lm_kernel<kStarts, kStaged><<<B, kGroupThreads * a.S, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// One block per stream, four warps per start; any F (staged in shared
// memory up to kMaxPoints). tr_acc and tr_lev may be null (no trace).
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for sizes
// the kernel does not take.
extern "C" int pose_lm_launch(const float* camp, const float* pts,
                              const float* uv_l, const float* uv_r,
                              const unsigned char* valid_l,
                              const unsigned char* valid_r, const float* T0,
                              float* T_all, unsigned char* inl_all,
                              float* cost_all, float* T_best,
                              unsigned char* inl_best, int* n_best,
                              unsigned char* tr_acc, unsigned char* tr_lev,
                              int B,
                              int F, int S, int rounds, int iters,
                              float chi2_th, void* stream) {
  if (F < 0 || S < 1 || S > kMaxStarts || rounds < 1
      || rounds > 30 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{camp, pts, uv_l, uv_r, valid_l, valid_r, T0, T_all, inl_all,
               cost_all, T_best, inl_best, n_best, tr_acc, tr_lev, F, S,
               rounds, iters, chi2_th};
  const cudaStream_t st = (cudaStream_t)stream;
  if (F <= kMaxPoints)
    return S <= 3 ? launch_kernel<3, true>(a, B, st)
                  : launch_kernel<kMaxStarts, true>(a, B, st);
  return S <= 3 ? launch_kernel<3, false>(a, B, st)
                : launch_kernel<kMaxStarts, false>(a, B, st);
}
