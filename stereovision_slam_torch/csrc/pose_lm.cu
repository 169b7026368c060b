// Kernel B: the whole multi-start stereo Levenberg-Marquardt pose solve.
//
// Replaces the TPU kernel stereovision_slam_tpu/ops/pose_pallas.py
// `_pose_kernel` (called by `solve_pose_multi_lr`). Same function: for each
// start, rounds x iters LM steps over 2F observations (left and right camera,
// each with its own intrinsics and rig->camera extrinsic) with a graduated
// Huber threshold chi2_th * 2^(rounds-1-rnd) (none in the last round), the
// damped 6x6 normal equations (H + lam diag(H) + 1e-10 I) solved by an
// unrolled Cholesky, T <- exp(dx) T, acceptance when the robust cost
// drops (lam * 0.3, else lam * 5), and inlier re-levelling between rounds.
// Outputs per start: T, the inlier mask, the final robust cost and the inlier
// count; the wrapper takes the argmin over starts.
//
// What bounds it on an H100: latency. The inputs are ~10 KB and the work is
// ~50 MFLOP for S=3, F=256, rounds*iters=18; each LM step is a chain of two
// block reductions and one serial 6x6 solve on one thread.
//
// Design: one block per start, 256 threads, each thread owning the left and
// right observation of up to kPerThread points (its point data and inlier
// flags live in registers). Each step reduces the 21 unique H entries, the
// 6 b entries and the incumbent robust cost with warp shuffles and then
// shared memory; thread 0 solves and forms exp(dx) T, which is broadcast
// through shared memory for the candidate-cost reduction. Reductions run in
// a fixed order, so a launch is deterministic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;           // F <= 1024
constexpr int kRed = 28;                // 21 H + 6 b + cost

struct Cam {
  float fx, fy, cx, cy, R[9], t[3];
};

struct Proj {
  float qx, qy, qz, X, Y, iz, Z, ru, rv;
};

__device__ __forceinline__ Proj project(const float* T, const Cam& c, float px,
                                        float py, float pz, float uo, float vo) {
  Proj p;
  p.qx = T[0] * px + T[1] * py + T[2] * pz + T[3];
  p.qy = T[4] * px + T[5] * py + T[6] * pz + T[7];
  p.qz = T[8] * px + T[9] * py + T[10] * pz + T[11];
  p.X = c.R[0] * p.qx + c.R[1] * p.qy + c.R[2] * p.qz + c.t[0];
  p.Y = c.R[3] * p.qx + c.R[4] * p.qy + c.R[5] * p.qz + c.t[1];
  p.Z = c.R[6] * p.qx + c.R[7] * p.qy + c.R[8] * p.qz + c.t[2];
  const float Zs = fabsf(p.Z) < 1e-8f ? 1e-8f : p.Z;
  p.iz = 1.0f / Zs;
  p.ru = c.fx * p.X * p.iz + c.cx - uo;
  p.rv = c.fy * p.Y * p.iz + c.cy - vo;
  return p;
}

// 12 pose-Jacobian columns (a, i) -> a*6+i, the reference's contraction
// order: J_proj (2x3, structural zeros skipped) times [R_ext | R_ext -hat(q)].
__device__ __forceinline__ void jac_cols(const Proj& p, const Cam& c, float J[12]) {
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

// Sum kRed-or-fewer per-thread values over the block, in a fixed order.
template <int K>
__device__ void block_sum(float (&v)[K], float (*warp_part)[kRed], float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_part[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = warp_part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    total[threadIdx.x] = s;
  }
  __syncthreads();
}

// Solve (6x6 PD) H x = -b, H given as its lower triangle.
__device__ void chol_solve(const float H[6][6], const float b[6], float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-30f)) : s / L[j][j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = -b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// T_new = exp([v, w]) T with the reference's Rodrigues / left-Jacobian forms.
__device__ void se3_exp_compose(const float dx[6], const float* T, float* Tn) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float t2 = wx * wx + wy * wy + wz * wz;
  const bool small = t2 < 1e-8f;
  const float t2s = small ? 1.0f : t2;
  const float th = sqrtf(t2s);
  const float st = sinf(th), ct = cosf(th);
  const float a = small ? 1.0f - t2 / 6.0f : st / th;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - ct) / t2s;
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f : (th - st) / (t2s * th);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float R[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      float w2 = 0.0f;
      for (int k = 0; k < 3; ++k)
        if (i != k && k != j) w2 = w2 + W[i][k] * W[k][j];
      const float e = (i == j) ? 1.0f : 0.0f;
      R[i][j] = (i == j) ? (e + 0.0f) + b * w2 : (e + a * W[i][j]) + b * w2;
      V[i][j] = (i == j) ? (e + 0.0f) + c * w2 : (e + b * W[i][j]) + c * w2;
    }
  }
  for (int i = 0; i < 3; ++i) {
    const float tr = ((0.0f + V[i][0] * dx[0]) + V[i][1] * dx[1]) + V[i][2] * dx[2];
    for (int j = 0; j < 4; ++j) {
      float s = ((0.0f + R[i][0] * T[j]) + R[i][1] * T[4 + j]) + R[i][2] * T[8 + j];
      if (j == 3) s = s + tr;
      Tn[4 * i + j] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ camp, const float* __restrict__ pts,
               const float* __restrict__ uv, const float* __restrict__ valid,
               const float* __restrict__ T0, float* __restrict__ T_out,
               float* __restrict__ inl_out, float* __restrict__ cost_out,
               float* __restrict__ nin_out, int F, int rounds, int iters,
               float chi2_th) {
  __shared__ float warp_part[kWarps][kRed];
  __shared__ float total[kRed];
  __shared__ float T_sh[12], Tn_sh[12];
  __shared__ Cam cams[2];
  const int s = blockIdx.x, tid = threadIdx.x;

  if (tid < 2) {
    const float* cp = camp + 16 * tid;
    Cam c;
    c.fx = cp[0]; c.fy = cp[1]; c.cx = cp[2]; c.cy = cp[3];
    for (int k = 0; k < 9; ++k) c.R[k] = cp[4 + k];
    for (int k = 0; k < 3; ++k) c.t[k] = cp[13 + k];
    cams[tid] = c;
  }
  if (tid < 12) T_sh[tid] = T0[12 * s + tid];

  float P[kPerThread][3], O[kPerThread][4];
  bool val[kPerThread][2], inl[kPerThread][2];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int f = tid + kThreads * k;
    const bool on = f < F;
    for (int d = 0; d < 3; ++d) P[k][d] = on ? pts[3 * f + d] : 0.0f;
    for (int d = 0; d < 4; ++d) O[k][d] = on ? uv[4 * f + d] : 0.0f;
    for (int h = 0; h < 2; ++h) {
      val[k][h] = on && valid[2 * f + h] > 0.5f;
      inl[k][h] = val[k][h];
    }
  }
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < rounds - 1;
    const float th = chi2_th * (float)(1 << (rounds - 1 - rnd));
    float lam = 1e-6f;                     // thread 0's copy is the live one
    for (int itr = 0; itr < iters; ++itr) {
      float acc[kRed];
#pragma unroll
      for (int q = 0; q < kRed; ++q) acc[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        for (int h = 0; h < 2; ++h) {
          if (!inl[k][h]) continue;
          const Proj p = project(T_sh, cams[h], P[k][0], P[k][1], P[k][2],
                                 O[k][2 * h], O[k][2 * h + 1]);
          if (!(p.Z > 1e-6f)) continue;
          const float c = p.ru * p.ru + p.rv * p.rv;
          float w = 1.0f;
          if (huber && !(c <= th)) w = sqrtf(th / fmaxf(c, 1e-20f));
          float J[12];
          jac_cols(p, cams[h], J);
          int q = 0;
          for (int i = 0; i < 6; ++i)
            for (int j = 0; j <= i; ++j, ++q)
              acc[q] += (w * J[i]) * J[j] + (w * J[6 + i]) * J[6 + j];
          for (int i = 0; i < 6; ++i)
            acc[21 + i] += (w * J[i]) * p.ru + (w * J[6 + i]) * p.rv;
          acc[27] += robust(c, huber, th);
        }
      }
      block_sum<kRed>(acc, warp_part, total);
      if (tid == 0) {
        float H[6][6], b[6], dx[6];
        int q = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j <= i; ++j, ++q) H[i][j] = H[j][i] = total[q];
        for (int i = 0; i < 6; ++i) {
          H[i][i] = (H[i][i] + lam * H[i][i]) + 1e-10f;
          b[i] = total[21 + i];
        }
        chol_solve(H, b, dx);
        se3_exp_compose(dx, T_sh, Tn_sh);
      }
      const float cost_T = total[27];
      __syncthreads();
      float cn[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        for (int h = 0; h < 2; ++h) {
          if (!inl[k][h]) continue;
          const Proj p = project(Tn_sh, cams[h], P[k][0], P[k][1], P[k][2],
                                 O[k][2 * h], O[k][2 * h + 1]);
          if (p.Z > 1e-6f) cn[0] += robust(p.ru * p.ru + p.rv * p.rv, huber, th);
        }
      }
      block_sum<1>(cn, warp_part, total);
      if (tid == 0) {
        const bool better = total[0] < cost_T;
        if (better) {
          for (int q = 0; q < 12; ++q) T_sh[q] = Tn_sh[q];
          lam = fmaxf(lam * 0.3f, 1e-9f);
        } else {
          lam = fminf(lam * 5.0f, 1e5f);
        }
      }
      __syncthreads();
    }
    // re-level the inliers on the raw chi2 at the refined pose
    const float next_th = chi2_th * (float)(1 << max(rounds - 2 - rnd, 0));
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      for (int h = 0; h < 2; ++h) {
        const Proj p = project(T_sh, cams[h], P[k][0], P[k][1], P[k][2],
                               O[k][2 * h], O[k][2 * h + 1]);
        const float c = p.Z > 1e-6f ? p.ru * p.ru + p.rv * p.rv : 1e12f;
        inl[k][h] = val[k][h] && c <= next_th;
      }
    }
  }

  float fin[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int f = tid + kThreads * k;
    if (f >= F) continue;
    for (int h = 0; h < 2; ++h) {
      const Proj p = project(T_sh, cams[h], P[k][0], P[k][1], P[k][2],
                             O[k][2 * h], O[k][2 * h + 1]);
      const float c = p.Z > 1e-6f ? p.ru * p.ru + p.rv * p.rv : 1e12f;
      fin[0] += val[k][h] ? fminf(c, chi2_th) : chi2_th;
      fin[1] += inl[k][h] ? 1.0f : 0.0f;
      inl_out[((size_t)s * 2 + h) * F + f] = inl[k][h] ? 1.0f : 0.0f;
    }
  }
  block_sum<2>(fin, warp_part, total);
  if (tid < 12) T_out[12 * s + tid] = T_sh[tid];
  if (tid == 0) {
    cost_out[s] = total[0];
    nin_out[s] = total[1];
  }
}

}  // namespace

extern "C" int pose_lm_launch(const float* camp, const float* pts,
                              const float* uv, const float* valid,
                              const float* T0, float* T_out, float* inl_out,
                              float* cost_out, float* nin_out, int F, int S,
                              int rounds, int iters, float chi2_th,
                              void* stream) {
  if (F > kThreads * kPerThread || rounds > 30) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  pose_lm_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
      camp, pts, uv, valid, T0, T_out, inl_out, cost_out, nin_out, F, rounds,
      iters, chi2_th);
  return (int)cudaGetLastError();
}
