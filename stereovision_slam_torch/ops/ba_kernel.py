"""The keyframe window's bundle adjustment in one launch per pass: the CUDA
kernel of `csrc/ba_window.cu` (it replaces no Pallas kernel: the
reference's `optimize_window` is plain XLA).

`backend.optimize_window` sends a map on a CUDA device to `launch` and any
other to `backend.optimize_window_plain`, the plain PyTorch version. The
kernel computes the plain version's pass: the same compaction of the
active landmarks (capped at `max_active_landmarks`), residuals, Jacobians,
Huber weights, damping, gauge, LM steps and lambda schedule, outlier
threshold, unlinking and statistics; the normal-equation blocks are summed
in float64 and rounded once to float32, everything else is float32. It
forms the Schur complement landmark by landmark over the keyframe pairs a
landmark is observed in, and solves the reduced system over the free
keyframes only; `landmark_major_step` is that formulation in plain PyTorch,
so the CPU tests hold it to `backend._assemble` + `backend.schur_solve`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stereovision_slam_torch.geometry import jacobians
from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.ops.pose_kernel import camera_block

MAX_K = 32          # csrc/ba_window.cu kMaxK: keyframe slots
MAX_ROUNDS = 32     # kMaxRounds: outlier rounds
launch_count = 0
# ba_window_launch(camp, kf_pose, kf_id, kf_valid, lm_pos, lm_valid,
#                  lm_obs_count, uv_l, uv_r, obs_lm, obs_has_r, obs_valid,
#                  o_kf_pose, o_lm_pos, o_obs_lm, o_has_r, o_count, o_stats,
#                  o_th, work, K, F, L, La, compact, iters, rounds,
#                  chi2_th, huber_d2, stream)
_ARGTYPES = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def launch(m, cam_left, cam_right, *, chi2_th: float, iters: int,
           outlier_rounds: int, max_active_landmarks: int | None):
    """One BA pass (`backend.optimize_window`) over a map on a CUDA device,
    one launch of the kernel. The outputs and the workspace are allocated
    here, so a captured graph's pool holds them. Raises on what the kernel
    does not take. Returns (new_map, (num_obs, num_outliers, final_chi2_th,
    lm_overflow), landmarks solved), all tensors."""
    K, F = m.obs_lm.shape
    L = m.lm_valid.shape[0]
    compact = max_active_landmarks is not None and max_active_landmarks < L
    La = max_active_landmarks if compact else L
    dev = m.kf_pose.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    want = {"kf_pose": ((K, 3, 4), f32), "kf_id": ((K,), i32),
            "kf_valid": ((K,), b8), "lm_pos": ((L, 3), f32),
            "lm_valid": ((L,), b8), "lm_obs_count": ((L,), i32),
            "obs_uv_l": ((K, F, 2), f32), "obs_uv_r": ((K, F, 2), f32),
            "obs_lm": ((K, F), i32), "obs_has_r": ((K, F), b8),
            "obs_valid": ((K, F), b8)}
    ins = {}
    for name, (shape, dtype) in want.items():
        t = getattr(m, name)
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"optimize_window: {name} must be a {dtype} "
                             f"{shape} tensor on {dev}")
        ins[name] = t.contiguous()
    if not 1 <= K <= MAX_K:
        raise ValueError(f"optimize_window: the kernel takes 1 to {MAX_K} "
                         f"keyframe slots (MAX_K), got {K}")
    if not 0 <= outlier_rounds <= MAX_ROUNDS:
        raise ValueError(f"optimize_window: the kernel takes 0 to "
                         f"{MAX_ROUNDS} outlier rounds, got {outlier_rounds}")
    if iters < 0 or La < 1:
        raise ValueError(f"optimize_window: iters {iters} and La {La} must "
                         f"be >= 0 and >= 1")
    camp = camera_block(cam_left, cam_right).to(dev)
    out = dict(kf_pose=torch.empty((K, 3, 4), dtype=f32, device=dev),
               lm_pos=torch.empty((L, 3), dtype=f32, device=dev),
               obs_lm=torch.empty((K, F), dtype=i32, device=dev),
               obs_has_r=torch.empty((K, F), dtype=b8, device=dev),
               lm_obs_count=torch.empty((L,), dtype=i32, device=dev))
    stats = torch.empty((4,), dtype=torch.int64, device=dev)
    th = torch.empty((1,), dtype=f32, device=dev)
    nbytes = _cuda.function("ba_window", "ba_window_workspace",
                            [ctypes.c_int] * 5)(K, F, L, La, outlier_rounds)
    if nbytes < 0:
        raise ValueError(f"optimize_window: the workspace of K {K}, F {F}, "
                         f"L {L}, La {La} passes 2 GB")
    work = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    fn = _cuda.function("ba_window", "ba_window_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    huber_d2 = float(np.float32(chi2_th * chi2_th))
    _cuda.launch(fn, "ba_window", camp, camp.data_ptr(),
                 *(t.data_ptr() for t in ins.values()),
                 *(t.data_ptr() for t in out.values()), stats.data_ptr(),
                 th.data_ptr(), work.data_ptr(), K, F, L, La, int(compact),
                 iters, outlier_rounds, float(chi2_th), huber_d2)
    return (m._replace(**out), (stats[0], stats[1], th[0], stats[2]),
            stats[3])


def landmark_major_step(r, J_pose, J_point, w, obs, K: int, L: int, lam,
                        kf_active, lm_active):
    """One LM step's (dx_pose (K, 6), dx_point (L, 3)) in the kernel's
    formulation, in plain PyTorch: the valid observations grouped by
    landmark, then keyframe, then flat index; H_ll, b_l and each (landmark,
    keyframe) G block summed in float64 over its group and rounded once
    (duplicate links of one keyframe to one landmark sum into one block);
    the Schur terms added only for the keyframe pairs a landmark is observed
    in; the damped reduced system solved over the active keyframes alone.
    The inputs are `backend._assemble`'s; the result is
    `backend.schur_solve`'s up to the order of its sums."""
    dt, dev = r.dtype, r.device
    M = obs.kf.shape[0]
    f64 = torch.float64
    on = w != 0
    wJp = torch.where(on[:, None, None], J_pose * w[:, None, None], 0.0)
    wJl = torch.where(on[:, None, None], J_point * w[:, None, None], 0.0)
    Jp = torch.where(on[:, None, None], J_pose, 0.0)
    Jl = torch.where(on[:, None, None], J_point, 0.0)
    rr = torch.where(on[:, None], r, 0.0)
    live = torch.nonzero(obs.valid & (obs.lm >= 0)).reshape(-1)
    lm, kf = obs.lm[live], obs.kf[live]
    order = torch.argsort((lm * K + kf) * M + live)
    live, lm, kf = live[order], lm[order], kf[order]

    def seg_sum(n, idx, blocks):
        acc = torch.zeros((n,) + blocks.shape[1:], dtype=f64, device=dev)
        return acc.index_add_(0, idx, blocks.to(f64)).to(dt)

    H_ll = seg_sum(L, lm, torch.einsum("nab,nac->nbc", wJl[live], Jl[live]))
    b_l = seg_sum(L, lm, torch.einsum("nab,na->nb", wJl[live], rr[live]))
    H_pp = seg_sum(K, kf, torch.einsum("nab,nac->nbc", wJp[live], Jp[live]))
    b_p = seg_sum(K, kf, torch.einsum("nab,na->nb", wJp[live], rr[live]))
    pair, group = torch.unique_consecutive(lm * K + kf, return_inverse=True)
    G = seg_sum(pair.shape[0], group,
                torch.einsum("nab,nac->nbc", wJp[live], Jl[live]))
    g_lm, g_kf = pair // K, pair % K

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hll_d = H_ll + lam * eye3 * torch.clamp(
        torch.diagonal(H_ll, dim1=-2, dim2=-1), min=1e-6)[..., None] * eye3
    Hll_inv = torch.where(lm_active[:, None, None], jacobians.inv3x3(Hll_d),
                          0.0)
    GH = torch.einsum("gac,gcd->gad", G, Hll_inv[g_lm])
    # every ordered pair of groups of one landmark
    first = torch.searchsorted(g_lm, g_lm)
    count = torch.bincount(g_lm, minlength=L)[g_lm]
    width = int(count.max()) if count.numel() else 0
    j = torch.arange(width, device=dev)
    g1 = torch.arange(g_lm.shape[0], device=dev)[:, None].expand(-1, width)
    g2 = first[:, None] + j[None, :]
    ok = j[None, :] < count[:, None]
    g1, g2 = g1[ok], g2[ok]
    S = torch.zeros((K * K, 6, 6), dtype=dt, device=dev)
    S.index_add_(0, g_kf[g1] * K + g_kf[g2],
                 -torch.einsum("pad,pbd->pab", GH[g1], G[g2]))
    S = S.reshape(K, K, 6, 6)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    idx = torch.arange(K, device=dev)
    S[idx, idx] += H_pp + lam * eye6 * torch.clamp(
        torch.diagonal(H_pp, dim1=-2, dim2=-1), min=1e-6)[..., None] * eye6
    b_s = b_p.clone().index_add_(0, g_kf,
                                 -torch.einsum("gad,gd->ga", GH, b_l[g_lm]))
    free = torch.nonzero(kf_active).reshape(-1)
    n = 6 * free.shape[0]
    dx_p = torch.zeros((K, 6), dtype=dt, device=dev)
    if n:
        S_f = S[free][:, free].permute(0, 2, 1, 3).reshape(n, n)
        dx_p[free] = torch.linalg.solve(S_f, -b_s[free].reshape(n)
                                        ).reshape(-1, 6)
    Gt_dx = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(
        0, g_lm, torch.einsum("gab,ga->gb", G, dx_p[g_kf]))
    dx_l = torch.einsum("lab,lb->la", Hll_inv, -b_l - Gt_dx)
    return dx_p, torch.where(lm_active[:, None], dx_l, 0.0)
