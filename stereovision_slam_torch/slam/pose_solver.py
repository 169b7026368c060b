"""Pose-only Levenberg-Marquardt solver by LU (counterpart of
`slam/pose_solver.py`).

The `"xla"` arm of multi-stream serving (`frontend.track_step_serving`):
the reference's XLA pose solve, in plain PyTorch on every device. Per
start: `rounds x iters` LM steps over the observations with per-observation
cameras (`frontend._blend_obs_cameras`), a graduated Huber threshold
chi2_th * 2^(rounds-1-rnd) (none in the last round), the damped 6x6 normal
equations solved by LU, `se3_exp(dx) @ T`, incumbent-cost acceptance with
the 0.3 / 5 damping schedule, and inlier re-levelling between rounds.
Kernel B (`ops/pose_kernel.py`) runs the same schedule with a Cholesky
solve; the two agree up to the solve's rounding.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.slam.map_state import row


def _solve_damped(H, b, lam):
    """Solve (H + lam * diag(H)) dx = -b (LM with multiplicative damping),
    batched over leading axes."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    damped = (H + lam[..., None, None]
              * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
              + 1e-10 * eye)
    return torch.linalg.solve_ex(damped, -b)[0]


def _chi2(cam: Camera, T, points, obs):
    """Raw chi2 per observation; points behind the camera are never
    inliers."""
    r, _, _, p_cam = jacobians.reprojection_residual_jac(cam, T, points, obs)
    c = torch.sum(r * r, dim=-1)
    return torch.where(p_cam[..., 2] > 1e-6, c, torch.full_like(c, 1e12))


def _lm_rounds(cam: Camera, T_init, points, obs, valid, chi2_th: float,
               rounds: int, iters: int):
    """The LM schedule from K starts at once: T_init (K, 3, 4); points
    (N, 3), obs (N, 2), valid (N,). Returns (T (K, 3, 4), inlier (K, N))."""
    dtype = T_init.dtype
    K = T_init.shape[0]
    inlier = valid.expand(K, -1)
    T = T_init
    for rnd in range(rounds):
        use_huber = rnd < rounds - 1
        # graduated non-convexity: early rounds loosen the robust threshold
        round_th = torch.full((), chi2_th * float(2 ** (rounds - 1 - rnd)),
                              dtype=dtype, device=T.device)

        def robust(c):
            if not use_huber:
                return c
            return torch.where(c <= round_th, c,
                               2.0 * torch.sqrt(round_th * c) - round_th)

        lam = torch.full((K,), 1e-6, dtype=dtype, device=T.device)
        for _ in range(iters):
            r, J, _, p_cam = jacobians.reprojection_residual_jac(
                cam, T[:, None], points, obs)
            m_top = inlier & (p_cam[..., 2] > 1e-6)
            w = m_top.to(dtype)
            c_top = torch.sum(r * r, dim=-1)
            if use_huber:
                w = w * jacobians.huber_weight(c_top, round_th)
            H = torch.einsum("knab,knac,kn->kbc", J, J, w)
            b = torch.einsum("knab,kna,kn->kb", J, r, w)
            dx = _solve_damped(H, b, lam)
            T_new = se3.se3_compose(se3.se3_exp(dx), T)
            # accept iff the weighted chi2 dropped; the incumbent's cost
            # comes from the top-of-iteration residuals
            rn, _, _, pn = jacobians.reprojection_residual_jac(
                cam, T_new[:, None], points, obs)
            cost_new = torch.sum(torch.where(
                inlier & (pn[..., 2] > 1e-6),
                robust(torch.sum(rn * rn, dim=-1)), torch.zeros(
                    (), dtype=dtype, device=T.device)), dim=-1)
            cost_T = torch.sum(torch.where(m_top, robust(c_top), torch.zeros(
                (), dtype=dtype, device=T.device)), dim=-1)
            better = cost_new < cost_T
            T = torch.where(better[:, None, None], T_new, T)
            lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e5))
        # re-classify on raw chi2: the graduated threshold in intermediate
        # rounds, the exact chi2_th for the final mask
        next_scale = float(2 ** max(rounds - 2 - rnd, 0))
        inlier = valid & (_chi2(cam, T[:, None], points, obs)
                          <= chi2_th * next_scale)
    return T, inlier


def solve_pose_multi(cam: Camera, T_inits, points, obs_uv, valid,
                     chi2_th: float = 5.991, rounds: int = 4,
                     iters: int = 10):
    """Multi-start pose solve: the full LM schedule from K initial poses
    (K, 3, 4), keeping the one with the lowest robust cost (first on ties).
    Returns (T_opt (3, 4), inlier_mask (N,), num_inliers () int32)."""
    Ts, inliers = _lm_rounds(cam, T_inits, points, obs_uv, valid, chi2_th,
                             rounds, iters)
    c = _chi2(cam, Ts[:, None], points, obs_uv)
    costs = torch.sum(torch.where(valid, torch.clamp(c, max=chi2_th),
                                  torch.full_like(c, chi2_th)), dim=-1)
    best = torch.argmin(costs)
    inlier = row(inliers, best)
    return row(Ts, best), inlier, inlier.sum().to(torch.int32)


def solve_pose(cam: Camera, T_init, points, obs_uv, valid,
               chi2_th: float = 5.991, rounds: int = 4, iters: int = 10):
    """Single-start pose solve from 2-D/3-D correspondences in one camera
    (the reference's `solve_pose`; PnP RANSAC's refinement). T_init (3, 4);
    points (N, 3); obs_uv (N, 2); valid (N,). Returns (T_opt (3, 4),
    inlier (N,) bool, num_inliers () int32)."""
    T, inlier = _lm_rounds(cam, T_init[None], points, obs_uv, valid,
                           chi2_th, rounds, iters)
    return T[0], inlier[0], inlier[0].sum().to(torch.int32)
