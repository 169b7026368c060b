"""Batched PnP RANSAC: the rig pose from 2-D/3-D correspondences
(counterpart of `slam/pnp.py`, the loop closure's geometric check).

All hypotheses at once: H sets of MIN_SET points sampled without
replacement (Gumbel top-k over the valid points, from uniform draws the
caller passes), each solved by a Hartley-normalized DLT (the 12x12 normal
matrix's null vector by shifted inverse iteration, projected onto SE(3)
through the Jacobi eigensolver), inliers of every hypothesis against every
point in one broadcast, then two single-start LM solves on the best
hypothesis's inliers, the second after re-classifying every point.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.geometry.camera import Camera, pixel2camera
from stereovision_slam_torch.geometry.symeig import symeig_small
from stereovision_slam_torch.slam.map_state import row
from stereovision_slam_torch.slam.pose_solver import _chi2, solve_pose

# Hypothesis sample size: a minimal 6-point DLT amplifies pixel noise too
# much in float32; 10-point sets cut that ~5x.
MIN_SET = 10


def _smallest_eigvec(AtA: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Smallest-eigenvalue eigenvectors of PSD (..., d, d) matrices by
    shifted inverse iteration (one LU, `iters` solves)."""
    d = AtA.shape[-1]
    eye = torch.eye(d, dtype=AtA.dtype, device=AtA.device)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-6 * (tr / d + 1e-30)
    LU, piv, _ = torch.linalg.lu_factor_ex(AtA + eps[..., None, None] * eye)
    v = torch.full(AtA.shape[:-1], 1.0, dtype=AtA.dtype, device=AtA.device)
    v = v / torch.sqrt(torch.tensor(float(d), dtype=AtA.dtype))
    for _ in range(iters):
        w = torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                     keepdim=True), min=1e-30)
    return v


def _orthonormalize(Pm: torch.Tensor) -> torch.Tensor:
    """Project (H, 3, 4) [M | t] onto SE(3) by the polar decomposition from
    the eigen-decomposition of M^T M: R = U diag(1, 1, sign det M) V^T,
    t / (mean singular value * sign)."""
    M = Pm[..., :3]
    lam, V = symeig_small(torch.matmul(M.transpose(-1, -2), M))  # ascending
    sv = torch.sqrt(torch.clamp(lam, min=0.0))
    U = torch.matmul(M, V) / torch.clamp(sv, min=1e-12)[:, None, :]
    s = torch.where(torch.linalg.det(M) >= 0.0, 1.0, -1.0).to(M.dtype)
    # flip the column of U of the smallest singular value when det < 0
    flip = torch.ones_like(sv)
    flip[:, 0] = s
    R = torch.matmul(U * flip[:, None, :], V.transpose(-1, -2))
    scale = torch.mean(sv, dim=-1) * s
    scale = torch.where(torch.abs(scale) < 1e-12,
                        torch.full_like(scale, 1e-12), scale)
    return se3.se3_from_Rt(R, Pm[..., 3] / scale[:, None])


def _dlt_pose(pts3d: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """DLT camera poses of H point sets: pts3d (H, S, 3) world points,
    xy_norm (H, S, 2) normalized image coordinates. Returns (H, 3, 4)."""
    H, S = pts3d.shape[:2]
    # Hartley normalization of the world points
    c = torch.mean(pts3d, dim=1)
    centered = pts3d - c[:, None]
    s = torch.clamp(torch.sqrt(torch.mean(torch.sum(centered * centered,
                                                    dim=2), dim=1) / 3.0),
                    min=1e-9)
    Xn = centered / s[:, None, None]
    X = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=2)   # (H, S, 4)
    zeros = torch.zeros_like(X)
    x, y = xy_norm[..., 0:1], xy_norm[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -x * X], dim=2),
                   torch.cat([zeros, X, -y * X], dim=2)], dim=1)  # (H, 2S, 12)
    Pn = _smallest_eigvec(torch.matmul(A.transpose(-1, -2), A)).reshape(
        H, 3, 4)
    # denormalize: Pn acts on (X - c) / s
    Mn = Pn[..., :3]
    P = torch.cat([Mn / s[:, None, None],
                   (Pn[..., 3] - torch.matmul(Mn, c[..., None])[..., 0]
                    / s[:, None])[..., None]], dim=2)
    # the null vector's sign is arbitrary: keep the candidate with more
    # points in front of the camera
    Ta, Tb = _orthonormalize(P), _orthonormalize(-P)

    def front_count(T):
        z = torch.matmul(pts3d, T[:, 2, :3, None])[..., 0] + T[:, 2, 3, None]
        return torch.sum(z > 0, dim=1)

    return torch.where((front_count(Ta) >= front_count(Tb))[:, None, None],
                       Ta, Tb)


def pnp_ransac(cam: Camera, pts3d, uv, valid, uniform,
               reproj_threshold: float = 5.991, refine_rounds: int = 2):
    """Robust rig pose from left-image pixels of world landmarks.

    cam: the left camera (its extrinsic is folded into the rig pose);
    pts3d (N, 3); uv (N, 2); valid (N,) bool; uniform (H, N) float draws in
    (0, 1], one row per hypothesis (the reference draws them from
    `jax.random.uniform(PRNGKey(kf_id), (H, N), minval=1e-9)`; see
    `ops.prng.uniform`). Returns (T_rig (3, 4), inliers (N,) bool,
    num_inliers () int32)."""
    xy = pixel2camera(cam, uv)[:, :2]
    logits = torch.where(valid, 0.0, -1e9).to(pts3d.dtype)
    scores = logits[None, :] + (-torch.log(-torch.log(uniform)))
    # top MIN_SET per row, ties to the lower index (as lax.top_k)
    sel = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :MIN_SET]
    T_cam_h = _dlt_pose(pts3d[sel], xy[sel])                   # (H, 3, 4)

    # every hypothesis against every point
    p_cam = (torch.einsum("hij,nj->hni", T_cam_h[:, :, :3], pts3d)
             + T_cam_h[:, None, :, 3])
    z = p_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    err = torch.sqrt((u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2)
    inl = valid[None, :] & (err <= reproj_threshold) & (z > 0)
    best = torch.argmax(torch.sum(inl, dim=1))
    T_cam, inliers0 = row(T_cam_h, best), row(inl, best)

    # LM refinement on the best inlier set, in the rig parameterization,
    # then once more after re-classifying every point at the refined pose
    th2 = reproj_threshold * reproj_threshold
    T_rig0 = se3.se3_compose(se3.se3_inverse(cam.pose), T_cam)
    T_rig1, _, _ = solve_pose(cam, T_rig0, pts3d, uv, inliers0, chi2_th=th2,
                              rounds=refine_rounds, iters=10)
    inliers1 = valid & (_chi2(cam, T_rig1, pts3d, uv) <= th2)
    return solve_pose(cam, T_rig1, pts3d, uv, inliers1, chi2_th=th2,
                      rounds=refine_rounds, iters=10)
