"""Trajectory evaluation: ATE / RPE (the port's own copy of
`utils/evaluation.py`, numpy only).

The C++ system publishes no quantitative evaluation; this module
provides the standard KITTI-style metrics the baseline methodology calls for:
absolute trajectory error (RMSE over camera centers, optional SE(3)/Sim(3)
Umeyama alignment) and relative pose error.
"""

from __future__ import annotations

import numpy as np


def camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """(N, 3, 4) world->cam poses -> (N, 3) camera centers c = -R^T t."""
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst (Umeyama 1991).

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_poses_cw: dict[int, np.ndarray],
             gt_poses_cw: dict[int, np.ndarray], align: bool = True) -> float:
    """ATE RMSE (m) over common frame ids."""
    ids = sorted(set(est_poses_cw) & set(gt_poses_cw))
    if not ids:
        return float("nan")
    est = camera_centers(np.stack([np.asarray(est_poses_cw[i]) for i in ids]))
    gt = camera_centers(np.stack([np.asarray(gt_poses_cw[i]) for i in ids]))
    if align and len(ids) >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_per_frame(est_poses_cw: dict[int, np.ndarray],
                  gt_poses_cw: dict[int, np.ndarray]) -> float:
    """RMS translational relative-pose error between consecutive common ids."""
    ids = sorted(set(est_poses_cw) & set(gt_poses_cw))
    errs = []
    for a, b in zip(ids[:-1], ids[1:]):
        def rel(poses):
            Ta = np.vstack([np.asarray(poses[a]), [0, 0, 0, 1]])
            Tb = np.vstack([np.asarray(poses[b]), [0, 0, 0, 1]])
            return Tb @ np.linalg.inv(Ta)
        d = rel(est_poses_cw)[:3, 3] - rel(gt_poses_cw)[:3, 3]
        errs.append(d @ d)
    return float(np.sqrt(np.mean(errs))) if errs else float("nan")
