"""Batched linear (DLT) triangulation (counterpart of
`geometry/triangulation.py`).

Per correspondence the 4x4 Gram matrix A^T A of the homogeneous system is
built and its smallest-eigenvalue eigenvector taken from the Jacobi solver.
The gate sigma_4 / sigma_3 < 1e-2 matches the reference; the caller applies
the depth gate.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.geometry.symeig import symeig_small


def triangulate(poses: torch.Tensor, points: torch.Tensor,
                sv_ratio_thresh: float = 1e-2):
    """poses (C, 3, 4) rig->camera extrinsics; points (N, C, 2) normalized
    plane coordinates. Returns (xyz (N, 3), ok (N,))."""
    p0, p1, p2 = poses[:, 0, :], poses[:, 1, :], poses[:, 2, :]
    x = points[..., 0][..., None]
    y = points[..., 1][..., None]
    A = torch.cat([x * p2[None] - p0[None], y * p2[None] - p1[None]], dim=1)
    B = torch.einsum("nri,nrj->nij", A, A)
    lam, V = symeig_small(B, sweeps=4)
    lam = torch.clamp(lam, min=0.0)
    s = torch.sqrt(torch.flip(lam, dims=[-1]))   # descending singular values
    w = V[:, :, 0]
    wh = w[:, 3]
    safe_wh = torch.where(torch.abs(wh) < 1e-12, torch.ones_like(wh), wh)
    xyz = w[:, :3] / safe_wh[:, None]
    ok = (s[:, 3] / torch.clamp(s[:, 2], min=1e-20)) < sv_ratio_thresh
    ok = ok & (s[:, 2] > 1e-6 * torch.clamp(s[:, 0], min=1e-20))
    ok = ok & (torch.abs(wh) >= 1e-12)
    return xyz, ok


def triangulate_stereo(baseline: torch.Tensor, points_l: torch.Tensor,
                       points_r: torch.Tensor, sv_ratio_thresh: float = 1e-2):
    """The two-view case of a rectified rig: `baseline` (2,) the x-offsets
    of the left and right cameras in the rig frame (each extrinsic's
    translation column), `points_l` / `points_r` (N, 2) normalized plane
    coordinates. Builds the two x-translated poses and dispatches to
    `triangulate`."""
    baseline = torch.as_tensor(baseline, dtype=points_l.dtype,
                               device=points_l.device)
    poses = torch.zeros((2, 3, 4), dtype=points_l.dtype,
                        device=points_l.device)
    poses[:, :, :3] = torch.eye(3, dtype=points_l.dtype,
                                device=points_l.device)
    poses[:, 0, 3] = baseline
    return triangulate(poses, torch.stack([points_l, points_r], dim=1),
                       sv_ratio_thresh)
