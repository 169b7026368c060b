"""Analytic projection residuals and Jacobians (counterpart of
`geometry/jacobians.py`).

  * residual r = project(point) - measurement;
  * pose updates are left-multiplicative, ``T <- se3_exp(dx) @ T``, tangent
    ordering [v, w];
  * everything is batched over the leading observation axis.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.geometry.camera import Camera


def project_points(cam: Camera, T_c_w: torch.Tensor, p_w: torch.Tensor):
    """World points through rig pose + camera extrinsic.

    Returns (uv (..., 2), p_cam (..., 3))."""
    p_cam = se3.se3_apply(cam.pose, se3.se3_apply(T_c_w, p_w))
    z = p_cam[..., 2]
    uv = torch.stack([cam.fx * p_cam[..., 0] / z + cam.cx,
                      cam.fy * p_cam[..., 1] / z + cam.cy], dim=-1)
    return uv, p_cam


def reprojection_residual_jac(cam: Camera, T_c_w: torch.Tensor,
                              p_w: torch.Tensor, uv_obs: torch.Tensor):
    """Residual and analytic Jacobians of the reprojection error.

    Returns (r (..., 2), J_pose (..., 2, 6), J_point (..., 2, 3),
    p_cam (..., 3))."""
    q = se3.se3_apply(T_c_w, p_w)
    p_cam = se3.se3_apply(cam.pose, q)
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    Zsafe = torch.where(torch.abs(Z) < 1e-8, torch.full_like(Z, 1e-8), Z)
    inv_z = 1.0 / Zsafe
    inv_z2 = inv_z * inv_z
    u = cam.fx * X * inv_z + cam.cx
    v = cam.fy * Y * inv_z + cam.cy
    r = torch.stack([u, v], dim=-1) - uv_obs

    zero = torch.zeros_like(X)
    J_proj = torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * X * inv_z2], dim=-1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * Y * inv_z2], dim=-1),
    ], dim=-2)
    R_ext = cam.pose[..., :3, :3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[:-1] + (3, 3))
    dq_dxi = torch.cat([eye, -se3.so3_hat(q)], dim=-1)
    J_pose = torch.matmul(J_proj, torch.matmul(R_ext, dq_dxi))
    J_point = torch.matmul(J_proj, torch.matmul(R_ext, T_c_w[..., :3, :3]))
    return r, J_pose, J_point, p_cam


def relative_pose_residual(T0: torch.Tensor, T1: torch.Tensor,
                           T01_meas: torch.Tensor) -> torch.Tensor:
    """Pose-graph edge residual r = log(T01_meas^-1 * T0 * T1^-1), (..., 6)."""
    return se3.se3_log(se3.se3_compose(
        se3.se3_inverse(T01_meas), se3.se3_compose(T0, se3.se3_inverse(T1))))


def huber_weight(r2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel on squared error r2, threshold
    delta2."""
    return torch.where(r2 <= delta2, torch.ones_like(r2),
                       torch.sqrt(delta2 / torch.clamp(r2, min=1e-20)))
