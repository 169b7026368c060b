"""SO(3)/SE(3) Lie-group operations on batched tensors.

Counterpart of `stereovision_slam_tpu/geometry/se3.py`, same conventions:

  * an SE(3) element is a (..., 3, 4) tensor ``T = [R | t]``;
  * the tangent is ``xi = [v(3), w(3)]``, translation first;
  * ``se3_exp(xi) @ T`` is the left-multiplicative update.

All functions broadcast over leading batch dimensions and keep the
reference's small-angle branches.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", a, v)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _rot_coeffs(w: torch.Tensor):
    """(a, b, c) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), with
    polynomial branches below t^2 = 1e-8."""
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    sin_t, cos_t = torch.sin(t), torch.cos(t)
    a = torch.where(small, 1.0 - t2 / 6.0, sin_t / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - cos_t) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - sin_t) / (t2s * t))
    return a, b, c


def _eye3(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) -> (..., 3, 3)."""
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    a, b, _ = _rot_coeffs(w)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation -> axis-angle, (..., 3, 3) -> (..., 3), with the guards near
    theta = 0 and theta = pi of the reference."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    near_pi = cos_theta < -1.0 + 1e-5
    small = theta < 1e-5
    denom = torch.where(torch.abs(sin_theta) < _EPS,
                        torch.ones_like(sin_theta), 2.0 * sin_theta)
    generic_scale = torch.where(small, 0.5 + theta * theta / 12.0,
                                theta / denom)
    w_generic = generic_scale[..., None] * v

    # near-pi branch: axis from the dominant diagonal of (R + I) / 2
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    ax = torch.sqrt(torch.clamp(diag, min=0.0))
    k = torch.argmax(diag, dim=-1)
    s01 = torch.sign(B[..., 0, 1] + _EPS)
    s02 = torch.sign(B[..., 0, 2] + _EPS)
    s12 = torch.sign(B[..., 1, 2] + _EPS)
    a0, a1, a2 = ax[..., 0], ax[..., 1], ax[..., 2]
    ax0 = torch.stack([a0, s01 * a1, s02 * a2], dim=-1)
    ax1 = torch.stack([s01 * a0, a1, s12 * a2], dim=-1)
    ax2 = torch.stack([s02 * a0, s12 * a1, a2], dim=-1)
    kk = k[..., None]
    signed = torch.where(kk == 0, ax0, torch.where(kk == 1, ax1, ax2))
    norm = torch.linalg.vector_norm(signed, dim=-1, keepdim=True)
    axis = signed / torch.where(norm < _EPS, torch.ones_like(norm), norm)
    w_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    _, b, c = _rot_coeffs(w)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    half = 0.5 * t
    sin_half = torch.sin(half)
    sin_half_safe = torch.where(torch.abs(sin_half) < _EPS,
                                torch.ones_like(sin_half), sin_half)
    cot_term = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                           (1.0 - half * torch.cos(half) / sin_half_safe) / t2s)
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * W2


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    T = torch.zeros((3, 4), dtype=dtype, device=device)
    T[0, 0] = T[1, 1] = T[2, 2] = 1.0
    return T


def se3_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [v, w] (..., 6) -> (..., 3, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    return se3_from_Rt(so3_exp(w), _mv(_so3_left_jacobian(w), v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> tangent [v, w] (..., 6)."""
    w = so3_log(T[..., :3, :3])
    v = _mv(_so3_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([v, w], dim=-1)


def se3_compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Group product Ta * Tb."""
    Ra = Ta[..., :3, :3]
    R = torch.matmul(Ra, Tb[..., :3, :3])
    t = _mv(Ra, Tb[..., :3, 3]) + Ta[..., :3, 3]
    return se3_from_Rt(R, t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rinv = T[..., :3, :3].transpose(-1, -2)
    return se3_from_Rt(Rinv, -_mv(Rinv, T[..., :3, 3]))


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) x (..., 3) -> (..., 3)."""
    return _mv(T[..., :3, :3], p) + T[..., :3, 3]


def se3_distance(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """||log(Ta * Tb^-1)||, the keyframe-eviction distance."""
    return torch.linalg.vector_norm(
        se3_log(se3_compose(Ta, se3_inverse(Tb))), dim=-1)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint (..., 6, 6) for the [v, w] ordering, Adj = [[R, hat(t) R],
    [0, R]]: T exp(xi) T^-1 = exp(Adj(T) xi). It transports tangent-frame
    quadratic forms, e.g. a loop edge's PnP Hessian into the pose-graph
    residual frame: info = Adj(meas)^T H Adj(meas)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, torch.matmul(so3_hat(t), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
