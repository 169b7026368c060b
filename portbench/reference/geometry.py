"""Rigid motions and the stereo rig, written for the reference.

A pose is a (..., 3, 4) matrix [R | t] mapping world points into the rig
frame (T_c_w). Tangent vectors are ordered [v, w] (translation first), and
perturbations act on the left: exp(xi) * T. A camera is the rig's pinhole:
intrinsics (fx, fy, cx, cy) and its extrinsic (rig -> camera) [R | t].
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the skew matrix (..., 3, 3) with hat(w) x = w x x."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(w: torch.Tensor):
    """sin(a)/a, (1 - cos a)/a^2 and (a - sin a)/a^3 of a = |w|, by their
    series where a^2 < 1e-8."""
    a2 = (w * w).sum(-1)
    small = a2 < 1e-8
    a2s = torch.where(small, torch.ones_like(a2), a2)
    a = torch.sqrt(a2s)
    c1 = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    c2 = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / a2s)
    c3 = torch.where(small, 1.0 / 6.0 - a2 / 120.0,
                     (a - torch.sin(a)) / (a2s * a))
    return c1, c2, c3


def _eye(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (3, 3))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """[v, w] (..., 6) -> (..., 3, 4): R = exp(hat w), t = J(w) v."""
    v, w = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    c1, c2, c3 = _coeffs(w)
    R = _eye(w) + c1[..., None, None] * W + c2[..., None, None] * W2
    J = _eye(w) + c2[..., None, None] * W + c3[..., None, None] * W2
    return torch.cat([R, (J @ v[..., None])], -1)


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> [v, w] (..., 6), the inverse of `exp`. The angle is
    taken from the trace, with the axis from the symmetric part near pi."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    cos_a = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]) - 1.0) * 0.5
    a = torch.acos(torch.clamp(cos_a, -1.0 + 1e-7, 1.0 - 1e-7))
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2]
                        - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_a = torch.sin(a)
    scale = torch.where(a < 1e-5, 0.5 + a * a / 12.0,
                        a / torch.where(sin_a.abs() < 1e-12,
                                        torch.ones_like(sin_a), 2.0 * sin_a))
    w = scale[..., None] * skew
    # near pi: |axis_i| = sqrt((R_ii + 1) / 2), signs from the symmetric part
    B = 0.5 * (R + _eye(t))
    k = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), -1)
    col = torch.gather(B, -1, k[..., None, None].expand(
        B.shape[:-1] + (1,)))[..., 0]
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1,
                                                      keepdim=True), min=1e-12)
    axis = axis * torch.where((axis * skew).sum(-1, keepdim=True) < 0, -1.0,
                              1.0)
    w = torch.where((cos_a < -1.0 + 1e-5)[..., None], a[..., None] * axis, w)
    W = hat(w)
    a2 = (w * w).sum(-1)
    small = a2 < 1e-8
    a2s = torch.where(small, torch.ones_like(a2), a2)
    h = 0.5 * torch.sqrt(a2s)
    sh = torch.sin(h)
    k2 = torch.where(small, 1.0 / 12.0 + a2 / 720.0,
                     (1.0 - h * torch.cos(h) / torch.where(
                         sh.abs() < 1e-12, torch.ones_like(sh), sh)) / a2s)
    Jinv = _eye(w) - 0.5 * W + k2[..., None, None] * (W @ W)
    return torch.cat([(Jinv @ t[..., None])[..., 0], w], -1)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A * B."""
    R = A[..., :3, :3]
    return torch.cat([R @ B[..., :3, :3],
                      (R @ B[..., :3, 3:]) + A[..., :3, 3:]], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return torch.cat([Rt, -(Rt @ T[..., :3, 3:])], -1)


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """T (..., 3, 4) applied to points p (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def identity(dtype=torch.float32) -> torch.Tensor:
    return torch.eye(3, 4, dtype=dtype)


def orthonormalize(T: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """T with R brought back onto SO(3) by `steps` Newton-Schulz polar
    steps R <- R (3 I - R^T R) / 2; t kept. The tracker stores its pose so
    after every solve."""
    R = T[..., :3, :3]
    I3 = _eye(T[..., 0, :3])
    for _ in range(steps):
        R = 0.5 * (R @ (3.0 * I3 - R.transpose(-1, -2) @ R))
    return torch.cat([R, T[..., :3, 3:]], -1)


def distance(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """|log(A * B^-1)|."""
    return torch.linalg.vector_norm(log(compose(A, inverse(B))), dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """(6, 6) Adj(T) for the [v, w] order: T exp(xi) T^-1 = exp(Adj xi)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], -1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], -1)], -2)


class Cam(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    ext: torch.Tensor       # (3, 4) rig -> camera


def rig(camera: dict) -> tuple[Cam, Cam]:
    """The configuration's rectified rig: the left camera at the rig's
    origin, the right one `baseline` metres along +x (its extrinsic shifts
    points by -baseline)."""
    k = [float(camera[n]) for n in ("fx", "fy", "cx", "cy")]
    right = identity()
    right[0, 3] = -float(camera["baseline"])
    return Cam(*k, identity()), Cam(*k, right)


def project(cam: Cam, T: torch.Tensor, p: torch.Tensor):
    """Pixels (..., 2) and camera-frame points (..., 3) of world points p
    seen from rig pose T."""
    q = apply(cam.ext.to(p.dtype), apply(T, p))
    z = q[..., 2]
    return torch.stack([cam.fx * q[..., 0] / z + cam.cx,
                        cam.fy * q[..., 1] / z + cam.cy], -1), q


def normalized(cam: Cam, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image-plane coordinates (..., 2)."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], -1)


def reprojection(cam: Cam, T: torch.Tensor, p: torch.Tensor,
                 uv: torch.Tensor):
    """Residual r = projection - uv (..., 2), its Jacobians with respect to
    a left perturbation of the rig pose (..., 2, 6) and to the point
    (..., 2, 3), and the camera-frame depth (...,). A depth under 1e-8 in
    magnitude is read as 1e-8."""
    ext = cam.ext.to(p.dtype)
    q = apply(T, p)
    c = apply(ext, q)
    z = c[..., 2]
    iz = 1.0 / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    r = torch.stack([cam.fx * c[..., 0] * iz + cam.cx - uv[..., 0],
                     cam.fy * c[..., 1] * iz + cam.cy - uv[..., 1]], -1)
    zero = torch.zeros_like(z)
    P = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * c[..., 0] * iz * iz], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * c[..., 1] * iz * iz], -1)],
        -2)
    PR = P @ ext[:3, :3]
    J_pose = torch.cat([PR, -PR @ hat(q)], -1)
    J_point = PR @ T[..., :3, :3]
    return r, J_pose, J_point, z
