"""The synthetic circuit scene, rendered with torch (a copy of the JAX test
fixtures' `forward_motion_poses`, `_value_noise`,
`render_textured_view_cylinder`, `render_arena_stereo_sequence` and
`make_stereo_rig`).

A textured ground plane inside a textured cylindrical wall, raycast with
exact pinhole geometry, so every pose has exact ground truth. The texture is
a chaotic sin-hash value noise, so it is rendered in float32 with the
reference fixture's order of operations: a float64 render hashes other
lattice values and draws another texture. `circuit` is the bench's
120-frame closed loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.geometry.camera import Camera

f32 = torch.float32


def make_stereo_rig(fx=350.0, fy=350.0, cx=310.0, cy=94.0, baseline=0.54,
                    device="cpu"):
    """KITTI-like rectified rig: left at the origin, right extrinsic
    x-translation -baseline."""
    left = Camera.create(fx, fy, cx, cy, baseline=0.0, device=device)
    right_pose = torch.zeros((3, 4))
    right_pose[:, :3] = torch.eye(3)
    right_pose[0, 3] = -baseline
    right = Camera.create(fx, fy, cx, cy, baseline=baseline, pose=right_pose,
                          device=device)
    return left, right


def forward_motion_poses(T: int, step=0.8, yaw_rate=0.0) -> torch.Tensor:
    """(T, 3, 4) float32 world->rig poses moving forward with constant yaw;
    pose 0 is the identity."""
    delta = se3.se3_exp(torch.tensor([0.0, 0.0, -step, 0.0, yaw_rate, 0.0],
                                     dtype=torch.float32))
    poses = [se3.se3_identity()]
    for _ in range(T - 1):
        poses.append(se3.se3_compose(delta, poses[-1]))
    return torch.stack(poses)


def _value_noise(x, z, octaves=4, base_scale=0.7, phase=0.0):
    total = torch.zeros_like(x)
    amp = 1.0
    for o in range(octaves):
        s = base_scale * (2.0 ** o)
        xs, zs = x * s, z * s
        x0, z0 = torch.floor(xs), torch.floor(zs)
        fx, fz = xs - x0, zs - z0
        fx = fx * fx * (3.0 - 2.0 * fx)
        fz = fz * fz * (3.0 - 2.0 * fz)

        def h(ix, iz):
            v = torch.sin(ix * 127.1 + iz * 311.7 + o * 74.7
                          + phase * 961.7) * 43758.5453
            return v - torch.floor(v)

        val = ((1 - fx) * (1 - fz) * h(x0, z0) + fx * (1 - fz) * h(x0 + 1, z0)
               + (1 - fx) * fz * h(x0, z0 + 1) + fx * fz * h(x0 + 1, z0 + 1))
        total = total + amp * val
        amp *= 0.55
    return total / 2.1


def render_textured_view_cylinder(cam_params, T_cw, H: int, W: int,
                                  ground_y=1.7, center_x=0.0, center_z=0.0,
                                  radius=30.0, device="cpu"):
    """(H, W) float32 view of the arena for world->camera pose T_cw."""
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=f32, device=device)
                      for v in cam_params)
    T_cw = torch.as_tensor(T_cw, dtype=f32, device=device)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                            torch.arange(W, dtype=f32, device=device),
                            indexing="ij")
    d_cam = torch.stack([(xx - cx) / fx, (yy - cy) / fy, torch.ones_like(xx)],
                        dim=-1)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    o = -R.T @ t
    d = torch.einsum("ji,hwj->hwi", R, d_cam)
    BIG = 1e9
    dy = d[..., 1]
    t_g = (ground_y - o[1]) / torch.where(torch.abs(dy) < 1e-6,
                                          torch.full_like(dy, 1e-6), dy)
    t_g = torch.where((dy > 1e-4) & (t_g > 0.0) & (t_g < 400.0), t_g,
                      torch.full_like(t_g, BIG))
    ox, oz = o[0] - center_x, o[2] - center_z
    dx, dz = d[..., 0], d[..., 2]
    a = dx * dx + dz * dz
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - radius * radius
    disc = b * b - 4 * a * c
    a_safe = torch.where(torch.abs(a) < 1e-9, torch.full_like(a, 1e-9), a)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2 * a_safe)
    t2 = (-b + sq) / (2 * a_safe)
    t_c = torch.where(t1 > 1e-3, t1, t2)
    y_at = o[1] + t_c * dy
    t_c = torch.where((disc > 0) & (t_c > 1e-3) & (y_at < ground_y)
                      & (y_at > -10.0), t_c, torch.full_like(t_c, BIG))
    t_hit = torch.minimum(t_g, t_c)
    px = o[0] + t_hit * d[..., 0]
    py = o[1] + t_hit * d[..., 1]
    pz = o[2] + t_hit * d[..., 2]
    ground = _value_noise(px, pz, octaves=5, base_scale=0.9)
    shade = 1.0 / (1.0 + 0.002 * t_hit * t_hit)
    ground_val = 40.0 + 190.0 * ground * (0.35 + 0.65 * shade)
    ang = torch.atan2(px - center_x, pz - center_z)
    wall = _value_noise(ang * radius * 0.8, py * 1.6, octaves=5,
                        base_scale=0.8)
    wall_val = 55.0 + 170.0 * wall * (0.4 + 0.6 * shade)
    val = torch.where(t_hit >= BIG, torch.full_like(t_hit, 120.0),
                      torch.where(t_g <= t_c, ground_val, wall_val))
    return torch.clamp(val, 0.0, 255.0)


def render_arena_stereo_sequence(poses, H=188, W=620, rig=None,
                                 center=(0.0, 10.0), radius=30.0,
                                 device="cpu"):
    """(T, H, W) float32 left and right images of the arena."""
    if rig is None:
        rig = make_stereo_rig()
    lefts, rights = [], []
    for pose in poses:
        views = []
        for cam in rig:
            T = se3.se3_compose(cam.pose.cpu().to(f32),
                                torch.as_tensor(pose).cpu().to(f32))
            views.append(render_textured_view_cylinder(
                (cam.fx, cam.fy, cam.cx, cam.cy), T, H, W,
                center_x=center[0], center_z=center[1], radius=radius,
                device=device))
        lefts.append(views[0])
        rights.append(views[1])
    return torch.stack(lefts), torch.stack(rights)


def circuit(T: int = 120, H: int = 188, W: int = 620, device="cpu"):
    """The bench's closed circuit: ~3 deg/frame of yaw closes the circle in
    T frames at 0.35 m/frame inside a radius-25 arena. Returns (lefts,
    rights (T, H, W) float32 numpy, poses (T, 3, 4) numpy, path length m,
    rig)."""
    step = 0.35
    rig = make_stereo_rig()
    poses = forward_motion_poses(T, step=step,
                                 yaw_rate=2 * math.pi / (T - 8))
    lefts, rights = render_arena_stereo_sequence(
        poses, H=H, W=W, rig=rig, center=(0.0, 6.0), radius=25.0,
        device=device)
    return (lefts.cpu().numpy(), rights.cpu().numpy(),
            np.asarray(poses.numpy(), np.float32), step * T, rig)


def circuit_long(T: int = 480, H: int = 188, W: int = 620, device="cpu"):
    """The bench's multi-lap circuit: the same arena driven at 0.35 m/frame
    with 2 pi / 112 of yaw a frame, a lap every 112 frames, every lap a
    loop-closure opportunity. Returns what `circuit` returns."""
    step = 0.35
    rig = make_stereo_rig()
    poses = forward_motion_poses(T, step=step, yaw_rate=2 * math.pi / 112)
    lefts, rights = render_arena_stereo_sequence(
        poses, H=H, W=W, rig=rig, center=(0.0, 6.0), radius=25.0,
        device=device)
    return (lefts.cpu().numpy(), rights.cpu().numpy(),
            np.asarray(poses.numpy(), np.float32), step * T, rig)
