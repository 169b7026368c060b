"""The traffic generator: laps of the textured arena, rendered on the device.

A frozen copy of the arena renderer of `stereovision_slam_torch/scenes.py`
(`_value_noise`, `_rays`, `_ground`, `render_textured_view_cylinder`,
`render_textured_views_cylinder`, `forward_motion_poses` and
`make_stereo_rig`, at commit 49562ac9c19ec4b6e01f6dee472fed199e03dcff),
with the wall-symmetry option left out (no cell uses it). The texture is a
chaotic sin-hash value noise rendered in float32; `tex_phase` reseeds it.

A lap is the `circuit_long` scene's closed circle: `step` metres a frame
with `2 pi / lap_frames` of yaw, so frame t + lap_frames sees what frame t
saw. A drive of any length is served by index from one rendered lap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry as geo

f32 = torch.float32
BIG = 1e9


def value_noise(x, z, octaves=4, base_scale=0.7, phase=0.0):
    ph = np.float32(np.float32(phase) * np.float32(961.7))
    total = torch.zeros_like(x)
    amp = 1.0
    for o in range(octaves):
        s = base_scale * (2.0 ** o)
        xs, zs = x * s, z * s
        x0, z0 = torch.floor(xs), torch.floor(zs)
        fx, fz = xs - x0, zs - z0
        fx = fx * fx * (3.0 - 2.0 * fx)
        fz = fz * fz * (3.0 - 2.0 * fz)
        c = float(np.float32(o * 74.7) + ph)

        def h(ix, iz):
            v = torch.sin(ix * 127.1 + iz * 311.7 + c) * 43758.5453
            return v - torch.floor(v)

        val = ((1 - fx) * (1 - fz) * h(x0, z0) + fx * (1 - fz) * h(x0 + 1, z0)
               + (1 - fx) * fz * h(x0, z0 + 1) + fx * fz * h(x0 + 1, z0 + 1))
        total = total + amp * val
        amp *= 0.55
    return total / 2.1


def _rays(cam_params, T_cw, H: int, W: int, device):
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=f32, device=device)
                      for v in cam_params)
    T_cw = torch.as_tensor(T_cw, dtype=f32, device=device)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                            torch.arange(W, dtype=f32, device=device),
                            indexing="ij")
    d_cam = torch.stack([(xx - cx) / fx, (yy - cy) / fy, torch.ones_like(xx)],
                        dim=-1)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    return -R.T @ t, torch.einsum("ji,hwj->hwi", R, d_cam)


def _ground(o, d, ground_y):
    dy = d[..., 1]
    t_g = (ground_y - o[1]) / torch.where(torch.abs(dy) < 1e-6,
                                          torch.full_like(dy, 1e-6), dy)
    return torch.where((dy > 1e-4) & (t_g > 0.0) & (t_g < 400.0), t_g,
                       torch.full_like(t_g, BIG))


def render_view(cam_params, T_cw, H: int, W: int, ground_y=1.7,
                center_x=0.0, center_z=0.0, radius=30.0, tex_phase=0.0,
                device="cpu"):
    """(H, W) float32 view of the arena for world->camera pose T_cw."""
    o, d = _rays(cam_params, T_cw, H, W, device)
    t_g = _ground(o, d, ground_y)
    dy = d[..., 1]
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
    ground = value_noise(px, pz, octaves=5, base_scale=0.9, phase=tex_phase)
    shade = 1.0 / (1.0 + 0.002 * t_hit * t_hit)
    ground_val = 40.0 + 190.0 * ground * (0.35 + 0.65 * shade)
    ang = torch.atan2(px - center_x, pz - center_z)
    wall = value_noise(ang * radius * 0.8, py * 1.6, octaves=5,
                       base_scale=0.8, phase=tex_phase)
    wall_val = 55.0 + 170.0 * wall * (0.4 + 0.6 * shade)
    val = torch.where(t_hit >= BIG, torch.full_like(t_hit, 120.0),
                      torch.where(t_g <= t_c, ground_val, wall_val))
    return torch.clamp(val, 0.0, 255.0)


def lap_poses(lap_frames: int, step: float) -> torch.Tensor:
    """(lap_frames, 3, 4) float32 world->rig poses of one lap: forward
    `step` a frame with 2 pi / lap_frames of yaw; pose 0 the identity."""
    delta = geo.exp(torch.tensor(
        [0.0, 0.0, -step, 0.0, 2 * math.pi / lap_frames, 0.0], dtype=f32))
    poses = [geo.identity()]
    for _ in range(lap_frames - 1):
        poses.append(geo.compose(delta, poses[-1]))
    return torch.stack(poses)


def rig_extrinsics(baseline: float) -> list[torch.Tensor]:
    """Left and right camera poses in the rig frame (right at -baseline)."""
    right = torch.zeros((3, 4))
    right[:, :3] = torch.eye(3)
    right[0, 3] = -baseline
    left = torch.zeros((3, 4))
    left[:, :3] = torch.eye(3)
    return [left, right]


def render_lap(scene: dict, tex_phase: float, device, batch: int = 16):
    """(lefts, rights) (lap_frames, H, W) float32 of one lap on `device`,
    rendered `batch` views at a time; `scene` is a configuration's
    "camera" and "arena" sections merged."""
    poses = lap_poses(scene["lap_frames"], scene["step_m"])
    cam = (scene["fx"], scene["fy"], scene["cx"], scene["cy"])
    H, W = scene["height"], scene["width"]
    kw = dict(center_x=scene["center"][0], center_z=scene["center"][1],
              radius=scene["radius"], ground_y=scene["ground_y"],
              tex_phase=tex_phase, device=device)
    views = []
    for ext in rig_extrinsics(scene["baseline"]):
        T = torch.stack([geo.compose(ext, p) for p in poses]).to(device)
        out = [torch.func.vmap(lambda t: render_view(cam, t, H, W, **kw))(
            T[i:i + batch]) for i in range(0, len(T), batch)]
        views.append(torch.cat(out))
    return views[0], views[1]
