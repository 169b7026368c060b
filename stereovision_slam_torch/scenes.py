"""The synthetic scenes, rendered with torch (copies of the JAX test fixtures'
`forward_motion_poses`, `figure_eight_poses`, `_value_noise`,
`render_textured_view_cylinder`, `render_arena_stereo_sequence`,
`render_textured_view_cylinder_hard`, `apply_photometric_nuisance`,
`render_hard_arena_stereo_sequence`, `render_textured_view`,
`render_textured_stereo_sequence` and `make_stereo_rig`).

Three worlds, raycast with exact pinhole geometry, so every pose has exact
ground truth: a textured ground plane inside a textured cylindrical wall
(the arena; `wall_symmetry=k` repeats the wall's low-frequency texture k
times around it, `tex_phase` reseeds the texture), the arena hardened with
occluding pillars, a moving sphere and photometric nuisance, and a straight
corridor (ground, two side walls and an angular sky). The texture is a
chaotic sin-hash value noise: one ulp of sin() moves a lattice value by
about 0.003, and where the hash sits at a wrap, to another value
altogether. So everything is rendered in float32 with the reference
fixture's order of operations; under any other rounding (a float64 render,
a reassociated sum) the hash draws another texture.

`scene(name, T)` gives the six scenes of the reference bench by name
(`SCENES`: forward, figure8, aliased, circuit, hard, circuit_long, the
names `BENCH_SCENE` takes); `circuit` is the bench's 120-frame closed loop.
`render_textured_view_cylinder`, `render_arena_stereo_sequence`,
`circuit` and `circuit_long` default to the CPU, as the tests and tools
that render the circuit call them; the other renderers and `scene` run
on "cuda" unless the caller passes device="cpu".
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.ops import prng

f32 = torch.float32
BIG = 1e9
SCENES = ("forward", "figure8", "aliased", "circuit", "hard", "circuit_long")


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


def figure_eight_poses(T: int, step=0.5, lead_in=6, tail=8,
                       blend=6) -> torch.Tensor:
    """(T, 3, 4) float32 world->rig poses of a figure-eight with smooth yaw
    changes: a straight lead-in whose last `blend` frames ramp the yaw up,
    one full lobe, a `blend`-frame ramp to the opposite rate right after
    the crossing, the second lobe, and `tail` frames past the second
    crossing. The crossing pose is revisited with the same heading at the
    end of each lobe: two loop-closure opportunities."""
    half = (T - lead_in - tail) // 2
    yaw = 2 * math.pi / half
    s_flip = lead_in + half
    poses = [se3.se3_identity()]
    for i in range(T - 1):
        if i < lead_in:
            w = 0.0 if i < lead_in - blend else (i - (lead_in - blend)) / blend
        elif i < s_flip:
            w = 1.0
        elif i < s_flip + blend:
            w = 1.0 - 2.0 * (i - s_flip) / blend
        else:
            w = -1.0
        delta = se3.se3_exp(torch.tensor([0.0, 0.0, -step, 0.0, yaw * w, 0.0],
                                         dtype=torch.float32))
        poses.append(se3.se3_compose(delta, poses[-1]))
    return torch.stack(poses)


def _value_noise(x, z, octaves=4, base_scale=0.7, phase=0.0):
    # the reference's renders see `phase` as a constant and fold the hash's
    # constant terms, o * 74.7 + phase * 961.7, into one float32 first
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

        def h(ix, iz):
            c = float(np.float32(o * 74.7) + ph)
            v = torch.sin(ix * 127.1 + iz * 311.7 + c) * 43758.5453
            return v - torch.floor(v)

        val = ((1 - fx) * (1 - fz) * h(x0, z0) + fx * (1 - fz) * h(x0 + 1, z0)
               + (1 - fx) * fz * h(x0, z0 + 1) + fx * fz * h(x0 + 1, z0 + 1))
        total = total + amp * val
        amp *= 0.55
    return total / 2.1


def _rays(cam_params, T_cw, H: int, W: int, device):
    """The camera centre (3,) and the world ray of every pixel (H, W, 3)."""
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


def _fmod_floor(x, period: float):
    """`jnp.mod(x, period)` for period > 0: fmod, then + period where the
    remainder is negative."""
    r = torch.fmod(x, period)
    return torch.where((r != 0) & (r < 0), r + period, r)


def render_textured_view_cylinder(cam_params, T_cw, H: int, W: int,
                                  ground_y=1.7, center_x=0.0, center_z=0.0,
                                  radius=30.0, wall_symmetry: int = 0,
                                  tex_phase=0.0, device="cpu"):
    """(H, W) float32 view of the arena for world->camera pose T_cw.
    `wall_symmetry=k` repeats the wall's low-frequency texture k times
    around the cylinder and keeps a unique fine component (look-alike
    sectors for a pooled place embedder); `tex_phase` reseeds every
    texture."""
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
    ground = _value_noise(px, pz, octaves=5, base_scale=0.9, phase=tex_phase)
    shade = 1.0 / (1.0 + 0.002 * t_hit * t_hit)
    ground_val = 40.0 + 190.0 * ground * (0.35 + 0.65 * shade)
    ang = torch.atan2(px - center_x, pz - center_z)
    if wall_symmetry:
        ang_s = _fmod_floor(ang, 2.0 * np.pi / wall_symmetry)
        low = _value_noise(ang_s * radius * 0.8, py * 1.6, octaves=3,
                           base_scale=0.35, phase=tex_phase)
        fine = _value_noise(ang * radius * 0.8 + 37.0, py * 1.6, octaves=2,
                            base_scale=3.2, phase=tex_phase)
        wall = 0.78 * low + 0.22 * fine
    else:
        wall = _value_noise(ang * radius * 0.8, py * 1.6, octaves=5,
                            base_scale=0.8, phase=tex_phase)
    wall_val = 55.0 + 170.0 * wall * (0.4 + 0.6 * shade)
    val = torch.where(t_hit >= BIG, torch.full_like(t_hit, 120.0),
                      torch.where(t_g <= t_c, ground_val, wall_val))
    return torch.clamp(val, 0.0, 255.0)


def render_textured_views_cylinder(cam_params, T_cws, H: int, W: int,
                                   device="cuda", **kw) -> torch.Tensor:
    """(B, H, W) views of the arena for (B, 3, 4) poses in one batched pass
    (`torch.func.vmap` of `render_textured_view_cylinder`; keywords as
    there). The same float32 operations, batched: a view agrees with its
    one-view render within the parity tests' tolerance."""
    dev = resolve_device(device)
    T_cws = torch.as_tensor(T_cws, dtype=f32, device=dev)
    return torch.func.vmap(lambda T: render_textured_view_cylinder(
        cam_params, T, H, W, device=dev, **kw))(T_cws)


def render_arena_stereo_sequence(poses, H=188, W=620, rig=None,
                                 center=(0.0, 10.0), radius=30.0,
                                 wall_symmetry: int = 0, tex_phase=0.0,
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
                wall_symmetry=wall_symmetry, tex_phase=tex_phase,
                device=device))
        lefts.append(views[0])
        rights.append(views[1])
    return torch.stack(lefts), torch.stack(rights)


def render_textured_view_cylinder_hard(cam_params, T_cw, H: int, W: int,
                                       t=0.0, ground_y=1.7, center_x=0.0,
                                       center_z=0.0, radius=30.0,
                                       wall_symmetry: int = 0,
                                       n_pillars: int = 6, tex_phase=0.0,
                                       device="cuda"):
    """The arena with `n_pillars` static textured pillars (occluders with
    parallax) on a ring at 0.55 radius and one sphere orbiting at 0.35
    radius, driven by the frame time `t`: its pixels break the static-world
    assumption. Clean radiance: `apply_photometric_nuisance` adds the
    photometric part."""
    dev = resolve_device(device)
    base = render_textured_view_cylinder(
        cam_params, T_cw, H, W, ground_y=ground_y, center_x=center_x,
        center_z=center_z, radius=radius, wall_symmetry=wall_symmetry,
        tex_phase=tex_phase, device=dev)
    o, d = _rays(cam_params, T_cw, H, W, dev)
    t_best = torch.full((H, W), BIG, dtype=f32, device=dev)
    val = base
    for k in range(n_pillars):
        ang = 2.0 * np.pi * (k + 0.35) / n_pillars
        pcx = center_x + 0.55 * radius * np.sin(ang)
        pcz = center_z + 0.55 * radius * np.cos(ang)
        pr = 0.5 + 0.25 * ((k * 0.37) % 1.0)
        ox = o[0] - pcx
        oz = o[2] - pcz
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2.0 * (ox * d[..., 0] + oz * d[..., 2])
        c = ox * ox + oz * oz - pr * pr
        disc = b * b - 4 * a * c
        a_safe = torch.where(torch.abs(a) < 1e-9, torch.full_like(a, 1e-9), a)
        t_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a_safe)
        y_at = o[1] + t_hit * d[..., 1]
        ok = (disc > 0) & (t_hit > 1e-3) & (y_at < ground_y) & (y_at > -2.2)
        t_hit = torch.where(ok, t_hit, torch.full_like(t_hit, BIG))
        px = o[0] + t_hit * d[..., 0]
        py = o[1] + t_hit * d[..., 1]
        tex = _value_noise(px * 2.1 + k * 13.7, py * 2.3, octaves=3,
                           base_scale=1.4, phase=tex_phase)
        pv = 50.0 + 170.0 * tex
        val = torch.where(t_hit < t_best, pv, val)
        t_best = torch.minimum(t_best, t_hit)
    t = torch.as_tensor(t, dtype=f32, device=dev)
    m_ang = 0.08 * t
    scx = center_x + 0.35 * radius * torch.sin(m_ang)
    scz = center_z + 0.35 * radius * torch.cos(m_ang)
    scy = torch.full((), 0.4, dtype=f32, device=dev)
    sr = 0.8
    oc = torch.stack([o[0] - scx, o[1] - scy, o[2] - scz])
    b = 2.0 * torch.einsum("hwi,i->hw", d, oc)
    a = torch.sum(d * d, dim=-1)
    c = oc @ oc - sr * sr
    disc = b * b - 4 * a * c
    t_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
    t_hit = torch.where((disc > 0) & (t_hit > 1e-3), t_hit,
                        torch.full_like(t_hit, BIG))
    # textured by the surface normal's direction (it turns as it orbits)
    n = o[None, None, :] + t_hit[..., None] * d - torch.stack([scx, scy, scz])
    tex = _value_noise(torch.atan2(n[..., 0], n[..., 2]) * 3.0 + m_ang * 5.0,
                       n[..., 1] * 4.0, octaves=3, base_scale=1.2)
    sv = 60.0 + 160.0 * tex
    val = torch.where(t_hit < t_best, sv, val)
    return torch.clamp(val, 0.0, 255.0)


def apply_photometric_nuisance(img, key, t):
    """Exposure drift (gain +-12% over ~80 frames, 1% of noise), a bias, a
    radial vignette, a 3-tap horizontal motion blur and sensor noise of
    sigma 2.5, on `img`'s device. `key` is a word pair of `ops/prng` (the
    reference's `jax.random` key): the draws are the reference's."""
    H, W = img.shape
    dev = img.device
    k1, k2 = prng.split(key)
    t = torch.as_tensor(t, dtype=f32, device=dev)
    gain = (1.0 + 0.12 * torch.sin(0.08 * t)
            + 0.01 * prng.normal(k1, (), device=dev))
    bias = 8.0 * torch.sin(0.05 * t + 1.2)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                            torch.arange(W, dtype=f32, device=dev),
                            indexing="ij")
    r2 = (((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2)
    vignette = 1.0 - 0.18 * r2
    blurred = (0.25 * torch.roll(img, 1, dims=1) + 0.5 * img
               + 0.25 * torch.roll(img, -1, dims=1))
    noise = 2.5 * prng.normal(k2, img.shape, device=dev)
    return torch.clamp(blurred * gain * vignette + bias + noise, 0.0, 255.0)


def render_hard_arena_stereo_sequence(poses, H=188, W=620, rig=None,
                                      center=(0.0, 10.0), radius=30.0,
                                      tex_phase=0.0, seed=0,
                                      photometric=True, device="cuda"):
    """(T, H, W) float32 left and right images of the hardened arena: the
    pillars, the sphere at frame time t, and (with `photometric`) the
    nuisance, the same gain state on both sides with independent noise.
    Frame t's keys: the key of `seed` split once per frame, that subkey
    split into the left and right keys (the reference's order)."""
    dev = resolve_device(device)
    if rig is None:
        rig = make_stereo_rig()
    key = seed
    lefts, rights = [], []
    for t, pose in enumerate(poses):
        key, sub = prng.split(key)
        tt = torch.tensor(float(t), dtype=f32, device=dev)
        views = []
        for cam, k in zip(rig, prng.split(sub)):
            T = se3.se3_compose(cam.pose.cpu().to(f32),
                                torch.as_tensor(pose).cpu().to(f32))
            img = render_textured_view_cylinder_hard(
                (cam.fx, cam.fy, cam.cx, cam.cy), T, H, W, t=tt,
                center_x=center[0], center_z=center[1], radius=radius,
                tex_phase=tex_phase, device=dev)
            views.append(apply_photometric_nuisance(img, k, tt)
                         if photometric else img)
        lefts.append(views[0])
        rights.append(views[1])
    return torch.stack(lefts), torch.stack(rights)


def render_textured_view(cam_params, T_cw, H: int, W: int, ground_y=1.7,
                         device="cuda"):
    """(H, W) float32 view of the straight corridor: a textured ground
    plane, textured side walls at x = +-13 m (off-plane structure for a
    well-conditioned pose) and an angular sky texture at infinity (no
    parallax)."""
    dev = resolve_device(device)
    o, d = _rays(cam_params, T_cw, H, W, dev)
    t_g = _ground(o, d, ground_y)
    wall_x = 13.0
    dx = d[..., 0]
    dx_safe = torch.where(torch.abs(dx) < 1e-6, torch.full_like(dx, 1e-6), dx)
    t_wl = (-wall_x - o[0]) / dx_safe
    t_wr = (wall_x - o[0]) / dx_safe

    def wall_valid(t_w):
        y_at = o[1] + t_w * d[..., 1]
        return (t_w > 0.0) & (t_w < 400.0) & (y_at < ground_y) & (y_at > -8.0)

    t_wl = torch.where(wall_valid(t_wl), t_wl, torch.full_like(t_wl, BIG))
    t_wr = torch.where(wall_valid(t_wr), t_wr, torch.full_like(t_wr, BIG))
    t_w = torch.minimum(t_wl, t_wr)
    t_hit = torch.minimum(t_g, t_w)
    px = o[0] + t_hit * d[..., 0]
    py = o[1] + t_hit * d[..., 1]
    pz = o[2] + t_hit * d[..., 2]
    ground = _value_noise(px, pz, octaves=5, base_scale=0.9)
    shade = 1.0 / (1.0 + 0.004 * t_hit * t_hit)
    ground_val = 40.0 + 190.0 * ground * (0.35 + 0.65 * shade)
    wall = _value_noise(pz * 1.3, py * 1.6, octaves=5, base_scale=0.8)
    wall_val = 55.0 + 170.0 * wall * (0.4 + 0.6 * shade)
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    dn = d / torch.clamp(norm, min=1e-9)
    az = torch.atan2(dn[..., 0], dn[..., 2])
    sky = _value_noise(az * 14.0, dn[..., 1] * 26.0, octaves=4,
                       base_scale=1.0)
    sky_val = 90.0 + 120.0 * sky
    val = torch.where(t_hit >= BIG, sky_val,
                      torch.where(t_g <= t_w, ground_val, wall_val))
    return torch.clamp(val, 0.0, 255.0)


def render_textured_stereo_sequence(poses, H=188, W=620, rig=None,
                                    ground_y=1.7, device="cuda"):
    """(T, H, W) float32 left and right images of the corridor."""
    dev = resolve_device(device)
    if rig is None:
        rig = make_stereo_rig()
    lefts, rights = [], []
    for pose in poses:
        views = [render_textured_view(
            (cam.fx, cam.fy, cam.cx, cam.cy),
            se3.se3_compose(cam.pose.cpu().to(f32),
                            torch.as_tensor(pose).cpu().to(f32)),
            H, W, ground_y, device=dev) for cam in rig]
        lefts.append(views[0])
        rights.append(views[1])
    return torch.stack(lefts), torch.stack(rights)


def scene(name: str, T: int = 120, H: int = 188, W: int = 620,
          device="cuda"):
    """One of the reference bench's six scenes by name (`SCENES`), with its
    poses, step, yaw rate, arena and renderer:
      forward      0.5 m a frame straight down the corridor;
      figure8      `figure_eight_poses(T, 0.5)` in the radius-25 arena;
      aliased      0.5 m, yaw 2 pi / (T + T // 3), the wall 4-fold
                   symmetric;
      circuit      0.35 m, yaw 2 pi / (T - 8): a closed circle;
      hard         the circuit in the hardened arena (pillars, the moving
                   sphere, photometric nuisance from seed 0);
      circuit_long 0.35 m, yaw 2 pi / 112: a lap every 112 frames.
    The arena is centred at (0, 6), radius 25. Returns (lefts, rights (T,
    H, W) float32 numpy, poses (T, 3, 4) numpy, path length m, rig)."""
    dev = resolve_device(device)
    rig = make_stereo_rig()
    arena = dict(H=H, W=W, rig=rig, center=(0.0, 6.0), radius=25.0,
                 device=dev)
    if name == "forward":
        step = 0.5
        poses = forward_motion_poses(T, step=step)
        lefts, rights = render_textured_stereo_sequence(poses, H=H, W=W,
                                                        rig=rig, device=dev)
    elif name == "figure8":
        step = 0.5
        poses = figure_eight_poses(T, step=step)
        lefts, rights = render_arena_stereo_sequence(poses, **arena)
    elif name == "aliased":
        step = 0.5
        poses = forward_motion_poses(T, step=step,
                                     yaw_rate=2 * np.pi / (T + T // 3))
        lefts, rights = render_arena_stereo_sequence(poses, wall_symmetry=4,
                                                     **arena)
    elif name in ("circuit", "hard", "circuit_long"):
        step = 0.35
        period = 112 if name == "circuit_long" else T - 8
        poses = forward_motion_poses(T, step=step,
                                     yaw_rate=2 * math.pi / period)
        render = (render_hard_arena_stereo_sequence if name == "hard"
                  else render_arena_stereo_sequence)
        lefts, rights = render(poses, **arena)
    else:
        raise ValueError(f"unknown scene {name!r}; one of {SCENES}")
    return (lefts.cpu().numpy(), rights.cpu().numpy(),
            np.asarray(poses.numpy(), np.float32), step * T, rig)


def circuit(T: int = 120, H: int = 188, W: int = 620, device="cpu"):
    """The bench's closed circuit: ~3 deg/frame of yaw closes the circle in
    T frames at 0.35 m/frame inside a radius-25 arena (`scene("circuit")`).
    Returns what `scene` returns."""
    return scene("circuit", T, H, W, device)


def circuit_long(T: int = 480, H: int = 188, W: int = 620, device="cpu"):
    """The bench's multi-lap circuit: the same arena driven at 0.35 m/frame
    with 2 pi / 112 of yaw a frame, a lap every 112 frames, every lap a
    loop-closure opportunity (`scene("circuit_long")`). Returns what
    `scene` returns."""
    return scene("circuit_long", T, H, W, device)
