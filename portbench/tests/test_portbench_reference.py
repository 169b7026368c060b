"""The plain reference stage by stage against the program's own plain
(CPU) versions, on a few rendered frames and on synthetic geometry. The
two are written apart; on the CPU they agree to float32 rounding, so a
stage whose semantics drift apart shows here before a run on the card."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import scenes
from portbench.reference import features, image, lk, loop, pgo, pose
from portbench.reference import geometry as geo

CAM = dict(fx=350.0, fy=350.0, cx=310.0, cy=94.0, baseline=0.54)


@pytest.fixture(scope="module")
def lap():
    real = scenes.lap_poses
    scenes.lap_poses = lambda n, s: real(n, s)[:3]
    try:
        scene = dict(CAM, width=620, height=188, lap_frames=112, step_m=0.35,
                     center=[0.0, 6.0], radius=25.0, ground_y=1.7)
        return scenes.render_lap(scene, 1.3, "cpu")
    finally:
        scenes.lap_poses = real


@pytest.fixture(scope="module")
def corners(lap):
    from stereovision_slam_torch.ops import gftt
    pts, ok, _ = gftt.detect(lap[0][0], 256, 0.01, 20)
    return pts, ok


def _program_rig():
    from stereovision_slam_torch.geometry.camera import Camera
    return (Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"]),
            Camera.create(CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                          baseline=CAM["baseline"],
                          pose=scenes.rig_extrinsics(CAM["baseline"])[1]))


def _problem(seed=3, F=200):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(F, 3, generator=g) * torch.tensor([20.0, 6.0, 30.0]) \
        + torch.tensor([-10.0, -3.0, 5.0])
    camL, camR = geo.rig(CAM)
    T = geo.exp(torch.tensor([0.1, -0.05, 0.3, 0.01, 0.02, -0.01]))
    uvl = geo.project(camL, T, X)[0] + 0.5 * torch.randn(F, 2, generator=g)
    uvr = geo.project(camR, T, X)[0] + 0.5 * torch.randn(F, 2, generator=g)
    uvl[:20] += 30.0          # outliers
    vl = torch.rand(F, generator=g) > 0.1
    return X, uvl, uvr, vl, vl & (torch.rand(F, generator=g) > 0.2)


def test_draws(lap):
    from stereovision_slam_torch.ops import prng
    assert torch.equal(prng.uniform(torch.tensor(37), (64, 256), 1e-9, 1.0),
                       loop.threefry_uniform(37, (64, 256), 1e-9, 1.0))


def test_pyramid_and_corners(lap, corners):
    from stereovision_slam_torch.ops import image as pim
    for a, b in zip(pim.build_pyramid(lap[0][0], 4),
                    image.pyramid(lap[0][0], 4)):
        assert float((a - b).abs().max()) < 1e-3
    pts, ok = features.corners(lap[0][0], 256, 0.01, 20)
    assert torch.equal(pts[ok], corners[0][corners[1]])


def test_lk(lap, corners):
    from stereovision_slam_torch.ops import image as pim
    from stereovision_slam_torch.ops import lk_lanes
    pts, ok = corners
    p0, p1 = (pim.build_pyramid(lap[0][i], 4) for i in (0, 1))
    uv1, st1, _ = lk_lanes.lk_pyramid_plain(
        [x[None] for x in p0], [x[None] for x in p1], pts[None], pts[None],
        ok[None], win_size=11, max_iters=12)
    uv2, st2 = lk.track(p0, p1, pts, pts, ok, win=11, iters=12)
    assert torch.equal(st1[0], st2) and int(st2.sum()) > 100
    assert float((uv1[0] - uv2)[st2].abs().max()) < 1e-3


def test_orb_and_embedding(lap, corners):
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.ops import descriptors
    pts, ok = corners
    img = lap[0][0]
    d1, o1 = descriptors.compute(img, pts, ok)
    d2, o2 = loop.orb(img, pts, ok, loop.orb_pattern())
    assert torch.equal(o1, o2)
    assert int((d1 != d2)[o1].sum()) <= 1
    e1 = place_net.embed_image(place_net.get_params(device="cpu"), img)
    assert 1.0 - float(e1 @ loop.embed(loop.place_weights(), img)) < 1e-5


def test_pose_solve():
    from stereovision_slam_torch.ops import pose_kernel
    X, uvl, uvr, vl, vr = _problem()
    T0 = torch.stack([geo.identity(), geo.exp(torch.tensor(
        [0.05, 0.0, 0.2, 0.0, 0.01, 0.0])), geo.exp(torch.tensor(
            [0.0, 0.0, 0.1, 0.0, 0.0, 0.0]))])
    out = pose_kernel.pose_lm_plain(
        pose_kernel.camera_block(*_program_rig()), X, uvl, uvr, vl, vr, T0,
        chi2_th=5.991, rounds=3, iters=6)
    T, inl = pose.solve(list(geo.rig(CAM)), [X, X], [uvl, uvr],
                        torch.cat([vl, vr]), T0, chi2_th=5.991, rounds=3,
                        iters=6)
    assert float((out.T - T).abs().max()) < 1e-5
    assert torch.equal(out.inlier, inl)


def test_pnp():
    from stereovision_slam_torch.ops import prng
    from stereovision_slam_torch.slam import pnp
    X, uvl, _, vl, _ = _problem(seed=5)
    u = prng.uniform(torch.tensor(41), (256, len(X)), 1e-9, 1.0)
    T1, i1, _ = pnp.pnp_ransac(_program_rig()[0], X, uvl, vl, u)
    T2, i2 = loop.pnp(geo.rig(CAM)[0], X, uvl, vl, u)
    assert float((T1 - T2).abs().max()) < 1e-4
    assert torch.equal(i1, i2)


def test_pose_graph():
    from stereovision_slam_torch.slam import pose_graph
    g = torch.Generator().manual_seed(7)
    n = 60
    step = geo.exp(torch.tensor([0.0, 0.0, -0.5, 0.0, 2 * math.pi / n, 0.0]))
    P = [geo.identity()]
    for _ in range(n - 1):
        P.append(geo.compose(step, P[-1]))
    P = torch.stack(P)
    noisy = geo.compose(geo.exp(0.02 * torch.randn(n, 6, generator=g)), P)
    noisy[0] = P[0]
    rel = geo.compose(geo.exp(0.003 * torch.randn(n - 1, 6, generator=g)),
                      geo.compose(P[1:], geo.inverse(P[:-1])))
    arc = dict(kf_frame_id=torch.arange(n, dtype=torch.int32),
               kf_pose=noisy, kf_set=torch.ones(n, dtype=torch.bool),
               kf_rel=torch.cat([geo.identity()[None], rel]))
    ms = dict(kf_valid=torch.zeros(4, dtype=torch.bool),
              kf_id=torch.full((4,), -1), kf_frame_id=torch.full((4,), -1),
              kf_pose=torch.zeros(4, 3, 4))
    li = torch.tensor([59, 50, 40], dtype=torch.int32)
    lj = torch.tensor([2, 5, 10], dtype=torch.int32)
    A = torch.randn(3, 6, 6, generator=g)
    info = A @ A.transpose(1, 2)
    info = info / torch.linalg.eigvalsh(info)[:, -1:, None]
    ls = dict(n_loops=torch.tensor(3), loop_i=li, loop_j=lj, loop_info=info,
              loop_rel=geo.compose(P[li.long()], geo.inverse(P[lj.long()])))
    G, _, _ = pgo.graph(arc, ms, ls)
    ref = pgo.solve(G, 22)
    E = len(G["i"])
    prog = pose_graph.optimize_pose_graph(pose_graph.PoseGraph(
        poses=G["poses"].float(), pose_valid=torch.ones(n, dtype=torch.bool),
        edge_i=G["i"], edge_j=G["j"], edge_meas=G["meas"].float(),
        edge_valid=torch.ones(E, dtype=torch.bool),
        edge_info=torch.cat([torch.eye(6).repeat(n - 1, 1, 1), info])),
        iters=22)
    assert pgo.cost(G, ref) < 0.01 * pgo.cost(G, G["poses"])
    assert abs(math.log(pgo.cost(G, prog.double()) / pgo.cost(G, ref))) \
        < 1e-3
