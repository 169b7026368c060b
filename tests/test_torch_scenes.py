"""Port parity, the scenes (scenes.py) against the reference fixture
(tests/synthetic.py) and the bench's scene renderer
(benchmarks/render_scene.py).

The poses agree to a few float32 ulps after 119 compositions (atol 2e-5
on translations of up to 16 m; measured 5.2e-6). The texture is a sin-hash
value noise whose hash multiplies sin() by 43758.5, so one ulp of sin()
moves a lattice value by about 0.003 and, where the hash sits at a wrap, to
another value altogether. Held to: mean absolute difference under 0.1 grey level,
and under 0.5% of pixels more than one grey level apart (measured 0.034
and 0.17% at this size, 0.027 and 0.14% at 188x620). A float64 render
differs everywhere. The other worlds are held the same way: the aliased
wall and a texture phase (the reference folds the hash's constant terms,
phase included, into one float32 before the sum; measured 0.013 / 0.02%
and 0.016 / 0.10%), the corridor (0.028 / 0.05%), and the hard scene with
its photometric nuisance at seed 0 (0.026 / 0.19%): its keys are the
reference's, its normals within a few ulps (torch's erfinv is not XLA's
polynomial). The figure-eight's poses agree to a few ulps (atol 2e-5,
measured 3.3e-6).
"""

import math
import sys

import numpy as np
import pytest
import torch

from stereovision_slam_torch import scenes
from tests import synthetic

H, W = 48, 160
RIG = dict(fx=350.0 * W / 620, fy=350.0 * W / 620, cx=310.0 * W / 620,
           cy=94.0 * H / 188)


def test_circuit_poses_are_the_reference_poses():
    jp = synthetic.forward_motion_poses(120, step=0.35,
                                        yaw_rate=2 * np.pi / 112)
    tp = scenes.forward_motion_poses(120, step=0.35,
                                     yaw_rate=2 * math.pi / 112)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-5)


@pytest.mark.parametrize("side", [0, 1])
def test_arena_render_matches_reference(side):
    poses = synthetic.forward_motion_poses(6, step=0.35,
                                           yaw_rate=2 * np.pi / 112)
    ref = synthetic.render_arena_stereo_sequence(
        poses, H=H, W=W, rig=synthetic.make_stereo_rig(**RIG),
        center=(0.0, 6.0), radius=25.0)[side]
    port = scenes.render_arena_stereo_sequence(
        torch.tensor(np.asarray(poses)), H=H, W=W,
        rig=scenes.make_stereo_rig(**RIG), center=(0.0, 6.0),
        radius=25.0)[side]
    assert port.dtype == torch.float32 and port.shape == ref.shape
    d = np.abs(port.numpy() - np.asarray(ref))
    assert d.mean() < 0.1, d.mean()
    assert (d > 1.0).mean() < 5e-3, (d > 1.0).mean()


def test_circuit_long_is_the_reference_scene():
    """`circuit_long` against benchmarks/render_scene.py's "circuit_long"
    (poses from tests/synthetic.py, yaw 2 pi / 112 a frame, 0.35 m a
    frame): the 480 poses (atol 1e-4 after 479 compositions) and the path
    length; its first frames at 188x620 rendered as the reference renders
    them, held as above."""
    jp = np.asarray(synthetic.forward_motion_poses(
        480, step=0.35, yaw_rate=2 * np.pi / 112))
    tp = scenes.forward_motion_poses(480, step=0.35,
                                     yaw_rate=2 * math.pi / 112).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    lefts, rights, gt, dist, _ = scenes.circuit_long(T=3)
    assert lefts.shape == (3, 188, 620) and dist == pytest.approx(0.35 * 3)
    np.testing.assert_allclose(gt, jp[:3], atol=2e-5)
    ref = synthetic.render_arena_stereo_sequence(
        jp[:3], H=188, W=620, rig=synthetic.make_stereo_rig(),
        center=(0.0, 6.0), radius=25.0)
    for port, r in ((lefts, ref[0]), (rights, ref[1])):
        d = np.abs(port - np.asarray(r))
        assert d.mean() < 0.1, d.mean()
        assert (d > 1.0).mean() < 5e-3, (d > 1.0).mean()


def _held(port, ref) -> None:
    d = np.abs(np.asarray(port) - np.asarray(ref))
    assert d.mean() < 0.1, d.mean()
    assert (d > 1.0).mean() < 5e-3, (d > 1.0).mean()


POSES6 = synthetic.forward_motion_poses(6, step=0.35,
                                        yaw_rate=2 * np.pi / 112)


@pytest.mark.parametrize("wall_symmetry,tex_phase", [(4, 0.0), (0, 1.613)])
def test_arena_symmetry_and_phase_match_reference(wall_symmetry, tex_phase):
    kw = dict(H=H, W=W, center=(0.0, 6.0), radius=25.0,
              wall_symmetry=wall_symmetry, tex_phase=tex_phase)
    ref = synthetic.render_arena_stereo_sequence(
        POSES6, rig=synthetic.make_stereo_rig(**RIG), **kw)
    port = scenes.render_arena_stereo_sequence(
        torch.tensor(np.asarray(POSES6)), rig=scenes.make_stereo_rig(**RIG),
        **kw)
    for side in (0, 1):
        _held(port[side].numpy(), ref[side])


def test_batched_views_match_single_views():
    """`render_textured_views_cylinder` (one vmapped pass) against one
    view at a time."""
    cam = scenes.make_stereo_rig(**RIG)[0]
    cp = (cam.fx, cam.fy, cam.cx, cam.cy)
    poses = torch.tensor(np.asarray(POSES6))
    kw = dict(ground_y=1.6, center_x=0.5, center_z=6.0, radius=22.0,
              tex_phase=3.2)
    batched = scenes.render_textured_views_cylinder(cp, poses, H, W,
                                                    device="cpu", **kw)
    single = torch.stack([scenes.render_textured_view_cylinder(
        cp, T, H, W, **kw) for T in poses])
    assert batched.shape == (6, H, W)
    _held(batched.numpy(), single.numpy())


def test_corridor_matches_reference():
    poses = synthetic.forward_motion_poses(5, step=0.5)
    ref = synthetic.render_textured_stereo_sequence(
        poses, H=H, W=W, rig=synthetic.make_stereo_rig(**RIG))
    port = scenes.render_textured_stereo_sequence(
        torch.tensor(np.asarray(poses)), H=H, W=W,
        rig=scenes.make_stereo_rig(**RIG), device="cpu")
    for side in (0, 1):
        _held(port[side].numpy(), ref[side])


@pytest.mark.parametrize("photometric", [True, False])
def test_hard_scene_matches_reference(photometric):
    kw = dict(H=H, W=W, center=(0.0, 6.0), radius=25.0,
              photometric=photometric)
    ref = synthetic.render_hard_arena_stereo_sequence(
        POSES6[:4], rig=synthetic.make_stereo_rig(**RIG), seed=0, **kw)
    port = scenes.render_hard_arena_stereo_sequence(
        torch.tensor(np.asarray(POSES6[:4])),
        rig=scenes.make_stereo_rig(**RIG), seed=0, device="cpu", **kw)
    for side in (0, 1):
        _held(port[side].numpy(), ref[side])
        assert port[side].min() >= 0.0 and port[side].max() <= 255.0


def test_figure_eight_poses_are_the_reference_poses():
    jp = np.asarray(synthetic.figure_eight_poses(112, step=0.5))
    tp = scenes.figure_eight_poses(112, step=0.5).numpy()
    assert tp.shape == (112, 3, 4) and tp.dtype == np.float32
    np.testing.assert_allclose(tp, jp, atol=2e-5)


@pytest.mark.parametrize("name", scenes.SCENES)
def test_named_scene_is_the_bench_scene(name, tmp_path, monkeypatch):
    """`scenes.scene(name)` against benchmarks/render_scene.py's branch of
    the same name: the poses (atol 2e-5), the path length and the frames'
    shape. T = 24 frames at 24x64 keeps the reference's renders cheap."""
    from benchmarks import render_scene

    T, h, w = 24, 24, 64
    out = str(tmp_path / "scene.npz")
    monkeypatch.setattr(sys, "argv", ["render_scene.py", out, str(T), str(h),
                                      str(w), name])
    render_scene.main()
    ref = np.load(out)
    lefts, rights, poses, dist, rig = scenes.scene(name, T, h, w,
                                                   device="cpu")
    assert lefts.shape == rights.shape == ref["lefts"].shape == (T, h, w)
    assert lefts.dtype == np.float32
    np.testing.assert_allclose(poses, ref["poses"], atol=2e-5)
    assert dist == pytest.approx(float(ref["dist"]))
    assert float(rig[1].baseline) == pytest.approx(0.54)


def test_scene_names_and_device():
    with pytest.raises(ValueError):
        scenes.scene("nowhere", 3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            scenes.scene("circuit", 3)
