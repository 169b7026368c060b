"""Port parity, the circuit scene (scenes.py) against the reference fixture
(tests/synthetic.py).

The poses agree to a few float32 ulps after 119 compositions (atol 2e-5
on translations of up to 16 m; measured 5.2e-6). The texture is a sin-hash
value noise whose hash multiplies sin() by 43758.5, so one ulp of sin()
moves a lattice value by about 0.003 and, where the hash sits at a wrap, to
another value altogether. Held to: mean absolute difference under 0.1 grey level,
and under 0.5% of pixels more than one grey level apart (measured 0.034
and 0.17% at this size, 0.027 and 0.14% at 188x620). A float64 render
differs everywhere.
"""

import math

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
