"""Port parity, the reference's smaller public API: the SE(3) accessors
(`so3_vee`, `se3_R`, `se3_t`, `se3_matrix`), `triangulate_stereo` and
`resize_half` on the inputs of the reference's own tests
(tests/test_se3.py, tests/test_camera_triangulation.py:80,
tests/test_image_ops.py:20) and on a random batch each; and `trajectory()`
on the chunked classes, which inherit it from `FusedVisualOdometry`.

The accessors and `resize_half` are exact (slices; a mean of four values
in the reference's order). `triangulate_stereo` dispatches to the port's
`triangulate`, whose Jacobi eigensolver rounds differently from the
reference's: points within 1e-3 relative, gates equal. On the CPU a
chunked run calls the branch functions the graphs would replay, so its
trajectory equals the eager class's bit for bit (tests/test_torch_scan.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.geometry import triangulation as jtri
from stereovision_slam_tpu.ops import image as jimops
from stereovision_slam_torch import convert
from stereovision_slam_torch.geometry import se3, triangulation
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.slam import fused, fused_loop
from tests.test_pipeline_frontend import small_config
from tests.test_torch_slice import scene  # noqa: F401  (module fixture)

torch.set_num_threads(1)


def _random_xi(seed: int, n: int, scale=0.5):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, 6))
                      * scale)


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_se3_accessors_match_reference(seed):
    """The reference tests' poses (random tangents of tests/test_se3.py
    through the reference's `se3_exp`), batched and one at a time."""
    T = np.array(jse3.se3_exp(jnp.asarray(_random_xi(seed, 8))))
    t = torch.from_numpy(T)
    for fn in ("se3_R", "se3_t", "se3_matrix"):
        np.testing.assert_array_equal(getattr(se3, fn)(t).numpy(),
                                      np.asarray(getattr(jse3, fn)(T)), fn)
        np.testing.assert_array_equal(getattr(se3, fn)(t[3]).numpy(),
                                      np.asarray(getattr(jse3, fn)(T[3])), fn)
    M = se3.se3_matrix(t)
    assert M.shape == (8, 4, 4) and M.dtype == t.dtype
    np.testing.assert_array_equal(M[:, 3].numpy(),
                                  np.tile([0.0, 0.0, 0.0, 1.0], (8, 1)))
    W = np.array(jse3.so3_hat(jnp.asarray(_random_xi(seed, 8)[:, 3:])))
    np.testing.assert_array_equal(se3.so3_vee(torch.from_numpy(W)).numpy(),
                                  np.asarray(jse3.so3_vee(W)))
    w = torch.from_numpy(_random_xi(seed, 5)[:, :3])
    np.testing.assert_array_equal(se3.so3_vee(se3.so3_hat(w)).numpy(),
                                  w.numpy())


def test_triangulate_stereo_matches_reference():
    """tests/test_camera_triangulation.py:80's points, then a random batch
    with far and behind-the-rig points mixed in."""
    pts = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(1), (64, 3),
        minval=jnp.array([-5.0, -3.0, 5.0]),
        maxval=jnp.array([5.0, 3.0, 60.0])))
    rng = np.random.default_rng(4)
    extra = rng.uniform([-20, -5, -3], [20, 5, 300], (64, 3)).astype(
        np.float32)
    for p in (pts, extra):
        b = np.array([0.0, -0.54], np.float32)
        pl = (p[:, :2] / p[:, 2:3]).astype(np.float32)
        pr = ((p + np.array([-0.54, 0.0, 0.0], np.float32))[:, :2]
              / p[:, 2:3]).astype(np.float32)
        xyz_j, ok_j = (np.asarray(a) for a in jtri.triangulate_stereo(
            jnp.asarray(b), jnp.asarray(pl), jnp.asarray(pr)))
        xyz, ok = triangulation.triangulate_stereo(
            torch.from_numpy(b), torch.from_numpy(pl), torch.from_numpy(pr))
        np.testing.assert_array_equal(ok.numpy(), ok_j)
        np.testing.assert_allclose(xyz.numpy()[ok_j], xyz_j[ok_j], rtol=1e-3,
                                   atol=1e-4)
    xyz, ok = triangulation.triangulate_stereo(
        (0.0, -0.54), torch.from_numpy(pl), torch.from_numpy(pr))
    assert ok.shape == (64,) and xyz.shape == (64, 3)


@pytest.mark.parametrize("shape", [(4, 4), (7, 9), (188, 620)])
def test_resize_half_matches_reference(shape):
    """tests/test_image_ops.py:20's ramp, then random images (odd sizes
    drop their last row or column)."""
    img = (np.arange(16.0, dtype=np.float32).reshape(4, 4) if shape == (4, 4)
           else np.random.default_rng(5).uniform(0, 255, shape).astype(
               np.float32))
    out = imops.resize_half(torch.from_numpy(img)).numpy()
    ref = np.asarray(jimops.resize_half(jnp.asarray(img)))
    assert out.shape == ref.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-4)
    if shape == (4, 4):
        assert out[0, 0] == (0 + 1 + 4 + 5) / 4


def _frames(scene):
    lefts, rights, rig, _ = scene
    return lefts, rights, [convert.camera(c) for c in rig]


def _trajectory(cls, scene, **kw):
    lefts, rights, rig = _frames(scene)
    vo = cls(convert.slam_config(small_config()),
             ArraySequenceDataset(lefts, rights, rig), device="cpu", **kw)
    vo.initialize()
    vo.run()
    return vo.trajectory()


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b) and len(a) >= 2
    for fid in a:
        np.testing.assert_array_equal(a[fid], b[fid])


def test_scan_trajectory_equals_eager(scene):  # noqa: F811
    """`ScanVisualOdometry` (chunks of 4 over the 14 frames, a padded row)
    against `FusedVisualOdometry`."""
    _equal(_trajectory(fused.ScanVisualOdometry, scene, chunk_size=4),
           _trajectory(fused.FusedVisualOdometry, scene))


def test_scan_loop_trajectory_equals_eager(scene):  # noqa: F811
    """`ScanLoopVisualOdometry` (chunk 8) with PlaceNet in the hook against
    `FusedLoopVisualOdometry`; `trajectory()` is not overridden."""
    params = place_net.get_params(device="cpu")
    for cls in (fused.ScanVisualOdometry, fused.UnrolledVisualOdometry,
                fused_loop.FusedLoopVisualOdometry,
                fused_loop.ScanLoopVisualOdometry):
        assert cls.trajectory is fused.FusedVisualOdometry.trajectory
        assert cls.drain is fused.FusedVisualOdometry.drain
    _equal(_trajectory(fused_loop.ScanLoopVisualOdometry, scene,
                       place_params=params),
           _trajectory(fused_loop.FusedLoopVisualOdometry, scene,
                       place_params=params))
