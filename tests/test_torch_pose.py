"""Port parity, kernel B (ops/pose_kernel.py).

The problem of tests/test_pose_pallas.py (128 points, 6 gross outliers,
three right observations missing, three starts), made with numpy from a
seed. Kernel B's plain version is held to `solve_pose_multi_lr(...,
interpret=True)`: both solve the damped 6x6 by Cholesky and differ only in
summation order, so the pose agrees within 1e-4 and the inlier sets are
equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereovision_slam_tpu.geometry import jacobians as jjac
from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.geometry.camera import Camera as JCamera
from stereovision_slam_tpu.ops.pose_pallas import solve_pose_multi_lr as jlr
from stereovision_slam_torch import convert
from stereovision_slam_torch.ops.pose_kernel import solve_pose_multi_lr as tlr


def _problem(seed=0, F=128, n_out=6, px_noise=0.25):
    rng = np.random.default_rng(seed)
    left = JCamera.create(350.0, 350.0, 310.0, 94.0)
    right = JCamera.create(350.0, 350.0, 310.0, 94.0, baseline=0.54,
                           pose=jse3.se3_from_Rt(jnp.eye(3),
                                                 jnp.array([-0.54, 0.0, 0.0])))
    T_gt = jse3.se3_exp(jnp.asarray([0.3, -0.1, 0.5, 0.02, -0.03, 0.01]))
    pts = np.stack([rng.uniform(-8, 8, F), rng.uniform(-3, 3, F),
                    rng.uniform(6, 40, F)], 1).astype(np.float32)
    uv_l = np.asarray(jjac.project_points(left, T_gt, jnp.asarray(pts))[0])
    uv_r = np.asarray(jjac.project_points(right, T_gt, jnp.asarray(pts))[0])
    uv_l = (uv_l + rng.normal(0, px_noise, uv_l.shape)).astype(np.float32)
    uv_r = (uv_r + rng.normal(0, px_noise, uv_r.shape)).astype(np.float32)
    uv_l[:n_out] += 35.0
    valid_l = np.ones(F, bool)
    valid_r = np.ones(F, bool)
    valid_r[F - 3:] = False
    T0 = jse3.se3_compose(jse3.se3_exp(jnp.asarray(
        [0.05, 0.02, -0.08, 0.01, 0.005, -0.01])), T_gt)
    T_inits = np.asarray(jnp.stack([T0, jse3.se3_identity(), jse3.se3_compose(
        jse3.se3_exp(jnp.asarray([-0.1, 0.0, 0.1, 0.0, 0.01, 0.0])), T_gt)]))
    return (left, right), np.asarray(T_gt), pts, uv_l, uv_r, valid_l, \
        valid_r, T_inits


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _err(T, T_gt):
    return float(np.linalg.norm(np.asarray(jse3.se3_log(jse3.se3_compose(
        jnp.asarray(T), jse3.se3_inverse(jnp.asarray(T_gt)))))))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernel_matches_interpreted_kernel(seed):
    cams, T_gt, pts, uv_l, uv_r, vl, vr, T_inits = _problem(seed)
    Tj, ij, nj = jlr(cams[0], cams[1], jnp.asarray(T_inits), jnp.asarray(pts),
                     jnp.asarray(uv_l), jnp.asarray(uv_r), jnp.asarray(vl),
                     jnp.asarray(vr), chi2_th=5.991, rounds=3, iters=6,
                     interpret=True)
    tc = [convert.camera(c) for c in cams]
    Tt, it, nt = tlr(tc[0], tc[1], *_torch(T_inits, pts, uv_l, uv_r, vl, vr),
                     chi2_th=5.991, rounds=3, iters=6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(nt) == int(nj)
    assert _err(Tt.numpy(), T_gt) < 5e-3
    assert not it[:6].any()              # the planted outliers are rejected


def test_plain_kernel_masks_and_degenerate():
    """All-invalid right half and a behind-camera point: finite, and the
    same answer as the interpreted kernel."""
    cams, T_gt, pts, uv_l, uv_r, vl, vr, T_inits = _problem(
        seed=3, n_out=0, px_noise=0.0)
    vr[:] = False
    pts[0] = [0.0, 0.0, -5.0]
    Tj, ij, _ = jlr(cams[0], cams[1], jnp.asarray(T_inits), jnp.asarray(pts),
                    jnp.asarray(uv_l), jnp.asarray(uv_r), jnp.asarray(vl),
                    jnp.asarray(vr), chi2_th=5.991, rounds=3, iters=6,
                    interpret=True)
    tc = [convert.camera(c) for c in cams]
    Tt, it, _ = tlr(tc[0], tc[1], *_torch(T_inits, pts, uv_l, uv_r, vl, vr),
                    chi2_th=5.991, rounds=3, iters=6)
    assert torch.isfinite(Tt).all()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not bool(it[0])
