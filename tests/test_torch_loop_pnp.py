"""Port parity, PnP RANSAC: `slam/pnp.pnp_ransac` against the reference's
on the same points and the same uniform draws (the reference's
`jax.random.uniform(PRNGKey(k), (H, N), minval=1e-9)`, fed to the port as
a tensor), at the reference test's operating points
(tests/test_loop_components.py): exact, 30% gross outliers, 0.5 px noise
with 20% outliers, and fewer valid points than a hypothesis needs.

Tolerances: the pose within 1e-4 and the inlier sets equal (the DLT, its
inverse iteration and the two LM solves run the same float32 steps, in
another sum order); both within the reference test's bounds of the truth.
With fewer valid points than MIN_SET the hypotheses draw invalid points,
whose Gumbel scores tie in float32: the port breaks ties by index as
`lax.top_k` does, and either way the result falls under the hook's
min_match of 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import jacobians, se3
from stereovision_slam_tpu.slam.pnp import pnp_ransac as jpnp
from stereovision_slam_torch import convert
from stereovision_slam_torch.geometry import se3 as tse3
from stereovision_slam_torch.ops import prng
from stereovision_slam_torch.slam import pnp
from tests import synthetic

torch.set_num_threads(1)


def _both(pts_w, uv, valid, key: int, H: int = 128):
    left, _ = synthetic.make_stereo_rig()
    a = jpnp(left, jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(valid),
             jax.random.PRNGKey(key), num_hypotheses=H)
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(key),
                                          (H, len(valid)), jnp.float32,
                                          1e-9, 1.0))
    assert np.array_equal(draws, prng.uniform(key, draws.shape, 1e-9,
                                              1.0).numpy())
    b = pnp.pnp_ransac(convert.camera(left), torch.tensor(np.asarray(pts_w)),
                       torch.tensor(np.asarray(uv)),
                       torch.tensor(np.asarray(valid)), torch.tensor(draws))
    return a, b


def _case(name):
    left, _ = synthetic.make_stereo_rig()
    if name == "exact":
        T = se3.se3_exp(jnp.array([1.0, -0.5, 3.0, 0.05, -0.1, 0.02]))
        pts_rig = synthetic.random_landmarks(jax.random.PRNGKey(5), 64)
        pts_w = se3.se3_apply(se3.se3_inverse(T), pts_rig)
        uv, _ = jacobians.project_points(left, T, pts_w)
        return T, pts_w, uv, np.ones(64, bool), 0, 1e-2, 60
    if name == "outliers":
        T = se3.se3_exp(jnp.array([-2.0, 0.3, 5.0, 0.02, 0.3, -0.05]))
        pts_rig = synthetic.random_landmarks(jax.random.PRNGKey(6), 96)
        pts_w = se3.se3_apply(se3.se3_inverse(T), pts_rig)
        uv, _ = jacobians.project_points(left, T, pts_w)
        uv = uv.at[:28].add(jax.random.uniform(
            jax.random.PRNGKey(7), (28, 2), minval=40.0, maxval=120.0))
        valid = np.ones(96, bool)
        valid[90:] = False
        return T, pts_w, uv, valid, 1, 2e-2, 55
    rng = np.random.default_rng(3)                      # noisy
    pts_w = jnp.asarray(np.stack([rng.uniform(-5, 5, 200),
                                  rng.uniform(-3, 3, 200),
                                  rng.uniform(6, 40, 200)], 1), jnp.float32)
    T = se3.se3_exp(jnp.array([0.3, -0.1, 0.8, 0.0, 0.1, 0.0]))
    uv, _ = jacobians.project_points(left, T, pts_w)
    uv = np.array(uv) + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
    uv[:40] += rng.uniform(30, 90, (40, 2)).astype(np.float32)
    return T, pts_w, uv, np.ones(200, bool), 4, 5e-2, 140


@pytest.mark.parametrize("name", ["exact", "outliers", "noisy"])
def test_pnp_ransac_matches_reference(name):
    T_true, pts_w, uv, valid, key, tol, min_in = _case(name)
    for H in (128, 256):
        (Tj, inl_j, n_j), (Tt, inl_t, n_t) = _both(pts_w, uv, valid, key, H)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                                   atol=1e-4)
        assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
        assert int(n_t) == int(n_j) >= min_in
        d = float(tse3.se3_distance(Tt, torch.tensor(np.asarray(T_true))))
        assert d < tol, d
        if name != "exact":
            assert not bool(inl_t[:28].any())


def test_pnp_ransac_too_few_points_is_rejected():
    pts_w = np.zeros((16, 3), np.float32)
    pts_w[:, 2] = 10.0
    pts_w[:, 0] = np.arange(16, dtype=np.float32) * 0.1
    uv = np.full((16, 2), 100.0, np.float32)
    valid = np.zeros(16, bool)
    valid[:3] = True
    (Tj, _, n_j), (Tt, inl_t, n_t) = _both(pts_w, uv, valid, 2)
    assert bool(torch.isfinite(Tt).all())
    assert int(n_t) < 10 and int(n_j) < 10          # the hook's min_match
    assert not bool(inl_t[3:].any())
