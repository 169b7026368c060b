"""Port parity, the slice: `FusedVisualOdometry(device="cpu")` against the
JAX one on the scene of tests/test_fused.py (120x320, 14 frames).

On the CPU the reference takes its full-image LK and its LU pose solve,
while the port takes its kernels' plain versions (windowed lanes LK,
Cholesky pose solve), so the comparison is semantic: the same keyframe
frames, per-frame inlier counts within 3 of each other (a point at a
search-window margin can fail one tracker and not the other), keyframe
poses within 2e-3 and ATEs within 2e-3 m of each other (measured 1.1e-4 and
1.1e-5). `trajectory()` is held to the reference's the same way.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_tpu.utils.evaluation import ate_rmse
from stereovision_slam_torch import convert
from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.fused import FusedVisualOdometry
from tests import synthetic
from tests.test_pipeline_frontend import small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    H, W = 120, 320
    rig = synthetic.make_stereo_rig(fx=260.0, fy=260.0, cx=160.0, cy=60.0)
    poses = synthetic.forward_motion_poses(14, step=0.5, yaw_rate=0.012)
    lms = jnp.concatenate([
        synthetic.random_landmarks(jax.random.PRNGKey(40), 80, z_range=(4, 40)),
        synthetic.random_landmarks(jax.random.PRNGKey(41), 60,
                                   z_range=(10, 50)) + jnp.array([0., 0., 6.]),
    ])
    lefts, rights = synthetic.render_stereo_sequence(
        jax.random.PRNGKey(17), poses, lms, H=H, W=W, rig=rig)
    return np.array(lefts), np.array(rights), rig, np.array(poses)


@pytest.fixture(scope="module")
def runs(scene):
    """The reference's and the port's fused pipelines over the scene."""
    lefts, rights, rig, _ = scene
    cfg = small_config()
    ref = JFused(cfg, JDataset(lefts, rights, list(rig)))
    ref.initialize()
    ref.run()
    port = FusedVisualOdometry(
        convert.slam_config(cfg),
        ArraySequenceDataset(lefts, rights, [convert.camera(c) for c in rig]),
        device="cpu")
    port.initialize()
    port.run()
    return ref, port


def test_fused_slice_matches_reference(scene, runs):
    poses = scene[3]
    ref, port = runs
    kf_j, lm_j, out_j = ref.drain()
    kf_t, lm_t, out_t = port.drain()

    est_j = {fid: p for fid, p in kf_j.values()}
    est_t = {fid: p for fid, p in kf_t.values()}
    assert sorted(est_t) == sorted(est_j)
    assert len(est_t) >= 2
    n_j = np.array([int(o.n_inliers) for _, o in out_j])
    n_t = np.array([int(o.n_inliers) for _, o in out_t])
    assert np.abs(n_j - n_t).max() <= 3, (n_j, n_t)
    assert [bool(o.kf_inserted) for _, o in out_t] == \
        [bool(o.kf_inserted) for _, o in out_j]
    for fid in est_j:
        np.testing.assert_allclose(est_t[fid], est_j[fid], atol=2e-3)
    gt = {i: poses[i] for i in range(len(poses))}
    ate_j = ate_rmse(est_j, gt, align=False)
    ate_t = ate_rmse(est_t, gt, align=False)
    assert abs(ate_t - ate_j) < 2e-3 and ate_t < 0.15
    assert abs(len(lm_t) - len(lm_j)) <= 0.05 * len(lm_j)
    # the device archives, carried across with convert
    arc_j = convert.archive_state(ref.arc)
    for f in ("kf_set", "kf_frame_id", "lm_set"):
        assert np.array_equal(getattr(port.arc, f).numpy(),
                              getattr(arc_j, f).numpy()), f
    for f in ("kf_pose", "kf_rel"):
        np.testing.assert_allclose(getattr(port.arc, f).numpy(),
                                   getattr(arc_j, f).numpy(), atol=2e-3)


def test_trajectory_matches_reference(scene, runs):
    """`trajectory()`, {frame_id: pose} of the drained keyframes, against
    the reference's, with the slice's tolerances."""
    ref, port = runs
    tj, tt = ref.trajectory(), port.trajectory()
    assert sorted(tt) == sorted(tj) and len(tt) >= 2
    for fid in tj:
        np.testing.assert_allclose(tt[fid], tj[fid], atol=2e-3)
    gt = {i: p for i, p in enumerate(scene[3])}
    assert abs(ate_rmse(tt, gt, align=False)
               - ate_rmse(tj, gt, align=False)) < 2e-3
    kf_t, _, _ = port.drain()
    assert tt.keys() == {f for f, _ in kf_t.values()}


def test_config_copy_reads_the_same_yaml():
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert [f.name for f in dataclasses.fields(SlamConfig)] == names
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))):
        a, b = JConfig.from_yaml(path), SlamConfig.from_yaml(path)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), path


def test_device_is_explicit():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            FusedVisualOdometry(SlamConfig(), None)
