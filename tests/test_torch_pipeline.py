"""Port parity, the classic pipeline (`slam/pipeline.py:VisualOdometry`)
against the reference's on the same frames, on the CPU: the keyframe
decisions and poses over a short synthetic sequence, the stereo
initialization's retry after a flat first frame, and a relocalization
after tracking loss (mirroring tests/test_relocalization.py).

On the CPU the reference takes its full-image LK and LU pose solve, the
port its kernels' plain versions, so the comparison is semantic: the same
keyframe frame ids, the same status sequence, keyframe poses within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.slam.backend import Backend as JBackend
from stereovision_slam_tpu.slam.pipeline import VisualOdometry as JVO
from stereovision_slam_torch import convert
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam.backend import Backend
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.pipeline import VisualOdometry
from stereovision_slam_torch.utils.evaluation import camera_centers
from tests import synthetic
from tests.test_pipeline_frontend import small_config

torch.set_num_threads(1)

POSE_TOL = 1e-3


@pytest.fixture(scope="module")
def sequence():
    """10 frames at 92x320, a flat first frame in front of them."""
    H, W, T = 92, 320, 10
    rig = synthetic.make_stereo_rig(fx=260.0, fy=260.0, cx=160.0, cy=46.0)
    poses = synthetic.forward_motion_poses(T, step=0.5, yaw_rate=0.01)
    lms = jnp.concatenate([
        synthetic.random_landmarks(jax.random.PRNGKey(0), 70,
                                   y_range=(-3, 3), z_range=(4, 35)),
        synthetic.random_landmarks(jax.random.PRNGKey(1), 50,
                                   y_range=(-3, 3), z_range=(8, 40)),
    ])
    lefts, rights = synthetic.render_stereo_sequence(
        jax.random.PRNGKey(2), poses, lms, H=H, W=W, rig=rig)
    return np.array(lefts), np.array(rights), rig, np.array(poses)


def _config():
    cfg = small_config()
    cfg.image_height, cfg.image_width = 92, 320
    return cfg


def _run_both(lefts, rights, rig):
    cfg = _config()
    ref = JVO(cfg, JDataset(lefts, rights, list(rig)), backend=JBackend())
    port = VisualOdometry(convert.slam_config(cfg), ArraySequenceDataset(
        lefts, rights, [convert.camera(c) for c in rig]), backend=Backend(),
        device="cpu")
    statuses = []
    for vo in (ref, port):
        vo.initialize()
        s = []
        while vo.step():
            s.append(vo.status.name)
        vo.finish()
        statuses.append(s)
    return ref, port, statuses


def _hold_trajectories(ref, port):
    tr, tp = ref.trajectory(), port.trajectory()
    assert sorted(tp) == sorted(tr)
    for f in tr:
        np.testing.assert_allclose(tp[f], np.asarray(tr[f]), atol=POSE_TOL,
                                   err_msg=f"frame {f}")
    return tp


def test_classic_pipeline_matches_reference(sequence):
    lefts, rights, rig, poses = sequence
    ref, port, (s_ref, s_port) = _run_both(lefts, rights, rig)
    assert s_port == s_ref
    assert port.kf_count == ref.kf_count >= 2
    tp = _hold_trajectories(ref, port)
    assert abs(len(port.archived_landmarks)
               - len(ref.archived_landmarks)) <= 0.05 * len(
                   ref.archived_landmarks)
    assert min(port.inlier_history) > _config().num_features_tracking
    assert port.fps() > 0
    # and against ground truth
    est = camera_centers(np.stack([tp[f] for f in sorted(tp)]))
    gt = camera_centers(poses[sorted(tp)])
    assert float(np.abs(est - gt).max()) < 0.05


def test_stereo_init_retries_after_a_flat_frame(sequence):
    lefts, rights, rig, _ = sequence
    flat = np.full_like(lefts[:1], 60.0)
    lefts = np.concatenate([flat, lefts[:4]])
    rights = np.concatenate([flat, rights[:4]])
    ref, port, (s_ref, s_port) = _run_both(lefts, rights, rig)
    assert s_port == s_ref
    assert s_port[0] == "INITING" and s_port[1] == "TRACKING_GOOD"
    assert port.archived_keyframes[0].frame_id == 1
    _hold_trajectories(ref, port)


def test_relocalizes_after_blank_frames():
    """The reference's relocalization test on the port: blank frames make
    tracking LOST; views matching the last keyframe bring it back, near the
    true pose."""
    H, W = 188, 620
    rig = synthetic.make_stereo_rig()
    fwd = synthetic.forward_motion_poses(10, step=0.4)
    fwd_t = torch.from_numpy(np.array(fwd))
    resume = [fwd_t[9]]
    mv = se3.se3_exp(torch.tensor([0., 0., -0.2, 0., 0., 0.]))
    for _ in range(4):
        resume.append(se3.se3_compose(mv, resume[-1]))
    poses_render = np.concatenate([np.asarray(fwd),
                                   torch.stack(resume).numpy()])
    lefts, rights = synthetic.render_textured_stereo_sequence(
        jnp.asarray(poses_render), H=H, W=W, rig=rig)
    lefts, rights = np.asarray(lefts), np.asarray(rights)
    blank = np.full((3, H, W), 60.0, np.float32)
    lefts = np.concatenate([lefts[:10], blank, lefts[10:]])
    rights = np.concatenate([rights[:10], blank, rights[10:]])

    cfg = SlamConfig(num_features_needed_for_keyframe=120)
    vo = VisualOdometry(cfg, ArraySequenceDataset(
        lefts, rights, [convert.camera(c) for c in rig]), backend=Backend(),
        device="cpu")
    vo.initialize()
    statuses = []
    while vo.step():
        statuses.append(vo.status)
    assert fe.FrontendStatus.LOST in statuses
    assert statuses[-1] in (fe.FrontendStatus.TRACKING_GOOD,
                            fe.FrontendStatus.TRACKING_BAD), statuses[-3:]
    est_c = camera_centers(vo.fs.T_cur.numpy()[None])[0]
    gt_c = camera_centers(poses_render[-1][None])[0]
    assert np.linalg.norm(est_c - gt_c) < 0.5, np.linalg.norm(est_c - gt_c)


def test_pipeline_asks_for_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VisualOdometry(SlamConfig(), None)
