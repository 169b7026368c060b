"""Port parity at the sizes that once exceeded the kernels' limits: LK
windows above 15 (kernel A now takes 1 to 31) and more than 1024 feature
slots (kernel B now takes any number of points). On the CPU the wrappers
run their plain versions, so these hold the plain versions and the routes
around them to the reference; tests/test_torch_cuda.py holds the kernels
to the plain versions at the same sizes on the card.

- `lk.track(win_size=21)` (OpenCV's default window) against the
  reference's `lk.track` at the same window on its CPU route (the
  per-level XLA loop over the full image; the reference's lanes kernel
  holds a fixed 16-pixel template window, so it takes windows up to 13
  only): statuses equal, positions within 1e-3 px (the tolerance of
  tests/test_torch_lk.py; 3e-5 measured);
- the fused odometry with `max_features = 1536` slots, 1536 GFTT corners a
  frame and `lk_win_size = 21` against the reference's fused odometry, both
  on their CPU routes: the same keyframe decisions, inlier counts within 3 +
  1% and poses within 2e-3 (the comparison of tests/test_torch_slice.py).
  Neither package's frontend reads `lk_win_size` (both track at the default
  window 11); the key is set as a user would set it.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.ops import lk as jlk
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.ops import lk as tlk
from stereovision_slam_torch.slam.fused import FusedVisualOdometry
from tests import synthetic

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(4, step=0.4, yaw_rate=0.003)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=188, W=620, rig=rig)
    return np.array(lefts), np.array(rights), rig


def test_lk_win21_matches_reference(frames):
    lefts, _, _ = frames
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(20, 600, 256), rng.uniform(20, 168, 256)],
                   axis=1).astype(np.float32)
    kw = dict(win_size=21, max_iters=12)
    uj, sj = jlk.track(jimg.build_pyramid(jnp.asarray(lefts[0]), 4),
                       jimg.build_pyramid(jnp.asarray(lefts[1]), 4),
                       jnp.asarray(pts), **kw)
    ut, st = tlk.track(timg.build_pyramid(torch.from_numpy(lefts[0]), 4),
                       timg.build_pyramid(torch.from_numpy(lefts[1]), 4),
                       torch.from_numpy(pts), **kw)
    uj, sj, ut, st = np.asarray(uj), np.asarray(sj), ut.numpy(), st.numpy()
    np.testing.assert_array_equal(st, sj)
    assert st.sum() > 240
    np.testing.assert_allclose(ut[st], uj[st], rtol=0, atol=1e-3)


def test_fused_odometry_at_1536_features_matches_reference(frames):
    lefts, rights, rig = frames
    cfg = JConfig(num_features=1536, max_features=1536, num_features_init=50,
                  num_features_needed_for_keyframe=100, gftt_min_distance=4,
                  max_landmarks=4096, lk_win_size=21, lk_max_iters=12,
                  pose_rounds=3, pose_iters_per_round=6)
    ref = JFused(cfg, JDataset(lefts, rights, list(rig)))
    ref.initialize()
    ref.run()
    kf_j, _, out_j = ref.drain()
    port = FusedVisualOdometry(
        convert.slam_config(cfg),
        ArraySequenceDataset(lefts, rights, [convert.camera(c) for c in rig]),
        device="cpu")
    port.initialize()
    assert port.cfg.max_features == 1536 and port.cfg.lk_win_size == 21
    port.run()
    kf_t, _, out_t = port.drain()
    assert port.fs.feat_uv.shape == (1536, 2)
    assert int(port.fs.feat_valid.sum()) > 1024        # past the old cap
    n_j = np.array([int(o.n_inliers) for _, o in out_j])
    n_t = np.array([int(o.n_inliers) for _, o in out_t])
    assert n_t[0] > 1024 and (n_t[1:] > 1024).all(), n_t
    assert (np.abs(n_j - n_t) <= 3 + 0.01 * n_j).all(), (n_j, n_t)
    assert [bool(o.kf_inserted) for _, o in out_t] == \
        [bool(o.kf_inserted) for _, o in out_j]
    for (_, a), (_, b) in zip(out_j, out_t):
        np.testing.assert_allclose(b.pose, np.asarray(a.pose), atol=2e-3)
    assert sorted(kf_t) == sorted(kf_j)
