"""Port parity, the init and LOST re-init branches of the fused step.

A blank first frame fails stereo initialization (the map reverts and the
next frame retries); a burst of blank frames mid-sequence drops tracking to
LOST, each blank frame fails the re-initialization gate (the map reverts,
no keyframe id is spent), and the first good frame re-initializes a
keyframe into the existing map. Both packages run the same frames and must
take the same branches on the same frames: the keyframe count after every
frame is equal.
"""

import numpy as np
import pytest

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert, scenes
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.slam.fused import FusedVisualOdometry
from tests import synthetic
from tests.test_pipeline_frontend import small_config

BLANK = (0, 12, 13, 14)


@pytest.fixture(scope="module")
def outage():
    poses = scenes.forward_motion_poses(24, step=0.35, yaw_rate=0.02)
    lefts, rights = scenes.render_arena_stereo_sequence(
        poses, H=120, W=320,
        rig=scenes.make_stereo_rig(fx=180.0, fy=180.0, cx=160.0, cy=60.0),
        center=(0.0, 6.0), radius=25.0)
    lefts, rights = lefts.numpy().copy(), rights.numpy().copy()
    for i in BLANK:
        lefts[i] = 0.0
        rights[i] = 0.0
    return lefts, rights, poses.numpy()


def test_init_and_lost_branches_match_reference(outage):
    lefts, rights, poses = outage
    cfg = small_config()
    rig = synthetic.make_stereo_rig(fx=180.0, fy=180.0, cx=160.0, cy=60.0)
    ref = JFused(cfg, JDataset(lefts, rights, list(rig)))
    ref.initialize()
    ref.run()
    kf_j, _, out_j = ref.drain()
    port = FusedVisualOdometry(
        convert.slam_config(cfg),
        ArraySequenceDataset(lefts, rights, [convert.camera(c) for c in rig]),
        device="cpu")
    port.initialize()
    port.run()
    kf_t, _, out_t = port.drain()

    counts_t = [int(o.kf_count) for _, o in out_t]
    assert counts_t == [int(o.kf_count) for _, o in out_j]
    assert counts_t[0] == -1 and counts_t[1] == 0      # init failed, retried
    n_in = [int(o.n_inliers) for _, o in out_t]
    for i in BLANK[1:]:
        assert n_in[i] <= cfg.num_features_tracking_bad
        assert counts_t[i] == counts_t[BLANK[1] - 1]     # no id spent
    # the first good frame after the burst re-initializes a keyframe
    assert counts_t[BLANK[-1] + 1] == counts_t[BLANK[-1]] + 1
    assert min(n_in[BLANK[-1] + 2:]) > cfg.num_features_needed_for_keyframe // 2
    assert sorted(f for f, _ in kf_t.values()) == \
        sorted(f for f, _ in kf_j.values())
    assert not any(f in BLANK for f, _ in kf_t.values())
