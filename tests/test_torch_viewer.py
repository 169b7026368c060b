"""Port parity, the viewer's JSONL sink (`viz/viewer.py`): the same log
calls on the same map (numpy for the reference, tensors for the port) give
the same transcript, the time stamps aside; and the classic pipeline on a
short sequence logs the reference's entity tree (tests/test_viewer.py).
"""

import json
import types

import numpy as np
import pytest
import torch

from stereovision_slam_tpu.slam import map_state as jmap
from stereovision_slam_tpu.viz import viewer as jviewer
from stereovision_slam_torch import convert
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.io.dataset import StereoFrame
from stereovision_slam_torch.slam.backend import Backend
from stereovision_slam_torch.slam.pipeline import KeyframeRecord
from stereovision_slam_torch.slam.pipeline import VisualOdometry
from stereovision_slam_torch.viz import viewer as tviewer
from tests import synthetic
from tests.test_pipeline_frontend import small_config

torch.set_num_threads(1)


def _fake_vo(ms, cam, cfg, kf_poses):
    return types.SimpleNamespace(
        ms=ms, cam_left=cam, cfg=cfg, kf_count=3, inlier_history=[40, 37],
        archived_keyframes={k: KeyframeRecord(frame_id=5 * k, kf_id=k,
                                              pose=p)
                            for k, p in enumerate(kf_poses)})


def _calls(viewer, vo, frame):
    viewer.add_current_frame(frame, vo)
    viewer.update_map(vo, frame)
    viewer.update_map(vo)
    viewer.log_info("Frontend: relocalized after tracking loss", "frontend")
    viewer.log_info_mkf("Backend: optimized active window after keyframe 3",
                        3, "backend")
    viewer.plot("plots/loop_deep_score", 0.71, 3)
    viewer.close()


def _transcript(path):
    with open(path) as f:
        events = [json.loads(line) for line in f]
    for e in events:
        e.pop("ts")
    return events


def test_transcript_equals_reference(tmp_path):
    if jviewer._HAS_RERUN or tviewer._HAS_RERUN:
        pytest.skip("rerun installed; the JSONL sink is not active")
    rng = np.random.default_rng(4)
    K, F, L = 6, 16, 64
    ms = jmap.empty_map(K, F, L)
    ms = jmap.MapState(*(np.array(v) for v in ms))
    kf_poses = [np.concatenate([np.eye(3), rng.normal(size=(3, 1))],
                               1).astype(np.float32) for _ in range(4)]
    ms = ms._replace(
        kf_valid=np.array([1, 1, 0, 1, 1, 0], bool),
        kf_id=np.array([0, 1, -1, 2, 3, -1], np.int32),
        kf_pose=np.stack(kf_poses[:2] + [np.zeros((3, 4), np.float32)]
                         + kf_poses[2:] + [np.zeros((3, 4), np.float32)]),
        lm_valid=rng.uniform(size=L) > 0.4,
        lm_pos=rng.normal(size=(L, 3)).astype(np.float32))
    rig = synthetic.make_stereo_rig()
    cfg = small_config()
    frame = StereoFrame(frame_id=15, left=rng.uniform(0, 255, (30, 50)).astype(
        np.float32), right=None)
    paths = []
    for name, mod, state, cam in (
            ("ref", jviewer, ms, rig[0]),
            ("port", tviewer, convert.map_state(ms), convert.camera(rig[0]))):
        path = str(tmp_path / f"{name}.jsonl")
        _calls(mod.Viewer(jsonl_path=path), _fake_vo(state, cam, cfg,
                                                     kf_poses), frame)
        paths.append(path)
    ref, port = (_transcript(p) for p in paths)
    assert len(ref) > 8
    assert port == ref


def test_pipeline_logs_the_entity_tree(tmp_path):
    if tviewer._HAS_RERUN:
        pytest.skip("rerun installed; the JSONL sink is not active")
    path = tmp_path / "viz.jsonl"
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(6, step=0.4, yaw_rate=0.0)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=96, W=320, rig=rig)
    cfg = small_config()
    cfg.num_features_needed_for_keyframe = cfg.num_features + 1
    viewer = tviewer.Viewer(jsonl_path=str(path))
    vo = VisualOdometry(cfg, ArraySequenceDataset(
        np.asarray(lefts), np.asarray(rights),
        [convert.camera(c) for c in rig]), viewer=viewer, backend=Backend(),
        device="cpu")
    vo.initialize()
    vo.run()
    events = _transcript(path)
    pin = [e for e in events if e.get("archetype") == "Pinhole"]
    assert {"world/stereosys0/cam_left", "world/stereosys1/cam_left"} <= {
        e["entity"] for e in pin}
    assert pin[0]["resolution"] == [320, 96]
    imgs = [e for e in events if e.get("archetype") == "Image"]
    assert imgs and imgs[0]["shape"] == [96, 320]
    lm = [e for e in events if e.get("archetype") == "Points3D"]
    assert lm[-1]["count"] > 20
    mkf = [e["max_keyframe_id"] for e in events if e["event"] == "log_mkf"]
    assert mkf == sorted(mkf) and len(mkf) >= 2
    plots = [e for e in events if e["event"] == "plot"]
    assert plots and plots[0]["name"] == "plots/frontend_inlier_ratio"
