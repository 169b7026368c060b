"""Checkpoint and resume (`slam/checkpoint.py`, `state_dict` on the
streaming pipelines): the port's own save -> load -> continue is bit-equal
on the CPU to the uninterrupted run, for the classic pipeline and for both
streaming ones; a checkpoint the reference writes after 6 frames resumes in
the port, whose next 3 frames hold to the reference's own continuation by
the pipeline bar (the same keyframe frame ids, poses within 1e-3); a
checkpoint of another pipeline class or format version is refused.
"""

import json

import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.slam import checkpoint as jck
from stereovision_slam_tpu.slam.backend import Backend as JBackend
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_tpu.slam.pipeline import VisualOdometry as JVO
from stereovision_slam_torch import convert
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.slam import checkpoint as ck
from stereovision_slam_torch.slam.backend import Backend
from stereovision_slam_torch.slam.fused import FusedVisualOdometry
from stereovision_slam_torch.slam.fused_loop import FusedLoopVisualOdometry
from stereovision_slam_torch.slam.loop_closure import LoopClosure
from stereovision_slam_torch.slam.pipeline import VisualOdometry
from stereovision_slam_torch.utils.exceptions import CheckpointError
from tests.test_checkpoint import make_dataset
from tests.test_pipeline_frontend import small_config

torch.set_num_threads(1)

SPLIT, MORE = 6, 3
POSE_TOL = 1e-3


@pytest.fixture(scope="module")
def data():
    lefts, rights, rig = make_dataset()
    return lefts, rights, rig


def _dataset(data, frames=None):
    lefts, rights, rig = data
    n = len(lefts) if frames is None else frames
    return ArraySequenceDataset(lefts[:n], rights[:n],
                                [convert.camera(c) for c in rig])


def _classic(data, frames=None):
    cfg = convert.slam_config(small_config())
    vo = VisualOdometry(cfg, _dataset(data, frames), backend=Backend(),
                        device="cpu")
    vo.initialize()
    # the loop closure joins, so its database is part of the state
    vo.loop_closure = LoopClosure(cfg, vo.cam_left, embedder="thumbnail")
    return vo


def _fused(data, loop: bool, frames=None):
    cfg = convert.slam_config(small_config())
    kw = dict(max_total_keyframes=64, max_total_landmarks=4096, device="cpu")
    vo = (FusedLoopVisualOdometry(cfg, _dataset(data, frames), **kw) if loop
          else FusedVisualOdometry(cfg, _dataset(data, frames), **kw))
    vo.initialize()
    return vo


def _state(vo) -> dict:
    """Everything the run leaves behind, as numpy."""
    if isinstance(vo, VisualOdometry):
        vo.finish()
        out = {f"kf{k}": r.pose for k, r in vo.archived_keyframes.items()}
        out.update({f"lm{k}": v for k, v in vo.archived_landmarks.items()})
        out["inliers"] = np.asarray(vo.inlier_history)
        out["db"] = np.asarray(sorted(vo.loop_closure.db))
        return out
    keyframes, landmarks, frames = vo.drain()
    out = {f"kf{k}": p for k, (_, p) in keyframes.items()}
    out.update({f"lm{k}": v for k, v in landmarks.items()})
    out["poses"] = np.stack([f.pose for _, f in frames])
    out["inliers"] = np.asarray([f.n_inliers for _, f in frames])
    if hasattr(vo, "ls"):
        out.update({f"ls.{k}": v.numpy() for k, v in vo.ls._asdict().items()})
    return out


@pytest.mark.parametrize("kind", ["classic", "fused", "fused_loop"])
def test_resume_is_bit_equal(data, tmp_path, kind):
    def make():
        return (_classic(data) if kind == "classic"
                else _fused(data, loop=kind == "fused_loop"))
    save, load = ((ck.save_checkpoint, ck.load_checkpoint) if kind == "classic"
                  else (ck.save_fused_checkpoint, ck.load_fused_checkpoint))
    full = make()
    while full.step():
        pass
    a = make()
    for _ in range(7):
        a.step()
    path = str(tmp_path / "state.npz")
    save(a, path)
    b = make()
    load(b, path)
    assert b.dataset.current_index == 7
    while b.step():
        pass
    sf, sb = _state(full), _state(b)
    assert sorted(sf) == sorted(sb)
    for k in sf:
        assert np.array_equal(sf[k], sb[k]), k


def _hold(ref_traj: dict, port_traj: dict):
    assert sorted(port_traj) == sorted(ref_traj)
    for f in ref_traj:
        np.testing.assert_allclose(port_traj[f], np.asarray(ref_traj[f]),
                                   atol=POSE_TOL, err_msg=f"frame {f}")


def test_reference_classic_checkpoint_resumes_in_the_port(data, tmp_path):
    lefts, rights, rig = data
    n = SPLIT + MORE
    ref = JVO(small_config(), JDataset(lefts[:n], rights[:n], list(rig)),
              backend=JBackend())
    ref.initialize()
    for _ in range(SPLIT):
        ref.step()
    path = str(tmp_path / "ref.npz")
    jck.save_checkpoint(ref, path)
    while ref.step():
        pass
    port = _classic(data, frames=n)
    port.loop_closure = None
    ck.load_checkpoint(port, path)
    assert port.dataset.current_index == SPLIT
    while port.step():
        pass
    assert port.status.name == ref.status.name
    assert port.kf_count == ref.kf_count
    _hold(ref.trajectory(), port.trajectory())


def test_reference_fused_checkpoint_resumes_in_the_port(data, tmp_path):
    lefts, rights, rig = data
    n = SPLIT + MORE
    ref = JFused(small_config(), JDataset(lefts[:n], rights[:n], list(rig)),
                 max_total_keyframes=64, max_total_landmarks=4096,
                 max_frames=64)
    ref.initialize()
    for _ in range(SPLIT):
        ref.step()
    path = str(tmp_path / "ref.npz")
    jck.save_fused_checkpoint(ref, path)
    ref.run()
    port = _fused(data, loop=False, frames=n)
    ck.load_fused_checkpoint(port, path)
    assert len(port.outputs) == SPLIT
    port.run()
    kf_r, _, out_r = ref.drain()
    kf_p, _, out_p = port.drain()
    assert [bool(f.kf_inserted) for _, f in out_p] == \
        [bool(f.kf_inserted) for _, f in out_r]
    assert [fid for fid, _ in out_p] == list(range(n))
    _hold({f: p for f, p in kf_r.values()}, {f: p for f, p in kf_p.values()})


def test_refuses_another_class_or_version(data, tmp_path):
    vo = _fused(data, loop=False, frames=3)
    vo.run()
    path = str(tmp_path / "f.npz")
    ck.save_fused_checkpoint(vo, path)
    with pytest.raises(CheckpointError, match="FusedVisualOdometry"):
        ck.load_fused_checkpoint(_fused(data, loop=True, frames=3), path)
    arrays, meta = vo.state_dict()
    arrays["meta_json"] = np.frombuffer(
        json.dumps(dict(meta, version=99)).encode(), dtype=np.uint8)
    path = str(tmp_path / "v.npz")
    np.savez(path, **arrays)
    with pytest.raises(CheckpointError, match="version"):
        ck.load_fused_checkpoint(_fused(data, loop=False, frames=3), path)
