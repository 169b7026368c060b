"""The classic visual-odometry pipeline (counterpart of `slam/pipeline.py`).

`VisualOdometry` wires the dataset, frontend, backend, loop closure and
viewer from a config, drives the frame loop and saves the outputs. The
C++ system's backend and loop-closure threads become a deterministic
schedule: BA runs after every keyframe insertion, and the loop closure
processes the keyframe right after it.

The host keeps the status machine (one device->host read of the inlier
count per frame, as in the reference), the archives of evicted keyframes
and landmarks, and the output files; the numerics are the frontend's and
backend's tensor programs on the pipeline's device, tracking through
kernels A and B (`frontend.track_step`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.ops import descriptors, gftt, prng
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.ops.pose_kernel import camera_block
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam import outputs as out_mod
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.loop_closure import (
    NUM_HYPOTHESES, _match_and_count, _rel, keyframe_snapshot)
from stereovision_slam_torch.slam.pnp import pnp_ransac

@dataclass
class KeyframeRecord:
    frame_id: int
    kf_id: int
    pose: np.ndarray                   # (3, 4) Tcw, refreshed on archive
    rel_to_prev: np.ndarray | None = None  # (3, 4), for pose-graph edges


class VisualOdometry:
    """Drives the full SLAM pipeline over a dataset on `device`."""

    def __init__(self, config: SlamConfig, dataset, viewer=None, backend=None,
                 loop_closure=None, device: str | torch.device = "cuda"):
        self.cfg = config
        self.dataset = dataset
        self.viewer = viewer
        self.backend = backend
        self.loop_closure = loop_closure
        self.device = resolve_device(device)

        self.status = fe.FrontendStatus.INITING
        self.fs: fe.FrontendState | None = None
        self.ms: mapmod.MapState | None = None
        self.kf_count = 0
        self.frame_count = 0
        # host archives (the C++ system's all_keyframes / all_landmarks)
        self.archived_keyframes: dict[int, KeyframeRecord] = {}
        self.archived_landmarks: dict[int, np.ndarray] = {}
        self.archived_landmark_first_kf: dict[int, int] = {}
        self.frame_times: list[float] = []
        self.inlier_history: list[int] = []
        self._reloc = None
        self._right = (None, None)     # (frame_id, right pyramid)

    # ------------------------------------------------------------------ #

    def initialize(self) -> None:
        cfg = self.cfg
        self.dataset.initialize()
        dev = self.device
        self.cam_left = self.dataset.get_camera(
            self.dataset.left_cam_index).to(dev)
        self.cam_right = self.dataset.get_camera(
            self.dataset.right_cam_index).to(dev)
        self.camp = camera_block(self.cam_left, self.cam_right)
        self.ms = self._empty_map()

    def _empty_map(self) -> mapmod.MapState:
        cfg = self.cfg
        return mapmod.empty_map(cfg.max_keyframes_window, cfg.max_features,
                                cfg.max_landmarks, device=self.device)

    def step(self) -> bool:
        """Process one frame; returns False at the end of the sequence."""
        frame = self.dataset.next_frame()
        if frame is None:
            return False
        t0 = time.perf_counter()
        self._add_frame(frame)
        self.frame_times.append(time.perf_counter() - t0)
        if self.viewer is not None:
            self.viewer.add_current_frame(frame, self)
        return True

    def run(self) -> None:
        """The whole sequence, then the shutdown."""
        while self.step():
            pass
        self.finish()

    # ------------------------------------------------------------------ #

    def _pyramid(self, img) -> tuple:
        t = torch.as_tensor(np.asarray(img, np.float32)).to(self.device)
        return tuple(imops.build_pyramid(t, self.cfg.lk_num_levels))

    def _right_pyramid(self, frame) -> tuple:
        """The frame's right pyramid, built once a frame (tracking and the
        keyframe insertion both read it)."""
        if self._right[0] != frame.frame_id:
            self._right = (frame.frame_id, self._pyramid(frame.right))
        return self._right[1]

    def _keyframe_kw(self) -> dict:
        cfg = self.cfg
        return dict(num_features=cfg.num_features,
                    min_distance=cfg.gftt_min_distance,
                    quality_level=cfg.gftt_quality_level,
                    max_depth=cfg.max_triangulation_depth,
                    num_active=cfg.num_active_keyframes,
                    detector=cfg.keypoint_feature_detector.lower())

    def _add_frame(self, frame) -> None:
        cfg = self.cfg
        pyr = self._pyramid(frame.left)

        if self.status == fe.FrontendStatus.INITING:
            self._stereo_init(frame, pyr)
            return

        if cfg.frontend_stereo_pose:
            right_pyr, cam_r = self._right_pyramid(frame), self.cam_right
        else:  # the C++ system's mono left-camera pose solve
            right_pyr, cam_r = None, None
        self.fs, n_in, _ = fe.track_step(
            self.fs, self.ms, pyr, self.cam_left, right_pyr, cam_r,
            chi2_th=cfg.chi2_th, rounds=cfg.pose_rounds,
            iters=cfg.pose_iters_per_round,
            anchored=bool(cfg.frontend_anchored_lk),
            multi_start=bool(cfg.frontend_multi_start), camp=self.camp)
        num_inliers = int(n_in)
        self.inlier_history.append(num_inliers)

        # the status machine
        if num_inliers > cfg.num_features_tracking:
            self.status = fe.FrontendStatus.TRACKING_GOOD
        elif num_inliers > cfg.num_features_tracking_bad:
            self.status = fe.FrontendStatus.TRACKING_BAD
        else:
            self.status = fe.FrontendStatus.LOST

        if (num_inliers < cfg.num_features_needed_for_keyframe
                and self.status != fe.FrontendStatus.LOST):
            self._insert_keyframe(frame)
        elif self.status == fe.FrontendStatus.LOST:
            # relocalization: descriptor matching and PnP against the last
            # keyframe's landmarks; on success re-anchor and rebuild the
            # features as a keyframe
            if self._relocalize(frame):
                self._insert_keyframe(frame)
                self.status = fe.FrontendStatus.TRACKING_BAD

        self.frame_count = frame.frame_id + 1

    def _stereo_init(self, frame, pyr) -> None:
        cfg = self.cfg
        self.fs = fe.init_state(cfg.max_features, pyr)
        fs, ms, _, n_new, _ = fe.keyframe_step(
            self.fs, self.ms, self._right_pyramid(frame), self.cam_left,
            self.cam_right, frame.frame_id, self.kf_count, detect_all=True,
            **self._keyframe_kw())
        n_new = int(n_new)
        if n_new >= cfg.num_features_init:
            self.fs, self.ms = fs, ms
            self._register_keyframe(frame.frame_id)
            self.status = fe.FrontendStatus.TRACKING_GOOD
            self._notify_backend()
            self._snapshot_for_reloc()
            if self.viewer is not None:
                self.viewer.log_info_mkf(
                    f"Frontend: stereo map initialized with {n_new} "
                    "landmarks", self.kf_count, "frontend")
                self.viewer.update_map(self, frame)
        else:
            # stay INITING and retry on the next frame with a fresh map,
            # dropping the failed attempt's keyframe and landmarks
            self.ms = self._empty_map()

    def _insert_keyframe(self, frame) -> None:
        self.kf_count += 1
        self.fs, self.ms, ev, _, _ = fe.keyframe_step(
            self.fs, self.ms, self._right_pyramid(frame), self.cam_left,
            self.cam_right, frame.frame_id, self.kf_count, detect_all=False,
            **self._keyframe_kw())
        self._register_keyframe(frame.frame_id)
        self._archive_eviction(ev)
        self._notify_backend()
        self._snapshot_for_reloc()
        if self.loop_closure is not None:
            self.loop_closure.add_keyframe(self, frame)
        if self.viewer is not None:
            self.viewer.log_info_mkf(
                f"Backend: optimized active window after keyframe "
                f"{self.kf_count}" if self.backend is not None else
                f"Frontend: inserted keyframe {self.kf_count}",
                self.kf_count,
                "backend" if self.backend is not None else "frontend")
            self.viewer.update_map(self, frame)

    # ------------------------------------------------------------------ #

    def _snapshot_for_reloc(self) -> None:
        """Keep the new keyframe's descriptors and landmark snapshot, for
        a later LOST frame to relocalize against (and for the loop closure
        to reuse on the same keyframe)."""
        self._reloc = dict(keyframe_snapshot(self.fs.pyr[0], self.fs,
                                             self.ms), kf_id=self.kf_count)

    def _relocalize(self, frame) -> bool:
        """PnP against the last keyframe's landmarks through descriptor
        matching. Returns True when a confident pose was recovered (and
        set)."""
        if self._reloc is None:
            return False
        cfg = self.cfg
        left = self.fs.pyr[0]  # the current frame (track_step already ran)
        pts, valid, _ = gftt.detect(left, max_corners=cfg.max_features,
                                    quality_level=cfg.gftt_quality_level,
                                    min_distance=cfg.gftt_min_distance)
        desc, ok = descriptors.compute(left, pts, valid)
        r = self._reloc
        idx, usable, n_match = _match_and_count(
            r["desc"], r["ok"], desc, ok, r["lm_has"])
        if int(n_match) < 10:
            return False
        uniform = prng.uniform(frame.frame_id,
                               (NUM_HYPOTHESES, r["lm_pos"].shape[0]), 1e-9,
                               1.0, device=self.device)
        T_new, _, n_in = pnp_ransac(self.cam_left, r["lm_pos"], pts[idx],
                                    usable, uniform, reproj_threshold=5.991)
        if int(n_in) < 10:
            return False
        self.fs = self.fs._replace(
            T_cur=T_new,
            T_rel=se3.se3_identity(T_new.dtype, T_new.device),
            feat_valid=torch.zeros_like(self.fs.feat_valid),
            feat_lm=torch.full_like(self.fs.feat_lm, -1))
        if self.viewer is not None:
            self.viewer.log_info("Frontend: relocalized after tracking loss",
                                 "frontend")
        return True

    def _register_keyframe(self, frame_id: int) -> None:
        pose = self.fs.T_cur.cpu().numpy().copy()
        prev = self.archived_keyframes.get(self.kf_count - 1)
        self.archived_keyframes[self.kf_count] = KeyframeRecord(
            frame_id=frame_id, kf_id=self.kf_count, pose=pose,
            rel_to_prev=None if prev is None else _rel(pose, prev.pose))

    def _archive_eviction(self, ev: mapmod.EvictedKeyframe) -> None:
        if not bool(ev.happened):
            return
        kf_id = int(ev.kf_id)
        if kf_id in self.archived_keyframes:
            self.archived_keyframes[kf_id].pose = ev.pose.cpu().numpy().copy()
        mask = ev.lm_archived.cpu().numpy()
        if mask.any():
            ids = ev.lm_id.cpu().numpy()[mask]
            pos = ev.lm_pos.cpu().numpy()[mask]     # a copy (masked)
            firsts = ev.lm_first_kf.cpu().numpy()[mask]
            for i, p, fk in zip(ids, pos, firsts):
                self.archived_landmarks[int(i)] = p
                self.archived_landmark_first_kf[int(i)] = int(fk)

    def _notify_backend(self) -> None:
        if self.backend is not None:
            self.ms = self.backend.optimize(self.ms, self.cam_left,
                                            self.cam_right)
            # the frontend pose from the newest (BA-refined) keyframe
            newest = torch.argmax(torch.where(
                self.ms.kf_valid, self.ms.kf_id,
                torch.full_like(self.ms.kf_id, -1)))
            self.fs = self.fs._replace(T_cur=self.ms.kf_pose[newest])
            self._refresh_relative_poses()

    def _window(self):
        """The window's keyframe slots, ids and poses on the host (the
        poses copied: the archives keep them)."""
        ms = self.ms
        return (np.nonzero(ms.kf_valid.cpu().numpy())[0],
                ms.kf_id.cpu().numpy(), ms.kf_pose.cpu().numpy().copy())

    def _refresh_relative_poses(self) -> None:
        """Refresh the archive poses and consecutive relative poses of the
        active window after BA (the C++ system's relative_pose_pkf_)."""
        slots, ids, poses = self._window()
        for s in slots:
            rec = self.archived_keyframes.get(int(ids[s]))
            if rec is None:
                continue
            rec.pose = poses[s]
            prev = self.archived_keyframes.get(int(ids[s]) - 1)
            if prev is not None:
                rec.rel_to_prev = _rel(poses[s], prev.pose)

    # ------------------------------------------------------------------ #

    def _sync_active_to_archive(self) -> None:
        """Fold the live window into the host archives."""
        ms = self.ms
        slots, ids, poses = self._window()
        frame_ids = ms.kf_frame_id.cpu().numpy()
        for s in slots:
            kf_id = int(ids[s])
            rec = self.archived_keyframes.get(kf_id)
            if rec is None:
                self.archived_keyframes[kf_id] = KeyframeRecord(
                    frame_id=int(frame_ids[s]), kf_id=kf_id, pose=poses[s])
            else:
                rec.pose = poses[s]
        lm_ids, pos, firsts = (t.cpu().numpy().copy() for t in (
            ms.lm_id, ms.lm_pos, ms.lm_first_kf))
        for s in np.nonzero(ms.lm_valid.cpu().numpy())[0]:
            self.archived_landmarks[int(lm_ids[s])] = pos[s]
            self.archived_landmark_first_kf[int(lm_ids[s])] = int(firsts[s])

    def finish(self) -> None:
        """Shutdown: the loop closure's global PGO, then the window folded
        into the archives."""
        if self.loop_closure is not None:
            self.loop_closure.stop(self)
        self._sync_active_to_archive()
        if self.viewer is not None:
            self.viewer.close()

    def save_output(self, timestamped_subdir: bool = True) -> str:
        self._sync_active_to_archive()
        keyframes = [(rec.frame_id, rec.pose)
                     for rec in self.archived_keyframes.values()]
        landmarks = (np.stack(list(self.archived_landmarks.values()))
                     if self.archived_landmarks else np.zeros((0, 3)))
        return out_mod.save_slam_output(
            self.cfg.output_dir, getattr(self.dataset, "dataset_dir", ""),
            self.dataset.left_cam_index, keyframes, landmarks,
            timestamped_subdir=timestamped_subdir)

    # ------------------------------------------------------------------ #

    def trajectory(self) -> dict[int, np.ndarray]:
        """frame_id -> (3, 4) Tcw for every keyframe (latest estimates)."""
        self._sync_active_to_archive()
        return {rec.frame_id: rec.pose
                for rec in self.archived_keyframes.values()}

    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / sum(self.frame_times)
