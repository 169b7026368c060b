"""Rerun-based visualization with a JSONL fallback (the port's own copy of
`viz/viewer.py`; tensors are read to the host at keyframe rate).

Equivalent of the C++ system's `Viewer` (viewer.cpp): spawns
the Rerun viewer process (:22), sets up world axes + two scalar plots
(:24-42), renders the active keyframes as pinhole frusta relative to the
newest one, the newest keyframe's left image, the active landmark cloud and
the full trajectory (:56-145), and writes component-colored text logs on the
`currentframe_id` and `max_keyframe_id` timelines (:147-190). Entity paths
(`world/stereosys{i}/cam_left`, `world/landmarks`, `world/path`,
`world/log`), timeline names and plot names match the reference so
recordings look the same.

The rerun Python SDK is optional: without it, every log call is appended to
a JSONL file (one object per event, carrying the same entity path and
archetype name) so pipelines remain observable and testable headless — the
tests assert the entity tree on this transcript.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

try:
    import rerun as rr
    _HAS_RERUN = True
except ImportError:  # pragma: no cover - environment-dependent
    rr = None
    _HAS_RERUN = False

# component log colors (viewer.h:60-64)
_COLORS = {
    "frontend": (255, 215, 0),
    "backend": (0, 255, 255),
    "loopclosure": (255, 0, 255),
    "vo": (255, 255, 255),
}


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _center_R(pose: np.ndarray):
    """(3,4) T_c_w -> (camera center in world, R_w_c)."""
    R, t = pose[:, :3], pose[:, 3]
    return -R.T @ t, R.T


class Viewer:
    """Host-side observer fed by the pipelines at frame/keyframe rate.

    Exactly one of two sinks is active: the rerun SDK (spawns the viewer
    process like viewer.cpp:22) or the JSONL transcript.
    """

    def __init__(self, app_id: str = "stereovision_slam_torch",
                 spawn: bool = True, jsonl_path: str | None = None):
        self.enabled = _HAS_RERUN
        self.jsonl_path = jsonl_path
        self._jsonl = None
        self._cur_frame_id = 0
        if self.enabled:
            rr.init(app_id, spawn=spawn)
            # world axes + plot styling (viewer.cpp:24-42)
            rr.log("world", rr.ViewCoordinates.RIGHT_HAND_Y_DOWN, static=True)
            for name in ("plots/frontend_inlier_ratio", "plots/loop_deep_score"):
                rr.log(name, rr.SeriesLine(), static=True)
        elif jsonl_path:
            self._jsonl = open(jsonl_path, "a")

    # ------------------------------------------------------------------ #

    def _emit(self, obj: dict) -> None:
        if self._jsonl is not None:
            obj["ts"] = time.time()
            self._jsonl.write(json.dumps(obj) + "\n")
            self._jsonl.flush()

    def add_current_frame(self, frame, vo) -> None:
        """Per-frame hook from the pipeline (Viewer::AddCurrentFrame)."""
        self._cur_frame_id = frame.frame_id
        if self.enabled:
            rr.set_time_sequence("currentframe_id", frame.frame_id)
        if vo.inlier_history:
            self.plot("plots/frontend_inlier_ratio",
                      vo.inlier_history[-1] / max(vo.cfg.num_features, 1),
                      vo.kf_count)

    def update_map(self, vo, frame=None) -> None:
        """Keyframe-rate map rendering (viewer.cpp:56-145).

        `frame` is the newest keyframe's frame (carrying the left image);
        when given, the image is logged onto the newest frustum entity
        (viewer.cpp:110-111).
        """
        ms = vo.ms
        if ms is None:
            return
        kf_valid = _np(ms.kf_valid)
        kf_ids = _np(ms.kf_id)
        kf_poses = _np(ms.kf_pose)
        lm_valid = _np(ms.lm_valid)
        lms = _np(ms.lm_pos)[lm_valid]

        # active keyframes ordered newest-first (viewer.cpp:68-71)
        order = sorted(np.nonzero(kf_valid)[0],
                       key=lambda s: -int(kf_ids[s]))
        if not order:
            return
        newest = order[0]
        mkf_id = int(kf_ids[newest])
        c0, R0 = _center_R(kf_poses[newest])

        cam = getattr(vo, "cam_left", None)
        fx = float(_np(cam.fx)) if cam is not None else 0.0
        fy = float(_np(cam.fy)) if cam is not None else 0.0
        if frame is not None:
            img = np.asarray(frame.left)
            res = (img.shape[1], img.shape[0])
        else:
            img = None
            res = (vo.cfg.image_width, vo.cfg.image_height)

        # full trajectory, by keyframe id (world/path, viewer.cpp:135-145)
        traj = sorted(((r.frame_id, r.pose)
                       for r in vo.archived_keyframes.values()))
        centers = [(_center_R(pose)[0]).tolist() for _, pose in traj]

        if self.enabled:
            rr.set_time_sequence("max_keyframe_id", mkf_id)
            for i, slot in enumerate(order):
                entity = f"world/stereosys{i}/cam_left"
                if i > 0:
                    # pose of keyframe i relative to the newest keyframe
                    # (T_ci_c0, viewer.cpp:83-96): most recent frustum stays
                    # at the origin, the rest are drawn around it
                    ci, Ri = _center_R(kf_poses[slot])
                    rel_R = Ri.T @ R0
                    rel_t = Ri.T @ (c0 - ci)
                    rr.log(entity, rr.Transform3D(
                        translation=rel_t, mat3x3=rel_R, from_parent=True))
                rr.log(entity, rr.Pinhole(
                    focal_length=[fx, fy], resolution=list(res)))
                if i == 0 and img is not None:
                    rr.log(entity,
                           rr.Image(np.clip(img, 0, 255).astype(np.uint8)))
            for entity in ("world/landmarks", "world/path"):
                rr.log(entity, rr.Transform3D(
                    translation=c0, mat3x3=R0, from_parent=True))
            rr.log("world/landmarks", rr.Points3D(lms))
            if centers:
                rr.log("world/path", rr.LineStrips3D([centers]))
        else:
            for i, slot in enumerate(order):
                entity = f"world/stereosys{i}/cam_left"
                self._emit({"event": "log_entity", "entity": entity,
                            "archetype": "Pinhole",
                            "focal_length": [fx, fy], "resolution": list(res),
                            "kf_id": int(kf_ids[slot]),
                            "max_keyframe_id": mkf_id})
                if i == 0 and img is not None:
                    self._emit({"event": "log_entity", "entity": entity,
                                "archetype": "Image",
                                "shape": list(img.shape),
                                "max_keyframe_id": mkf_id})
            self._emit({"event": "log_entity", "entity": "world/landmarks",
                        "archetype": "Points3D", "count": int(lm_valid.sum()),
                        "max_keyframe_id": mkf_id})
            self._emit({"event": "log_entity", "entity": "world/path",
                        "archetype": "LineStrips3D", "length": len(centers),
                        "max_keyframe_id": mkf_id})

    def log_info(self, msg: str, component: str = "vo") -> None:
        """Component-colored text log on the current-frame timeline
        (Viewer::LogInfo, viewer.cpp:149-161)."""
        if self.enabled:
            rr.set_time_sequence("currentframe_id", self._cur_frame_id)
            rr.log("world/log",
                   rr.TextLog(msg, color=_COLORS.get(component)))
        else:
            self._emit({"event": "log", "entity": "world/log",
                        "component": component, "msg": msg,
                        "currentframe_id": self._cur_frame_id})

    def log_info_mkf(self, msg: str, mkf_id: int,
                     component: str = "vo") -> None:
        """Text log stamped on BOTH timelines (Viewer::LogInfoMKF,
        viewer.cpp:163-177) — used for keyframe-rate events (insertions,
        BA passes, loop closures)."""
        if self.enabled:
            rr.set_time_sequence("currentframe_id", self._cur_frame_id)
            rr.set_time_sequence("max_keyframe_id", int(mkf_id))
            rr.log("world/log",
                   rr.TextLog(msg, color=_COLORS.get(component)))
        else:
            self._emit({"event": "log_mkf", "entity": "world/log",
                        "component": component, "msg": msg,
                        "currentframe_id": self._cur_frame_id,
                        "max_keyframe_id": int(mkf_id)})

    def plot(self, name: str, value: float, mkf_id: int) -> None:
        """Scalar sample stamped on both timelines (Viewer::Plot,
        viewer.cpp:179-190)."""
        if self.enabled:
            rr.set_time_sequence("currentframe_id", self._cur_frame_id)
            rr.set_time_sequence("max_keyframe_id", int(mkf_id))
            rr.log(name, rr.Scalar(float(value)))
        else:
            self._emit({"event": "plot", "name": name, "value": float(value),
                        "currentframe_id": self._cur_frame_id,
                        "max_keyframe_id": int(mkf_id)})

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
