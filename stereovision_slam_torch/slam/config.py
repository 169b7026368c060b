"""SLAM configuration (the port's own copy of `slam/config.py`).

A plain dataclass whose key names match the reference's default.yaml, so the
per-sequence YAML files drop in unchanged; the OpenCV "%YAML:1.0" directive
line is tolerated. Static capacities (feature slots, window sizes, landmark
table size) size every fixed-shape tensor of the port.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import yaml

from stereovision_slam_torch.utils.exceptions import ConfigError


# The PlaceNet loop-closure operating point, one gate set for every scene
# (the reference's `PLACENET_LOOP_GATES`): true revisits score 0.94-1.00
# against <= 0.61 for false argmax candidates (strong 0.65); a self-similar
# corridor pushes 32-64 entries above 0.5 (max_weak 12); skip 24 excludes
# trivially overlapping recent views.
PLACENET_LOOP_GATES = dict(
    potential_loop_strong_threshold=0.65,
    potential_loop_weak_threshold=0.50,
    max_num_weak_threshold=12,
    keyframes_to_skip_in_candidate_search=24,
    keyframes_to_ignore_after_loop=5,
    min_num_acceptable_keypoint_match=10,
)


@dataclass
class SlamConfig:
    # --- dataset ---
    dataset_dir: str = ""
    left_cam_index: int = 0
    right_cam_index: int = 1
    is_color_input: int = 0
    output_dir: str = "./outputs/SLAM-outputs"

    # --- frontend ---
    num_features: int = 150
    num_features_init: int = 50
    num_features_tracking: int = 50
    num_features_tracking_bad: int = 20
    num_features_needed_for_keyframe: int = 80
    max_triangulation_depth: float = 300.0
    keypoint_feature_detector: str = "GFTT"

    # --- map ---
    num_active_keyframes: int = 10

    # --- backend ---
    backend_on: int = 1
    chi2_th: float = 5.991

    # --- loop closure ---
    loopclosure_on: int = 1
    dnn_weights_path: str = "./dnn_weights/mobilenet_v2.onnx"
    keyframes_to_ignore_after_loop: int = 5
    potential_loop_weak_threshold: float = 0.92
    potential_loop_strong_threshold: float = 0.95
    max_num_weak_threshold: int = 3
    min_num_acceptable_keypoint_match: int = 11
    min_pose_differnece_between_old_new: float = 1.0   # [sic] reference key
    max_pose_differnece_between_old_new: float = 50.0  # [sic] reference key
    max_pose_distance_between_loop_keyframes: float = 20.0
    global_pose_graph_optimization: int = 1

    # --- visualization ---
    visualizer_on: int = 1

    # --- static capacities ---
    max_features: int = 256          # feature slots per frame (>= num_features)
    max_landmarks: int = 4096        # active landmark table size
    max_keyframes_window: int = 16   # padded active-KF window
    max_total_keyframes: int = 4096  # pose-graph capacity
    lk_num_levels: int = 4
    lk_win_size: int = 11
    lk_max_iters: int = 30
    gftt_quality_level: float = 0.01
    gftt_min_distance: int = 20
    keyframes_to_skip_in_candidate_search: int = 20
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    frontend_anchored_lk: int = 1
    frontend_stereo_pose: int = 1
    frontend_multi_start: int = 1
    ba_lm_iters: int = 10
    ba_outlier_rounds: int = 5
    ba_max_active_landmarks: int = 1024
    ba_every_kth_keyframe: int = 1
    image_height: int = 188
    image_width: int = 620

    @staticmethod
    def from_yaml(path: str) -> "SlamConfig":
        if not os.path.exists(path):
            raise ConfigError(f"config file not found: {path}")
        with open(path) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
        data = yaml.safe_load("\n".join(lines)) or {}
        cfg = SlamConfig()
        known = {f.name for f in dataclasses.fields(SlamConfig)}
        for key, value in data.items():
            key = key.strip()
            if key in known:
                setattr(cfg, key, type(getattr(cfg, key))(value))
        return cfg

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)
