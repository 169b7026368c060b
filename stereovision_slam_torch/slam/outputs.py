"""SLAM output writers: keyframes.txt + landmarks.pcd (the port's own copy
of `slam/outputs.py`, numpy only).

Byte-format-compatible with the C++ system's saveSLAMOutputInFile
(visual_odometry.cpp:198-310) so its dense-reconstruction stage and
external evaluation tooling interoperate:

    keyframes.txt:  dataset_dir\n left_cam_index\n then per keyframe
                    "frame_id r00 r01 r02 tx r10 ... tz\n"  (3x4 Tcw, row major)
    landmarks.pcd:  ASCII PCD of all landmark positions
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from stereovision_slam_torch.io import pcd


def save_slam_output(output_dir: str, dataset_dir: str, left_cam_index: int,
                     keyframes: list[tuple[int, np.ndarray]],
                     landmarks: np.ndarray,
                     timestamped_subdir: bool = True) -> str:
    """Write keyframes.txt + landmarks.pcd; returns the output folder path.

    Args:
      keyframes: list of (frame_id, (3,4) Tcw), any order (sorted by id here,
        visual_odometry.cpp:269-279).
      landmarks: (N, 3) world points.
    """
    if timestamped_subdir:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        out = os.path.join(output_dir, stamp)
    else:
        out = output_dir
    os.makedirs(out, exist_ok=True)

    pcd.write_pcd_xyz(os.path.join(out, "landmarks.pcd"),
                      np.asarray(landmarks, dtype=np.float32))

    with open(os.path.join(out, "keyframes.txt"), "w") as f:
        f.write(f"{dataset_dir}\n{left_cam_index}\n")
        for frame_id, T in sorted(keyframes, key=lambda kv: kv[0]):
            T = np.asarray(T, dtype=np.float64).reshape(3, 4)
            vals = " ".join(f"{v:.9g}" for v in T.reshape(-1))
            f.write(f"{frame_id} {vals}\n")
    return out


def load_keyframes_file(path: str):
    """Parse keyframes.txt (the dense-reconstruction input,
    dense_reconstruction.cpp:34-74). Returns (dataset_dir, left_cam_index,
    list of (frame_id, (3,4) Tcw))."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    dataset_dir = lines[0]
    left_cam_index = int(lines[1])
    frames = []
    for ln in lines[2:]:
        parts = ln.split()
        fid = int(parts[0])
        T = np.array([float(v) for v in parts[1:13]], dtype=np.float32).reshape(3, 4)
        frames.append((fid, T))
    return dataset_dir, left_cam_index, frames
