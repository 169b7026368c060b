"""KITTI odometry sequence loader (counterpart of `io/kitti.py`).

Parses calib.txt's 3x4 projections into four cameras - intrinsics from K,
stereo translation t = K^-1 p4, baseline |t|, K scaled by 1 / downsample
for the image decimation - and reads PNG pairs with Pillow, decimated by
nearest neighbour (`[::2, ::2]`, cv::INTER_NEAREST), as the reference
does. The cameras are torch `Camera`s on the dataset's device; the frames
stay numpy float32 on the host, where the VO loops pick them up.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.io.dataset import StereoFrame
from stereovision_slam_torch.utils.exceptions import DatasetError

try:
    from PIL import Image
    _HAS_PIL = True
except ImportError:  # pragma: no cover - environment-dependent
    _HAS_PIL = False


class KittiDataset:
    """Sequence loader: `initialize`, `get_camera`, `frame_by_id`,
    `next_frame` and iteration, as the reference's."""

    def __init__(self, dataset_dir: str, left_cam_index: int = 0,
                 right_cam_index: int = 1, is_color_input: bool = False,
                 downsample: int = 2, device: str | torch.device = "cuda"):
        self.dataset_dir = dataset_dir
        self.left_cam_index = left_cam_index
        self.right_cam_index = right_cam_index
        self.is_color_input = is_color_input
        self.downsample = downsample
        self.device = resolve_device(device)
        self.cameras: list[Camera] = []
        self.current_index = 0

    def initialize(self) -> None:
        calib_path = os.path.join(self.dataset_dir, "calib.txt")
        if not os.path.exists(calib_path):
            raise DatasetError(
                f"Cannot open KITTI camera parameters file: {calib_path}")
        self.cameras = []
        with open(calib_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 13 or not parts[0].startswith("P"):
                    continue
                p = np.array([float(v) for v in parts[1:13]]).reshape(3, 4)
                K = p[:, :3]
                t = np.linalg.solve(K, p[:, 3])
                baseline = float(np.linalg.norm(t))
                Ks = K * (1.0 / self.downsample)
                pose = np.concatenate([np.eye(3, dtype=np.float32),
                                       t.astype(np.float32)[:, None]], axis=1)
                self.cameras.append(Camera.create(
                    fx=Ks[0, 0], fy=Ks[1, 1], cx=Ks[0, 2], cy=Ks[1, 2],
                    baseline=baseline, pose=torch.from_numpy(pose),
                    device=self.device))
        if len(self.cameras) < 2:
            raise DatasetError(f"calib.txt yielded {len(self.cameras)} cameras")
        self.current_index = 0

    def get_camera(self, camera_id: int) -> Camera:
        return self.cameras[camera_id]

    def _image_path(self, cam_index: int, frame_id: int) -> str:
        return os.path.join(self.dataset_dir, f"image_{cam_index}",
                            f"{frame_id:06d}.png")

    def _load_image(self, path: str) -> np.ndarray | None:
        if not os.path.exists(path):
            return None
        if not _HAS_PIL:
            raise DatasetError("Pillow is not available for PNG decoding")
        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB" if self.is_color_input
                                         else "L"), dtype=np.float32)
        d = self.downsample
        if d > 1:
            arr = arr[::d, ::d]   # INTER_NEAREST decimation
        return arr

    def frame_by_id(self, frame_id: int) -> StereoFrame | None:
        left = self._load_image(self._image_path(self.left_cam_index,
                                                 frame_id))
        right = self._load_image(self._image_path(self.right_cam_index,
                                                  frame_id))
        if left is None or right is None:
            return None
        return StereoFrame(frame_id=frame_id, left=left, right=right)

    def next_frame(self) -> StereoFrame | None:
        frame = self.frame_by_id(self.current_index)
        if frame is not None:
            self.current_index += 1
        return frame

    def __iter__(self):
        while True:
            f = self.next_frame()
            if f is None:
                return
            yield f
