"""In-memory stereo sequence (counterpart of `io/kitti.py`'s
`StereoFrame` and `ArraySequenceDataset`)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from stereovision_slam_torch.geometry.camera import Camera


@dataclass
class StereoFrame:
    frame_id: int
    left: np.ndarray    # (H, W) float32 grayscale
    right: np.ndarray


class ArraySequenceDataset:
    """Frames from (T, H, W) arrays, with the KITTI loader's interface."""

    def __init__(self, lefts, rights, cameras: list[Camera],
                 dataset_dir: str = "<synthetic>"):
        self.lefts = np.asarray(lefts)
        self.rights = np.asarray(rights)
        self.cameras = list(cameras)
        self.dataset_dir = dataset_dir
        self.left_cam_index = 0
        self.right_cam_index = 1
        self.current_index = 0

    def initialize(self) -> None:
        self.current_index = 0

    def get_camera(self, camera_id: int) -> Camera:
        return self.cameras[camera_id]

    def frame_by_id(self, frame_id: int) -> StereoFrame | None:
        if frame_id < 0 or frame_id >= len(self.lefts):
            return None
        return StereoFrame(frame_id=frame_id,
                           left=self.lefts[frame_id].astype(np.float32),
                           right=self.rights[frame_id].astype(np.float32))

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
