"""How the benchmark builds the program's objects: its configuration, its
rig and the dataset protocol its pipelines read cameras (and, serving,
frames) through. The only place besides the drivers' calls that names the
program's classes."""

from __future__ import annotations

from portbench import scenes


class LapDataset:
    """The cameras of the rig, in the program's dataset protocol; frames
    are handed to `step_chunk` directly."""

    left_cam_index, right_cam_index = 0, 1

    def __init__(self, cams):
        self.cams = cams

    def initialize(self) -> None:
        pass

    def get_camera(self, i: int):
        return self.cams[i]


def program_config(slam: dict):
    from stereovision_slam_torch.slam.config import SlamConfig
    cfg = SlamConfig()
    for k, v in slam.items():
        setattr(cfg, k, v)
    return cfg


def program_rig(cam: dict):
    from stereovision_slam_torch.geometry.camera import Camera
    left = Camera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                         baseline=0.0)
    right = Camera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                          baseline=cam["baseline"],
                          pose=scenes.rig_extrinsics(cam["baseline"])[1])
    return [left, right]
