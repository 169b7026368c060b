"""Pinhole stereo camera model (counterpart of `geometry/camera.py`).

Pose conventions as in the reference:
  * ``T_c_w`` - pose of the stereo rig in the world (world -> rig);
  * ``cam.pose`` - rig -> camera extrinsic;
  * world2camera(p) = cam.pose * T_c_w * p.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import se3


class Camera(NamedTuple):
    fx: torch.Tensor        # () scalars
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    baseline: torch.Tensor
    pose: torch.Tensor      # rig -> camera, (3, 4)
    pose_inv: torch.Tensor  # camera -> rig, (3, 4)

    @staticmethod
    def create(fx, fy, cx, cy, baseline=0.0, pose=None, dtype=torch.float32,
               device="cpu") -> "Camera":
        if pose is None:
            pose = se3.se3_identity(dtype, device)
        pose = torch.as_tensor(pose, dtype=dtype, device=device)

        def s(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return Camera(fx=s(fx), fy=s(fy), cx=s(cx), cy=s(cy),
                      baseline=s(baseline), pose=pose,
                      pose_inv=se3.se3_inverse(pose))

    def to(self, device) -> "Camera":
        return Camera(*(f.to(device) for f in self))

    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, z, self.cx]),
                            torch.stack([z, self.fy, self.cy]),
                            torch.stack([z, z, o])])


def world2camera(cam: Camera, p_w: torch.Tensor,
                 T_c_w: torch.Tensor) -> torch.Tensor:
    return se3.se3_apply(cam.pose, se3.se3_apply(T_c_w, p_w))


def camera2world(cam: Camera, p_c: torch.Tensor,
                 T_c_w: torch.Tensor) -> torch.Tensor:
    return se3.se3_apply(se3.se3_inverse(T_c_w),
                         se3.se3_apply(cam.pose_inv, p_c))


def camera2pixel(cam: Camera, p_c: torch.Tensor) -> torch.Tensor:
    z = p_c[..., 2]
    return torch.stack([cam.fx * p_c[..., 0] / z + cam.cx,
                        cam.fy * p_c[..., 1] / z + cam.cy], dim=-1)


def pixel2camera(cam: Camera, p_p: torch.Tensor, depth=1.0) -> torch.Tensor:
    depth = torch.as_tensor(depth, dtype=p_p.dtype, device=p_p.device)
    return torch.stack([(p_p[..., 0] - cam.cx) * depth / cam.fx,
                        (p_p[..., 1] - cam.cy) * depth / cam.fy,
                        depth.expand(p_p[..., 0].shape)], dim=-1)


def world2pixel(cam: Camera, p_w: torch.Tensor,
                T_c_w: torch.Tensor) -> torch.Tensor:
    return camera2pixel(cam, world2camera(cam, p_w, T_c_w))


def pixel2world(cam: Camera, p_p: torch.Tensor, T_c_w: torch.Tensor,
                depth=1.0) -> torch.Tensor:
    return camera2world(cam, pixel2camera(cam, p_p, depth), T_c_w)
