"""Offline dense 3-D reconstruction from SLAM keyframe poses (counterpart
of `dense/reconstruction.py`).

Reads the SLAM output's keyframes.txt, runs block matching on each
keyframe's colour stereo pair (`ops/stereo_bm.py`), turns disparity into
depth z = f b / d, back-projects every valid pixel through the keyframe
pose into a coloured world cloud, removes outliers per keyframe and once
more over the merged cloud (`ops/sor.py`, PCL SOR semantics, or the
non-default voxel-density filter), keeps one point per 0.02 m voxel, and
writes a binary PCD (`io/pcd.py`). Disparity, back-projection and the
k-NN run on the device; the voxel grid, the density filter and the PCD are
host numpy, as in the reference.

Batched mode (`mesh=`, the reference's `build_sharded_dense_kernel`):
keyframes go through the disparity and back-projection in stacks of
`mesh.size * per_device_batch`, padded with zero images (the texture gate
marks every padded pixel invalid). Each rank of the mesh takes its
`per_device_batch` keyframes of a stack through one batched pass on its own
device, and the host gathers the points. The back-projection is written out
as elementwise float32 sums (no matmul), and the pose is inverted on the
host, so a keyframe's points are the same bits on the CPU and on the card,
batched or not.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from stereovision_slam_torch.device import on_device, resolve_device
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.io import pcd
from stereovision_slam_torch.ops.sor import statistical_outlier_removal
from stereovision_slam_torch.ops.stereo_bm import compute_disparity
from stereovision_slam_torch.slam.outputs import load_keyframes_file
from stereovision_slam_torch.utils.profiling import StageTimer

f32 = torch.float32


def _depth_and_points(disp, valid, fx, fy, cx, cy, baseline, T_cw,
                      min_depth: float = 1.0, max_depth: float = 200.0):
    """Disparity (..., H, W) -> world points (..., H*W, 3) and their mask
    (..., H*W); T_cw (..., 3, 4) world -> camera."""
    dev = disp.device
    fx, fy, cx, cy, baseline = (torch.full((), float(v), dtype=f32,
                                           device=dev)
                                for v in (fx, fy, cx, cy, baseline))
    H, W = disp.shape[-2:]
    zero = torch.zeros((), dtype=f32, device=dev)
    z = torch.where(valid & (disp > 0.1),
                    fx * baseline / torch.clamp(disp, min=0.1), zero)
    ok = valid & (z >= min_depth) & (z <= max_depth)
    yy = torch.arange(H, dtype=f32, device=dev)[:, None]
    xx = torch.arange(W, dtype=f32, device=dev)[None, :]
    x = (xx - cx) * z / fx
    y = (yy - cy) * z / fy
    T_wc = se3.se3_inverse(torch.as_tensor(T_cw, dtype=f32).cpu()).to(dev)
    lead = T_wc.shape[:-2]
    R = T_wc[..., :3, :3].reshape(*lead, 3, 3, 1, 1)
    t = T_wc[..., :3, 3].reshape(*lead, 3, 1, 1)
    p = torch.stack([R[..., i, 0, :, :] * x + R[..., i, 1, :, :] * y
                     + R[..., i, 2, :, :] * z + t[..., i, :, :]
                     for i in range(3)], dim=-1)
    return p.reshape(*p.shape[:-3], H * W, 3), ok.reshape(*ok.shape[:-2],
                                                          H * W)


def density_filter(points: np.ndarray, voxel: float = 0.1,
                   min_neighbors: int = 4) -> np.ndarray:
    """Boolean keep-mask: drop points whose voxel plus its 6 face
    neighbours hold fewer than `min_neighbors` points (the non-default
    fast filter)."""
    if len(points) == 0:
        return np.zeros((0,), bool)
    keys = np.floor(points / voxel).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    voxel_count = np.bincount(inv)
    neigh = voxel_count[inv].astype(np.int64)
    lookup = {tuple(k): c for k, c in zip(uniq, voxel_count)}
    for dz in (-1, 1):
        for axis in range(3):
            shifted = keys.copy()
            shifted[:, axis] += dz
            neigh += np.array([lookup.get(tuple(k), 0) for k in shifted])
    return neigh >= min_neighbors


def voxel_downsample(points: np.ndarray, colors: np.ndarray | None,
                     leaf: float = 0.02):
    """One point per voxel (the first hit), pcl::VoxelGrid's 0.02 m leaf."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / leaf).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    first = np.sort(first)
    return points[first], (colors[first] if colors is not None else None)


@dataclass
class DenseReconstructionConfig:
    slam_output_dir: str = ""
    left_color_cam_index: int = 2
    right_color_cam_index: int = 3
    is_color_input: bool = True
    num_disparities: int = 128
    block_size: int = 15
    min_depth: float = 1.0
    max_depth: float = 150.0
    voxel_leaf: float = 0.02
    # 'statistical': PCL SOR semantics (meanK / sigma); 'density': the
    # voxel-density approximation
    outlier_filter: str = "statistical"
    sor_mean_k: int = 50
    sor_std_ratio: float = 1.0
    sor_max_ref: int = 16384   # neighbour-search subsample cap
    sor_chunk: int = 1024      # queries per distance-matrix tile
    density_voxel: float = 0.15
    density_min_neighbors: int = 5


class DenseReconstruction:
    """Offline dense mapper driven by a SLAM output directory.

    `timer` collects the stages' times (decode, disparity,
    back-projection, keyframe SOR, global SOR, voxel, PCD write; the
    clock read after the device's queue drains) and `counts` the points
    before and after each filter."""

    def __init__(self, cfg: DenseReconstructionConfig, dataset_factory=None,
                 device: str | torch.device = "cuda"):
        """dataset_factory(dataset_dir) -> a dataset with get_camera /
        frame_by_id; default the KITTI loader on the colour cameras."""
        self.cfg = cfg
        self.dataset_factory = dataset_factory
        self.device = resolve_device(device)
        self.dataset = None
        self.keyframes = []
        self.timer = StageTimer(self.device)
        self.counts: dict[str, int] = {}

    def initialize(self) -> None:
        # the reference's config names keyframes.txt itself; accept the
        # file or its directory
        if self.cfg.slam_output_dir.endswith(".txt"):
            kf_path = self.cfg.slam_output_dir
            self.cfg.slam_output_dir = os.path.dirname(kf_path)
        else:
            kf_path = os.path.join(self.cfg.slam_output_dir, "keyframes.txt")
        dataset_dir, _, frames = load_keyframes_file(kf_path)
        self.keyframes = frames
        if self.dataset_factory is not None:
            self.dataset = self.dataset_factory(dataset_dir)
        else:
            from stereovision_slam_torch.io.kitti import KittiDataset
            self.dataset = KittiDataset(
                dataset_dir,
                left_cam_index=self.cfg.left_color_cam_index,
                right_cam_index=self.cfg.right_color_cam_index,
                is_color_input=self.cfg.is_color_input, device=self.device)
            self.dataset.initialize()

    def _frame_arrays(self, frame_id: int):
        """(left_gray, right_gray, colours (H, W, 3) uint8) of a keyframe,
        or None; colour turns grey by the channel mean."""
        with self.timer.time("decode"):
            frame = self.dataset.frame_by_id(frame_id)
            if frame is None:
                return None
            left = np.asarray(frame.left, np.float32)
            right = np.asarray(frame.right, np.float32)
            if left.ndim == 3:
                return (left.mean(axis=-1), right.mean(axis=-1),
                        left.astype(np.uint8))
            return left, right, np.stack([left] * 3, axis=-1).astype(np.uint8)

    def _cams(self):
        cfg = self.cfg
        cam = self.dataset.get_camera(
            getattr(self.dataset, "left_cam_index", cfg.left_color_cam_index))
        cam_r = self.dataset.get_camera(
            getattr(self.dataset, "right_cam_index",
                    cfg.right_color_cam_index))
        baseline = abs(float(cam_r.baseline) - float(cam.baseline))
        return cam, baseline

    def _points(self, lefts, rights, T_cws, device=None):
        """Disparity and back-projection of one pair or a stack: (points,
        mask) on `device` (the reconstruction's by default)."""
        cfg = self.cfg
        dev = self.device if device is None else device
        cam, baseline = self._cams()
        with self.timer.time("disparity"):
            disp, valid = compute_disparity(
                torch.from_numpy(np.ascontiguousarray(lefts)).to(dev),
                torch.from_numpy(np.ascontiguousarray(rights)).to(dev),
                num_disparities=cfg.num_disparities,
                block_size=cfg.block_size)
        with self.timer.time("back-projection"):
            return _depth_and_points(
                disp, valid, cam.fx, cam.fy, cam.cx, cam.cy, baseline,
                torch.from_numpy(np.asarray(T_cws, np.float32)),
                cfg.min_depth, cfg.max_depth)

    def _keep(self, pts, ok, colors_img):
        """One keyframe's valid points and colours after its own filter."""
        ok_np = ok.cpu().numpy()
        pts_np = pts[ok].cpu().numpy()
        cols_np = colors_img.reshape(-1, 3)[ok_np]
        self.counts["valid_points"] = (self.counts.get("valid_points", 0)
                                       + len(pts_np))
        with self.timer.time("keyframe SOR"):
            keep = self._outlier_keep_mask(pts_np)
        return pts_np[keep], cols_np[keep]

    def reconstruct_keyframe(self, frame_id: int, T_cw: np.ndarray):
        """One keyframe -> (points (N, 3) float32, colours (N, 3) uint8),
        or (None, None) if its frames are missing."""
        arrs = self._frame_arrays(frame_id)
        if arrs is None:
            return None, None
        left_gray, right_gray, colors_img = arrs
        pts, ok = self._points(left_gray, right_gray, T_cw)
        return self._keep(pts, ok, colors_img)

    def _outlier_keep_mask(self, points: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        if cfg.outlier_filter == "density":
            return density_filter(points, cfg.density_voxel,
                                  cfg.density_min_neighbors)
        return statistical_outlier_removal(
            points, mean_k=cfg.sor_mean_k, std_ratio=cfg.sor_std_ratio,
            max_ref=cfg.sor_max_ref, chunk=cfg.sor_chunk, device=self.device)

    def _reconstruct_batched(self, kfs, mesh, per_device_batch: int):
        """Stacks of mesh.size * per_device_batch keyframes, zero-padded,
        split per rank: rank r's per_device_batch keyframes go through one
        disparity and back-projection pass on the rank's device. The host
        gathers the points and applies the per-keyframe filter, as the
        reference's `_reconstruct_sharded` does."""
        B = mesh.size * per_device_batch
        loaded = []
        for frame_id, T in kfs:
            arrs = self._frame_arrays(frame_id)
            if arrs is not None:
                loaded.append((arrs, T))
        all_pts, all_cols = [], []
        ident = np.eye(3, 4, dtype=np.float32)
        for s in range(0, len(loaded), B):
            chunk = loaded[s:s + B]
            pad = B - len(chunk)
            zero = np.zeros_like(loaded[0][0][0])
            lefts = np.stack([a[0] for a, _ in chunk] + [zero] * pad)
            rights = np.stack([a[1] for a, _ in chunk] + [zero] * pad)
            T_cws = np.stack([np.asarray(T, np.float32) for _, T in chunk]
                             + [ident] * pad)
            parts = []
            for r, dev in enumerate(mesh.devices):
                sl = slice(r * per_device_batch, (r + 1) * per_device_batch)
                with on_device(dev):
                    parts.append(self._points(lefts[sl], rights[sl],
                                              T_cws[sl], dev))
            for b, (arrs, _) in enumerate(chunk):
                pts, ok = parts[b // per_device_batch]
                r = b % per_device_batch
                p, c = self._keep(pts[r], ok[r], arrs[2])
                if len(p):
                    all_pts.append(p)
                    all_cols.append(c)
        return all_pts, all_cols

    def dense_reconstruct(self, output_path: str | None = None,
                          max_keyframes: int | None = None, mesh=None,
                          per_device_batch: int = 1):
        """The whole pipeline over the keyframes; writes
        dense_pointcloud.pcd into the SLAM output directory. With `mesh`
        (a `parallel.mesh.Mesh`), keyframes go in batches instead of one by
        one. Returns (points, colours)."""
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices):
            raise ValueError(f"the mesh lives on {mesh.devices}, the "
                             f"reconstruction on {self.device}")
        self.counts = {"valid_points": 0}
        all_pts, all_cols = [], []
        kfs = (self.keyframes[:max_keyframes] if max_keyframes
               else self.keyframes)
        self.counts["keyframes"] = len(kfs)
        if mesh is not None and kfs:
            all_pts, all_cols = self._reconstruct_batched(
                kfs, mesh, per_device_batch)
        else:
            for frame_id, T in kfs:
                pts, cols = self.reconstruct_keyframe(frame_id, T)
                if pts is not None and len(pts):
                    all_pts.append(pts)
                    all_cols.append(cols)
        if not all_pts:
            points = np.zeros((0, 3), np.float32)
            colors = np.zeros((0, 3), np.uint8)
        else:
            points = np.concatenate(all_pts)
            colors = np.concatenate(all_cols)
            self.counts["after_keyframe_filter"] = len(points)
            # the reference filters per keyframe and once more over the
            # merged cloud
            with self.timer.time("global SOR"):
                keep = self._outlier_keep_mask(points)
            points, colors = points[keep], colors[keep]
            self.counts["after_global_filter"] = len(points)
            with self.timer.time("voxel"):
                points, colors = voxel_downsample(points, colors,
                                                  self.cfg.voxel_leaf)
        self.counts["after_voxel"] = len(points)
        if output_path is None:
            output_path = os.path.join(self.cfg.slam_output_dir,
                                       "dense_pointcloud.pcd")
        with self.timer.time("PCD write"):
            pcd.write_pcd_xyzrgb(output_path, points, colors)
        return points, colors
