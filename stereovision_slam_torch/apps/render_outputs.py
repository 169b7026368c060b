"""Render SLAM and dense-reconstruction outputs to PNG figures (counterpart
of `apps/render_outputs.py`).

    python -m stereovision_slam_torch.apps.render_outputs SLAM_OUTPUT_DIR \
        [--out DIR]

SLAM_OUTPUT_DIR holds keyframes.txt and landmarks.pcd, and optionally
dense_pointcloud.pcd (`apps.run_dense_reconstruction`). Writes
trajectory.png (top-down keyframe centres over the landmarks),
landmarks.png and dense_pointcloud.png (3-D scatter) into DIR, by default
the input directory. matplotlib is imported when a figure is drawn.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from stereovision_slam_torch.io import pcd
from stereovision_slam_torch.slam.outputs import load_keyframes_file
from stereovision_slam_torch.utils.evaluation import camera_centers


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_trajectory(kf_path: str, lm_path: str | None,
                      out_png: str) -> np.ndarray:
    """The top-down trajectory and landmark map; returns the plotted camera
    centres (T, 3)."""
    plt = _pyplot()
    _, _, keyframes = load_keyframes_file(kf_path)
    centers = camera_centers(np.stack([T for _, T in keyframes]))
    fig, ax = plt.subplots(figsize=(8, 8))
    if lm_path and os.path.exists(lm_path):
        pts, _ = pcd.read_pcd(lm_path)
        ax.scatter(pts[:, 0], pts[:, 2], s=0.5, c="#9aa4ad", linewidths=0,
                   label=f"landmarks ({len(pts)})")
    ax.plot(centers[:, 0], centers[:, 2], "-", color="#1f6feb", lw=1.5,
            label=f"trajectory ({len(centers)} keyframes)")
    ax.plot(centers[0, 0], centers[0, 2], "o", color="#2da44e", ms=8,
            label="start")
    ax.plot(centers[-1, 0], centers[-1, 2], "s", color="#cf222e", ms=8,
            label="end")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=9)
    ax.set_title("SLAM trajectory + landmark map (top-down)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)
    return centers


def render_cloud(cloud_path: str, out_png: str,
                 max_points: int = 200_000) -> None:
    """A 3-D scatter of a PCD, at most `max_points` (a seeded sample)."""
    plt = _pyplot()
    pts, colors = pcd.read_pcd(cloud_path)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                               replace=False)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    c = colors / 255.0 if colors is not None else pts[:, 1]
    ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.3, c=c, linewidths=0)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("-y [m]")
    ax.set_title(f"Point cloud ({len(pts)} pts): "
                 f"{os.path.basename(cloud_path)}")
    fig.tight_layout()
    fig.savefig(out_png, dpi=130)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render SLAM / dense outputs to PNG figures.")
    ap.add_argument("slam_output_dir")
    ap.add_argument("--out", default=None,
                    help="output directory for the PNGs (default: the input "
                         "directory)")
    args = ap.parse_args(argv)
    src = args.slam_output_dir
    kf = os.path.join(src, "keyframes.txt")
    lm = os.path.join(src, "landmarks.pcd")
    if not (os.path.exists(kf) or os.path.exists(lm)):
        ap.error(f"no keyframes.txt or landmarks.pcd in {src}")
    out_dir = args.out or src
    os.makedirs(out_dir, exist_ok=True)
    figures = []
    if os.path.exists(kf):
        figures.append(("trajectory.png",
                        lambda png: render_trajectory(kf, lm, png)))
    for name in ("landmarks", "dense_pointcloud"):
        cloud = os.path.join(src, f"{name}.pcd")
        if os.path.exists(cloud):
            figures.append((f"{name}.png",
                            lambda png, cloud=cloud: render_cloud(cloud,
                                                                  png)))
    for name, draw in figures:
        png = os.path.join(out_dir, name)
        draw(png)
        print(f"wrote {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
