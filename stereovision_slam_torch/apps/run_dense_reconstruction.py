"""Dense 3-D reconstruction command line (counterpart of
`apps/run_dense_reconstruction.py`).

    python -m stereovision_slam_torch.apps.run_dense_reconstruction \
        CONFIG.yaml [--device cuda|cpu] [--mesh] [--per-device-batch N]

CONFIG is the reference's dense YAML (a `%YAML` line is skipped):
`slam_output_dir` names a SLAM run's output folder or its keyframes.txt;
`left_cam_index` / `right_cam_index` (default 2 and 3) the colour cameras
of the sequence that keyframes.txt names, `is_color_input` (default 1)
whether its PNGs are colour. The run goes to the card unless `--device
cpu` is given. `--mesh` reconstructs keyframes in batches of (devices x
`--per-device-batch`) instead of one by one; the port's mesh is one card.
Writes <slam_output_dir>/dense_pointcloud.pcd.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m stereovision_slam_torch.apps.run_dense_reconstruction",
        description="Dense coloured point cloud from a SLAM run's keyframes.")
    ap.add_argument("config", help="dense reconstruction YAML config")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", action="store_true",
                    help="reconstruct keyframes in batches over the mesh")
    ap.add_argument("--per-device-batch", type=int, default=1, metavar="N")
    return ap.parse_args(argv)


def load_config(path: str):
    """A `DenseReconstructionConfig` from the reference's YAML keys."""
    import yaml

    from stereovision_slam_torch.dense.reconstruction import (
        DenseReconstructionConfig)

    with open(path) as f:
        text = "\n".join(ln for ln in f.read().splitlines()
                         if not ln.startswith("%YAML"))
    data = yaml.safe_load(text) or {}
    return DenseReconstructionConfig(
        slam_output_dir=data.get("slam_output_dir", ""),
        left_color_cam_index=int(data.get("left_cam_index", 2)),
        right_color_cam_index=int(data.get("right_cam_index", 3)),
        is_color_input=bool(data.get("is_color_input", 1)))


def run(args: argparse.Namespace) -> dict:
    """Reconstruct as the command line asks. Returns a summary: the
    reconstruction (`dr`, with its stage timer and point counts),
    `points`, `colors` and the written `output` path."""
    from stereovision_slam_torch.dense.reconstruction import (
        DenseReconstruction)
    from stereovision_slam_torch.device import resolve_device
    from stereovision_slam_torch.parallel.mesh import make_local_mesh

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    dr = DenseReconstruction(cfg, device=device)
    dr.initialize()
    mesh = make_local_mesh(device) if args.mesh else None
    points, colors = dr.dense_reconstruct(
        mesh=mesh, per_device_batch=args.per_device_batch)
    out = os.path.join(cfg.slam_output_dir, "dense_pointcloud.pcd")
    print(f"Dense reconstruction finished: {len(points)} points -> {out}")
    return dict(dr=dr, points=points, colors=colors, output=out)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.exists(args.config):
        print(f"Config file not found: {args.config}")
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
