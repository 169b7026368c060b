"""Trajectory evaluation command line (counterpart of
`apps/evaluate_trajectory.py`): ATE and RPE of a SLAM keyframes.txt against
KITTI-format ground truth (a poses file with 12 values per line, T_w_cam
row major, the odometry benchmark's format).

Usage: python -m stereovision_slam_torch.apps.evaluate_trajectory
           <keyframes.txt> <kitti_gt_poses.txt> [--align]
"""

from __future__ import annotations

import sys

import numpy as np

from stereovision_slam_torch.slam.outputs import load_keyframes_file
from stereovision_slam_torch.utils.evaluation import ate_rmse, rpe_per_frame


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = [a for a in argv if not a.startswith("--")]
    align = "--align" in argv
    if len(args) != 2:
        print(__doc__)
        return 1
    kf_path, gt_path = args
    _, _, frames = load_keyframes_file(kf_path)
    est = {fid: T for fid, T in frames}

    # KITTI ground truth: T_w_cam per line (cam -> world); inverted to T_cw
    gt = {}
    with open(gt_path) as f:
        for i, line in enumerate(f):
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            T_wc = np.array(vals, np.float64).reshape(3, 4)
            R = T_wc[:, :3].T
            t = -R @ T_wc[:, 3]
            gt[i] = np.concatenate([R, t[:, None]], axis=1).astype(np.float32)

    common = sorted(set(est) & set(gt))
    ate = ate_rmse(est, gt, align=align)
    rpe = rpe_per_frame(est, gt)
    print(f"frames compared: {len(common)}")
    print(f"ATE RMSE: {ate:.4f} m{' (SE3-aligned)' if align else ''}")
    print(f"RPE (translational, consecutive keyframes): {rpe:.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
