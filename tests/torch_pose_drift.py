"""How far the poses' rotations drift from SO(3), frame by frame.

    python -m tests.torch_pose_drift [--frames 45] [--device cuda]
    JAX_PLATFORMS=cpu python -m tests.torch_pose_drift --device cpu
        [--reference]

Runs the port's `FusedVisualOdometry` over the first frames of the bench's
circuit with `chip_smoke.py`'s settings and prints, after each frame,
max |R R^T - I| of the current pose `T_cur` and of the constant-velocity
model `T_rel`, and of kernel B's input starts and output (chosen pose,
every start) and of the window before and after BA, where they ran. With
--reference (CPU only) it also runs the reference's `FusedVisualOdometry`
on the same images and prints its `T_cur`'s drift. The motion model is
`T_rel = T_new * T_prev^-1` with the inverse taken as a transpose, which
is exact only on SO(3): a deviation e of the poses becomes about 2e in
`T_rel`, and the next pose started from `T_rel * T_cur` carries it on.
The reference keeps that growth; the port's frontend projects each solved
pose back onto SO(3) (`se3.se3_orthonormalize`), so its deviation stays at
float32 rounding.
"""

from __future__ import annotations

import argparse
import sys


def _drift(T) -> float:
    """max |R R^T - I| over the poses of T (..., 3, 4), numpy or torch."""
    import numpy as np
    import torch
    if not isinstance(T, torch.Tensor):
        T = torch.from_numpy(np.array(T))
    R = T[..., :3, :3].double()
    eye = torch.eye(3, dtype=torch.float64, device=R.device)
    return float((R @ R.transpose(-1, -2) - eye).abs().amax())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, ".")
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.ops import pose_kernel
    from stereovision_slam_torch.slam import fused
    from stereovision_slam_torch.slam.fused import FusedVisualOdometry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = args.frames
    lefts, rights, _, _, rig = scenes.circuit(120, 188, 620,
                                              device=args.device)
    vo = FusedVisualOdometry(
        chip_smoke.bench_config(), ArraySequenceDataset(
            lefts[:n], rights[:n], list(rig)), max_total_keyframes=512,
        max_total_landmarks=1 << 16, device=args.device)
    vo.initialize()
    log = []
    pose_lm, optimize_window = pose_kernel.pose_lm, fused.optimize_window

    def solve(*a, **kw):
        out = pose_lm(*a, **kw)
        log.append(f"B starts {_drift(a[6]):.1e} chosen {_drift(out.T):.1e} "
                   f"all {_drift(out.T_all):.1e}")
        return out

    def ba(m, *a, **kw):
        out = optimize_window(m, *a, **kw)
        log.append(f"BA {_drift(m.kf_pose[m.kf_valid]):.1e} -> "
                   f"{_drift(out[0].kf_pose[out[0].kf_valid]):.1e}")
        return out

    pose_kernel.pose_lm, fused.optimize_window = solve, ba
    try:
        for f in range(n):
            log.clear()
            vo.step()
            print(f"frame {f}: T_cur {_drift(vo.fs.T_cur):.2e} T_rel "
                  f"{_drift(vo.fs.T_rel):.2e}; " + "; ".join(log), flush=True)
    finally:
        pose_kernel.pose_lm, fused.optimize_window = pose_lm, optimize_window
    if args.reference:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import bench
        from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDS
        from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JF
        from tests import synthetic

        ref = JF(bench.make_config(), JDS(lefts[:n], rights[:n],
                                          list(synthetic.make_stereo_rig())),
                 max_total_keyframes=512, max_total_landmarks=1 << 16)
        ref.initialize()
        drift = []
        while ref.step():
            drift.append(_drift(np.asarray(ref.fs.T_cur)))
        print("reference T_cur by frame: " + " ".join(
            f"{f}:{d:.1e}" for f, d in enumerate(drift)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
