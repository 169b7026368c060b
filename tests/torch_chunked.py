"""Phase 15 of chip_smoke.py alone (the chunked modes), beside the eager
loop path run here without phase 13's kernel holds. On the card:

    python -m tests.torch_chunked [--profile]

(about 3 minutes with the kernels' build). It prints the card's name and
power limit, each eager run, then phase 15's lines, and exits non-zero if
a hold or gate of phase 15 fails. `--profile` adds the profiler's tables
of the eager and the chunked loop path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def eager_loop_run(name: str, scene, dev, params) -> dict:
    """`FusedLoopVisualOdometry` on one scene: the numbers phase 15 prints
    beside its chunked runs."""
    import numpy as np
    import torch

    import chip_smoke
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry)

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    vo = chip_smoke.loop_vo(FusedLoopVisualOdometry, lefts, rights, rig,
                            dev, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo.run()
    dt = time.perf_counter() - t0
    keyframes, _, frames = vo.drain()

    def ate_of(traj):
        errs = [np.linalg.norm(-p[:, :3].T @ p[:, 3]
                               + gt[f][:, :3].T @ gt[f][:, 3])
                for f, p in traj]
        return float(np.sqrt(np.mean(np.square(errs))))
    vo.warm_pgo(kf_hint=len(keyframes))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = vo.run_pgo()
    torch.cuda.synchronize()
    info = dict(fps=T / dt, ms=1e3 * dt / T, keyframes=len(keyframes),
                loops=len(vo.loop_edges()),
                ate=ate_of(sorted(keyframes.values())),
                ate_pgo=ate_of(traj.items()),
                pgo_s=time.perf_counter() - t0,
                poses=np.stack([f.pose for _, f in frames]))
    print(f"eager {name}: {T / dt:.2f} fps, {info['keyframes']} keyframes, "
          f"{info['loops']} loops, ATE {info['ate']:.4f} m, after PGO "
          f"{info['ate_pgo']:.4f} m over {dist:.1f} m, pgo_s "
          f"{info['pgo_s']:.3f}")
    return info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_chunked: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.ops import (_cuda, gather, lk_iterate,
                                             lk_lanes, pose_kernel)
    from stereovision_slam_torch.parallel import ring_reduce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi_line())
    _cuda.build_all()
    dev = "cuda"
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    circuit = scenes.circuit(120, 188, 620, device=dev)
    scenes_loop = {"circuit": circuit,
                   "circuit_long": scenes.circuit_long(chip_smoke.LONG_T, 188,
                                                       620, device=dev)}
    params = place_net.get_params(device=dev)
    eager = {name: eager_loop_run(name, scene, dev, params)
             for name, scene in scenes_loop.items()}
    lefts, rights, _, _, rig = circuit
    _, dt = chip_smoke.run_slice(lefts, rights, rig, dev)
    _, missed = chip_smoke.chunked_phase(
        scenes_loop, circuit, counters, dev, params, eager,
        len(lefts) / dt, int(args.profile))
    print(chip_smoke.smi_line())
    if missed:
        print("torch_chunked: MISSED: " + "; ".join(missed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
