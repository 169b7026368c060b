"""Phase 19 of `chip_smoke.py` with what it builds on, alone, on the card:
the slice (phase 4) for its final window and keyframes, kernel D (10),
the sharded BA (11) and PGO (12), the command line's fused run (14) and
the dense tool (16), then phase 19: the
distributed backend across two processes, serving over a mesh and the
dense tool over mesh ranks (about 4 minutes):

    python -m tests.torch_slice10

Prints what the phases print and the gates they miss; exits 1 if any.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.ops import (_cuda, gather, lk_iterate,
                                             lk_lanes, pose_kernel)
    from stereovision_slam_torch.parallel import ring_reduce

    print(cs.smi_line())
    _cuda.build_all()
    lefts, rights, gt, dist, rig = scene = scenes.circuit(120, 188, 620,
                                                          device="cuda")
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    vo, _ = cs.run_slice(lefts, rights, rig, "cuda")
    keyframes, _, _ = vo.drain()
    kernel_d = cs.check_ring("cuda")
    ba, pgo, dense = {}, {}, {}
    cs.sharded_ba_phase(vo, counters, "cuda", 0.0, False, ba)
    cs.pgo_phase(keyframes, gt, "cuda", False, pgo)
    streams = cs.serving_streams(lefts, rights, gt)
    missed = []
    n_d, timing, failed = cs.dist_phase(ba, pgo, kernel_d, "cuda")
    print(f"kernel D launches across the processes {n_d}, timings {timing}")
    missed += failed
    launches, failed = cs.serving_mesh_phase(streams, rig, counters, "cuda")
    missed += failed
    tmp = tempfile.mkdtemp(prefix="svslam_kitti_")
    try:
        _, _, _, failed, outputs = cs.cli_phase(scene, counters, "cuda", tmp)
        missed += failed
        missed += cs.dense_phase(outputs, tmp, "cuda", keep=dense)
        missed += cs.dense_mesh_phase(dense, tmp, "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("missed: " + ("none" if not missed else "; ".join(missed)))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
