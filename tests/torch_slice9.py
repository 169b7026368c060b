"""Phases 14 and 16-18 of `chip_smoke.py` alone, on the card: the command
line on the circuit as a KITTI sequence, then the dense tool over its fused
run, MobileNet-V2 and FAST (about 4 minutes):

    python -m tests.torch_slice9 [--save-keyframes PATH]

Prints what the phases print and the gates they miss; exits 1 if any.
`--save-keyframes` copies the fused run's keyframes.txt to PATH, for
`tests/torch_slice9_reference.py --dense PATH`.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-keyframes", default=None, metavar="PATH")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.ops import (gather, lk_iterate, lk_lanes,
                                             pose_kernel)
    from stereovision_slam_torch.parallel import ring_reduce

    print(cs.smi_line())
    scene = scenes.circuit(120, 188, 620, device="cuda")
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    tmp = tempfile.mkdtemp(prefix="svslam_kitti_")
    missed = []
    try:
        _, _, _, failed, outputs = cs.cli_phase(scene, counters, "cuda", tmp)
        missed += failed
        missed += cs.dense_phase(outputs, tmp, "cuda", args.save_keyframes)
        missed += cs.mobilenet_phase(scene, outputs, tmp, counters,
                                     "cuda")[1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    missed += cs.fast_phase(scene, counters, "cuda")[1]
    print("missed: " + ("none" if not missed else "; ".join(missed)))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
