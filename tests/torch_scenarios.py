"""Phases 20 and 21 of `chip_smoke.py` alone, on the card: the reference's
loop-scene scenarios rendered on "cuda" (the figure-eight, the aliased
arena, the corridor, PlaceNet's precision and recall, MobileNet-V2 at the
reference's gates, the hard scene chunked and eager with every kernel A
and B launch of the eager run held to its plain version, the long
corridor), then PlaceNet's training tool at its defaults into a temporary
file (about 2.5 minutes):

    python -m tests.torch_scenarios

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
    import torch

    import chip_smoke as cs
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.ops import (_cuda, gather, lk_iterate,
                                             lk_lanes, pose_kernel)
    from stereovision_slam_torch.parallel import ring_reduce

    print(cs.smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build_all()
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    params = place_net.get_params(device="cuda")
    totals, a_err, b_err, missed = cs.scenario_phase(counters, "cuda", params)
    print(f"kernel A and B launches {totals}, largest errors on the hard "
          f"scene {a_err:.3e}, {b_err:.3e}")
    tmp = tempfile.mkdtemp(prefix="svslam_train_")
    try:
        missed += cs.training_phase(tmp, "cuda", params)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("missed: " + ("none" if not missed else "; ".join(missed)))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
