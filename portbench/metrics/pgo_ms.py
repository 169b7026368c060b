"""Pose graph: `run_pgo` at a drive's end, host clock ending in a
synchronize (its graph capture included), median over the drives that
ended in the window."""

from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "pose graph"
MOVES = "frames_per_s"


def read(rec: dict):
    pgo = rec.get("pgo_s")
    return 1e3 * median(pgo) if pgo else None
