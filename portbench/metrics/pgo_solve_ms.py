"""Pose graph: the host's milliseconds in the `pgo.solve` span (the LM
iterations' graph replays, a new size's capture, the poses read to the
host) of the span stretch's shutdown PGO."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "pose graph"
MOVES = "frames_per_s"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    return spans.span_ms(st, "pgo.solve") or None
