"""Keyframe branch: the device's milliseconds in the `kf.ba` device span
(`backend.optimize_window` inside the keyframe graph), median over the
span stretch's BA passes."""

from portbench import spans
from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "keyframe branch"
MOVES = "frame_ms_p95"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    vals = [d["ms"] for d in spans.device_spans(st, "kf.ba")]
    return median(vals) if vals else None
