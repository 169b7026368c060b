"""Keyframe branch: the device's milliseconds from the start of a keyframe
frame's first device span to the end of its last (the keyframe, BA and
hook stages inside the keyframe and hook graphs, and what runs between
them), median over the span stretch's keyframe frames."""

from portbench import spans
from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "keyframe branch"
MOVES = "frame_ms_p95"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    kf = spans.keyframe_requests(st)
    per: dict = {}
    for d in st["records"]["device_frames"]:
        r = d["request"]
        if spans.in_drive(st, r) and tuple(r) in kf:
            per[tuple(r)] = per.get(tuple(r), 0.0) + d["ms"]
    return median(list(per.values())) if per else None
