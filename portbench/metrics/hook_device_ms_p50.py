"""Loop hook: the device's milliseconds in the hook's device spans
(`hook.embed`, `hook.orb`, `hook.scan`, `hook.attempt`, `hook.correct`,
`hook.insert`) of a keyframe, median over the span stretch's keyframe
frames."""

from portbench import spans
from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "loop hook"
MOVES = "frame_ms_p95"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    kf = spans.keyframe_requests(st)
    per = spans.device_ms_by_request(st, "hook.")
    vals = [v for r, v in per.items() if r in kf]
    return median(vals) if vals else None
