"""Graph runner: the host's milliseconds inside the `graph.replay` spans of
a keyframe frame (the track graph and the keyframe and hook graphs it
replays), median over the span stretch's keyframe frames."""

from portbench import spans
from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "graph runner"
MOVES = "frame_ms_p95"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    reqs = spans.by_request(st)
    kf = spans.keyframe_requests(st)
    vals = [sum(spans.dur_ms(s) for s in reqs[r] if s["name"] ==
                "graph.replay") for r in kf]
    return median(vals) if vals else None
