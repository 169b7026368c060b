"""Drive start: the host's milliseconds in the `drive.init` span (the
eager stereo initialization of a fresh pipeline's first frame, with its
host read) of the span stretch's drive."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "drive start"
MOVES = "frames_per_s"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    return spans.span_ms(st, "drive.init") or None
