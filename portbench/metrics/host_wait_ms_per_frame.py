"""Host loop: the host's milliseconds inside the program's `host_read.*`
spans (the device->host reads that decide a branch: the inlier count, the
hook's candidate and correction gates, the new landmarks of an
initialization) over the span stretch's frames, per frame."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "host loop"
MOVES = "frames_per_s"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    return sum(spans.dur_ms(s) for ss in spans.by_request(st).values()
               for s in ss if s["name"].startswith("host_read.")) \
        / st["frames"]
