"""Keyframe branch: the landmarks BA's compaction left out of a pass
(`optimize_window`'s `lm_overflow`, the device counter `ba.lm_overflow`)
per BA pass (`ba.passes`), over the span stretch's drive (the keyframe
graph's warm-up among its passes)."""

from portbench import spans

UNIT, BETTER, SOURCE = "landmarks/pass", "lower", "program_counter"
LAYER = "keyframe branch"
MOVES = "frame_ms_p95"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    c = st["drive_device_counts"]
    if not c.get("ba.passes"):
        return None
    return c.get("ba.lm_overflow", 0.0) / c["ba.passes"]
