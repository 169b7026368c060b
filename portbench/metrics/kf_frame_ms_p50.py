"""Keyframe branch: the median handover-to-pose time of the window's frames
that inserted a keyframe (tracking, keyframe, BA, the loop hook)."""

from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "keyframe branch"
MOVES = "frame_ms_p95"


def read(rec: dict):
    lat = [t for t, k in zip(rec.get("frame_lat_s", []),
                             rec.get("frame_kf", [])) if k]
    return 1e3 * median(lat) if lat else None
