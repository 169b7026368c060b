"""Track branch: the median handover-to-pose time of the window's frames
that inserted no keyframe."""

from portbench.harness import median

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "track branch"
MOVES = "frames_per_s"


def read(rec: dict):
    lat = [t for t, k in zip(rec.get("frame_lat_s", []),
                             rec.get("frame_kf", [])) if not k]
    return 1e3 * median(lat) if lat else None
