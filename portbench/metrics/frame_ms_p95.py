"""The 95th percentile over the window's frames of the time from a frame's
handover to its pose on the host (the drive's last frame with its PGO)."""

from portbench.harness import quantile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(rec: dict):
    lat = rec.get("frame_lat_s")
    return 1e3 * quantile(lat, 0.95) if lat else None
