"""Frames completed in the window over the window's seconds (one stream,
drives back to back)."""

UNIT, BETTER, SOURCE = "frames/s", "higher", "host_clock"


def read(rec: dict):
    return rec["frames"] / rec["window_s"]
