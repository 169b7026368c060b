"""Process start to the window's start: imports, kernel loads (and in a
checkout's first run their build), rendering, weights, warm-up."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec: dict):
    return rec["setup_s"]
