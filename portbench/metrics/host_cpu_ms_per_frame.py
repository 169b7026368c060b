"""Host loop: the process's CPU time over the window per frame handed over
(`time.process_time()`)."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "host loop"
MOVES = "frames_per_s"


def read(rec: dict):
    return 1e3 * rec["cpu_s"] / rec["frames"]
