"""Device: the share of the traced slice's wall time in which no device
operation ran (1 - the union of their intervals over the wall), percent."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "frames_per_s"


def read(rec: dict):
    if not rec.get("traced_s"):
        return None
    return 100 * (1 - rec["busy_s"] / rec["traced_s"])
