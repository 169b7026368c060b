"""Loop hook: its device-to-host reads (`hook_reads`) over the window per
keyframe inserted."""

UNIT, BETTER, SOURCE = "reads/kf", "lower", "program_counter"
LAYER = "loop hook"
MOVES = "frame_ms_p95"


def read(rec: dict):
    if not rec.get("keyframes"):
        return None
    return rec["hook_reads"] / rec["keyframes"]
