"""Graph runner: the host seconds of the graphs' warm-ups and captures
(`GraphRunner.capture_s`) of each drive that started in the window, their
mean; nothing where no drive started in it."""

UNIT, BETTER, SOURCE = "s", "lower", "program_counter"
LAYER = "graph runner"
MOVES = "frames_per_s"


def read(rec: dict):
    caps = rec.get("capture_s_drives")
    return sum(caps) / len(caps) if caps else None
