"""Graph runner: CUDA graph replays (`GraphRunner.replays`) over the window
per frame."""

UNIT, BETTER, SOURCE = "replays/frame", "lower", "program_counter"
LAYER = "graph runner"
MOVES = "frames_per_s"


def read(rec: dict):
    if "graph_replays" not in rec:
        return None
    return rec["graph_replays"] / rec["frames"]
