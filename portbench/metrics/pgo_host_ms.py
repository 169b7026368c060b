"""Pose graph: the host's milliseconds in the `pgo.drain`, `pgo.assemble`
and `pgo.reanchor` spans (the state read to the host, the graph built in
numpy, the landmarks moved with their keyframes) of the span stretch's
shutdown PGO."""

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "pose graph"
MOVES = "frames_per_s"


def read(rec: dict):
    st = spans.of(rec)
    if st is None:
        return None
    return sum(spans.span_ms(st, f"pgo.{p}")
               for p in ("drain", "assemble", "reanchor")) or None
