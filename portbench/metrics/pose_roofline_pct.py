"""Kernels: kernel B's share of its roofline over the span stretch's
profiled frames: the least time of their launches (`roofline.bound_ms`
of the launches' summed bytes and summed operations; the program counts
each launch's bytes and, on the device, its valid observations;
`roofline.pose_counts` turns them into operations for the launch's starts
and passes) over the kernel's device time in the same frames, percent.
The least time of the sums is at most the sum of the launches' least
times, so the share under-reads."""

import torch

from portbench import roofline, spans

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "frames_per_s"


def operations(tag: str, observations: float) -> float:
    """The operations of the calls of the shape `tag`
    ("S<starts>.r<rounds>.i<iters>") over `observations` valid
    observations in all."""
    S, rounds, iters = (int(p[len(c):]) for p, c in
                        zip(tag.split("."), ("S", "r", "i")))
    f64 = torch.float64
    args = [torch.zeros(0)] * 4 + [torch.tensor([observations], dtype=f64),
                                   torch.zeros(1, dtype=f64),
                                   torch.zeros((S, 3, 4))]
    _, flops = roofline.pose_counts(args, [], dict(rounds=rounds,
                                                   iters=iters))
    return flops


def read(rec: dict):
    st = spans.of(rec)
    if st is None or not st.get("sub"):
        return None
    sub = st["sub"]
    nbytes = flops = 0.0
    for name in sub["counts"]:
        if name.startswith("kernel.B.launches["):
            tag = name[len("kernel.B.launches["):-1]
            nbytes += sub["counts"].get(f"kernel.B.bytes[{tag}]", 0)
            flops += operations(tag, sub["device_counts"].get(
                f"kernel.B.observations[{tag}]", 0.0))
    device_ms = sub["kernel_ns"]["B"] / 1e6
    if not device_ms or not nbytes:
        return None
    least, _ = roofline.bound_ms(nbytes, flops, roofline.peaks(st["kind"]))
    return 100.0 * least / device_ms
