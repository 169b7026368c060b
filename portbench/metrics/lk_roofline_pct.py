"""Kernels: kernel A's share of its roofline over the span stretch's
profiled frames: the least time of their launches (`roofline.bound_ms`
of the launches' summed bytes and summed operations; the program counts
each launch's bytes and, on the device, its iterations over points and
levels; `roofline.lk_counts` turns them into operations) over the
kernel's device time in the same frames, percent. The least time of the
sums is at most the sum of the launches' least times, so the share
under-reads."""

import torch

from portbench import roofline, spans

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "frames_per_s"


def operations(tag: str, launches: float, iterations: float) -> float:
    """The operations of `launches` calls of the shape `tag`
    ("L<levels>.n<points>.win<window>") that took `iterations` in all."""
    L, n, win = (int(p[p.index(c) + len(c):]) for p, c in
                 zip(tag.split("."), ("L", "n", "win")))
    rows = torch.zeros((L, n, 6), dtype=torch.float64)
    _, base = roofline.lk_counts(([], []), rows, win)
    rows[0, 0, 5] = iterations
    _, first = roofline.lk_counts(([], []), rows, win)
    return launches * base + (first - base)


def read(rec: dict):
    st = spans.of(rec)
    if st is None or not st.get("sub"):
        return None
    sub = st["sub"]
    nbytes = flops = 0.0
    for name, n in sub["counts"].items():
        if name.startswith("kernel.A.launches["):
            tag = name[len("kernel.A.launches["):-1]
            nbytes += sub["counts"].get(f"kernel.A.bytes[{tag}]", 0)
            flops += operations(tag, n, sub["device_counts"].get(
                f"kernel.A.iterations[{tag}]", 0.0))
    device_ms = sub["kernel_ns"]["A"] / 1e6
    if not device_ms or not nbytes:
        return None
    least, _ = roofline.bound_ms(nbytes, flops, roofline.peaks(st["kind"]))
    return 100.0 * least / device_ms
