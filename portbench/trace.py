"""The device's view of a slice of a run, from torch.profiler's trace.

`profile(fn)` runs `fn` under the profiler (CPU and CUDA activities) and
reduces the trace: the seconds in which any device operation ran (the
union of their intervals), the slice's wall time on the host clock (ending
in a synchronize), the device operations that took most time, the device's
idle time by what the host was doing meanwhile (the innermost host
operation that covers each gap's middle), and how many device operations
carry each of the given kernel names (to hold against the launch
counters: the profiler may miss kernels launched through ctypes).
"""

from __future__ import annotations

import bisect
import time

import torch

TOP = 10
SHORT_GAP_NS = 10_000
SHORT_GAP = "between device operations (gaps under 10 us)"


def _events(prof):
    """(name, is_device, start_ns, end_ns, annotation) of every event."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        out.append((e.name(), dev, int(e.start_ns()), int(e.end_ns()),
                    bool(e.is_user_annotation())))
    return out


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps_by_host(busy, host, lo: int, hi: int):
    """{label: idle ns}: the idle stretches of [lo, hi) outside `busy`,
    each given to the innermost host event (name, start, end) that covers
    its middle, or to "host (no traced operation)"."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out: dict = {}
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            label = SHORT_GAP
        else:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for name, s, e in host[max(0, i - 64):i]:
                if s <= mid < e and (best is None or e - s < best[1]):
                    best = (name, e - s)
            label = best[0] if best else "host (no traced operation)"
        out[label] = out.get(label, 0) + (b - a)
    return out


def reduce(events, wall_s: float, kernel_names: dict) -> dict:
    dev = [(n, s, e) for n, d, s, e, ann in events if d and not ann]
    host = [(n, s, e) for n, d, s, e, ann in events if not d]
    busy = union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: dict = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    lo = min([s for _, s, _ in host + dev], default=0)
    hi = max([e for _, _, e in host + dev], default=0)
    idle = gaps_by_host(busy, host, lo, hi) if dev else {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    seen = {k: sum(1 for n, _, _ in dev if pat in n)
            for k, pat in kernel_names.items()}
    return dict(busy_s=busy_s, traced_s=wall_s,
                breakdown={"device_ops": [[n[:120], v / 1e9] for n, v in top],
                           "idle_gaps": [[n[:120], v / 1e9]
                                         for n, v in gaps]},
                kernels_seen=seen,
                kernel_device_s={k: sum(e - s for n, s, e in dev if pat in n)
                                 / 1e9 for k, pat in kernel_names.items()})


def profile(fn, device, kernel_names: dict) -> dict:
    """Run `fn()` under torch.profiler and reduce its trace (see the module
    docstring); `kernel_names` maps a short name to a substring of the
    device kernel's name."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return reduce(_events(prof), wall, kernel_names)
