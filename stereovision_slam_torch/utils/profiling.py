"""Profiling and tracing (counterpart of `utils/profiling.py`).

Per-stage wall-clock timers with summary statistics, and a thin wrapper
over `torch.profiler` that writes a Chrome trace (the reference wraps
`jax.profiler`). A stage that runs on the card is timed only when its work
is done: give `StageTimer` the device, and it calls
`torch.cuda.synchronize()` before it reads the clock at either end (without
it a stage times the launches, not the work).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    """Accumulates wall-clock samples per named stage; `device` names the
    device whose queue is drained before each clock reading (a CUDA
    device), or None."""

    def __init__(self, device: str | torch.device | None = None):
        self.samples: dict[str, list[float]] = defaultdict(list)
        dev = None if device is None else torch.device(device)
        self._sync = dev is not None and dev.type == "cuda"

    def _clock(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.samples[stage].append(self._clock() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs)
            out[stage] = {
                "count": int(a.size),
                "total_s": float(a.sum()),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>7}{'mean ms':>10}{'p50 ms':>10}"
                 f"{'p95 ms':>10}{'total s':>10}"]
        for stage, s in sorted(self.summary().items(),
                               key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{stage:<24}{s['count']:>7}{s['mean_ms']:>10.2f}"
                         f"{s['p50_ms']:>10.2f}{s['p95_ms']:>10.2f}"
                         f"{s['total_s']:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with `torch.profiler` (host, and the card where
    there is one) and write a Chrome trace `trace.json` into log_dir.
    Yields the profiler (its `key_averages()` give the tables)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
