"""Profiling and tracing (counterpart of `utils/profiling.py`).

The recorder: spans and counters inside the program, off unless `enable()`
is called (`disable()`, `reset()` and `read()` complete it). While it is off
a call site costs one attribute test: `span()` and `device_span()` return
one shared no-op object, and `count()`, `device_count()` return at once.

* `span(name, attr, request=)`: a host span, on `time.perf_counter_ns()`,
  with the index of the span that encloses it and the request it belongs
  to (the pipeline's id and a frame id, which a span given `request=` sets
  for everything inside it). While a `torch.profiler` session is active it
  also opens `torch.profiler.record_function(name)`, so that a device
  trace holds the program's names around the device operations. `enable()`
  takes one pair of (`perf_counter_ns`, `time_ns`) readings: `read()`
  gives the offset that puts every span on the profiler's clock (kineto's
  host events carry Unix-epoch nanoseconds).
* `device_span(name)`: a stage inside a function that `slam/graphs.py`'s
  `GraphRunner` captures. Inside a capture it records a pair of timed
  external CUDA events, which become event-record nodes of the graph, so
  every replay times the stage again on the device; the runner hands each
  replay's pair to `replayed()`. Elapsed times are read lazily: before the
  next replay of the same graph, when the next request starts, or at
  `read()`; where the device has not finished them, the read waits for the
  end event (a cost of tracing only). Outside a capture (eager calls, the
  CPU) a device span is a host span marked `"device@host"`: its number is a
  host time.
* `count(name, n)`: a host counter. The runner takes back what a capture
  counted and adds it again on every replay, as it does the kernel
  modules' `launch_count`.
* `device_count(name, t)`: adds a 0-d tensor (or a number) into a float64
  accumulator on the tensor's device, allocated outside any capture
  (`prepare`); it counts what ran on the device, the warm-up and every
  replay, not the capture. Read once, at `read()`.

A graph records its event nodes and counter adds only when the recorder
was on at its capture; the runner keys its graphs on that.

Also per-stage wall-clock timers with summary statistics (`StageTimer`),
and a wrapper over `torch.profiler` that writes a Chrome trace of spans
and kernels (`device_trace`; the reference wraps `jax.profiler`). A stage
that runs on the card is timed only when its work is done: give
`StageTimer` the device, and it calls `torch.cuda.synchronize()` before it
reads the clock at either end (without it a stage times the launches, not
the work).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict

import numpy as np
import torch

DEVICE_COUNTERS = 256       # slots of a device's accumulator


def clock_pair() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) at one instant: of a few readings, the
    one whose two perf_counter_ns readings around time_ns lie closest (a
    thread preempted between two readings would shift every span)."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, t)
    return best[1], best[2]


class _NoSpan:
    """The shared span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Recorder:
    """Spans and counters of the program (see the module docstring); one
    per process, `RECORDER`."""

    def __init__(self):
        self.on = False
        self.acc: dict = {}     # device -> float64 accumulator
        self.slots: dict = {}   # device counter name -> accumulator slot
        self.reset()

    def reset(self) -> None:
        """Drop every record and zero the device accumulators in place (the
        captured graphs hold their addresses and slots)."""
        self.spans: list = []       # (name, t0, t1, parent, request, attr,
        #                             kind), by index
        self.stack: list[int] = []  # indices of the open host spans
        self.request = None
        self.counts: dict = {}
        self.device_spans: list = []   # (name, ms, request, parent)
        self.device_frames: list = []  # (request, ms first start -> last end)
        self.pending: list = []        # (request, parent, [(name, e0, e1)])
        self.capture: list | None = None
        for acc in self.acc.values():
            acc.zero_()
        self.clock = clock_pair()

    # -- device spans ---------------------------------------------------- #

    def collect(self) -> None:
        """Read the elapsed times of the pending replays' device spans, and
        each request's first-start-to-last-end stretch."""
        if not self.pending:
            return
        by_request: dict = {}
        for request, parent, pairs in self.pending:
            for name, e0, e1 in pairs:
                e1.synchronize()
                self.device_spans.append((name, e0.elapsed_time(e1), request,
                                          parent))
            first = by_request.get(request, (pairs[0][1],))[0]
            by_request[request] = (first, pairs[-1][2])
        for request, (e0, e1) in by_request.items():
            self.device_frames.append((request, e0.elapsed_time(e1)))
        self.pending = []

    # -- device counters ------------------------------------------------- #

    def prepare(self, device) -> torch.Tensor:
        """The accumulator of `device`, allocated on first use (never
        inside a capture: the runner calls this before it captures)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        acc = self.acc.get(dev)
        if acc is None:
            acc = self.acc[dev] = torch.zeros(DEVICE_COUNTERS,
                                              dtype=torch.float64, device=dev)
        return acc

    def device_count(self, name: str, value, device=None) -> None:
        dev = value.device if torch.is_tensor(value) else device
        slot = self.slots.get(name)
        if slot is None:
            if len(self.slots) >= DEVICE_COUNTERS:
                raise RuntimeError(f"device_count: more than "
                                   f"{DEVICE_COUNTERS} device counters")
            slot = self.slots[name] = len(self.slots)
        cell = self.prepare(dev).narrow(0, slot, 1)
        if torch.is_tensor(value):
            cell.add_(value.detach().reshape(1).to(torch.float64))
        else:
            cell.add_(float(value))

    def device_counts(self) -> dict:
        """{name: value} of the device counters (one read per device)."""
        out: dict = {}
        for acc in self.acc.values():
            vals = acc.cpu().tolist()
            for name, slot in self.slots.items():
                out[name] = out.get(name, 0.0) + vals[slot]
        return out

    # -- reading --------------------------------------------------------- #

    def read(self) -> dict:
        """The records as plain Python data: `spans` (dicts of name,
        start_ns, end_ns on `perf_counter_ns`, parent index or -1,
        request, attr, kind "host" or "device@host"), `epoch_offset_ns`
        (add it to a span's times to put them on the profiler's clock),
        `device_spans` (name, ms, request, parent: the graph.replay span
        that ran it), `device_frames` (request, ms from the first device
        span's start to the last one's end), `counts` and
        `device_counts`."""
        self.collect()
        dev_counts = self.device_counts()
        keys = ("name", "start_ns", "end_ns", "parent", "request", "attr",
                "kind")
        now = time.perf_counter_ns()
        spans = [dict(zip(keys, s if s is not None else (
            "(open)", now, now, -1, None, None, "open"))) for s in self.spans]
        for s in spans:
            if s["attr"] is not None:
                s["attr"] = str(s["attr"])
        return dict(
            spans=spans, epoch_offset_ns=self.clock[1] - self.clock[0],
            device_spans=[dict(zip(("name", "ms", "request", "parent"), d))
                          for d in self.device_spans],
            device_frames=[dict(request=r, ms=ms)
                           for r, ms in self.device_frames],
            counts=dict(self.counts), device_counts=dev_counts)


RECORDER = Recorder()
_pipeline_ids = itertools.count()


class _Span:
    """An open host span (see `span`)."""

    __slots__ = ("name", "attr", "kind", "request", "index", "saved", "t0",
                 "rf")

    def __init__(self, name: str, attr=None, request=None,
                 kind: str = "host"):
        self.name, self.attr, self.kind = name, attr, kind
        self.request = request

    def __enter__(self):
        rec = RECORDER
        if self.request is not None and rec.pending:
            rec.collect()       # the previous request's device spans
        self.index = len(rec.spans)
        rec.spans.append(None)
        self.saved = rec.request
        if self.request is not None:
            rec.request = self.request
        rec.stack.append(self.index)
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        rec = RECORDER
        rec.stack.pop()
        parent = rec.stack[-1] if rec.stack else -1
        rec.spans[self.index] = (self.name, self.t0, t1, parent,
                                 rec.request, self.attr, self.kind)
        rec.request = self.saved
        return False


class _DeviceSpan:
    """A stage of a function under capture: a pair of timed external CUDA
    events around it, which the capture records as graph nodes."""

    __slots__ = ("name", "e0", "e1")

    def __init__(self, name: str):
        self.name = name
        self.e0 = torch.cuda.Event(enable_timing=True, external=True)
        self.e1 = torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.e0.record()
        RECORDER.capture.append((self.name, self.e0, self.e1))
        return self

    def __exit__(self, *exc):
        self.e1.record()
        return False


# -- the recorder's interface ------------------------------------------- #

def enable() -> None:
    """Turn the recorder on; the clock pair for `read()` is taken now."""
    RECORDER.on = True
    RECORDER.clock = clock_pair()


def disable() -> None:
    RECORDER.on = False


def reset() -> None:
    RECORDER.reset()


def read() -> dict:
    return RECORDER.read()


def enabled() -> bool:
    return RECORDER.on


def pipeline_id() -> int:
    """A new pipeline's id, the first half of its spans' requests."""
    return next(_pipeline_ids)


def span(name: str, attr=None, request=None):
    """A host span around a `with` block (see the module docstring)."""
    if not RECORDER.on:
        return NO_SPAN
    return _Span(name, attr, request)


def device_span(name: str):
    """A device-timed stage inside a captured function; a host span marked
    "device@host" elsewhere."""
    if not RECORDER.on:
        return NO_SPAN
    if RECORDER.capture is not None:
        return _DeviceSpan(name)
    return _Span(name, kind="device@host")


def count(name: str, n=1) -> None:
    """Add `n` to the host counter `name`."""
    if RECORDER.on:
        RECORDER.counts[name] = RECORDER.counts.get(name, 0) + n


def device_count(name: str, value, device=None) -> None:
    """Add a tensor's value (any shape of one element; or a number on
    `device`) into the device counter `name`, on the device."""
    if RECORDER.on:
        RECORDER.device_count(name, value, device)


def kernel_launch(kernel: str, tag: str, tensors, **work) -> None:
    """The recorder's counters of one launch of kernel `kernel` whose shape
    and settings `tag` names: `kernel.<kernel>.launches[<tag>]`,
    `kernel.<kernel>.bytes[<tag>]` (each argument and output tensor's bytes
    once) and, for each `work` entry (a device tensor), the device counter
    `kernel.<kernel>.<entry>[<tag>]`."""
    if not RECORDER.on:
        return
    count(f"kernel.{kernel}.launches[{tag}]")
    count(f"kernel.{kernel}.bytes[{tag}]",
          sum(t.numel() * t.element_size() for t in tensors))
    for name, value in work.items():
        RECORDER.device_count(f"kernel.{kernel}.{name}[{tag}]", value)


def host_read(name: str, x, cast=bool, counts: dict | None = None):
    """`cast(x)`: a device->host read that decides a branch, counted under
    `name` in `counts` where given, inside a `host_read.<name>` span while
    the recorder is on."""
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
    if not RECORDER.on:
        return cast(x)
    with _Span("host_read." + name):
        return cast(x)


def counts() -> dict:
    """A copy of the host counters (empty while the recorder is off)."""
    return dict(RECORDER.counts) if RECORDER.on else {}


def device_counts() -> dict:
    """The device counters, read to the host now."""
    return RECORDER.device_counts()


# -- what the graph runner calls ---------------------------------------- #


def prepare(device) -> None:
    """Allocate `device`'s counter accumulator before a capture."""
    if RECORDER.on:
        RECORDER.prepare(device)


@contextlib.contextmanager
def capturing():
    """Collects the device spans that a capture records; yields their
    list, [(name, start event, end event)] in the order of the stream."""
    rec = RECORDER
    saved, rec.capture = rec.capture, []
    try:
        yield rec.capture
    finally:
        rec.capture = saved


def before_replay(pairs) -> None:
    """Read the pending device spans if this graph's events are among them
    (a replay records its events anew)."""
    rec = RECORDER
    if pairs and any(p is pairs for _, _, p in rec.pending):
        rec.collect()


def replayed(pairs, parent: int) -> None:
    """A replay of a graph whose device spans are `pairs` was enqueued
    inside the host span with index `parent`."""
    if pairs:
        RECORDER.pending.append((RECORDER.request, parent, pairs))


# -- summaries ----------------------------------------------------------- #

def self_ns(spans: list) -> list:
    """Each host span's self time: its duration minus what its child spans
    cover (spans of one thread nest, so children are disjoint)."""
    out = [s["end_ns"] - s["start_ns"] for s in spans]
    for s in spans:
        if s["parent"] >= 0:
            out[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return out


def summary(records: dict) -> dict:
    """{span name: count, total_ms, p50_ms, p95_ms, self_ms} of `read()`'s
    host spans, and of its device spans under "device:<name>"."""
    spans = records["spans"]
    selfs = self_ns(spans)
    groups: dict = defaultdict(lambda: ([], []))
    for s, own in zip(spans, selfs):
        d, o = groups[s["name"]]
        d.append((s["end_ns"] - s["start_ns"]) / 1e6)
        o.append(own / 1e6)
    for d in records["device_spans"]:
        dd, oo = groups["device:" + d["name"]]
        dd.append(d["ms"])
        oo.append(d["ms"])
    out = {}
    for name, (d, o) in groups.items():
        a = np.asarray(d)
        out[name] = {"count": int(a.size), "total_ms": float(a.sum()),
                     "p50_ms": float(np.percentile(a, 50)),
                     "p95_ms": float(np.percentile(a, 95)),
                     "self_ms": float(np.sum(o))}
    return out


def report(records: dict) -> str:
    """`summary` as a table, by total time."""
    lines = [f"{'span':<28}{'count':>7}{'total ms':>11}{'p50 ms':>9}"
             f"{'p95 ms':>9}{'self ms':>11}"]
    for name, s in sorted(summary(records).items(),
                          key=lambda kv: -kv[1]["total_ms"]):
        lines.append(f"{name[:28]:<28}{s['count']:>7}{s['total_ms']:>11.2f}"
                     f"{s['p50_ms']:>9.3f}{s['p95_ms']:>9.3f}"
                     f"{s['self_ms']:>11.2f}")
    return "\n".join(lines)


class StageTimer:
    """Accumulates wall-clock samples per named stage; `device` names the
    device whose queue is drained before each clock reading (a CUDA
    device), or None. Each stage is also a span of the recorder while it
    is on."""

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
            with span(stage):
                try:
                    yield
                finally:
                    t1 = self._clock()
        finally:
            self.samples[stage].append(t1 - t0)

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
    there is one) and write a Chrome trace `trace.json` into log_dir, with
    the recorder on for the block (turned off after it unless it was on
    before), so that the trace holds the program's spans beside the
    kernels. Yields the profiler (its `key_averages()` give the tables)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = RECORDER.on
    if not was_on:
        enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
