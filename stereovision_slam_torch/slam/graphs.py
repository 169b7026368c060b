"""CUDA graphs over a pipeline's state (the port's counterpart of the
reference's `jax.jit` of a chunk or of `run_pgo`).

A `GraphRunner` runs functions of no arguments that read the pipeline's
static tensors (its state, the frame buffers, the id scalars) and return
the writes that end them: a pair `(dst, src)` copies `src` into `dst` leaf
by leaf (tensors, or tuples and NamedTuples of them), a triple `(dst, idx,
src)` writes `src` into row `idx` (a 0-d index tensor) of `dst`. The state
therefore keeps its addresses from one call to the next.

On the card the first call of a key warms the function up eagerly on a side
stream (its writes are dropped: one real evaluation, whose kernel launches
count), captures it on that stream with `torch.cuda.CUDAGraph` into the
runner's one memory pool, and replays it; every later call is one
`graph.replay()`. A failed
capture raises: nothing runs eagerly in its place. The kernel wrappers count
their launches as Python calls, which a replay does not make, so the runner
takes back the count that the capture added and adds it again on every
replay; the recorder's host counters (`utils/profiling.py`) are taken back
and added again in the same way. A graph captured while the recorder is on
holds its device spans and counters, and is kept under `Traced(key)`, so
that a replay with the recorder off never runs one. On the CPU the runner
calls the function and makes its writes.

Inside a captured function nothing may read the device from the host, copy
host data to the device, size an output by the data, or check a
linear-algebra result on the host; tests/test_torch_scan.py finds such
operators on the CPU (`capture_lint`).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from stereovision_slam_torch.ops import ba_kernel, lk_lanes, pose_kernel
from stereovision_slam_torch.utils import profiling

KERNEL_MODULES = (lk_lanes, pose_kernel, ba_kernel)  # A, B and BA


class Traced(NamedTuple):
    """The key of a graph captured with the recorder on."""
    key: object


def leaves(x) -> list:
    """The tensors of a tensor or a (nested) tuple of them, in order."""
    if x is None:
        return []
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in leaves(v)]


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def write(writes) -> None:
    """Make the writes of a captured function (see the module docstring).
    A source that lives in the storage of another write's destination is
    copied first, so that every source is read before any destination is
    written."""
    pairs, rows = [], []
    for w in writes:
        if len(w) == 2:
            d, s = leaves(w[0]), leaves(w[1])
            if len(d) != len(s):
                raise ValueError(f"write: {len(s)} sources for {len(d)} "
                                 "destinations")
            pairs += [(a, b) for a, b in zip(d, s) if a is not b]
        else:
            rows.append(w)
    for a, b in pairs:
        if a.shape != b.shape:
            raise ValueError(f"write: a {tuple(b.shape)} source for a "
                             f"{tuple(a.shape)} destination")
    rows = [(d, i, s if torch.is_tensor(s) else torch.full(
        (), s, dtype=d.dtype, device=d.device)) for d, i, s in rows]
    dst = {_ptr(a) for a, _ in pairs} | {_ptr(r[0]) for r in rows}
    pairs = [(a, b.clone() if _ptr(b) in dst else b) for a, b in pairs]
    rows = [(d, i.clone() if _ptr(i) in dst else i,
             s.clone() if _ptr(s) in dst else s) for d, i, s in rows]
    for a, b in pairs:
        a.copy_(b)
    for d, i, s in rows:
        d.index_copy_(0, i.reshape(1).to(torch.int64),
                      s.to(d.dtype).expand(d.shape[1:]).unsqueeze(0))


@contextlib.contextmanager
def _linalg_on_cusolver():
    """cuSOLVER and cuBLAS for the dense solves while a function is warmed
    up and captured: MAGMA, PyTorch's other backend for small batched
    factorizations, may synchronize."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


class GraphRunner:
    """Captured functions of one pipeline, by key, in one memory pool.

    `replays` counts graph replays, `captures` the graphs captured,
    `capture_s` the host time of their warm-ups and captures, and
    `warm_launches` the kernel launches of the warm-ups, by module name.
    Each replay is a `graph.replay` span of the recorder (the key as its
    attribute), each warm-up and capture a `graph.capture` span, and the
    capture within it a `graph.record` span (kernel wrappers called there
    launch nothing)."""

    def __init__(self, device, modules=KERNEL_MODULES):
        self.device = torch.device(device)
        self.modules = tuple(modules)
        self.graphs: dict = {}
        self.per_replay: dict = {}
        self.device_spans: dict = {}
        self.replays = 0
        self.captures = 0
        self.capture_s = 0.0
        self.warm_launches = {m.__name__: 0 for m in self.modules}
        self._pool = None

    def _counts(self) -> dict:
        """The host counters a capture may move: the kernel modules' launch
        counts (by module) and the recorder's counters (by name)."""
        return {**{m: m.launch_count for m in self.modules},
                **profiling.counts()}

    @staticmethod
    def _add(counts: dict) -> None:
        for k, n in counts.items():
            if isinstance(k, str):
                profiling.count(k, n)
            else:
                k.launch_count += n

    def run(self, key, fn, warm=None) -> None:
        """Run `fn` (on the card: its graph for `key`, captured at the first
        call after a warm-up of `warm`, or of `fn` when None)."""
        if self.device.type != "cuda":
            write(fn())
            return
        traced = profiling.enabled()
        if traced:
            key = Traced(key)
        graph = self.graphs.get(key)
        if graph is None:
            with profiling.span("graph.capture", key):
                graph = self._capture(key, fn, warm or fn)
        if traced:
            pairs = self.device_spans.get(key)
            profiling.before_replay(pairs)
            with profiling.span("graph.replay", key) as sp:
                graph.replay()
            profiling.replayed(pairs, sp.index)
        else:
            graph.replay()
        self.replays += 1
        self._add(self.per_replay[key])

    def _capture(self, key, fn, warm):
        t0 = time.perf_counter()
        dev = self.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        profiling.prepare(dev)
        c0 = self._counts()
        with torch.cuda.stream(side), _linalg_on_cusolver():
            warm()
        c1 = self._counts()
        for m in self.modules:
            self.warm_launches[m.__name__] += c1[m] - c0[m]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # `torch.cuda.graph` would also synchronize and empty the
        # allocator's caches before each capture; these captures share one
        # pool and need neither
        try:
            with torch.cuda.stream(side), _linalg_on_cusolver(), \
                    profiling.capturing() as pairs, \
                    profiling.span("graph.record", key):
                graph.capture_begin(pool=self._pool)
                try:
                    write(fn())
                finally:
                    graph.capture_end()
        finally:
            c2 = self._counts()
            # the capture launched and counted nothing
            self._add({k: c1.get(k, 0) - n for k, n in c2.items()})
        main.wait_stream(side)
        self.per_replay[key] = {k: n - c1.get(k, 0) for k, n in c2.items()
                                if n != c1.get(k, 0)}
        if pairs:
            self.device_spans[key] = pairs
        self.graphs[key] = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph
