"""The span stretch: the per-layer metrics that read spans and counters
inside the program (`stereovision_slam_torch/utils/profiling.py`'s
recorder), and what they read.

In a `--trace 1` run on the card, the first of those metrics' readers to
ask (`of(rec)`) runs the stretch once; the readers are called after every
other number of the result line has been taken (the window, the traced
slice, the device's peak memory, the check), so none of them moves. The
stretch runs in a process of its own (`python -m portbench.spans
--stretch`): after a torch.profiler session a CUDA graph's launch stays
about ten times slower for the rest of the process (the keyframe graph's
0.2 ms became 2.3 ms on an H100), and the run has just profiled its traced
slice. There it first warms up as the driver's set-up does (a pipeline that
warms the PGO graph and runs `WARM_FRAMES` frames, so that the process's
first initialization, captures and PGO, which take seconds more, are paid
off the stretch), then turns the recorder on, builds a fresh pipeline of
the cell's configuration and runs one whole drive of the same lap from the
seed: the stereo initialization and the graph captures, `drive_frames`
frames each handed over with its pose read, and the shutdown PGO. Then the
pipeline goes on for `trace_frames` frames of the lap under torch.profiler,
with the host and device counters read around them: the profiled frames,
which the device-trace metrics read, come after every span the other
metrics read. The stretch's process holds itself to the run's rule on
loaded modules before it prints its record: where it has loaded JAX or the
JAX package it exits 3, and so does the run. Where the program has no
recorder (an older checkout), or the run is not a traced run of the loop
driver on the card, there is no stretch and the readers report nothing.

`python -m portbench.spans --workload loop.circuit --seed N --turns K`
measures the cost of tracing in one process that profiles nothing until
its end: the warm-up, then K pairs of drives with the recorder off and
on in turns (off, on, on, off, ...), each drive's frames/s and
95th-percentile frame time; then a stretch drive, its metrics and the
recorder's span table.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

from portbench import harness, scenes, trace
from portbench.program import LapDataset, program_config, program_rig

KEY = "stretch"
STRETCH_TIMEOUT_S = 600
# past the lap's first revisit (112 frames), so that the warm-up also runs
# the hook's attempt graph once
WARM_FRAMES = 160
# the per-layer metrics that read the stretch (`metrics/<name>.py`)
READERS = ("host_wait_ms_per_frame", "kf_launch_ms_p50",
           "kf_device_ms_p50", "ba_device_ms_p50", "ba_overflow_per_pass",
           "hook_device_ms_p50", "init_ms", "pgo_solve_ms", "pgo_host_ms",
           "lk_roofline_pct", "pose_roofline_pct")
# the device kernels of the loop cell's kernels A and B, as the loop
# driver names them
KERNELS = {"A": "lk_pyramid_kernel", "B": "pose_lm_kernel"}


def recorder():
    """The program's recorder module, or None where it has none."""
    from stereovision_slam_torch.utils import profiling
    return profiling if hasattr(profiling, "enable") else None


def _run_args():
    """(workload, seed) of this process's `portbench.run` command line when
    it is a traced run on the card, else None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    try:
        args, _ = ap.parse_known_args(sys.argv[1:])
    except SystemExit:
        return None
    if args.workload is None or args.seed is None or args.trace != 1 \
            or args.device != "cuda":
        return None
    return args.workload, args.seed


def of(rec: dict):
    """The stretch's record for the metrics (run at the first call; None
    where there is none)."""
    if KEY not in rec:
        rec[KEY] = None
        run_args = _run_args()
        if run_args is not None and "frame_lat_s" in rec:
            rec[KEY] = stretch_in_process(*run_args)
    return rec[KEY]


def stretch_in_process(cell: str, seed: int):
    """The stretch of `cell` run by `python -m portbench.spans --stretch` in
    a process of its own; None where the program has no recorder or the
    process fails (the result line then goes out without its metrics).
    Exits 3, as `portbench.run` does, where the stretch's process loaded a
    module of JAX or of the JAX package."""
    from portbench.run import ROOT
    if recorder() is None:
        return None
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "portbench.spans", "--stretch",
           "--workload", cell, "--seed", str(seed)]
    try:
        res = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             text=True, timeout=STRETCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"portbench spans: the stretch took over {STRETCH_TIMEOUT_S} "
              f"s; its metrics are left out", file=sys.stderr)
        return None
    lines = res.stdout.strip().splitlines()
    if res.returncode == 3:
        print("portbench spans: the stretch loaded a module the run may not "
              "load", file=sys.stderr)
        raise SystemExit(3)
    if res.returncode != 0 or not lines:
        print(f"portbench spans: the stretch exited {res.returncode}; its "
              f"metrics are left out", file=sys.stderr)
        return None
    out = json.loads(lines[-1])
    print(f"portbench spans: the stretch ({out['frames']} frames with the "
          f"recorder on, then {out['sub']['frames']} profiled) took "
          f"{time.perf_counter() - t0:.1f} s in its own process; "
          f"{out['checks']}", file=sys.stderr)
    return out


class Stretch:
    """One cell's lap, weights and configuration, and whole drives on fresh
    pipelines over them."""

    def __init__(self, spec: dict, seed: int, device: str):
        import torch

        from stereovision_slam_torch.models import place_net
        self.cfg_file, self.wl = spec["config"], spec["workload"]
        self.dev = torch.device(device)
        self.scene = dict(self.cfg_file["camera"], **self.wl["arena"])
        self.lap_l, self.lap_r = scenes.render_lap(
            self.scene, harness.tex_phase(seed, self.wl["tex_phase"]),
            self.dev)
        self.start = int(harness.rng(seed, 1).integers(
            self.scene["lap_frames"]))
        self.params = place_net.get_params(device=self.dev)
        self.rig = [c.to(self.dev) for c in program_rig(
            self.cfg_file["camera"])]
        self.cfg = program_config(self.cfg_file["slam"])
        self.frames = int(self.wl.get("drive_frames",
                                      self.cfg_file["drive_frames"]))
        self.profiled = int(self.wl["trace_frames"])

    def _pipeline(self):
        """A fresh pipeline of the configuration; its output buffer also
        holds the profiled frames that follow the drive."""
        from stereovision_slam_torch.slam.fused_loop import (
            ScanLoopVisualOdometry)
        caps = self.cfg_file["capacities"]
        vo = ScanLoopVisualOdometry(
            self.cfg, LapDataset(self.rig), place_params=self.params,
            chunk_size=1, max_total_keyframes=caps["max_total_keyframes"],
            max_total_landmarks=caps["max_total_landmarks"],
            max_frames=caps["max_frames"] + self.profiled,
            max_loop_edges=caps["max_loop_edges"],
            num_hypotheses=self.cfg_file["pnp_hypotheses"], device=self.dev)
        vo.initialize()
        return vo

    def _frame(self, vo, t: int) -> tuple:
        """Hand over frame t of the drive and read its pose, as the driver
        does; (seconds, keyframe inserted)."""
        i = (self.start + t) % self.scene["lap_frames"]
        kf0 = vo.kf_count
        a = time.perf_counter()
        vo.step_chunk(self.lap_l[i:i + 1], self.lap_r[i:i + 1], None,
                      np.ones(1, bool), host_fids=[t], n=1)
        row = len(vo._fids) - 1
        vo.out_buf.pose[row].cpu()
        int(vo.out_buf.n_inliers[row])
        return time.perf_counter() - a, vo.kf_count > kf0

    def warm(self) -> None:
        """The set-up's warm-up on a pipeline of its own: the PGO graph
        (`warm_pgo`) and the first `WARM_FRAMES` frames, untraced."""
        vo = self._pipeline()
        vo.warm_pgo(kf_hint=self.wl["pgo_kf_hint"],
                    iters=self.cfg_file["pgo_iters"])
        for t in range(min(WARM_FRAMES, self.frames)):
            self._frame(vo, t)
        harness.synchronize(self.dev)

    def drive(self, traced: bool, profiled: bool = True) -> dict:
        """One whole drive on a fresh pipeline and its PGO, the recorder on
        where `traced` (reset first); with `profiled` (and `traced`), then
        `trace_frames` more frames under torch.profiler. Returns the
        drive's frame times and, traced, what the metrics read."""
        import torch
        prof_mod = recorder()
        profiled = profiled and traced
        if traced:
            prof_mod.reset()
            prof_mod.enable()
        vo = None
        try:
            vo = self._pipeline()
            lat, kfs = [], []
            for t in range(self.frames):
                dt, kf = self._frame(vo, t)
                lat.append(dt)
                kfs.append(kf)
            a = time.perf_counter()
            vo.run_pgo(iters=self.cfg_file["pgo_iters"])
            harness.synchronize(self.dev)
            pgo_s = time.perf_counter() - a
            drive_counts = prof_mod.device_counts() if traced else None
            sub = None
            if profiled:
                sub = _SubSlice(self.dev)
                for t in range(self.frames, self.frames + self.profiled):
                    self._frame(vo, t)
                sub = dict(sub.close(KERNELS), frames=self.profiled)
            records = prof_mod.read() if traced else None
        finally:
            if traced:
                prof_mod.disable()
                prof_mod.reset()
            vo = None
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
        out = dict(frames=self.frames, frame_lat_s=lat, frame_kf=kfs,
                   pgo_s=pgo_s, traced=traced)
        if traced:
            kind = torch.cuda.get_device_name(self.dev) \
                if self.dev.type == "cuda" else "cpu"
            out.update(records=records, drive_device_counts=drive_counts,
                       sub=sub, kind=kind)
            out["checks"] = consistency(out)
        return out


class _SubSlice:
    """The profiled frames: torch.profiler around them, and the recorder's
    counters read before and after."""

    def __init__(self, dev):
        import torch
        from torch.profiler import ProfilerActivity
        self.dev = dev
        prof_mod = recorder()
        harness.synchronize(dev)
        self.counts0 = prof_mod.counts()
        self.dcounts0 = prof_mod.device_counts()
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter_ns()

    def close(self, kernels: dict) -> dict:
        harness.synchronize(self.dev)
        wall_ns = time.perf_counter_ns() - self.t0
        self.prof.__exit__(None, None, None)
        prof_mod = recorder()
        counts, dcounts = prof_mod.counts(), prof_mod.device_counts()
        events = trace._events(self.prof)
        dev = [(n, s, e) for n, d, s, e, ann in events if d and not ann]
        host = [(n, s, e) for n, d, s, e, ann in events if not d]
        lo = min([s for _, s, _ in host + dev], default=0)
        hi = max([e for _, _, e in host + dev], default=0)
        return dict(
            wall_ns=wall_ns, lo_ns=lo, hi_ns=hi,
            busy=trace.union([(s, e) for _, s, e in dev]),
            kernel_ns={k: sum(e - s for n, s, e in dev if pat in n)
                       for k, pat in kernels.items()},
            kernel_ops={k: sum(1 for n, _, _ in dev if pat in n)
                        for k, pat in kernels.items()},
            replay_events=[(s, e) for n, s, e in host
                           if n == "graph.replay"],
            counts={k: v - self.counts0.get(k, 0) for k, v in counts.items()
                    if v != self.counts0.get(k, 0)},
            device_counts={k: v - self.dcounts0.get(k, 0.0)
                           for k, v in dcounts.items()})


# -- what the readers share ---------------------------------------------- #

def read_all(rec: dict) -> dict:
    """{name: value} of every reader of the stretch (`READERS`)."""
    from portbench.run import BENCH, load_file
    return {name: load_file(BENCH / "metrics" / f"{name}.py", name).read(rec)
            for name in READERS}


def dur_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def in_drive(st: dict, request) -> bool:
    """The request is one of the drive's frames (not a profiled one)."""
    return request is not None and request[1] is not None \
        and request[1] < st["frames"]


def by_request(st: dict) -> dict:
    """{request: [host spans]} of the drive's frames' requests (pipeline
    id, frame id)."""
    out: dict = {}
    for s in st["records"]["spans"]:
        if in_drive(st, s["request"]):
            out.setdefault(tuple(s["request"]), []).append(s)
    return out


def keyframe_requests(st: dict) -> set:
    """The requests of the drive's frames that replayed a keyframe graph."""
    return {r for r, ss in by_request(st).items()
            if any(s["name"] == "graph.replay" and "keyframe" in s["attr"]
                   for s in ss)}


def device_spans(st: dict, prefix: str = "") -> list:
    """The device spans of the drive's frames whose name starts with
    `prefix`."""
    return [d for d in st["records"]["device_spans"]
            if in_drive(st, d["request"]) and d["name"].startswith(prefix)]


def device_ms_by_request(st: dict, prefix: str) -> dict:
    """{request: summed ms of the drive's device spans whose name starts
    with `prefix`}."""
    out: dict = {}
    for d in device_spans(st, prefix):
        r = tuple(d["request"])
        out[r] = out.get(r, 0.0) + d["ms"]
    return out


def span_ms(st: dict, name: str) -> float:
    """The summed ms of the host spans named `name` outside the profiled
    frames."""
    return sum(dur_ms(s) for s in st["records"]["spans"]
               if s["name"] == name and (s["request"] is None
                                         or s["request"][1] is None
                                         or in_drive(st, s["request"])))


def on_profiler_clock(st: dict, name: str | None = None) -> list:
    """[(start, end)] of the host spans (named `name`, or all) on the
    profiler's clock."""
    records = st["records"]
    off = records["epoch_offset_ns"]
    return [(s["start_ns"] + off, s["end_ns"] + off)
            for s in records["spans"] if name is None or s["name"] == name]


def idle(sub: dict) -> list:
    """The device-idle stretches of the profiled frames, [(start, end)]."""
    edges = [sub["lo_ns"]] + [x for s, e in sub["busy"] for x in (s, e)] \
        + [sub["hi_ns"]]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sets of intervals (each merged
    first)."""
    a, b = trace.union(a), trace.union(b)
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def consistency(st: dict) -> dict:
    """The stretch's own checks: the PGO's parts against the host clock's
    `run_pgo`, the device spans of each keyframe frame within its
    first-to-last stretch, the idle time of the profiled frames that the
    program's spans cover, and the spans' clock against the profiler's own
    `graph.replay` events."""
    rec, sub = st["records"], st["sub"]
    parts = sum(span_ms(st, f"pgo.{p}")
                for p in ("drain", "assemble", "solve", "reanchor"))
    frames = {tuple(d["request"]): d["ms"] for d in rec["device_frames"]
              if in_drive(st, d["request"])}
    summed = device_ms_by_request(st, "")
    worst = max((summed[r] - frames.get(r, 0.0) for r in summed),
                default=0.0)
    out = dict(pgo_parts_over_run_pgo=parts / (1e3 * st["pgo_s"]),
               kf_device_spans_over_window_ms=worst)
    if sub:
        gaps = idle(sub)
        total = sum(b - a for a, b in gaps)
        out["idle_in_spans_pct"] = 100.0 * overlap_ns(
            gaps, on_profiler_clock(st)) / total if total else None
        ours = [s for s, _ in on_profiler_clock(st, "graph.replay")
                if sub["lo_ns"] <= s <= sub["hi_ns"]]
        if ours and sub["replay_events"]:
            out["replay_clock_gap_ms_p50"] = float(np.median(
                [min(abs(a - b) for b in ours) / 1e6
                 for a, _ in sub["replay_events"]]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="loop.circuit")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--stretch", action="store_true",
                    help="run the stretch alone and print its record as "
                         "the last line (JSON)")
    ap.add_argument("--turns", type=int, default=2,
                    help="pairs of drives, recorder off and on")
    args = ap.parse_args(argv)
    import torch

    from portbench.run import cell_spec, forbidden_modules
    if recorder() is None or not torch.cuda.is_available():
        print("portbench spans: needs the program's recorder and a CUDA "
              "device", file=sys.stderr)
        return 2
    st = Stretch(cell_spec(args.workload), args.seed, "cuda")
    st.warm()
    if not args.stretch:
        runs = []
        for traced in ([False, True, True, False] * args.turns)[
                :2 * args.turns]:
            lat = st.drive(traced=traced, profiled=False)["frame_lat_s"]
            runs.append(dict(traced=traced, frames_per_s=len(lat) / sum(lat),
                             frame_ms_p95=1e3 * harness.quantile(lat, 0.95)))
            print(json.dumps(runs[-1]), flush=True)
        for traced in (False, True):
            sel = [r for r in runs if r["traced"] is traced]
            print(f"recorder {'on ' if traced else 'off'}: frames/s "
                  f"{[round(r['frames_per_s'], 2) for r in sel]}, p95 ms "
                  f"{[round(r['frame_ms_p95'], 3) for r in sel]}")
    try:
        out = st.drive(traced=True)
    except Exception:
        traceback.print_exc()
        return 1
    if args.stretch:
        found = forbidden_modules()
        if found:
            print(f"portbench spans: modules loaded that the run may not "
                  f"load: {found}", file=sys.stderr)
            return 3
        print(json.dumps(out))
        return 0
    print(json.dumps({"checks": out["checks"]}))
    print(json.dumps({"stretch_metrics": read_all({KEY: out})}))
    print(recorder().report(out["records"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
