"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout. The cell's entry in `BENCHMARK.json` names its
configuration (`configs/<config>.json`) and `workloads/<cell>.json` names
its driver (`drivers/<driver>.py`) and traffic. A run loads, warms up,
measures for `--seconds`, then, with `--trace 1`, profiles a steady slice
after the window; reads the peak device memory, frees the program's state,
and holds what the window produced against the plain reference
(`reference/`). The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones, each read by `metrics/<name>.py`)
and `device`, then `checks` (each compared number beside its limit). The
compared numbers are also the last lines of standard error.

Exits 2 without a result when no CUDA device (or fewer than the cell asks
for) is present, and 3 when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# Build and kernel caches of the program live at fixed paths inside the
# checkout, so that only a cell's first run there builds.
CACHE = BENCH / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "stereovision_slam_tpu")


def process_start() -> float:
    """This process's start on the `time.time()` clock (from /proc), or
    now where /proc does not say."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        btime = next(int(ln.split()[1]) for ln in
                     Path("/proc/stat").read_text().splitlines()
                     if ln.startswith("btime "))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_file(path: Path, name: str):
    """The module of a file found by name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench._loaded.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(cell: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, workload
    file and metric entries; raises KeyError for an unknown cell."""
    bench = read_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    workload = read_json(root / "portbench" / "workloads" / f"{cell}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{cell}.json: {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")

    # a metric without a "workloads" list belongs to every cell (end to
    # end) or to every cell that reports the metric it moves (per layer)
    every = [w["name"] for w in bench["workloads"]]
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", every)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return dict(entry=entry, config=read_json(root / config["file"]),
                workload=workload, end_to_end=e2e, per_layer=per_layer)


def metric_values(entries: list, rec: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader
    (`metrics/<name>.py`, `read(rec)`) finds something to read."""
    out = {}
    for m in entries:
        mod = load_file(root / "portbench" / "metrics" / f"{m['name']}.py",
                        m["name"])
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda; cpu only for the tests' rehearsals, which "
                         "print no device metric")
    args = ap.parse_args(argv)

    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    spec = cell_spec(args.workload)
    chips = int(spec["entry"]["chips"])
    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    drv_name = spec["workload"]["driver"]
    drv_mod = load_file(BENCH / "drivers" / f"{drv_name}.py", drv_name)
    drv = drv_mod.Driver(spec, seed=args.seed, device=args.device)

    t_drv = time.time()
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
    print(f"portbench: set-up {time.time() - t_start:.3f} s, of which the "
          f"driver's {time.time() - t_drv:.3f} s (rendering, the program's "
          f"construction, warm-up)", file=sys.stderr)
    rec = drv.window(args.seconds)
    rec["setup_s"] = rec["t0_wall"] - t_start
    if args.trace:
        rec.update(drv.trace())
    device = device_info(torch, chips) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0}
    if on_card and args.trace:
        device["busy_s"] = rec["busy_s"]
        device["window_s"] = rec["traced_s"]
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.set_num_threads(os.cpu_count() or 1)
    checks = drv.check()
    correct = all(c["value"] <= c["limit"] for c in checks) and bool(checks)

    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 3
    entries = spec["per_layer"] if args.trace else spec["end_to_end"]
    metrics = metric_values(entries, rec) if on_card else {}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if args.trace and on_card:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = {c["name"]: [c["value"], c["limit"]] for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
