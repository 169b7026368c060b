"""The readings that a cell's limits are set from, in one process.

    python -m portbench.calibrate --workload <cell> --seconds <s>
        --seeds 11,12,... [--control-seeds 11,12,13] [--trace-first]

For each seed: the cell's set-up and a window of `--seconds`, then the
numbers that decide `correct` (`Driver.numbers()`), and for the control
seeds the same numbers with the reference at the next precision down put
in the program's place (`numbers(control=True)`), each reduced as a run
reduces it (`reference.common.reduce`). Prints a JSON line a seed and,
last, each number's lower reading (the largest over the sound seeds) and
upper reading (the smallest over the control seeds). The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from portbench import run as prun
from portbench.reference.common import reduce


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--trace-first", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = prun.cell_spec(args.workload)
    name = spec["workload"]["driver"]
    mod = prun.load_file(prun.BENCH / "drivers" / f"{name}.py", name)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for n, seed in enumerate(seeds):
        t0 = time.time()
        drv = mod.Driver(spec, seed=seed, device=args.device)
        drv.setup()
        setup = time.time() - t0
        rec = drv.window(args.seconds)
        line = {"seed": seed, "setup_s": setup,
                "frames_per_s": rec["frames"] / rec["window_s"],
                "frames": rec["frames"], "failed": rec["failed"]}
        if args.trace_first and n == 0:
            tr = drv.trace()
            line.update(busy_s=tr["busy_s"], traced_s=tr["traced_s"],
                        kernels_seen=tr["kernels_seen"],
                        kernel_launches=tr.get("kernel_launches"),
                        breakdown=tr["breakdown"])
        if args.device == "cuda":
            line["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        drv.release()
        t1 = time.time()
        vals = drv.numbers()
        line["ref_s"] = time.time() - t1
        line["ref_times"] = getattr(drv, "ref_times", None)
        line["sound"] = {k: reduce(v) for k, v in vals.items() if v}
        line["top3"] = {k: sorted(v)[-3:] for k, v in vals.items() if v}
        line["counts"] = {k: len(v) for k, v in vals.items()}
        for k, v in line["sound"].items():
            lower[k] = max(lower.get(k, v), v)
        if seed in control:
            t1 = time.time()
            cv = drv.numbers(control=True)
            line["control_s"] = time.time() - t1
            line["control"] = {k: reduce(v) for k, v in cv.items() if v}
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, v), v)
        print(json.dumps(line), flush=True)
        del drv
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
