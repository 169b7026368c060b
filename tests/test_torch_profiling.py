"""Port parity, `utils/profiling.py`: the stage timer's summary and report
equal the JAX package's on the same samples (host arithmetic, exact), the
timer records each stage, and the device trace writes a Chrome trace of a
block of PyTorch work on the CPU.
"""

import json
import os

import numpy as np
import torch

from stereovision_slam_tpu.utils import profiling as jprof
from stereovision_slam_torch.utils import profiling


def test_stage_timer_matches_reference():
    rng = np.random.default_rng(0)
    samples = {"decode": rng.uniform(0.01, 0.03, 12).tolist(),
               "disparity": rng.uniform(0.001, 0.01, 12).tolist(),
               "global SOR": [1.5]}
    a, b = profiling.StageTimer(), jprof.StageTimer()
    for stage, xs in samples.items():
        a.samples[stage].extend(xs)
        b.samples[stage].extend(xs)
    assert a.summary() == b.summary()
    assert a.report() == b.report()
    t = profiling.StageTimer("cpu")
    for _ in range(3):
        with t.time("work"):
            torch.ones(64, 64).sum()
    s = t.summary()["work"]
    assert s["count"] == 3 and s["total_s"] > 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        x = torch.ones(128, 128)
        (x @ x).sum()
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
