"""The benchmark is driven by data: a cell, a configuration and a per-layer
metric are found by their names; the metric files agree with
BENCHMARK.json; the roofline counts match hand counts at the main path's
shapes of kernels A and B."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from portbench import roofline
from portbench import run as prun

ROOT = prun.ROOT


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_are_found_without_a_code_edit(tmp_path):
    """A copy of the benchmark with a configuration, a cell and a metric
    added as files and BENCHMARK.json entries only."""
    root = tmp_path
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = bench()
    cfg = json.loads((ROOT / "portbench/configs/kitti-loop.json").read_text())
    cfg["drive_frames"] = 4541
    (root / "portbench/configs/kitti-00.json").write_text(json.dumps(cfg))
    b["configs"].append(dict(b["configs"][0], name="kitti-00",
                             file="portbench/configs/kitti-00.json"))
    wl = json.loads((ROOT / "portbench/workloads/loop.circuit.json")
                    .read_text())
    wl.update(config="kitti-00", traffic="circuit-long")
    (root / "portbench/workloads/loop.kitti00.json").write_text(
        json.dumps(wl))
    b["workloads"].append(dict(b["workloads"][0], name="loop.kitti00",
                               config="kitti-00", traffic="circuit-long"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "loop.circuit" in m.get("workloads", []):
            m["workloads"].append("loop.kitti00")
    (root / "portbench/metrics/frames_total.py").write_text(
        'UNIT = "frames"\n\n\ndef read(rec):\n    return rec["frames"]\n')
    b["per_layer"].append({"name": "frames_total", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "host loop", "moves": "frames_per_s",
                           "workloads": ["loop.kitti00"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    spec = prun.cell_spec("loop.kitti00", root=root)
    assert spec["config"]["drive_frames"] == 4541
    assert spec["workload"]["traffic"] == "circuit-long"
    assert [m["name"] for m in spec["per_layer"]][-1] == "frames_total"
    rec = dict(frames=12, window_s=2.0, frame_lat_s=[0.01] * 12,
               setup_s=1.0)
    got = prun.metric_values(spec["per_layer"][-1:], rec, root=root)
    assert got == {"frames_total": {"value": 12.0, "unit": "frames"}}
    got = prun.metric_values(spec["end_to_end"], rec, root=root)
    assert got["frames_per_s"]["value"] == 6.0


def test_metric_files_agree_with_the_benchmark():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        mod = prun.load_file(ROOT / "portbench" / "metrics" /
                             f"{m['name']}.py", m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"]), m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for w in b["workloads"]:
        f = json.loads((ROOT / "portbench/workloads" / f"{w['name']}.json")
                       .read_text())
        assert (f["config"], f["traffic"]) == (w["config"], w["traffic"])
        assert (ROOT / "portbench/drivers" / f"{f['driver']}.py").exists()


def test_every_cell_reports_what_the_contract_asks():
    b = bench()
    for w in b["workloads"]:
        spec = prun.cell_spec(w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]


def _pyramids(G, H=188, W=620, L=4):
    levels, h, w = [], H, W
    for _ in range(L):
        levels.append(torch.zeros(G, h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return levels


def test_kernel_a_counts_by_hand():
    """The second LK call of a tracked frame: G = 2 groups of 256 points
    over four levels of 188 x 620, every point 3 iterations a level."""
    G, N, L, win = 2, 256, 4, 11
    args = (_pyramids(G), _pyramids(G))
    rows = torch.zeros(L, G * N, 6)
    rows[:, :, 5] = 3
    nbytes, flops = roofline.lk_counts(args, rows, win)
    pixels = 188 * 620 + 94 * 310 + 47 * 155 + 24 * 78      # 154857
    assert nbytes == 4 * 2 * G * pixels + 512 * 17 + 512 * 9 + 4 * L * 512 * 6
    assert nbytes == 2540176
    assert flops == (L * 512 * 95 + L * 512 * 3 * 12) * 121 == 32462848


def test_kernel_b_counts_by_hand():
    """One stream, 256 points, 4 starts, 3 rounds of 6 iterations; 200 left
    and 150 right observations valid."""
    F, S = 256, 4
    valid_l = torch.zeros(1, F, dtype=torch.bool)
    valid_l[0, :200] = True
    valid_r = torch.zeros(1, F, dtype=torch.bool)
    valid_r[0, :150] = True
    args = (torch.zeros(2, 16), torch.zeros(1, F, 3), torch.zeros(1, F, 2),
            torch.zeros(1, F, 2), valid_l, valid_r, torch.zeros(1, S, 3, 4))
    out = (torch.zeros(1, 3, 4), torch.zeros(1, 2 * F, dtype=torch.bool),
           torch.zeros(1, dtype=torch.int32))
    nbytes, flops = roofline.pose_counts(args, out,
                                         {"rounds": 3, "iters": 6})
    assert nbytes == (128 + 3072 + 2048 + 2048 + 256 + 256 + 192
                      + 48 + 512 + 4)
    assert flops == S * (3 * 7 + 1) * 350 * 240 == 7392000


def test_bound_picks_the_larger_time():
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    ms, by = roofline.bound_ms(3.35e9, 0.0, peak)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = roofline.bound_ms(0.0, 67e9, peak)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_trace_reduction_by_hand():
    """Device intervals [0, 10) and [5, 20) and [40, 50) us: busy 30 us;
    the idle [20, 40) us under a synchronize, [50, 100) under "outer"."""
    from portbench import trace
    us = 1000
    ev = [("k1", True, 0, 10 * us, False),
          ("k2", True, 5 * us, 20 * us, False),
          ("lk_pyramid_kernel<11>", True, 40 * us, 50 * us, False),
          ("cudaStreamSynchronize", False, 15 * us, 45 * us, False),
          ("outer", False, 0, 100 * us, False)]
    r = trace.reduce(ev, 100e-6, {"A": "lk_pyramid_kernel"})
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["kernels_seen"] == {"A": 1}
    assert r["kernel_device_s"] == {"A": pytest.approx(10e-6)}
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps == {"cudaStreamSynchronize": pytest.approx(20e-6),
                    "outer": pytest.approx(50e-6)}
    assert r["breakdown"]["device_ops"][0] == ["k2", pytest.approx(15e-6)]
