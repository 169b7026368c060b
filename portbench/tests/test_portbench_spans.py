"""CPU tests of the span stretch (`portbench/spans.py`): a short stretch drive
on the CPU with the recorder on (the drive, then the profiled frames after
it), its consistency checks and the readers that a CPU run can feed (the
host spans; the device spans and the kernels' device time exist only on the
card), the warm-up and a drive with the recorder off recording nothing, and
the stretch staying out of runs that are not traced runs on the card. Run
with `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import copy
import json
import sys

import pytest

from portbench import run as prun
from portbench import scenes, spans

LAP = 40


@pytest.fixture(autouse=True)
def small_lap(monkeypatch):
    """Render only the first LAP frames of a lap; the drive starts within
    the first four frames."""
    real = scenes.lap_poses
    monkeypatch.setattr(scenes, "lap_poses",
                        lambda n, step: real(n, step)[:LAP])
    from portbench import harness
    real_rng = harness.rng

    class Small:
        def __init__(self, seed, salt=0):
            self.g = real_rng(seed, salt)

        def integers(self, n):
            return int(self.g.integers(min(n, 4)))
    monkeypatch.setattr(harness, "rng", Small)


def tiny_spec() -> dict:
    spec = copy.deepcopy(prun.cell_spec("loop.circuit"))
    spec["workload"].update(drive_frames=12, trace_frames=3)
    return spec


def test_stretch_on_the_cpu():
    st = spans.Stretch(tiny_spec(), 2**31 + 5, "cpu")
    out = st.drive(traced=True)
    rec = out["records"]
    assert out["frames"] == 12 and len(out["frame_lat_s"]) == 12
    frames = [s for s in rec["spans"] if s["name"] == "frame"]
    assert [s["request"][1] for s in frames] == list(range(15))
    assert {"drive.init", "pgo", "pgo.drain", "pgo.assemble"} <= {
        s["name"] for s in rec["spans"]}
    sub = out["sub"]
    assert sub["frames"] == 3 and sub["wall_ns"] > 0
    assert sub["kernel_ns"] == {"A": 0, "B": 0}
    assert out["drive_device_counts"]["ba.passes"] >= 1
    c = out["checks"]
    assert 0.5 < c["pgo_parts_over_run_pgo"] <= 1.0
    got = spans.read_all({spans.KEY: out})
    # the record crosses from the stretch's process as JSON
    assert spans.read_all({spans.KEY: json.loads(json.dumps(out))}) == got
    assert got["host_wait_ms_per_frame"] > 0 and got["init_ms"] > 0
    assert got["pgo_host_ms"] > 0
    # no device spans, graph replays or kernel time on the CPU
    for name in ("kf_device_ms_p50", "ba_device_ms_p50", "kf_launch_ms_p50",
                 "lk_roofline_pct", "pose_roofline_pct"):
        assert got[name] is None, name
    assert not spans.recorder().enabled()
    assert spans.recorder().read()["spans"] == []


def test_untraced_drive_records_nothing():
    st = spans.Stretch(tiny_spec(), 7, "cpu")
    st.warm()
    out = st.drive(traced=False)
    assert "records" not in out and len(out["frame_lat_s"]) == 12
    assert spans.recorder().read()["spans"] == []


@pytest.mark.parametrize("argv", [
    ["run.py", "--workload", "loop.circuit", "--seed", "1", "--trace", "0"],
    ["run.py", "--workload", "loop.circuit", "--seed", "1", "--trace", "1",
     "--device", "cpu"],
    ["pytest", "-q"]])
def test_no_stretch_outside_a_traced_card_run(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    assert spans._run_args() is None
    rec = {"frame_lat_s": [0.01]}
    assert spans.of(rec) is None and rec[spans.KEY] is None
