"""CPU tests of the benchmark: each driver through a whole run at a few
frames, the control and the planted faults failing `correct`, and the
import rules. The program runs its plain kernel versions here, so sound
runs read gaps of 0; the readings the limits are set from come from the
card (PERF.md). Run with `python -m pytest portbench/tests -q`."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import subprocess
import sys

import pytest
import torch

from portbench import run as prun
from portbench import scenes

ROOT = prun.ROOT
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")
# a few frames of each cell: small windows, one drive ending in the window
TINY = {
    "loop.circuit": dict(drive_frames=10, warm_frames=4, samples=4,
                         sample_fps_guess=1, embed_samples=2,
                         trace_frames=2),
}
LAP = 40      # lap frames rendered in the tests (the drives use a few)
TINY_NUMBERS = ("pose_gap", "inlier_gap", "window_gap", "landmark_gap",
                "embed_gap")


@pytest.fixture(autouse=True)
def small_lap(monkeypatch):
    """Render only the first LAP frames of a lap: the tests' drives start
    within the first four frames and stay inside them."""
    real = scenes.lap_poses
    monkeypatch.setattr(scenes, "lap_poses",
                        lambda n, step: real(n, step)[:LAP])


def tiny_spec(cell: str) -> dict:
    spec = copy.deepcopy(prun.cell_spec(cell))
    spec["workload"].update(TINY[cell])
    spec["workload"]["arena"]["lap_frames"] = 112
    # a few frames close no loop, so the loop edges and the PGO have no
    # sample here: the tiny cell holds the other numbers to their limits
    limits = spec["workload"]["limits"]
    spec["workload"]["limits"] = {k: limits[k] for k in TINY_NUMBERS}
    return spec


def _rng_small(seed, salt=0):
    import numpy as np
    g = np.random.default_rng([abs(int(seed)), salt])

    class G:
        def integers(self, n):
            return int(g.integers(min(n, 4)))

        def choice(self, *a, **kw):
            return g.choice(*a, **kw)

        def permutation(self, n):
            return g.permutation(n)
    return G()


def cpu_run(cell: str, monkeypatch, seed: int = 2**31 + 77) -> dict:
    spec = tiny_spec(cell)
    monkeypatch.setattr(prun, "cell_spec", lambda name: spec)
    from portbench import harness
    monkeypatch.setattr(harness, "rng", _rng_small)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = prun.main(["--workload", cell, "--seed", str(seed),
                        "--seconds", "2", "--trace", "0",
                        "--device", "cpu"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_prints_its_line(cell, monkeypatch):
    line = cpu_run(cell, monkeypatch)
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"pose_gap", "inlier_gap"} <= set(line["checks"])
    assert prun.forbidden_modules() == []


def _frozen_track(fused):
    real = fused.track_branch

    def unchanged(fs, ms, *a, **kw):
        fs1, n_in, n_tr = real(fs, ms, *a, **kw)
        return fs1._replace(T_cur=fs.T_cur), n_in, n_tr
    return unchanged


def _altered_pose(pose_kernel):
    real = pose_kernel.pose_lm

    def altered(*a, **kw):
        out = real(*a, **kw)
        return out._replace(T=out.T + 1e-2)
    return altered


def _no_keyframes(fused_loop):
    """The keyframe decision never taken: every frame stays a tracked
    frame, however few inliers it keeps."""
    real = fused_loop.ScanLoopVisualOdometry.initialize

    def init(self):
        real(self)
        self._static["kf_threshold"] = 0
    return init


def _keyframe_not_stored(fused_loop):
    """The keyframe decision taken, but the keyframe's graph never run."""
    return lambda self, run_ba: None


FAULTS = {
    "state_unchanged": ("stereovision_slam_torch.slam.fused", "track_branch",
                        _frozen_track),
    "answer_altered": ("stereovision_slam_torch.ops.pose_kernel", "pose_lm",
                       _altered_pose),
    "keyframe_never_inserted": (
        "stereovision_slam_torch.slam.fused_loop",
        "ScanLoopVisualOdometry.initialize", _no_keyframes),
    "keyframe_not_stored": ("stereovision_slam_torch.slam.fused_loop",
                            "ScanLoopVisualOdometry._keyframe",
                            _keyframe_not_stored),
}


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_correct(cell, fault, monkeypatch):
    import importlib
    modname, attr, make = FAULTS[fault]
    mod = importlib.import_module(modname)
    owner, name = (mod, attr) if "." not in attr else (
        getattr(mod, attr.split(".")[0]), attr.split(".")[1])
    monkeypatch.setattr(owner, name, make(mod))
    line = cpu_run(cell, monkeypatch)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_a_number(cell, monkeypatch):
    """The reference in bfloat16 storage put in the program's place fails
    at least one of the cell's limits as committed."""
    spec = tiny_spec(cell)
    limits = prun.cell_spec(cell)["workload"]["limits"]
    from portbench import harness
    monkeypatch.setattr(harness, "rng", _rng_small)
    name = spec["workload"]["driver"]
    mod = prun.load_file(prun.BENCH / "drivers" / f"{name}.py", name)
    drv = mod.Driver(spec, seed=12345, device="cpu")
    drv.setup()
    drv.window(2.0)
    drv.release()
    vals = drv.numbers(control=True)
    over = [k for k, v in vals.items() if v and max(v) > limits[k]]
    assert over, vals


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, pkgutil, importlib, portbench.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'portbench.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'stereovision_slam_torch', 'stereovision_slam_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = prun.main(["--workload", "loop.circuit", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_on_the_card(card, cell):
    """A short run of the cell as the benchmark runs it, on the card."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2**31 + 5), "--seconds", "20", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
