"""Port parity, the output renderer (`apps/render_outputs.py`): the
counterpart of tests/test_apps_io.py's renderer test on the port's command
line, and the plotted camera centres against the reference's reading of
the same keyframes.txt (to 1e-6: both invert the same float32 poses)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def slam_output(tmp_path):
    from stereovision_slam_torch.slam.outputs import save_slam_output
    kfs = []
    for i in range(12):
        R = np.array([[np.cos(0.05 * i), 0, np.sin(0.05 * i)], [0, 1, 0],
                      [-np.sin(0.05 * i), 0, np.cos(0.05 * i)]], np.float32)
        T = np.hstack([R, np.array([[0.1 * i], [0.0], [-0.5 * i]],
                                   np.float32)])
        kfs.append((i, T))
    lms = np.random.default_rng(0).uniform(-10, 10, (200, 3)).astype(
        np.float32)
    return save_slam_output(str(tmp_path), "/data/kitti/05", 0, kfs, lms,
                            timestamped_subdir=False)


def test_render_outputs_cli(slam_output, tmp_path):
    pytest.importorskip("matplotlib")
    out_dir = str(tmp_path / "figures")
    proc = subprocess.run(
        [sys.executable, "-m", "stereovision_slam_torch.apps.render_outputs",
         slam_output, "--out", out_dir], capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    for name in ("trajectory.png", "landmarks.png"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0
        assert f"wrote {os.path.join(out_dir, name)}" in proc.stdout
    assert not os.path.exists(os.path.join(out_dir, "dense_pointcloud.png"))


def test_render_outputs_needs_outputs(tmp_path, capsys):
    from stereovision_slam_torch.apps import render_outputs
    with pytest.raises(SystemExit):
        render_outputs.main([str(tmp_path)])
    assert "no keyframes.txt" in capsys.readouterr().err


def test_plotted_centres_match_reference(slam_output, tmp_path):
    pytest.importorskip("matplotlib")
    from stereovision_slam_tpu.slam.outputs import load_keyframes_file
    from stereovision_slam_tpu.utils.evaluation import camera_centers
    from stereovision_slam_torch.apps import render_outputs

    kf = os.path.join(slam_output, "keyframes.txt")
    png = str(tmp_path / "t.png")
    got = render_outputs.render_trajectory(
        kf, os.path.join(slam_output, "landmarks.pcd"), png)
    _, _, keyframes = load_keyframes_file(kf)
    want = np.asarray(camera_centers(np.stack([T for _, T in keyframes])))
    assert got.shape == (12, 3) and os.path.getsize(png) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
