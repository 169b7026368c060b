"""The port's command line (`python -m stereovision_slam_torch.apps.run_slam`)
in process with `--device cpu`, on a fabricated KITTI directory of 8
frames built as tests/test_apps_io.py builds its own: classic and fused
modes write keyframes.txt and landmarks.pcd and close no loop on the
straight line; a fused run resumed from its checkpoint writes the
uninterrupted run's keyframes; `--mode scan` and `--mode unrolled` (the
chunked modes) write the fused run's keyframes; an unknown mode is
refused; and without `--device` the command line asks for the card.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from stereovision_slam_torch.apps import run_slam
from stereovision_slam_torch.slam.outputs import load_keyframes_file
from tests import synthetic
from tests.test_pipeline_frontend import small_config

torch.set_num_threads(1)

T = 8


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """A mini KITTI sequence from the synthetic renderer: full-resolution
    PNGs (the loader decimates 2x) and calib.txt."""
    root = tmp_path_factory.mktemp("kitti") / "sequences" / "99"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir(parents=True)
    fx, cx, cy, b = 520.0, 320.0, 92.0, 0.54
    rows = [f"P{i}: {fx} 0 {cx} {-fx * b if i % 2 else 0.0} 0 {fx} {cy} 0 "
            "0 0 1 0" for i in range(4)]
    (root / "calib.txt").write_text("\n".join(rows) + "\n")
    H, W = 184, 640
    rig = synthetic.make_stereo_rig(fx=fx / 2, fy=fx / 2, cx=cx / 2,
                                    cy=cy / 2, baseline=b)
    poses = synthetic.forward_motion_poses(T, step=0.5)
    lms = jnp.concatenate([
        synthetic.random_landmarks(jax.random.PRNGKey(0), 60,
                                   y_range=(-3, 3), z_range=(4, 35)),
        synthetic.random_landmarks(jax.random.PRNGKey(1), 40,
                                   y_range=(-3, 3), z_range=(8, 40)),
    ])
    lefts, rights = synthetic.render_stereo_sequence(
        jax.random.PRNGKey(2), poses, lms, H=H // 2, W=W // 2, rig=rig)
    for i in range(T):
        for sub, img in (("image_0", lefts[i]), ("image_1", rights[i])):
            big = np.asarray(jax.image.resize(img, (H, W), "nearest"))
            Image.fromarray(big.astype(np.uint8), "L").save(
                root / sub / f"{i:06d}.png")
    return str(root)


def _config(tmp_path, kitti_dir, name: str) -> str:
    cfg = dataclasses.asdict(small_config())
    cfg.update(dataset_dir=kitti_dir, output_dir=str(tmp_path / name),
               image_height=92, image_width=320, visualizer_on=1)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _keyframes(out_dir: str):
    _, _, frames = load_keyframes_file(os.path.join(out_dir, "keyframes.txt"))
    return frames


@pytest.mark.parametrize("mode", ["classic", "fused"])
def test_cli_runs_on_the_cpu(kitti_dir, tmp_path, capsys, mode):
    cfg = _config(tmp_path, kitti_dir, mode)
    assert run_slam.main([cfg, "--device", "cpu", "--mode", mode]) == 0
    text = capsys.readouterr().out
    assert "Loop closure: 0 loop(s) closed" in text
    assert f"SLAM finished ({mode})" in text
    out = glob.glob(str(tmp_path / mode / "*" / "keyframes.txt"))
    assert len(out) == 1
    out_dir = os.path.dirname(out[0])
    assert os.path.getsize(os.path.join(out_dir, "landmarks.pcd")) > 0
    assert f"Output saved to {out_dir}" in text
    frames = _keyframes(out_dir)
    assert len(frames) >= 2 and frames[0][0] == 0
    with open(out[0]) as f:
        assert f.readline().strip() == kitti_dir
    if mode == "classic":     # the viewer's transcript (no rerun here)
        assert os.path.getsize(tmp_path / mode / "viewer.jsonl") > 0


def test_cli_fused_resume(kitti_dir, tmp_path):
    full = run_slam.run(run_slam.parse_args(
        [_config(tmp_path, kitti_dir, "full"), "--device", "cpu",
         "--mode", "fused", "--checkpoint-every", "5"]))
    ckpt = str(tmp_path / "full" / run_slam.CHECKPOINT_NAME)
    resumed = run_slam.run(run_slam.parse_args(
        [_config(tmp_path, kitti_dir, "resumed"), "--device", "cpu",
         "--mode", "fused", "--resume", ckpt]))
    assert any("(5 frames already processed)" in line
               for line in resumed["lines"])
    a, b = _keyframes(full["output"]), _keyframes(resumed["output"])
    assert [f for f, _ in a] == [f for f, _ in b]
    for (_, pa), (_, pb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("mode", ["scan", "unrolled"])
def test_cli_chunked_modes(kitti_dir, tmp_path, capsys, mode):
    """The chunked modes write the fused run's keyframes, bit for bit on
    the CPU (the scene has no loop to close)."""
    runs = {m: run_slam.run(run_slam.parse_args(
        [_config(tmp_path, kitti_dir, m), "--device", "cpu", "--mode", m]))
        for m in ("fused", mode)}
    assert any(line.startswith(f"SLAM finished ({mode})")
               for line in runs[mode]["lines"])
    a, b = (_keyframes(runs[m]["output"]) for m in ("fused", mode))
    assert [f for f, _ in a] == [f for f, _ in b] and len(a) >= 2
    for (_, pa), (_, pb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


def test_cli_refuses_unported_modes(kitti_dir, tmp_path, capsys):
    """Every mode of the reference's command line is ported: an unknown
    mode and a missing config are refused."""
    cfg = _config(tmp_path, kitti_dir, "fast")
    assert run_slam.main([cfg, "--device", "cpu", "--mode", "fast"]) == 1
    assert "expected classic|fused|scan|unrolled" in capsys.readouterr().out
    assert run_slam.main([str(tmp_path / "missing.yaml")]) == 1


def test_cli_asks_for_the_card(kitti_dir, tmp_path):
    assert run_slam.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_slam.main([_config(tmp_path, kitti_dir, "card")])
