"""Port parity, the host I/O of the command line: the KITTI loader
(`io/kitti.py`), the output writers (`slam/outputs.py`, `io/pcd.py`), the
trajectory metrics (`utils/evaluation.py`) and `apps/evaluate_trajectory`,
each against the reference's on the same files or arrays.

Both loaders decode with Pillow. Bars: cameras within 1e-6 (relative) of
the reference's; frames, grey and colour, bit-equal; keyframes.txt and
landmarks.pcd byte-equal; ATE and RPE within 1e-6.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stereovision_slam_tpu.io.kitti import KittiDataset as JKitti
from stereovision_slam_tpu.slam import outputs as jout
from stereovision_slam_tpu.utils import evaluation as jeval
from stereovision_slam_torch.apps import evaluate_trajectory
from stereovision_slam_torch.io import pcd
from stereovision_slam_torch.io.kitti import KittiDataset
from stereovision_slam_torch.slam import outputs as tout
from stereovision_slam_torch.utils import evaluation as teval
from stereovision_slam_torch.utils.exceptions import DatasetError

# sequence 00's calib.txt (KITTI odometry)
CALIB = """P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P1: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 -3.861448000000e+02 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P2: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 4.538225000000e+01 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 -1.130887000000e-01 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 3.779761000000e-03
P3: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 -3.372877000000e+02 0.000000000000e+00 7.188560000000e+02 1.852157000000e+02 2.369057000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 4.915215000000e-03
"""
H, W, T = 37, 61, 3      # odd sizes: the decimation keeps rows 0, 2, ...


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """calib.txt, grey image_0/1 and colour image_2/3 PNGs of seeded
    noise."""
    root = tmp_path_factory.mktemp("kitti") / "00"
    rng = np.random.default_rng(5)
    for cam in range(4):
        (root / f"image_{cam}").mkdir(parents=True)
        for i in range(T):
            if cam < 2:
                img = Image.fromarray(rng.integers(0, 256, (H, W), np.uint8),
                                      "L")
            else:
                img = Image.fromarray(rng.integers(0, 256, (H, W, 3),
                                                   np.uint8), "RGB")
            img.save(root / f"image_{cam}" / f"{i:06d}.png")
    (root / "calib.txt").write_text(CALIB)
    return str(root)


@pytest.mark.parametrize("cams,color", [((0, 1), False), ((2, 3), True),
                                        ((2, 3), False)])
def test_loader_matches_reference(sequence, cams, color):
    ref = JKitti(sequence, *cams, is_color_input=color)
    port = KittiDataset(sequence, *cams, is_color_input=color, device="cpu")
    ref.initialize()
    port.initialize()
    assert len(port.cameras) == len(ref.cameras) == 4
    for cr, cp in zip(ref.cameras, port.cameras):
        for f in cr._fields:
            r, p = np.asarray(getattr(cr, f)), getattr(cp, f).numpy()
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6, err_msg=f)
    for fr, fp in zip(ref, port):
        assert fp.frame_id == fr.frame_id
        for a, b in ((fr.left, fp.left), (fr.right, fp.right)):
            assert b.dtype == np.float32 and b.shape == a.shape
            assert np.array_equal(a, b)
    assert port.current_index == ref.current_index == T
    assert port.frame_by_id(T) is None and port.next_frame() is None


def test_loader_refuses_missing_calib(tmp_path):
    with pytest.raises(DatasetError):
        KittiDataset(str(tmp_path), device="cpu").initialize()


def test_loader_asks_for_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            KittiDataset("unused")


def test_outputs_byte_equal_to_reference(tmp_path):
    rng = np.random.default_rng(9)
    keyframes = [(int(f), rng.normal(size=(3, 4)).astype(np.float32))
                 for f in (7, 0, 3, 12)]
    landmarks = (rng.normal(size=(50, 3)) * 30).astype(np.float32)
    a = jout.save_slam_output(str(tmp_path / "ref"), "/data/seq/00", 0,
                              keyframes, landmarks, timestamped_subdir=False)
    b = tout.save_slam_output(str(tmp_path / "port"), "/data/seq/00", 0,
                              keyframes, landmarks, timestamped_subdir=False)
    for name in ("keyframes.txt", "landmarks.pcd"):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    _, _, frames = tout.load_keyframes_file(os.path.join(b, "keyframes.txt"))
    assert [f for f, _ in frames] == [0, 3, 7, 12]
    pts, colors = pcd.read_pcd(os.path.join(b, "landmarks.pcd"))
    np.testing.assert_allclose(pts, landmarks, rtol=1e-6)
    assert colors is None
    # the binary coloured cloud round-trips
    cols = rng.integers(0, 256, (50, 3), np.uint8)
    pcd.write_pcd_xyzrgb(str(tmp_path / "c.pcd"), landmarks, cols)
    pts2, cols2 = pcd.read_pcd(str(tmp_path / "c.pcd"))
    assert np.array_equal(pts2, landmarks) and np.array_equal(cols2, cols)


def _trajectories(seed: int = 3, n: int = 20):
    rng = np.random.default_rng(seed)
    gt, est = {}, {}
    for i in range(n):
        a = 0.05 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.3 * i, 0.01 * i, 1.0 * i])
        gt[i] = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        est[i] = (gt[i] + rng.normal(scale=0.02, size=(3, 4))).astype(
            np.float32)
    return est, gt


@pytest.mark.parametrize("align", [False, True])
def test_metrics_match_reference(align):
    est, gt = _trajectories()
    assert abs(teval.ate_rmse(est, gt, align=align)
               - jeval.ate_rmse(est, gt, align=align)) <= 1e-6
    assert abs(teval.rpe_per_frame(est, gt)
               - jeval.rpe_per_frame(est, gt)) <= 1e-6
    src = teval.camera_centers(np.stack(list(est.values())))
    dst = jeval.camera_centers(np.stack(list(gt.values())))
    for a, b in zip(teval.umeyama_alignment(src, dst, with_scale=True),
                    jeval.umeyama_alignment(src, dst, with_scale=True)):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_evaluate_trajectory_app(tmp_path, capsys):
    est, gt = _trajectories(n=12)
    out = tout.save_slam_output(str(tmp_path), "seq", 0, list(est.items()),
                                np.zeros((0, 3)), timestamped_subdir=False)
    lines = []
    for i in range(12):     # KITTI ground truth: T_w_cam per line
        Rt = gt[i].astype(np.float64)
        R = Rt[:, :3].T
        lines.append(" ".join(f"{v:.9g}" for v in np.concatenate(
            [R, (-R @ Rt[:, 3])[:, None]], 1).reshape(-1)))
    gt_path = tmp_path / "gt.txt"
    gt_path.write_text("\n".join(lines) + "\n")
    assert evaluate_trajectory.main(
        [os.path.join(out, "keyframes.txt"), str(gt_path), "--align"]) == 0
    text = capsys.readouterr().out
    assert "frames compared: 12" in text
    ate = jeval.ate_rmse(*_file_trajectories(out, gt), align=True)
    assert f"ATE RMSE: {ate:.4f} m (SE3-aligned)" in text
    assert evaluate_trajectory.main([]) == 1


def _file_trajectories(out, gt):
    _, _, frames = jout.load_keyframes_file(os.path.join(out, "keyframes.txt"))
    return {f: p for f, p in frames}, gt
