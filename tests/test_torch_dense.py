"""Port parity, dense reconstruction: `dense/reconstruction.py` and its
command line against the JAX package on the same fabricated sequences.

Tolerances: the disparity is the reference's bit for bit away from the
texture gate's margin (tests/test_torch_stereo_bm.py); the points differ
only by the back-projection's float32 sum order, within 1e-5 relative.
With the density filter (host numpy in both) the clouds, colours and PCDs
are equal in count and order. With the default statistical filter, the
SOR keep decisions of points whose mean k-NN distance sits at the
threshold follow rounding (tests/test_torch_sor.py holds the others), so
the two clouds are held to 0.2% of their points, counted and by voxel. The
batched path equals the serial one bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.dense import reconstruction as jrec
from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.geometry.camera import Camera as JCamera
from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_torch.apps import run_dense_reconstruction as app
from stereovision_slam_torch.dense import reconstruction as rec
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.io.pcd import read_pcd
from stereovision_slam_torch.parallel.mesh import make_local_mesh
from stereovision_slam_torch.slam.outputs import save_slam_output
from tests import synthetic

torch.set_num_threads(1)

H, W = 64, 224
FX, BASE = 150.0, 0.5
CLOUD_AGREE = 2e-3
POINT_RTOL = 1e-5


def _colour(grey, c):
    """Channel c of an RGB frame whose channels differ."""
    return np.clip(grey * (0.7 + 0.15 * c) + 10.0 * c, 0, 255)


def _sequence(n_kf: int, seed: int = 2, width: int = W):
    """n_kf keyframes looking at textured walls 5, 6, ... m away from
    slightly rotated poses: RGB (n, H, width, 3) lefts and rights, poses."""
    import jax
    lefts, rights, kfs = [], [], []
    for i in range(n_kf):
        z = 5.0 + i
        grey = synthetic.smooth_texture(jax.random.PRNGKey(seed + i), H,
                                        width)
        rgb = np.stack([_colour(np.asarray(grey), c) for c in range(3)], -1)
        shifted = np.stack([np.asarray(synthetic.translate_image(
            jnp.asarray(rgb[..., c]), -FX * BASE / z, 0.0))
            for c in range(3)], -1)
        lefts.append(rgb)
        rights.append(shifted)
        T = np.asarray(jse3.se3_exp(jnp.asarray(
            [0.3 * i, -0.1 * i, 0.5 * i, 0.02 * i, 0.05 * i, -0.01 * i],
            jnp.float32)))
        kfs.append((i, T))
    return (np.stack(lefts).astype(np.float32),
            np.stack(rights).astype(np.float32), kfs)


def _cams_np():
    cx, cy = W / 2.0, H / 2.0
    right_pose = np.eye(3, 4, dtype=np.float32)
    right_pose[0, 3] = -BASE
    return (dict(fx=FX, fy=FX, cx=cx, cy=cy, baseline=0.0),
            dict(fx=FX, fy=FX, cx=cx, cy=cy, baseline=BASE, pose=right_pose))


def _datasets(lefts, rights):
    cl, cr = _cams_np()
    jcams = [JCamera.create(**{k: (jnp.asarray(v) if k == "pose" else v)
                               for k, v in c.items()}) for c in (cl, cr)]
    cams = [Camera.create(**{k: (torch.from_numpy(v) if k == "pose" else v)
                             for k, v in c.items()}) for c in (cl, cr)]
    return JDataset(lefts, rights, jcams), ArraySequenceDataset(lefts, rights,
                                                                cams)


CFG = dict(num_disparities=32, block_size=11, max_depth=50.0,
           voxel_leaf=0.05, density_voxel=0.3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    lefts, rights, kfs = _sequence(2)
    out = save_slam_output(str(tmp_path_factory.mktemp("slam")), "<synthetic>",
                           0, kfs, np.zeros((0, 3)), timestamped_subdir=False)
    return lefts, rights, kfs, out


def _port(out, lefts, rights, tmp, filt="statistical", **kw):
    _, ds = _datasets(lefts, rights)
    dr = rec.DenseReconstruction(
        rec.DenseReconstructionConfig(slam_output_dir=out,
                                      outlier_filter=filt, **CFG),
        dataset_factory=lambda _: ds, device="cpu")
    dr.initialize()
    pts, cols = dr.dense_reconstruct(
        output_path=os.path.join(tmp, "port.pcd"), **kw)
    return pts, cols, dr


def _reference(out, lefts, rights, path, filt):
    jds, _ = _datasets(lefts, rights)
    jdr = jrec.DenseReconstruction(
        jrec.DenseReconstructionConfig(slam_output_dir=out,
                                       outlier_filter=filt, **CFG),
        dataset_factory=lambda _: jds)
    jdr.initialize()
    return jdr.dense_reconstruct(output_path=path)


def test_end_to_end_matches_reference(scene, tmp_path):
    """The density filter: the same cloud, colours and PCD."""
    lefts, rights, kfs, out = scene
    jpts, jcols = _reference(out, lefts, rights, str(tmp_path / "ref.pcd"),
                             "density")
    pts, cols, dr = _port(out, lefts, rights, str(tmp_path), "density")
    print(f"points: {dr.counts}; reference {len(jpts)}")
    assert len(pts) == len(jpts) > 1000
    np.testing.assert_allclose(pts, jpts, rtol=POINT_RTOL,
                               atol=POINT_RTOL * float(np.abs(jpts).max()))
    np.testing.assert_array_equal(cols, jcols)
    # colours from the RGB frames (the three channels differ)
    assert len(np.unique(cols[:, 0].astype(int) - cols[:, 2])) > 10
    p2, c2 = read_pcd(str(tmp_path / "port.pcd"))
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, cols)
    j2, jc2 = read_pcd(str(tmp_path / "ref.pcd"))
    assert len(j2) == len(p2)
    np.testing.assert_array_equal(jc2, c2)


def test_end_to_end_statistical_matches_reference(scene, tmp_path):
    """The default SOR filter: clouds within 0.2% of their points."""
    lefts, rights, kfs, out = scene
    jpts, _ = _reference(out, lefts, rights, str(tmp_path / "ref.pcd"),
                         "statistical")
    pts, _, dr = _port(out, lefts, rights, str(tmp_path))
    print(f"points: {dr.counts}; reference {len(jpts)}")
    assert len(pts) > 1000
    assert abs(len(pts) - len(jpts)) <= CLOUD_AGREE * len(jpts)
    keys = [set(map(tuple, np.floor(p / CFG["voxel_leaf"]).astype(int)))
            for p in (pts, jpts)]
    assert len(keys[0] ^ keys[1]) <= 2 * CLOUD_AGREE * len(jpts)
    assert set(dr.counts) >= {"keyframes", "valid_points",
                              "after_keyframe_filter", "after_global_filter",
                              "after_voxel"}
    assert set(dr.timer.samples) == {"decode", "disparity", "back-projection",
                                     "keyframe SOR", "global SOR", "voxel",
                                     "PCD write"}


def test_depth_and_points_match_reference():
    """The back-projection alone, on a disparity map with a rotated pose."""
    rng = np.random.default_rng(0)
    disp = rng.uniform(0.0, 40.0, (H, W)).astype(np.float32)
    valid = rng.uniform(size=(H, W)) > 0.2
    T = np.array(jse3.se3_exp(jnp.asarray([1.0, -2.0, 3.0, 0.1, -0.2, 0.3],
                                            jnp.float32)))
    args = (FX, FX + 3.0, W / 2.0, H / 2.0)
    jp, jok = jrec._depth_and_points(jnp.asarray(disp), jnp.asarray(valid),
                                     *args, jnp.asarray(BASE, jnp.float32),
                                     jnp.asarray(T), 1.0, 150.0)
    p, ok = rec._depth_and_points(torch.from_numpy(disp),
                                  torch.from_numpy(valid), *args, BASE,
                                  torch.from_numpy(T), 1.0, 150.0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    jp = np.asarray(jp)[np.asarray(jok)]
    np.testing.assert_allclose(p.numpy()[ok.numpy()], jp, rtol=POINT_RTOL,
                               atol=POINT_RTOL * float(np.abs(jp).max()))


def test_batched_equals_serial(scene, tmp_path):
    """Four keyframes a batch over the one-device mesh (two keyframes and
    two zero pads) give the serial run's cloud bit for bit."""
    lefts, rights, _, out = scene
    serial, scols, _ = _port(out, lefts, rights, str(tmp_path), "density")
    mesh = make_local_mesh("cpu")
    assert mesh.size == 1
    batched, bcols, _ = _port(out, lefts, rights, str(tmp_path), "density",
                              mesh=mesh, per_device_batch=4)
    np.testing.assert_array_equal(batched, serial)
    np.testing.assert_array_equal(bcols, scols)


def test_filters_match_reference():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(0, 0.05, (200, 3)),
                          [[5.0, 5.0, 5.0], [-7.0, 2.0, 1.0]]])
    np.testing.assert_array_equal(rec.density_filter(pts, 0.2, 4),
                                  jrec.density_filter(pts, 0.2, 4))
    cols = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
    for a, b in zip(rec.voxel_downsample(pts, cols, 0.02),
                    jrec.voxel_downsample(pts, cols, 0.02)):
        np.testing.assert_array_equal(a, b)


def _write_png(path, rgb):
    from PIL import Image
    Image.fromarray(np.clip(np.rint(rgb), 0, 255).astype(np.uint8)).save(path)


def kitti_colour_dir(root, lefts, rights):
    """A KITTI sequence with colour cameras 2 and 3 at twice the size (the
    loader's 2x decimation gives the frames back) and a calib.txt."""
    cl, cr = _cams_np()
    rows = []
    for i in range(4):
        tx = -2 * FX * BASE if i == 3 else 0.0
        rows.append(f"P{i}: {2 * FX} 0 {2 * cl['cx']} {tx} 0 {2 * FX} "
                    f"{2 * cl['cy']} 0 0 0 1 0")
    os.makedirs(root)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    for cam, seq in ((2, lefts), (3, rights)):
        os.makedirs(os.path.join(root, f"image_{cam}"))
        for i, img in enumerate(seq):
            _write_png(os.path.join(root, f"image_{cam}", f"{i:06d}.png"),
                       np.repeat(np.repeat(img, 2, axis=0), 2, axis=1))


def _cli_setup(tmp_path):
    lefts, rights, kfs = _sequence(2, seed=11, width=200)
    seq = str(tmp_path / "sequence")
    kitti_colour_dir(seq, lefts, rights)
    out = save_slam_output(str(tmp_path / "slam"), seq, 0, kfs,
                           np.zeros((0, 3)), timestamped_subdir=False)
    cfg = tmp_path / "dense.yaml"
    cfg.write_text("%YAML:1.0\n---\nslam_output_dir: "
                   f"{os.path.join(out, 'keyframes.txt')}\n"
                   "left_cam_index: 2\nright_cam_index: 3\n"
                   "is_color_input: 1\n")
    return str(cfg), out, lefts


def test_cli_on_the_cpu(tmp_path, capsys):
    cfg, out, lefts = _cli_setup(tmp_path)
    assert app.main([cfg, "--device", "cpu"]) == 0
    said = capsys.readouterr().out.strip().splitlines()[-1]
    path = os.path.join(out, "dense_pointcloud.pcd")
    pts, cols = read_pcd(path)
    assert said == (f"Dense reconstruction finished: {len(pts)} points -> "
                    f"{path}")
    assert len(pts) > 500
    # colours come from the RGB frames, channel by channel
    palette = set(map(tuple, np.clip(np.rint(lefts), 0, 255).astype(
        np.uint8).reshape(-1, 3)))
    assert all(tuple(c) in palette for c in cols[:200])
    assert (cols[:, 0] != cols[:, 2]).mean() > 0.9
    # the batched command line gives the same cloud
    assert app.main([cfg, "--device", "cpu", "--mesh",
                     "--per-device-batch", "4"]) == 0
    p2, c2 = read_pcd(path)
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, cols)


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    cfg, _, _ = _cli_setup(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([cfg])
    assert app.main([cfg, "--device", "cpu"]) == 0


def test_missing_config(tmp_path, capsys):
    assert app.main([str(tmp_path / "nope.yaml")]) == 1
    assert "Config file not found" in capsys.readouterr().out
