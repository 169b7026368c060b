"""Port parity, the native (C++) PNG loader (`io/native_loader.py`): the
four cases of tests/test_native_loader.py on the port's loader, and its
frames against the reference's native loader and the port's Pillow loader
on the same files, bit for bit (both decode the same 8-bit pixels and
decimate by nearest neighbour)."""

import ctypes.util
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image


def _missing() -> str | None:
    """What the native loader's build lacks here, or None."""
    if shutil.which("g++") is None:
        return "g++"
    header = subprocess.run(["g++", "-x", "c++", "-E", "-", "-o", "-"],
                            input="#include <png.h>\n", capture_output=True,
                            text=True)
    if header.returncode != 0 or not (ctypes.util.find_library("png16")
                                      or ctypes.util.find_library("png")):
        return "libpng (header or library)"
    return None


MISSING = _missing()
pytestmark = pytest.mark.skipif(MISSING is not None,
                                reason=f"the native loader needs {MISSING}")


def write_png(path, arr):
    Image.fromarray(arr.astype(np.uint8), "L").save(path)


def test_decode_matches_pil(tmp_path):
    from stereovision_slam_torch.io import native_loader
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    p = str(tmp_path / "a.png")
    write_png(p, img)
    out = native_loader.decode_png(p, downsample=1)
    np.testing.assert_array_equal(out, img.astype(np.float32))


def test_decode_downsample(tmp_path):
    from stereovision_slam_torch.io import native_loader
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    p = str(tmp_path / "b.png")
    write_png(p, img)
    out = native_loader.decode_png(p, downsample=2)
    np.testing.assert_array_equal(out, img[::2, ::2].astype(np.float32))


def test_decode_missing_returns_none(tmp_path):
    from stereovision_slam_torch.io import native_loader
    assert native_loader.decode_png(str(tmp_path / "nope.png")) is None


@pytest.fixture
def sequence(tmp_path):
    root = tmp_path / "sequences" / "01"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir(parents=True)
    fx, cx, cy, b = 520.0, 320.0, 92.0, 0.54
    rows = []
    for i in range(4):
        tx = -fx * b if i % 2 == 1 else 0.0
        rows.append(f"P{i}: {fx} 0 {cx} {tx} 0 {fx} {cy} 0 0 0 1 0")
    (root / "calib.txt").write_text("\n".join(rows) + "\n")
    rng = np.random.default_rng(2)
    truth = []
    for i in range(10):
        left = rng.integers(0, 256, (64, 128)).astype(np.uint8)
        right = rng.integers(0, 256, (64, 128)).astype(np.uint8)
        write_png(root / "image_0" / f"{i:06d}.png", left)
        write_png(root / "image_1" / f"{i:06d}.png", right)
        truth.append((left, right))
    return str(root), truth


def test_dataset_prefetch_roundtrip(sequence):
    from stereovision_slam_torch.io import native_loader
    root, truth = sequence
    ds = native_loader.NativeKittiDataset(root, downsample=2, n_prefetch=4,
                                          n_threads=2, device="cpu")
    ds.initialize()
    assert len(ds.cameras) == 4
    n = 0
    while True:
        f = ds.next_frame()
        if f is None:
            break
        tl, tr = truth[f.frame_id]
        np.testing.assert_array_equal(f.left, tl[::2, ::2].astype(np.float32))
        np.testing.assert_array_equal(f.right,
                                      tr[::2, ::2].astype(np.float32))
        assert f.left.shape == (32, 64)
        n += 1
    assert n == 10
    ds.close()


def test_frames_equal_reference_and_pillow_loaders(sequence):
    """Every frame of the port's native loader equals the reference's
    native loader's and the port's Pillow loader's; the cameras equal the
    Pillow loader's."""
    from stereovision_slam_tpu.io import native_loader as jnative
    from stereovision_slam_torch.io import native_loader
    from stereovision_slam_torch.io.kitti import KittiDataset
    if not jnative.native_available():
        pytest.skip("the reference's native loader does not build here")
    root, _ = sequence
    ports = [native_loader.NativeKittiDataset(root, device="cpu"),
             KittiDataset(root, device="cpu"),
             jnative.NativeKittiDataset(root)]
    for ds in ports:
        ds.initialize()
    for a, b in zip(ports[0].cameras, ports[1].cameras):
        for x, y in zip(a, b):
            assert np.array_equal(x.numpy(), y.numpy())
    n = 0
    while True:
        frames = [ds.next_frame() for ds in ports]
        if frames[0] is None:
            assert all(f is None for f in frames)
            break
        for f in frames[1:]:
            assert f.frame_id == frames[0].frame_id
            np.testing.assert_array_equal(frames[0].left, f.left)
            np.testing.assert_array_equal(frames[0].right, f.right)
        n += 1
    assert n == 10
    for ds in (ports[0], ports[2]):
        ds.close()


def test_build_is_named_by_its_source():
    """The library lands in the port's build directory, never in native/,
    under a name that changes with the source."""
    from stereovision_slam_torch.io import native_loader
    path = native_loader.build()
    assert path.parent == native_loader.BUILD_DIR
    assert path.exists() and path == native_loader._lib_path()
    assert native_loader.native_available()
