"""ctypes bindings for the native (C++) stereo-frame loader (counterpart of
`io/native_loader.py`).

PNG decode and decimation run in the worker threads of
`stereovision_slam_torch/native/dataloader.cpp`, which prefetch ahead of the
pipeline. The library is built at first use with `g++ -O3 -fPIC -std=c++17
-shared ... -lpng -lpthread` into `stereovision_slam_torch/_build/` (listed
in .gitignore), named by a hash of its source so an edited source rebuilds,
and loaded with ctypes. A failed build raises from `NativeKittiDataset` and
`decode_png`; `native_available()` reports it. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from stereovision_slam_torch.io.dataset import StereoFrame
from stereovision_slam_torch.io.kitti import KittiDataset

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "dataloader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
LIBS = ["-lpng", "-lpthread"]
_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"libsvslam_loader_{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the native loader's build failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.svslam_loader_create.restype = ctypes.c_void_p
    lib.svslam_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.svslam_loader_get.restype = ctypes.c_int
    lib.svslam_loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, fp, fp, ctypes.c_int, ctypes.c_int,
        ip, ip]
    lib.svslam_loader_destroy.restype = None
    lib.svslam_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.svslam_decode_png.restype = ctypes.c_int
    lib.svslam_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.c_int, fp, ctypes.c_int, ctypes.c_int, ip, ip]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (g++ and libpng)."""
    try:
        _load_lib()
        return True
    except (RuntimeError, OSError):
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_png(path: str, downsample: int = 1,
               max_shape=(2048, 4096)) -> np.ndarray | None:
    """One grayscale float32 decode through the native library; None when
    the file is missing or not a PNG."""
    lib = _load_lib()
    buf = np.empty(max_shape, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    ok = lib.svslam_decode_png(path.encode(), downsample, _fptr(buf),
                               max_shape[0], max_shape[1], ctypes.byref(h),
                               ctypes.byref(w))
    if not ok:
        return None
    return buf.reshape(-1)[:h.value * w.value].reshape(h.value,
                                                       w.value).copy()


class NativeKittiDataset(KittiDataset):
    """`KittiDataset` (calibration, cameras, numpy frames) whose
    `next_frame` reads the native loader's prefetching worker threads.
    Grayscale only, as the reference's."""

    def __init__(self, dataset_dir: str, left_cam_index: int = 0,
                 right_cam_index: int = 1, downsample: int = 2,
                 n_prefetch: int = 8, n_threads: int = 2,
                 max_shape=(2048, 4096), device="cuda"):
        super().__init__(dataset_dir, left_cam_index, right_cam_index,
                         is_color_input=False, downsample=downsample,
                         device=device)
        self._lib = _load_lib()
        self._handle = None
        self._n_prefetch = n_prefetch
        self._n_threads = n_threads
        self._max_shape = max_shape

    def initialize(self) -> None:
        super().initialize()
        self.close()
        left_dir = os.path.join(self.dataset_dir,
                                f"image_{self.left_cam_index}")
        right_dir = os.path.join(self.dataset_dir,
                                 f"image_{self.right_cam_index}")
        self._handle = self._lib.svslam_loader_create(
            left_dir.encode(), right_dir.encode(), self.downsample,
            self._n_prefetch, self._n_threads)

    def next_frame(self) -> StereoFrame | None:
        fid = self.current_index
        mh, mw = self._max_shape
        left = np.empty((mh, mw), np.float32)
        right = np.empty((mh, mw), np.float32)
        h, w = ctypes.c_int(), ctypes.c_int()
        ok = self._lib.svslam_loader_get(self._handle, fid, _fptr(left),
                                         _fptr(right), mh, mw,
                                         ctypes.byref(h), ctypes.byref(w))
        if not ok:
            return None
        self.current_index += 1
        n = h.value * w.value
        shape = (h.value, w.value)
        return StereoFrame(
            frame_id=fid,
            left=left.reshape(-1)[:n].reshape(shape).copy(),
            right=right.reshape(-1)[:n].reshape(shape).copy())

    def close(self) -> None:
        if self._handle is not None:
            self._lib.svslam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
