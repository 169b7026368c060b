"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exports plain C functions. It is compiled at first use
by `nvcc -gencode arch=compute_90a,code=sm_90a` into its own shared library
under `stereovision_slam_torch/_build/` (listed in .gitignore), named by a
hash of the source so an edited source rebuilds, and loaded with ctypes.
`build_all()` starts one nvcc per source at once and waits for all of them.

Kernels launch on PyTorch's current stream of their tensors' card, with
that card made the CUDA runtime's current device for the call (`launch`):
a C entry point launches on the current device, and kernel A's opt-in to
more shared memory holds for that device only. Every C entry point
returns the `cudaGetLastError()` after its launch, and `check()` raises on
a non-zero code. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lk_pyramid", "pose_lm", "lk_iterate", "gather_windows",
           "ring_reduce", "ba_window")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def function(lib: str, name: str, argtypes: list):
    """C entry point `name` of library `lib`, with its argument types set
    (pointers and the stream as c_void_p) and an int return code."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def launch(fn, what: str, like, *args) -> None:
    """Call the C entry point `fn(*args, stream)` with `like`'s card the
    current device and PyTorch's current stream of that card as the last
    argument; raise on a launch error."""
    import torch
    with torch.cuda.device(like.device):
        code = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    check(code, what)
