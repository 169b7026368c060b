"""The per-point window gather (counterpart of `benchmarks/probe_gather.py`'s
`_dynslice_kernel` and of `ops/image.py:_gather_patches_mxu`).

`gather_windows` writes the (P, P) window of each point's level image at
its integer corner: the CUDA kernel of `csrc/gather_windows.cu` on a CUDA
tensor, `gather_windows_plain` (one advanced-indexing expression,
`image.gather_patches`) on a CPU tensor. The windows are kernel C's `win`
input (`ops/lk_iterate.py`).
"""

from __future__ import annotations

import ctypes

import torch

from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.ops import image as imops

launch_count = 0
# gather_windows_launch(imgs, group, cy, cx, out, N, H, W, P, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gather_windows_plain(imgs, group, cy, cx, P: int) -> torch.Tensor:
    """Plain PyTorch version: (N, P, P) windows imgs[group, cy + r, cx + c]."""
    return imops.gather_patches(imgs, group, cy, cx, P - 1)


def gather_windows(imgs, group, cy, cx, P: int) -> torch.Tensor:
    """(N, P, P) windows of the (G, H, W) float32 stack `imgs` at integer
    corners (cy, cx) (N,), point n reading image group[n]. The corners are
    clipped into [0, H - P] x [0, W - P] by the caller (lk._track_level)."""
    if imgs.device.type == "cpu":
        return gather_windows_plain(imgs, group, cy, cx, P)
    if imgs.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {imgs.device}")
    G, H, W = imgs.shape
    N = group.shape[0]
    if imgs.dtype != torch.float32 or not imgs.is_contiguous():
        raise ValueError("gather_windows: imgs must be contiguous float32")
    for name, t in (("group", group), ("cy", cy), ("cx", cx)):
        if (t.shape != (N,) or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != imgs.device):
            raise ValueError(f"gather_windows: {name} must be a contiguous "
                             f"int32 ({N},) tensor on {imgs.device}")
    if not 0 < P <= min(H, W):
        raise ValueError(f"gather_windows: window {P} exceeds the {H}x{W} "
                         "image")
    out = torch.empty((N, P, P), dtype=torch.float32, device=imgs.device)
    fn = _cuda.function("gather_windows", "gather_windows_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    _cuda.launch(fn, "gather_windows", imgs, imgs.data_ptr(),
                 group.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                 out.data_ptr(), N, H, W, P)
    return out
