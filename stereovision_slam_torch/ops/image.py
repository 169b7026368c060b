"""Image primitives: pyramids, gradients, bilinear patch sampling
(counterpart of `ops/image.py`).

Filters are the reference's zero-padded separable shift-adds, term by term in
the same order, rather than `F.conv2d`: cuDNN would run a float32 convolution
in TF32 by default, and the order of the taps would differ. Every function
works on the last two axes, so a (B, H, W) stack is filtered in one pass.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sep_filter(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Row kernel kx then column kernel ky, SAME size, zero padding."""
    kx = np.asarray(kx, dtype=np.float32).tolist()
    ky = np.asarray(ky, dtype=np.float32).tolist()
    H, W = img.shape[-2:]
    rx, ry = len(kx) // 2, len(ky) // 2
    padded = F.pad(img, (rx, rx, 0, 0))
    out = None
    for i, w in enumerate(kx):
        if w == 0.0:
            continue
        term = padded[..., :, i:i + W] * w
        out = term if out is None else out + term
    padded = F.pad(out, (0, 0, ry, ry))
    out2 = None
    for i, w in enumerate(ky):
        if w == 0.0:
            continue
        term = padded[..., i:i + H, :] * w
        out2 = term if out2 is None else out2 + term
    return out2


_PYRDOWN_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian 5-tap blur + 2x decimation (cv::pyrDown semantics)."""
    return _sep_filter(img, _PYRDOWN_K, _PYRDOWN_K)[..., ::2, ::2]


def build_pyramid(img: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """`num_levels` images, level 0 = full resolution."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def build_pyramid_batched(imgs: torch.Tensor,
                          num_levels: int) -> list[torch.Tensor]:
    """Pyramids of a (B, H, W) stack, one pass per level."""
    return build_pyramid(imgs, num_levels)


_SCHARR_D = np.array([-1.0, 0.0, 1.0], np.float32)
_SCHARR_S = np.array([3.0, 10.0, 3.0], np.float32) / 32.0


def scharr_gradients(img: torch.Tensor):
    return (_sep_filter(img, _SCHARR_D, _SCHARR_S),
            _sep_filter(img, _SCHARR_S, _SCHARR_D))


def sobel_gradients(img: torch.Tensor):
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    return _sep_filter(img, d, s), _sep_filter(img, s, d)


def _bilinear_combine(raw: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """(N, S, S) integer samples -> (N, S-1, S-1), the reference's 4-term
    order."""
    fx = frac[:, 0][:, None, None]
    fy = frac[:, 1][:, None, None]
    return ((1 - fy) * (1 - fx) * raw[:, :-1, :-1]
            + (1 - fy) * fx * raw[:, :-1, 1:]
            + fy * (1 - fx) * raw[:, 1:, :-1]
            + fy * fx * raw[:, 1:, 1:])


def sample_patches(img: torch.Tensor, centers: torch.Tensor, size: int):
    """Bilinear `size` x `size` patches centered at (N, 2) float (x, y).

    Returns (patches (N, size, size), valid (N,)): valid when the whole patch
    with its +1 bilinear apron is in bounds."""
    H, W = img.shape
    half = (size - 1) / 2.0
    tl = centers - half
    base = torch.floor(tl)
    frac = tl - base
    x0 = torch.clamp(base[:, 0].to(torch.int64), 0, W - size - 1)
    y0 = torch.clamp(base[:, 1].to(torch.int64), 0, H - size - 1)
    valid = ((tl[:, 0] >= 0.0) & (tl[:, 1] >= 0.0)
             & (tl[:, 0] + size < W) & (tl[:, 1] + size < H))
    r = torch.arange(size + 1, device=img.device)
    rows = (y0[:, None] + r[None])[:, :, None]
    cols = (x0[:, None] + r[None])[:, None, :]
    raw = img[rows, cols]
    return _bilinear_combine(raw, frac), valid
