"""Image operations the reference's stages share: zero-padded separable
filters, the 5-tap pyramid, gradient kernels and bilinear patches.

Images are float32 (H, W) grey values in [0, 255]; a point is (x, y) in
pixels, x along the row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PYR_TAPS = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
# OpenCV's getGaussianKernel for ksize 5 and 7 with sigma <= 0
GAUSS5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)
GAUSS7 = (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125)


def filter2(img: torch.Tensor, along_x, along_y) -> torch.Tensor:
    """Separable correlation with zero padding, same size: `along_x` over
    each row, then `along_y` over each column. img (..., H, W)."""
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    kx = torch.tensor(along_x, dtype=img.dtype).reshape(1, 1, 1, -1)
    ky = torch.tensor(along_y, dtype=img.dtype).reshape(1, 1, -1, 1)
    x = F.conv2d(x, kx, padding=(0, len(along_x) // 2))
    x = F.conv2d(x, ky, padding=(len(along_y) // 2, 0))
    return x.reshape(*lead, H, W)


def pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Level 0 the image; each next level blurred by the 5-tap binomial
    and every second row and column kept (cv::pyrDown)."""
    out = [img]
    for _ in range(levels - 1):
        out.append(filter2(out[-1], PYR_TAPS, PYR_TAPS)[..., ::2, ::2])
    return out


def sobel(img: torch.Tensor):
    """(d/dx, d/dy) with the 3x3 Sobel kernels."""
    d, s = (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)
    return filter2(img, d, s), filter2(img, s, d)


def floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64; non-finite values (unused slots) read as 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.floor(torch.clamp(x, -1e9, 1e9)).long()


def bilinear(raw: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """(N, S + 1, S + 1) integer samples -> (N, S, S) at the fractional
    offset (fx, fy) (N,) from each sample."""
    fx, fy = fx[:, None, None], fy[:, None, None]
    return ((1 - fy) * (1 - fx) * raw[:, :-1, :-1]
            + (1 - fy) * fx * raw[:, :-1, 1:]
            + fy * (1 - fx) * raw[:, 1:, :-1] + fy * fx * raw[:, 1:, 1:])


def window(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
           size: int) -> torch.Tensor:
    """(N, size, size) of img (H, W) from integer corners (N,), indices
    clamped into the image."""
    H, W = img.shape
    r = torch.arange(size)
    ys = torch.clamp(y0[:, None] + r, 0, H - 1)
    xs = torch.clamp(x0[:, None] + r, 0, W - 1)
    return img[ys[:, :, None], xs[:, None, :]]


def patches(img: torch.Tensor, centers: torch.Tensor, size: int):
    """Bilinear size x size patches centred on (N, 2) points, and whether
    each patch with its one-pixel apron lies in the image."""
    H, W = img.shape
    tl = centers - (size - 1) / 2.0
    frac = tl - torch.floor(tl)
    x0 = torch.clamp(floor_index(tl[:, 0]), 0, W - size - 1)
    y0 = torch.clamp(floor_index(tl[:, 1]), 0, H - size - 1)
    ok = ((tl[:, 0] >= 0) & (tl[:, 1] >= 0) & (tl[:, 0] + size < W)
          & (tl[:, 1] + size < H))
    return bilinear(window(img, x0, y0, size + 1), frac[:, 0],
                    frac[:, 1]), ok
