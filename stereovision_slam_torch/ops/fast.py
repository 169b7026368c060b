"""FAST-9 corner detection, the ORB detector's corner stage (counterpart
of `ops/fast.py`).

The config's `keypoint_feature_detector: ORB` detects with FAST-9: the 16
pixels of the radius-3 Bresenham ring as 16 rolled copies of the image,
bright and dark ring masks against the centre +- the threshold, and the
>= 9 contiguous test as an unrolled AND over the 16 cyclic windows. The
score is the sum of |ring - centre| - threshold over the whole ring (the
reference's approximation of the arc's sum, which keeps the ranking),
summed in ring order. Selection as `ops/gftt.py`: an in-bounds mask, a
(2r+1)^2 max-pool non-maximum suppression with -inf padding, and a stable
descending sort for `lax.top_k`'s ties toward the lower index.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.ops.gftt import _max_pool_same

# Bresenham circle of radius 3 (the FAST-16 ring), (dy, dx)
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: at least 9 contiguous ring pixels brighter or darker


def _has_arc(mask: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(mask[0])
    for start in range(16):
        run = mask[start]
        for k in range(1, ARC):
            run = run & mask[(start + k) % 16]
        out = out | run
    return out


def fast_response(img: torch.Tensor, threshold: float = 10.0) -> torch.Tensor:
    """(H, W) FAST-9 response: 0 off corners, else the full ring's score."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                        for dy, dx in _RING])          # (16, H, W)
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold
    is_corner = _has_arc(bright) | _has_arc(dark)
    excess = torch.clamp(torch.abs(ring - img[None]) - threshold, min=0.0)
    score = excess[0]
    for i in range(1, 16):
        score = score + excess[i]
    return torch.where(is_corner, score, torch.zeros_like(score))


def detect(img: torch.Tensor, max_corners: int, threshold: float = 10.0,
           min_distance: int = 20, mask: torch.Tensor | None = None,
           border: int = 4):
    """FAST corners with `gftt.detect`'s contract: (pts (max_corners, 2)
    float (x, y), valid, scores), strongest first."""
    H, W = img.shape
    resp = fast_response(img, threshold)
    zero = torch.zeros((), dtype=resp.dtype, device=resp.device)
    if mask is not None:
        resp = torch.where(mask, resp, zero)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    resp = torch.where(inb, resp, zero)

    r = max(min_distance // 2, 1)
    pooled = _max_pool_same(resp, 2 * r + 1)
    is_peak = (resp >= pooled) & (resp > 0.0)
    flat = torch.where(is_peak, resp, zero).reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:max_corners], idx[:max_corners]
    pts = torch.stack([(idx % W).to(torch.float32),
                       (idx // W).to(torch.float32)], dim=-1)
    return pts, scores > 0.0, scores
