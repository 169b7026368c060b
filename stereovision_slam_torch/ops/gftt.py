"""Good-features-to-track corner detection (counterpart of `ops/gftt.py`).

Min-eigenvalue response from Sobel gradients and a box-filtered structure
tensor, an occupancy mask around tracked features, (2r+1)^2 max-pool
non-maximum suppression, and a top-k selection. `lax.top_k` breaks ties
toward the lower index, so the selection here is a stable descending sort.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stereovision_slam_torch.ops import image as imops


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue response (cv::cornerMinEigenVal)."""
    ix, iy = imops.sobel_gradients(img)
    box = np.ones(block_size, np.float32) / float(block_size * block_size)
    ones = np.ones(block_size, np.float32)
    planes = torch.stack([ix * ix, iy * iy, ix * iy])
    sxx, syy, sxy = imops._sep_filter(planes, box, ones)
    tr_half = 0.5 * (sxx + syy)
    dd = sxx - syy
    det_part = torch.sqrt(torch.clamp(0.25 * (dd * dd) + sxy * sxy, min=0.0))
    return tr_half - det_part


def _max_pool_same(x: torch.Tensor, win: int) -> torch.Tensor:
    """(H, W) max over a win x win window, SAME size, -inf padding."""
    return F.max_pool2d(x[None, None], win, stride=1, padding=win // 2)[0, 0]


def occupancy_mask(shape: tuple[int, int], pts: torch.Tensor,
                   pts_valid: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) bool, False within ~radius of any valid point (cell grid of
    side `radius`, each occupied cell dilated by one cell)."""
    H, W = shape
    cell = max(int(radius), 1)
    gh = -(-H // cell)
    gw = -(-W // cell)
    cx = torch.clamp((pts[:, 0] / cell).to(torch.int64), 0, gw - 1)
    cy = torch.clamp((pts[:, 1] / cell).to(torch.int64), 0, gh - 1)
    grid = torch.zeros(gh * gw, dtype=torch.float32, device=pts.device)
    grid.scatter_reduce_(0, cy * gw + cx, pts_valid.to(torch.float32), "amax")
    dil = _max_pool_same(grid.reshape(gh, gw), 3) > 0.5
    up = dil.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:H, :W]
    return ~up


def detect(img: torch.Tensor, max_corners: int, quality_level: float = 0.01,
           min_distance: int = 20, mask: torch.Tensor | None = None,
           border: int = 3):
    """Up to `max_corners` corners, strongest first.

    Returns (pts (max_corners, 2) float (x, y), valid (max_corners,),
    scores (max_corners,))."""
    H, W = img.shape
    resp = min_eig_response(img)
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
    thresh = quality_level * torch.max(resp)
    valid = scores > torch.clamp(thresh, min=0.0)
    return pts, valid, scores
