"""Dense stereo block matching (counterpart of `ops/stereo_bm.py`).

The reference's replacement for cv::StereoBM (128 disparities, 15x15
block): the whole SAD cost volume at once - for every disparity d the
absolute difference of the left image and the right image shifted right by
d, columns x < d set to 1e6, box-filtered by two separable sums - then the
first argmin over the disparity axis, a uniqueness test against the best
cost outside +-1, a parabola through the neighbours for the sub-pixel
offset, a texture gate on the box-filtered |Sobel x| and the border mask.

The volume is (D, H, W), or (B, D, H, W) for a (B, H, W) stack of pairs
(the reference vmaps over keyframes); the box filter is `imops._sep_filter`,
the reference's zero-padded shift-adds in its order. Every step but the
texture gate's image mean is elementwise or a min/argmin, so the disparity
and validity are the same bits on the CPU and on the card. The mean is
accumulated in float64 and rounded to float32, so it does not depend on a
reduction order either (the reference takes a float32 mean).

The 1e6 sentinel is kept as the reference has it: window sums that mix
sentinels and real costs near the left border lose their fractional digits
in float32, and the `cmin < 1e5` gate and the `x >= border + D` mask hide
them.
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_slam_torch.ops import image as imops

SENTINEL = 1e6


def _box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    k = np.ones((size,), np.float32)
    return imops._sep_filter(img, k, k)


def _texture(left: torch.Tensor, block_size: int, texture_threshold: float):
    """The texture statistic (the box-filtered |Sobel x| over the block's
    area) and its threshold, broadcast per image."""
    ix, _ = imops.sobel_gradients(left)
    area = torch.full((), float(block_size * block_size), dtype=ix.dtype,
                      device=ix.device)
    tex = _box_filter(torch.abs(ix), block_size) / area
    mean = left.to(torch.float64).mean(dim=(-2, -1)).to(torch.float32)
    gate = (texture_threshold / 255.0 * torch.clamp(mean, min=1.0)) * 0.05
    return tex, gate[..., None, None]


def cost_volume(left: torch.Tensor, right: torch.Tensor, num_disparities: int,
                block_size: int) -> torch.Tensor:
    """(..., H, W) pairs -> (..., D, H, W) box-filtered SAD costs:
    `roll(right, d)` along x, |left - shifted|, 1e6 where x < d."""
    W = left.shape[-1]
    dev = left.device
    d = torch.arange(num_disparities, device=dev)[:, None]
    x = torch.arange(W, device=dev)[None, :]
    shifted = right[..., (x - d) % W].movedim(-2, -3)   # (..., D, H, W)
    ad = torch.abs(left[..., None, :, :] - shifted)
    ad = torch.where((x >= d)[:, None, :], ad,
                     torch.full((), SENTINEL, dtype=ad.dtype, device=dev))
    return _box_filter(ad, block_size)


def compute_disparity(left: torch.Tensor, right: torch.Tensor,
                      num_disparities: int = 128, block_size: int = 15,
                      uniqueness_ratio: float = 1.12,
                      texture_threshold: float = 12.0):
    """Disparity map of a rectified grayscale pair, or of a (B, H, W)
    stack of pairs.

    Returns (disp (..., H, W) float32 sub-pixel disparity, 0 where invalid,
    valid (..., H, W) bool)."""
    H, W = left.shape[-2:]
    D = num_disparities
    dev = left.device
    costs = cost_volume(left, right, D, block_size)

    def full(v):
        return torch.full((), v, dtype=costs.dtype, device=dev)

    best = torch.argmin(costs, dim=-3)                  # first minimum
    cmin = torch.amin(costs, dim=-3)

    # uniqueness: the best cost outside +-1 of the minimum must be worse
    d_axis = torch.arange(D, device=dev)[:, None, None]
    near = torch.abs(d_axis - best[..., None, :, :]) <= 1
    second = torch.amin(torch.where(near, full(SENTINEL), costs), dim=-3)
    unique = second >= cmin * uniqueness_ratio

    # sub-pixel parabola around the minimum
    bm1 = torch.clamp(best - 1, 0, D - 1)
    bp1 = torch.clamp(best + 1, 0, D - 1)
    c0 = torch.gather(costs, -3, bm1[..., None, :, :])[..., 0, :, :]
    c1 = cmin
    c2 = torch.gather(costs, -3, bp1[..., None, :, :])[..., 0, :, :]
    denom = c0 - 2 * c1 + c2
    big = torch.abs(denom) > 1e-6
    delta = torch.where(big, 0.5 * (c0 - c2) / torch.where(big, denom,
                                                            full(1.0)),
                        full(0.0))
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    # texture gate: flat regions are unreliable
    tex, gate = _texture(left, block_size, texture_threshold)
    textured = tex > gate

    border = block_size // 2
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = ((yy >= border) & (yy < H - border)
           & (xx >= border + D) & (xx < W - border))
    valid = unique & textured & inb & (best > 0) & (cmin < 1e5)
    return torch.where(valid, disp, full(0.0)), valid


def texture_margin(left: torch.Tensor, block_size: int = 15,
                   texture_threshold: float = 12.0) -> torch.Tensor:
    """|tex - threshold| / threshold per pixel: how close each pixel's
    texture statistic sits to the gate (where another package's float32
    image mean can flip the decision)."""
    tex, gate = _texture(left, block_size, texture_threshold)
    return torch.abs(tex - gate) / gate
