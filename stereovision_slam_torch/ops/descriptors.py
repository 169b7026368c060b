"""Oriented BRIEF (ORB-style) binary descriptors (counterpart of
`ops/descriptors.py`): per keypoint an orientation from the
intensity-centroid moments of a 31x31 patch of the 5-tap blurred image,
then 256 comparisons va < vb over a seeded Gaussian sampling pattern
rotated by that orientation, sampled nearest (rounded offsets) from a
bilinear 33x33 patch, packed into 8 words of 32 bits.

The reference samples nearest with two one-hot contractions, which exist
for the TPU; a direct gather returns the same values. The words are int32
tensors holding the reference's uint32 bits (`convert.py` views one as the
other).
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_slam_torch.ops import image as imops

PATCH = 31           # orientation / sampling patch (cv::ORB patchSize)
N_BITS = 256
N_WORDS = N_BITS // 32


def _make_pattern(seed: int = 7) -> np.ndarray:
    """(N_BITS, 4) sampling-pair offsets (x0, y0, x1, y1), sigma PATCH/5,
    the reference's seeded pattern."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pat = rng.normal(0.0, sigma, size=(N_BITS, 4))
    return np.clip(pat, -(PATCH // 2 - 1), PATCH // 2 - 1).astype(np.float32)


def orientations(img: torch.Tensor, pts: torch.Tensor):
    """Intensity-centroid orientation per keypoint over the circular patch.
    Returns (cos, sin, valid) for (N, 2) points."""
    patches, valid = imops.sample_patches(img, pts, PATCH)
    half = (PATCH - 1) / 2.0
    r = torch.arange(PATCH, dtype=img.dtype, device=img.device) - half
    circ = ((r[:, None] ** 2 + r[None, :] ** 2) <= half * half).to(img.dtype)
    pw = patches * circ
    m10 = torch.sum(pw * r[None, None, :], dim=(1, 2))
    m01 = torch.sum(pw * r[None, :, None], dim=(1, 2))
    norm = torch.sqrt(m10 * m10 + m01 * m01)
    safe = torch.clamp(norm, min=1e-9)
    return m10 / safe, m01 / safe, valid


def compute(img: torch.Tensor, pts: torch.Tensor, valid=None, pattern=None):
    """Descriptors for (N, 2) keypoints on an (H, W) image.

    pattern: (N_BITS, 4) offsets, default `_make_pattern()`. Returns (desc
    (N, N_WORDS) int32 packed bits, ok (N,) bool: patch in bounds and the
    point valid)."""
    n = pts.shape[0]
    dev = img.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    if pattern is None:
        pattern = torch.as_tensor(_make_pattern(), device=dev)
    smooth = imops.gaussian_blur(img, 5)
    ca, sa, pv = orientations(smooth, pts)

    px0, py0, px1, py1 = pattern.unbind(1)

    def rot(px, py):
        x = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        y = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return x, y

    x0, y0 = rot(px0, py0)
    x1, y1 = rot(px1, py1)
    # nearest sampling of both endpoints of each pair from one bilinear
    # patch per keypoint (cv::ORB's GET_VALUE rounds the offsets)
    patches, pv2 = imops.sample_patches(smooth, pts, PATCH + 2)
    half = (PATCH + 1) / 2.0
    P2 = PATCH + 2
    xs = torch.cat([x0, x1], dim=1)             # (N, 2 * N_BITS)
    ys = torch.cat([y0, y1], dim=1)
    xi = torch.clamp(torch.round(xs + half).to(torch.int64), 0, P2 - 1)
    yi = torch.clamp(torch.round(ys + half).to(torch.int64), 0, P2 - 1)
    vals = patches[torch.arange(n, device=dev)[:, None], yi, xi]
    bits = (vals[:, :N_BITS] < vals[:, N_BITS:]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = torch.sum(bits.reshape(n, N_WORDS, 32) << shifts, dim=-1)
    words = words - ((words >> 31) & 1) * (1 << 32)   # the bits as int32
    return words.to(torch.int32), valid & pv & pv2
