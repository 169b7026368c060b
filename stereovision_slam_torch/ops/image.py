"""Image primitives: pyramids, gradients, Gaussian blur, linear resize,
bilinear patch and point sampling (counterpart of `ops/image.py`).

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


# OpenCV's fixed small-kernel tables (getGaussianKernel with sigma <= 0 and
# ksize <= 7 returns these, not the sigma formula).
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125], np.float32),
}


def gaussian_kernel1d(size: int, sigma: float | None = None) -> np.ndarray:
    """Odd-sized normalized 1-D Gaussian (OpenCV conventions when sigma is
    None: fixed taps for ksize <= 7, else sigma 0.3((k-1)/2-1)+0.8), as a
    numpy array: the taps are constants of the shift-add filter."""
    if (sigma is None or sigma <= 0) and size in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[size]
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


def gaussian_blur(img: torch.Tensor, size: int,
                  sigma: float | None = None) -> torch.Tensor:
    """Separable Gaussian blur, SAME size, zero padding."""
    k = gaussian_kernel1d(size, sigma)
    return _sep_filter(img, k, k)


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """(..., H, W) -> (..., h, w), the counterpart of `jax.image.resize(img,
    shape, "linear")`: half-pixel centers and, when shrinking, a triangle
    kernel widened by the scale (JAX antialiases by default), which is
    `F.interpolate(..., "bilinear", antialias=True)`."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    out = F.interpolate(x, size=tuple(shape), mode="bilinear",
                        antialias=True, align_corners=False)
    return out.reshape(*lead, *shape)


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


def floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, with non-finite values read as 0 (they belong to
    masked slots, whose indices only need to stay in bounds; the
    reference's float->int conversion saturates)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.floor(torch.clamp(x, -1e9, 1e9)).to(torch.int64)


def _patch_corners(H: int, W: int, centers: torch.Tensor, size: int):
    """Integer corners (y0, x0) clipped into an (H, W) image, bilinear
    fractions and the in-bounds flag of `size` patches at (N, 2) centers."""
    half = (size - 1) / 2.0
    tl = centers - half
    frac = tl - torch.floor(tl)
    x0 = torch.clamp(floor_int(tl[:, 0]), 0, W - size - 1)
    y0 = torch.clamp(floor_int(tl[:, 1]), 0, H - size - 1)
    valid = ((tl[:, 0] >= 0.0) & (tl[:, 1] >= 0.0)
             & (tl[:, 0] + size < W) & (tl[:, 1] + size < H))
    return y0, x0, frac, valid


def gather_patches(imgs: torch.Tensor, group, y0, x0, size: int):
    """(N, size+1, size+1) integer-corner windows `imgs[group, y0 + r,
    x0 + c]` of a (G, H, W) stack: the reference's `_gather_patches_mxu`,
    whose one-hot matmuls exist only for the TPU. Indices are clamped into
    the image; callers pass corners already clipped, so the clamp only keeps
    a read in bounds."""
    G, H, W = imgs.shape
    r = torch.arange(size + 1, device=imgs.device)
    rows = torch.clamp(y0.to(torch.int64)[:, None] + r, 0, H - 1)
    cols = torch.clamp(x0.to(torch.int64)[:, None] + r, 0, W - 1)
    return imgs[group.to(torch.int64)[:, None, None], rows[:, :, None],
                cols[:, None, :]]


def _groups(n: int, group, device) -> torch.Tensor:
    if group is None:
        return torch.zeros(n, dtype=torch.int64, device=device)
    return group


def sample_patches(img: torch.Tensor, centers: torch.Tensor, size: int,
                   group=None):
    """Bilinear `size` x `size` patches centered at (N, 2) float (x, y).

    img is (H, W), or (G, H, W) with `group` (N,) naming each point's image.
    Returns (patches (N, size, size), valid (N,)): valid when the whole patch
    with its +1 bilinear apron is in bounds."""
    H, W = img.shape[-2:]
    y0, x0, frac, valid = _patch_corners(H, W, centers, size)
    stack = img if img.dim() == 3 else img[None]
    raw = gather_patches(stack, _groups(len(centers), group, img.device),
                         y0, x0, size)
    return _bilinear_combine(raw, frac), valid


def sample_patches_multi(imgs: torch.Tensor, centers: torch.Tensor,
                         size: int, group=None):
    """Patches of C same-shape images at shared centers: imgs (C, H, W), or
    (C, G, H, W) with `group` (N,). Bit-identical to C `sample_patches`
    calls. Returns (patches (C, N, size, size), valid (N,))."""
    C = imgs.shape[0]
    H, W = imgs.shape[-2:]
    y0, x0, frac, valid = _patch_corners(H, W, centers, size)
    g = _groups(len(centers), group, imgs.device)
    stacks = imgs if imgs.dim() == 4 else imgs[:, None]
    patches = torch.stack([
        _bilinear_combine(gather_patches(stacks[c], g, y0, x0, size), frac)
        for c in range(C)])
    return patches, valid


def bilinear_sample(img: torch.Tensor, pts: torch.Tensor):
    """Bilinear samples of an (H, W) image at (N, 2) float (x, y) points.
    Returns (values (N,), valid (N,)): valid inside [0, W - 2] x
    [0, H - 2]."""
    patches, _ = sample_patches(img, pts, 1)
    H, W = img.shape
    valid = ((pts[:, 0] >= 0.0) & (pts[:, 1] >= 0.0)
             & (pts[:, 0] <= W - 2.0) & (pts[:, 1] <= H - 2.0))
    return patches[:, 0, 0], valid
