"""New keypoints and their depth: good-features-to-track corners away from
the tracked features, and the two-view triangulation of the rig.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.image import filter2, sobel


def min_eig(img: torch.Tensor) -> torch.Tensor:
    """The Shi-Tomasi response: the smaller eigenvalue of the structure
    tensor of Sobel gradients, summed over 3 x 3 and divided by 9."""
    ix, iy = sobel(img)
    box, ones = (1 / 9,) * 3, (1.0,) * 3
    sxx, syy, sxy = filter2(torch.stack([ix * ix, iy * iy, ix * iy]), box,
                            ones)
    d = sxx - syy
    return 0.5 * (sxx + syy) - torch.sqrt(torch.clamp(0.25 * d * d + sxy * sxy,
                                                      min=0.0))


def free_area(H: int, W: int, pts: torch.Tensor, valid: torch.Tensor,
              cell: int) -> torch.Tensor:
    """(H, W) True away from the valid points: the image cut into cells of
    `cell` pixels, a point marks its cell and the eight around it."""
    cell = max(int(cell), 1)
    gh, gw = -(-H // cell), -(-W // cell)
    cx = torch.clamp((pts[:, 0] / cell).long(), 0, gw - 1)
    cy = torch.clamp((pts[:, 1] / cell).long(), 0, gh - 1)
    grid = torch.zeros(gh, gw)
    grid[cy[valid], cx[valid]] = 1.0
    near = F.max_pool2d(grid[None, None], 3, stride=1, padding=1)[0, 0] > 0
    near = near.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return ~near[:H, :W]


def corners(img: torch.Tensor, n: int, quality: float, min_distance: int,
            mask=None, border: int = 3):
    """Up to n corners, strongest first: local maxima of the response over
    (2r + 1)^2, r = min_distance // 2, that are positive, inside `border`
    and `mask`; valid above quality x the largest response. Equal
    responses keep raster order. Returns (pts (n, 2), valid (n,))."""
    H, W = img.shape
    resp = min_eig(img)
    keep = torch.ones_like(resp, dtype=torch.bool) if mask is None else mask
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    keep = keep & (yy >= border) & (yy < H - border) & (xx >= border) \
        & (xx < W - border)
    resp = torch.where(keep, resp, torch.zeros_like(resp))
    r = max(min_distance // 2, 1)
    peak = F.max_pool2d(resp[None, None], 2 * r + 1, stride=1,
                        padding=r)[0, 0]
    score = torch.where((resp >= peak) & (resp > 0), resp,
                        torch.zeros_like(resp)).reshape(-1)
    order = torch.sort(score, descending=True, stable=True).indices[:n]
    pts = torch.stack([(order % W).float(), (order // W).float()], -1)
    valid = score[order] > torch.clamp(quality * resp.max(), min=0.0)
    return pts, valid


def triangulate(ext_l: torch.Tensor, ext_r: torch.Tensor, xl: torch.Tensor,
                xr: torch.Tensor, ratio: float = 1e-2):
    """Rig-frame points (N, 3) from normalized coordinates (N, 2) in the
    two cameras, by the null vector of the 4 x 4 linear system (in float64),
    and whether each is well conditioned: singular values s0 >= .. >= s3
    with s3 / s2 < ratio, s2 > 1e-6 s0, and a finite homogeneous scale."""
    rows = []
    for P, x in ((ext_l, xl), (ext_r, xr)):
        P = P.double()
        x = x.double()
        rows += [x[:, :1] * P[2] - P[0], x[:, 1:] * P[2] - P[1]]
    A = torch.stack(rows, 1)
    ev, V = torch.linalg.eigh(A.transpose(1, 2) @ A)
    s = torch.sqrt(torch.clamp(ev, min=0.0)).flip(-1)
    w = V[:, :, 0]
    h = w[:, 3]
    ok = (s[:, 3] / torch.clamp(s[:, 2], min=1e-20) < ratio) \
        & (s[:, 2] > 1e-6 * torch.clamp(s[:, 0], min=1e-20)) \
        & (h.abs() >= 1e-12)
    h = torch.where(h.abs() < 1e-12, torch.ones_like(h), h)
    xyz = w[:, :3] / h[:, None]
    return xyz.float(), ok
