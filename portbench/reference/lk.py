"""Pyramidal Lucas-Kanade tracking of sparse points, as the tracker runs
it: a fixed search window around each point's guess at every level.

Per level, coarse to fine, each point is tracked on the level edge-padded
by `win // 2 + 2` pixels:
  * its template is the win x win bilinear patch at the source point,
    with Scharr gradients taken inside a (win + 3)^2 window (zero past the
    padded level) and sampled with the same fractions;
  * it may only move inside a search window of the target level, centred
    on its guess and clipped into the padded level, the window `S + 2m`
    pixels a side (S = win + 1, m the level's margin) rounded up to 8;
  * Gauss-Newton steps on the 2x2 structure tensor, at most `iters`,
    stop on a step under `eps`, where the patch leaves the level or the
    window, or where the tensor's smaller eigenvalue per pixel is under
    `min_eig`;
  * the next level's guess is twice the point.
A point's status at the end: its level-0 template inside the padded
level, the tensor solvable there, the final patch inside the padded level,
the point never having left its level-0 window, and the point inside the
unpadded image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.image import bilinear, floor_index

MARGIN_X = (10, 14, 18, 26)
MARGIN_Y = (10, 10, 12, 14)
SCHARR = (3 / 32, 10 / 32, 3 / 32)


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def search_window(level: int, Hp: int, Wp: int, win: int) -> tuple:
    S = win + 1
    mx = MARGIN_X[min(level, len(MARGIN_X) - 1)]
    my = MARGIN_Y[min(level, len(MARGIN_Y) - 1)]
    Py = max(min(_round8(S + 2 * my), Hp // 8 * 8), _round8(S))
    Px = max(min(_round8(S + 2 * mx), Wp // 8 * 8), _round8(S))
    return Py, Px


def _level(prev, cur, src, guess, frozen, *, level, win, iters, eps,
           min_eig):
    """One level for N points of one image pair (padded levels and
    padded coordinates). Returns (points, solvable, left_window,
    template_inside)."""
    Hp, Wp = prev.shape
    S, half = win + 1, (win - 1) / 2.0
    Py, Px = search_window(level, Hp, Wp, win)

    # template and its gradients
    tl = src - half
    tfx, tfy = tl[:, 0] - torch.floor(tl[:, 0]), tl[:, 1] - torch.floor(
        tl[:, 1])
    tx0 = torch.clamp(floor_index(tl[:, 0]) - 1, min=0)
    ty0 = torch.clamp(floor_index(tl[:, 1]) - 1, min=0)
    n = win + 3
    r = torch.arange(n)
    ys, xs = ty0[:, None] + r, tx0[:, None] + r
    X = prev[ys.clamp(max=Hp - 1)[:, :, None], xs.clamp(max=Wp - 1)[:, None]]
    X = torch.where((ys < Hp)[:, :, None] & (xs < Wp)[:, None], X, 0.0)
    a, b, c = SCHARR
    dx = X[:, :, 2:] - X[:, :, :-2]
    gx_raw = a * dx[:, :-2] + b * dx[:, 1:-1] + a * dx[:, 2:]
    sm = a * X[:, :, :-2] + b * X[:, :, 1:-1] + a * X[:, :, 2:]
    gy_raw = sm[:, 2:] - sm[:, :-2]
    tmpl = bilinear(X[:, 1:S + 1, 1:S + 1], tfx, tfy)
    gx = bilinear(gx_raw[:, :S, :S], tfx, tfy)
    gy = bilinear(gy_raw[:, :S, :S], tfx, tfy)
    t_in = ((tl[:, 0] >= 0) & (tl[:, 1] >= 0) & (tl[:, 0] + win < Wp)
            & (tl[:, 1] + win < Hp))

    sxx = (gx * gx).sum((1, 2))
    sxy = (gx * gy).sum((1, 2))
    syy = (gy * gy).sum((1, 2))
    det = sxx * syy - sxy * sxy
    m = 0.5 * (sxx + syy)
    lam_min = (m - torch.sqrt(torch.clamp(m * m - det, min=0.0))) / (win * win)
    solvable = (lam_min > min_eig) & (det > 1e-12)
    det = torch.where(det > 1e-12, det, torch.ones_like(det))

    # the search window, fixed for the level
    corner = floor_index(guess - half)
    wx = torch.clamp(corner[:, 0] - (Px - S) // 2, 0, max(Wp - Px, 0))
    wy = torch.clamp(corner[:, 1] - (Py - S) // 2, 0, max(Hp - Py, 0))
    rows = torch.arange(Py)
    cols = torch.arange(Px)
    big = cur[(wy[:, None] + rows)[:, :, None], (wx[:, None] + cols)[:, None]]
    idx = torch.arange(len(src))

    p = guess.clone()
    left = torch.zeros(len(src), dtype=torch.bool)
    for _ in range(iters):
        if bool(frozen.all()):
            break
        tl = p - half
        inside = ((tl[:, 0] >= 0) & (tl[:, 1] >= 0) & (tl[:, 0] + win < Wp)
                  & (tl[:, 1] + win < Hp))
        lx, ly = tl[:, 0] - wx, tl[:, 1] - wy
        in_win = (lx >= 0) & (ly >= 0) & (lx + S <= Px) & (ly + S <= Py)
        bx, by = torch.floor(lx), torch.floor(ly)
        x0 = torch.clamp(floor_index(bx), 0, Px - S)
        y0 = torch.clamp(floor_index(by), 0, Py - S)
        rs = torch.arange(S)
        raw = big[idx[:, None, None], (y0[:, None] + rs)[:, :, None],
                  (x0[:, None] + rs)[:, None, :]]
        e = bilinear(raw, lx - bx, ly - by) - tmpl
        ex, ey = (e * gx).sum((1, 2)), (e * gy).sum((1, 2))
        ux = (syy * ex - sxy * ey) / det
        uy = (sxx * ey - sxy * ex) / det
        ok = inside & in_win
        move = solvable & ok & ~frozen
        p = torch.where(move[:, None], p - torch.stack([ux, uy], -1), p)
        left |= ~in_win & ~frozen
        frozen = frozen | (move & (ux * ux + uy * uy < eps * eps)) \
            | ~(solvable & ok)
    return p, solvable, left, t_in


def track(src_pyr, dst_pyr, pts, guess, mask, *, win: int = 11,
          iters: int = 30, eps: float = 0.01, min_eig: float = 1e-4):
    """Track points (N, 2) of src_pyr's level 0 into dst_pyr, starting at
    the level-0 guesses (N, 2); masked-out points are not moved. Pyramids
    are lists of (H, W) levels, level 0 finest. Returns (points (N, 2),
    status (N,))."""
    pad = win // 2 + 2
    L = len(src_pyr)
    frozen0 = ~mask
    g = guess * 0.5 ** (L - 1)
    for level in range(L - 1, -1, -1):
        prev = F.pad(src_pyr[level][None, None], (pad,) * 4,
                     mode="replicate")[0, 0]
        cur = F.pad(dst_pyr[level][None, None], (pad,) * 4,
                    mode="replicate")[0, 0]
        p, solvable, left, t_in = _level(
            prev, cur, pts * 0.5 ** level + pad, g + pad, frozen0.clone(),
            level=level, win=win, iters=iters, eps=eps, min_eig=min_eig)
        g = (p - pad) * (2.0 if level else 1.0)
    H, W = dst_pyr[0].shape
    tl = p - (win - 1) / 2.0
    Hp, Wp = H + 2 * pad, W + 2 * pad
    inside_p = ((tl[:, 0] >= 0) & (tl[:, 1] >= 0) & (tl[:, 0] + win < Wp)
                & (tl[:, 1] + win < Hp))
    inside = (g[:, 0] >= 0) & (g[:, 0] < W) & (g[:, 1] >= 0) & (g[:, 1] < H)
    return g, t_in & solvable & inside_p & ~left & inside
