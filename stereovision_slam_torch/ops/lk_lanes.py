"""Kernel A: one pyramid level of LK for many points, and the loop over
the levels (counterpart of `ops/lk_lanes.py`).

`lk_level` launches the CUDA kernel of `csrc/lk_level.cu` on a CUDA tensor
and runs `lk_level_plain`, its plain PyTorch version, on a CPU tensor. The
per-level prep (`_prep_level`: template corner, search-window clip,
bilinear fractions) and the status logic of `track_grouped_lanes` are
shared Python, so the CPU tests reach them.

Semantics held from the reference:
  * template window corner max(floor(tl) - 1, 0), in-window sample start 1,
    zero overhang past the padded level's right/bottom edge;
  * search-window corner clipped to [0, Wp - Px] x [0, Hp - Py], in-window
    sample base clipped to [0, Px - S] x [0, Py - S], a step only when the
    patch is in the image and in the window;
  * final status from the padded bounds at level 0, then the unpadded ones.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.ops.image import floor_int

# Per-level margins (pixels each side a point may travel within one level).
_MARGINS_X = (10, 14, 18, 26)
_MARGINS_Y = (10, 10, 12, 14)
META_COLS = 9    # [x, y, cx, cy, frozen0, tfx, tfy, twx, twy]
OUT_COLS = 6     # [x, y, frozen, left_win, solvable, iterations]

launch_count = 0
# lk_level_launch(prev, cur, meta, out, n, N, H, W, pad, Py, Px, win,
#                 max_iters, eps2, min_eig_thr, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def level_window_shape(level: int, Hp: int, Wp: int, win: int):
    """(Py, Px) search-window shape for a level with padded size (Hp, Wp)."""
    S = win + 1
    mx = _MARGINS_X[min(level, len(_MARGINS_X) - 1)]
    my = _MARGINS_Y[min(level, len(_MARGINS_Y) - 1)]
    Py = min(_round_up(S + 2 * my, 8), (Hp // 8) * 8)
    Px = min(_round_up(S + 2 * mx, 8), (Wp // 8) * 8)
    return max(Py, _round_up(S, 8)), max(Px, _round_up(S, 8))


def levels_ok(pyramid, win_size: int) -> bool:
    """Every level is large enough for its search window (the reference's
    `_lanes_levels_ok`)."""
    pad = win_size // 2 + 2
    s8 = _round_up(win_size + 1, 8)
    for lv in pyramid:
        H, W = lv.shape[-2:]
        if ((H + 2 * pad) // 8) * 8 < s8 or ((W + 2 * pad) // 8) * 8 < s8:
            return False
    return True


def _prep_level(prev_pts, guesses, frozen0, Hp: int, Wp: int, win: int,
                Py: int, Px: int):
    """Per-point meta rows for one level (padded coordinates in and out).

    Returns (meta (n, 9) float32, tmpl_ok (n,) bool)."""
    S = win + 1
    half = (win - 1) / 2.0
    tl = prev_pts - half
    tbase = torch.floor(tl)
    tfrac = tl - tbase
    tb = floor_int(tl)
    tw_x = torch.clamp(tb[:, 0] - 1, min=0)
    tw_y = torch.clamp(tb[:, 1] - 1, min=0)
    tmpl_ok = ((tl[:, 0] >= 0.0) & (tl[:, 1] >= 0.0)
               & (tl[:, 0] + win < Wp) & (tl[:, 1] + win < Hp))
    corner = floor_int(guesses - half)
    cx = torch.clamp(corner[:, 0] - (Px - S) // 2, 0, max(Wp - Px, 0))
    cy = torch.clamp(corner[:, 1] - (Py - S) // 2, 0, max(Hp - Py, 0))
    f32 = torch.float32
    meta = torch.stack([guesses[:, 0], guesses[:, 1], cx.to(f32), cy.to(f32),
                        frozen0, tfrac[:, 0], tfrac[:, 1], tw_x.to(f32),
                        tw_y.to(f32)], dim=1).to(f32).contiguous()
    return meta, tmpl_ok


def lk_level_plain(prev_img, cur_img, meta, *, N: int, pad: int, Py: int,
                   Px: int, win: int, max_iters: int, eps: float,
                   min_eig_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same (n, 6) out."""
    G, H, W = prev_img.shape
    Hp, Wp = H + 2 * pad, W + 2 * pad
    dev = prev_img.device
    n = meta.shape[0]
    S = win + 1
    tw = win + 3
    prev_p = F.pad(prev_img[:, None], (pad, pad, pad, pad),
                   mode="replicate")[:, 0]
    cur_p = F.pad(cur_img[:, None], (pad, pad, pad, pad),
                  mode="replicate")[:, 0]
    g = (torch.arange(n, device=dev) // N)[:, None, None]
    px, py = meta[:, 0].clone(), meta[:, 1].clone()
    cx, cy = meta[:, 2].long(), meta[:, 3].long()
    frozen = meta[:, 4] > 0.5
    tfx, tfy = meta[:, 5][:, None, None], meta[:, 6][:, None, None]
    twx, twy = meta[:, 7].long(), meta[:, 8].long()

    # (1) template window with zero overhang, template and Scharr gradients
    rr = torch.arange(tw, device=dev)
    rows, cols = twy[:, None] + rr, twx[:, None] + rr
    X = prev_p[g, rows.clamp(max=Hp - 1)[:, :, None],
               cols.clamp(max=Wp - 1)[:, None, :]]
    inside = (rows < Hp)[:, :, None] & (cols < Wp)[:, None, :]
    X = torch.where(inside, X, torch.zeros((), device=dev))
    c0, c1 = 3.0 / 32.0, 10.0 / 32.0
    d = X[:, :, 2:] - X[:, :, :-2]
    ix = d[:, :-2] * c0 + d[:, 1:-1] * c1 + d[:, 2:] * c0
    s = X[:, :, :-2] * c0 + X[:, :, 1:-1] * c1 + X[:, :, 2:] * c0
    iy = s[:, 2:] - s[:, :-2]
    t00, t01 = (1 - tfy) * (1 - tfx), (1 - tfy) * tfx
    t10, t11 = tfy * (1 - tfx), tfy * tfx

    def bil(raw, a00, a01, a10, a11):
        return (a00 * raw[:, :-1, :-1] + a01 * raw[:, :-1, 1:]
                + a10 * raw[:, 1:, :-1] + a11 * raw[:, 1:, 1:])

    tmpl = bil(X[:, 1:1 + S, 1:1 + S], t00, t01, t10, t11)
    gx = bil(ix[:, :S, :S], t00, t01, t10, t11)
    gy = bil(iy[:, :S, :S], t00, t01, t10, t11)

    # (2) structure tensor and solvability
    gxx = (gx * gx).sum(dim=(1, 2))
    gxy = (gx * gy).sum(dim=(1, 2))
    gyy = (gy * gy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr_half = 0.5 * (gxx + gyy)
    min_eig = (tr_half - torch.sqrt(torch.clamp(tr_half * tr_half - det,
                                                min=0.0))) / (win * win)
    solvable = (min_eig > min_eig_threshold) & (det > 1e-12)
    det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))

    # (3) Gauss-Newton inside the (Py, Px) search window
    ry, rx = torch.arange(Py, device=dev), torch.arange(Px, device=dev)
    big = cur_p[g, (cy[:, None] + ry)[:, :, None], (cx[:, None] + rx)[:, None, :]]
    ar = torch.arange(n, device=dev)[:, None, None]
    rS = torch.arange(S, device=dev)
    half = (win - 1) / 2.0
    eps2 = eps * eps
    left_win = torch.zeros(n, dtype=torch.bool, device=dev)
    iters = torch.zeros(n, dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        if bool(frozen.all()):
            break
        tlx, tly = px - half, py - half
        g_ok = (tlx >= 0.0) & (tly >= 0.0) & (tlx + win < Wp) & (tly + win < Hp)
        locx, locy = tlx - cx.float(), tly - cy.float()
        in_win = ((locx >= 0.0) & (locy >= 0.0)
                  & (locx + S <= Px) & (locy + S <= Py))
        bx0, by0 = torch.floor(locx), torch.floor(locy)
        fx = (locx - bx0)[:, None, None]
        fy = (locy - by0)[:, None, None]
        x0 = torch.clamp(floor_int(bx0), 0, Px - S)
        y0 = torch.clamp(floor_int(by0), 0, Py - S)
        raw = big[ar, (y0[:, None] + rS)[:, :, None],
                  (x0[:, None] + rS)[:, None, :]]
        cur = bil(raw, (1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx),
                  fy * fx)
        diff = cur - tmpl
        bx = (diff * gx).sum(dim=(1, 2))
        by = (diff * gy).sum(dim=(1, 2))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        inb = g_ok & in_win
        step_ok = solvable & inb & ~frozen
        px = torch.where(step_ok, px - dx, px)
        py = torch.where(step_ok, py - dy, py)
        converged = dx * dx + dy * dy < eps2
        left_win = left_win | (~in_win & ~frozen)
        iters = iters + (~frozen).float()
        frozen = frozen | (converged & step_ok) | ~(solvable & inb)
    return torch.stack([px, py, frozen.float(), left_win.float(),
                        solvable.float(), iters], dim=1)


def lk_level(prev_img, cur_img, meta, *, N: int, pad: int, Py: int, Px: int,
             win: int, max_iters: int, eps: float,
             min_eig_threshold: float) -> torch.Tensor:
    """One level for n = G * N points: prev_img / cur_img (G, H, W) float32
    unpadded level images, meta (n, 9) from `_prep_level`. Returns (n, 6)
    [x, y, frozen, left_win, solvable, iterations]."""
    kw = dict(N=N, pad=pad, Py=Py, Px=Px, win=win, max_iters=max_iters,
              eps=eps, min_eig_threshold=min_eig_threshold)
    if prev_img.device.type == "cpu":
        return lk_level_plain(prev_img, cur_img, meta, **kw)
    if prev_img.device.type != "cuda":
        raise ValueError(f"lk_level: unsupported device {prev_img.device}")
    G, H, W = prev_img.shape
    n = meta.shape[0]
    for t, name in ((prev_img, "prev_img"), (cur_img, "cur_img"),
                    (meta, "meta")):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != prev_img.device:
            raise ValueError(f"lk_level: {name} must be contiguous float32 "
                             f"on {prev_img.device}")
    if cur_img.shape != prev_img.shape or meta.shape != (n, META_COLS):
        raise ValueError("lk_level: shape mismatch")
    if n != G * N:
        raise ValueError(f"lk_level: {n} points for {G} groups of {N}")
    out = torch.empty((n, OUT_COLS), dtype=torch.float32, device=meta.device)
    fn = _cuda.function("lk_level", "lk_level_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    code = fn(prev_img.data_ptr(), cur_img.data_ptr(), meta.data_ptr(),
              out.data_ptr(), n, N, H, W, pad, Py, Px, win, max_iters,
              float(eps * eps), float(min_eig_threshold),
              _cuda.stream_handle(prev_img))
    _cuda.check(code, "lk_level")
    return out


def track_grouped_lanes(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
                        *, win_size: int = 11, max_iters: int = 30,
                        eps: float = 0.01, min_eig_threshold: float = 1e-4,
                        level_fn=lk_level):
    """Track G point groups, each with its own image pair, through the
    pyramid: one `level_fn` call per level over all G * N points.

    tmpl_pyramids / tgt_pyramids: lists (level 0 finest) of (G, H, W);
    pts / initial_pts (G, N, 2); masks (G, N) bool. Returns
    (cur_pts (G, N, 2), status (G, N))."""
    num_levels = len(tmpl_pyramids)
    G, N, _ = pts.shape
    n = G * N
    guesses = initial_pts * (0.5 ** (num_levels - 1))
    pad = win_size // 2 + 2
    frozen0 = (~masks).to(torch.float32).reshape(n)
    half = (win_size - 1) / 2.0
    status_fine = None
    for level in range(num_levels - 1, -1, -1):
        s = 0.5 ** level
        H, W = tmpl_pyramids[level].shape[-2:]
        Hp, Wp = H + 2 * pad, W + 2 * pad
        Py, Px = level_window_shape(level, Hp, Wp, win_size)
        meta, tmpl_ok = _prep_level(
            (pts * s + pad).reshape(n, 2), (guesses + pad).reshape(n, 2),
            frozen0, Hp, Wp, win_size, Py, Px)
        out = level_fn(tmpl_pyramids[level].contiguous(),
                       tgt_pyramids[level].contiguous(), meta, N=N, pad=pad,
                       Py=Py, Px=Px, win=win_size, max_iters=max_iters,
                       eps=eps, min_eig_threshold=min_eig_threshold)
        guesses = out[:, :2].reshape(G, N, 2) - pad
        if level == 0:
            tlx, tly = out[:, 0] - half, out[:, 1] - half
            final_inb = ((tlx >= 0.0) & (tly >= 0.0)
                         & (tlx + win_size < Wp) & (tly + win_size < Hp))
            status_fine = (tmpl_ok & (out[:, 4] > 0.5) & final_inb
                           & ~(out[:, 3] > 0.5)).reshape(G, N)
        else:
            guesses = guesses * 2.0
    H0, W0 = tgt_pyramids[0].shape[-2:]
    inb = ((guesses[..., 0] >= 0.0) & (guesses[..., 0] < W0)
           & (guesses[..., 1] >= 0.0) & (guesses[..., 1] < H0))
    return guesses, status_fine & inb
