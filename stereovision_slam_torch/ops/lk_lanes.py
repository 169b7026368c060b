"""Kernel A: pyramidal LK for many points, every level in one launch
(counterpart of `ops/lk_lanes.py`).

`lk_pyramid` launches the CUDA kernel of `csrc/lk_pyramid.cu` on CUDA
tensors and runs `lk_pyramid_plain`, its plain PyTorch version, on CPU
tensors. The plain version is the level loop of the reference: per level,
`_prep_level` (template corner, search-window clip, bilinear fractions),
`lk_level_plain` (one level for every point), then the guess for the next
level; the status at level 0. The kernel does all of that in one launch.
`level_table` (pad and window shapes per level) is shared Python, so the
CPU tests reach it.

Semantics held from the reference:
  * template window corner max(floor(tl) - 1, 0), in-window sample start 1,
    zero overhang past the padded level's right/bottom edge;
  * search-window corner clipped to [0, Wp - Px] x [0, Hp - Py], in-window
    sample base clipped to [0, Px - S] x [0, Py - S], a step only when the
    patch is in the image and in the window;
  * final status from the padded bounds at level 0, then the unpadded ones.
"""

from __future__ import annotations

import array
import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.ops.image import floor_int
from stereovision_slam_torch.utils import profiling

# Per-level margins (pixels each side a point may travel within one level).
_MARGINS_X = (10, 14, 18, 26)
_MARGINS_Y = (10, 10, 12, 14)
OUT_COLS = 6     # [x, y, frozen, left_win, solvable, iterations]
MAX_LEVELS = 8   # csrc/lk_pyramid.cu kMaxLevels
MAX_WIN = 31     # csrc/lk_pyramid.cu kMaxWin

launch_count = 0
# lk_pyramid_launch(prev_ptrs, cur_ptrs, dims, levels, pts, init, masks, uv,
#                   status, rows, n, N, pad, win, max_iters, init_scale,
#                   eps2, min_eig_thr, stream)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + [ctypes.c_void_p])


class LevelShape(NamedTuple):
    """One level of the pyramid: its size, padded size, search window and
    whether the padded level holds the window (`levels_ok`'s test)."""
    H: int
    W: int
    Hp: int
    Wp: int
    Py: int
    Px: int
    fits: bool


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
    """Kernel A takes the call: the window and the depth are within its
    instances (`MAX_WIN`, `MAX_LEVELS`), and every level is large enough
    for its search window (the reference's `_lanes_levels_ok`). Where not,
    `lk.track_batched` takes the per-level route."""
    if not (1 <= win_size <= MAX_WIN and 1 <= len(pyramid) <= MAX_LEVELS):
        return False
    pad = win_size // 2 + 2
    s8 = _round_up(win_size + 1, 8)
    for lv in pyramid:
        H, W = lv.shape[-2:]
        if ((H + 2 * pad) // 8) * 8 < s8 or ((W + 2 * pad) // 8) * 8 < s8:
            return False
    return True


def level_table(pyramid, win_size: int) -> tuple[int, tuple[LevelShape]]:
    """(pad, one `LevelShape` per level, level 0 finest) of a pyramid of
    (..., H, W) levels: the padded sizes, the search windows of
    `level_window_shape`, and whether each level fits them."""
    return _table(tuple(tuple(lv.shape[-2:]) for lv in pyramid), win_size)[:2]


@lru_cache(maxsize=64)
def _table(sizes: tuple, win_size: int):
    """`level_table` of levels of sizes ((H, W), ...), and its rows (H, W,
    Py, Px) as the C int array the kernel's level table is built from."""
    pad = win_size // 2 + 2
    s8 = _round_up(win_size + 1, 8)
    shapes = []
    for level, (H, W) in enumerate(sizes):
        Hp, Wp = H + 2 * pad, W + 2 * pad
        Py, Px = level_window_shape(level, Hp, Wp, win_size)
        shapes.append(LevelShape(H, W, Hp, Wp, Py, Px,
                                 (Hp // 8) * 8 >= s8 and (Wp // 8) * 8 >= s8))
    dims = array.array("i", [v for sh in shapes
                             for v in (sh.H, sh.W, sh.Py, sh.Px)])
    return pad, tuple(shapes), dims


def _prep_level(prev_pts, guesses, frozen0, Hp: int, Wp: int, win: int,
                Py: int, Px: int):
    """Per-point meta rows for one level (padded coordinates in and out).

    Returns (meta (n, 9) float32 [x, y, cx, cy, frozen0, tfx, tfy, twx,
    twy], tmpl_ok (n,) bool)."""
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


def level_meta(pts, guesses, masks, pad: int, shape: LevelShape, level: int,
               win: int):
    """`_prep_level` of one level: the template points pts (G, N, 2) of
    level 0 scaled to the level, the guesses (G, N, 2) in the level's
    unpadded coordinates, masked slots frozen. Returns (meta (n, 9),
    tmpl_ok (n,))."""
    n = masks.numel()
    s = 0.5 ** level
    return _prep_level((pts * s + pad).reshape(n, 2),
                       (guesses + pad).reshape(n, 2),
                       (~masks).to(torch.float32).reshape(n), shape.Hp,
                       shape.Wp, win, shape.Py, shape.Px)


def next_guesses(rows, pad: int, level: int):
    """The guesses (n, 2) that a level's rows (n, 6) hand on, in the next
    finer level's unpadded coordinates (at level 0: the result)."""
    guesses = rows[:, :2] - pad
    return guesses * 2.0 if level > 0 else guesses


def lk_level_plain(prev_img, cur_img, meta, *, N: int, pad: int, Py: int,
                   Px: int, win: int, max_iters: int, eps: float,
                   min_eig_threshold: float) -> torch.Tensor:
    """One level for n = G * N points, the step of `lk_pyramid_plain`:
    prev_img / cur_img (G, H, W) float32 unpadded level images, meta (n, 9)
    from `_prep_level`. Returns (n, 6) [x, y, frozen, left_win, solvable,
    iterations]."""
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


def _levels_loop(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
                 win_size: int, max_iters: int, eps: float,
                 min_eig_threshold: float, level_fn, given_rows=None):
    """The reference's loop over the levels, coarse to fine, one `level_fn`
    call (with `lk_level_plain`'s signature) per level over all G * N
    points. With `given_rows`, (L, n, 6), each level starts from those
    rows at the level above instead of its own. Returns
    (cur_pts (G, N, 2), status (G, N), rows (L, n, 6))."""
    num_levels = len(tmpl_pyramids)
    G, N, _ = pts.shape
    pad, shapes = level_table(tmpl_pyramids, win_size)
    half = (win_size - 1) / 2.0
    guesses = initial_pts * (0.5 ** (num_levels - 1))
    rows = [None] * num_levels
    for level in range(num_levels - 1, -1, -1):
        sh = shapes[level]
        meta, tmpl_ok = level_meta(pts, guesses, masks, pad, sh, level,
                                   win_size)
        out = level_fn(tmpl_pyramids[level].contiguous(),
                       tgt_pyramids[level].contiguous(), meta, N=N, pad=pad,
                       Py=sh.Py, Px=sh.Px, win=win_size, max_iters=max_iters,
                       eps=eps, min_eig_threshold=min_eig_threshold)
        rows[level] = out
        handed = out if given_rows is None else given_rows[level]
        guesses = next_guesses(handed, pad, level).reshape(G, N, 2)
    sh = shapes[0]
    out = rows[0]
    tlx, tly = out[:, 0] - half, out[:, 1] - half
    final_inb = ((tlx >= 0.0) & (tly >= 0.0)
                 & (tlx + win_size < sh.Wp) & (tly + win_size < sh.Hp))
    status = (tmpl_ok & (out[:, 4] > 0.5) & final_inb
              & ~(out[:, 3] > 0.5)).reshape(G, N)
    inb = ((guesses[..., 0] >= 0.0) & (guesses[..., 0] < sh.W)
           & (guesses[..., 1] >= 0.0) & (guesses[..., 1] < sh.H))
    return guesses, status & inb, torch.stack(rows)


def lk_pyramid_plain(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
                     win_size: int = 11, max_iters: int = 30,
                     eps: float = 0.01, min_eig_threshold: float = 1e-4):
    """Plain PyTorch version of the kernel: the level loop over
    `lk_level_plain`. Same inputs and outputs as `lk_pyramid`."""
    return _levels_loop(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
                        win_size=win_size, max_iters=max_iters, eps=eps,
                        min_eig_threshold=min_eig_threshold,
                        level_fn=lk_level_plain)


def lk_pyramid(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
               win_size: int = 11, max_iters: int = 30, eps: float = 0.01,
               min_eig_threshold: float = 1e-4):
    """Track G point groups, each with its own image pair, through the
    whole pyramid: one launch of kernel A on CUDA tensors.

    tmpl_pyramids / tgt_pyramids: lists (level 0 finest) of (G, H, W)
    float32; pts / initial_pts (G, N, 2) float32; masks (G, N) bool. Every
    level must hold its search window (`levels_ok`). Returns
    (cur_pts (G, N, 2), status (G, N), rows (L, G * N, 6)): each level's
    [x, y, frozen, left_win, solvable, iterations], x and y in the level's
    padded coordinates."""
    kw = dict(win_size=win_size, max_iters=max_iters, eps=eps,
              min_eig_threshold=min_eig_threshold)
    dev = pts.device
    if dev.type == "cpu":
        return lk_pyramid_plain(tmpl_pyramids, tgt_pyramids, pts,
                                initial_pts, masks, **kw)
    if dev.type != "cuda":
        raise ValueError(f"lk_pyramid: unsupported device {dev}")
    with profiling.span("kernel.A"):
        return _lk_pyramid_cuda(tmpl_pyramids, tgt_pyramids, pts,
                                initial_pts, masks, **kw)


def _lk_pyramid_cuda(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
                     *, win_size, max_iters, eps, min_eig_threshold):
    """`lk_pyramid` on CUDA tensors: checks, outputs, one launch, and the
    recorder's counters of the launch (`profiling.kernel_launch`: its
    iterations summed over points and levels are the data-dependent
    work)."""
    dev = pts.device
    G, N, _ = pts.shape
    n = G * N
    L = len(tmpl_pyramids)
    if not 1 <= L <= MAX_LEVELS or len(tgt_pyramids) != L:
        raise ValueError(f"lk_pyramid: {L} template and {len(tgt_pyramids)} "
                         f"target levels, 1 to {MAX_LEVELS} each")
    if not 1 <= win_size <= MAX_WIN:
        raise ValueError(f"lk_pyramid: win_size {win_size} not in "
                         f"1..{MAX_WIN}")
    levels = [t.contiguous() for pyr in (tmpl_pyramids, tgt_pyramids)
              for t in pyr]
    for t, name in [(pts, "pts"), (initial_pts, "initial_pts")] + [
            (lv, "a pyramid level") for lv in levels]:
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"lk_pyramid: {name} must be float32 on {dev}")
    if initial_pts.shape != pts.shape or pts.shape[-1] != 2 \
            or masks.shape != (G, N):
        raise ValueError("lk_pyramid: pts, initial_pts and masks must be "
                         "(G, N, 2), (G, N, 2) and (G, N)")
    if masks.dtype != torch.bool or masks.device != dev:
        raise ValueError(f"lk_pyramid: masks must be bool on {dev}")
    for a, b in zip(levels[:L], levels[L:]):
        if a.dim() != 3 or a.shape != b.shape or a.shape[0] != G:
            raise ValueError("lk_pyramid: every level must be (G, H, W) in "
                             "both pyramids")
    pad, shapes, dims = _table(tuple(tuple(t.shape[-2:]) for t in levels[:L]),
                               win_size)
    if not all(sh.fits for sh in shapes):
        raise ValueError("lk_pyramid: a level is smaller than its search "
                         "window (see levels_ok)")
    pts_c, init_c = pts.contiguous(), initial_pts.contiguous()
    masks_c = masks.contiguous()
    uv = torch.empty((G, N, 2), dtype=torch.float32, device=dev)
    status = torch.empty((G, N), dtype=torch.bool, device=dev)
    rows = torch.empty((L, n, OUT_COLS), dtype=torch.float32, device=dev)
    ptrs = array.array("Q", [t.data_ptr() for t in levels])   # prev, cur
    fn = _cuda.function("lk_pyramid", "lk_pyramid_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    base = ptrs.buffer_info()[0]
    _cuda.launch(fn, "lk_pyramid", pts, base, base + 8 * L,
                 dims.buffer_info()[0], L, pts_c.data_ptr(),
                 init_c.data_ptr(), masks_c.data_ptr(), uv.data_ptr(),
                 status.data_ptr(), rows.data_ptr(), n, N, pad, win_size,
                 max_iters, 0.5 ** (L - 1), float(eps * eps),
                 float(min_eig_threshold))
    if profiling.enabled():
        profiling.kernel_launch(
            "A", f"L{L}.n{n}.win{win_size}",
            levels + [pts_c, init_c, masks_c, uv, status, rows],
            iterations=rows[:, :, 5].sum())
    return uv, status, rows


def replay_levels(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, rows,
                  *, win_size: int = 11, max_iters: int = 30,
                  eps: float = 0.01, min_eig_threshold: float = 1e-4):
    """Each level of `lk_level_plain`, fed the meta that `_prep_level`
    builds from `rows` (an (L, n, 6) result of `lk_pyramid`) at the level
    above, or from the initial guesses at the top: what the plain version
    makes of each level from the kernel's own start. Returns (L, n, 6)."""
    return _levels_loop(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
                        win_size=win_size, max_iters=max_iters, eps=eps,
                        min_eig_threshold=min_eig_threshold,
                        level_fn=lk_level_plain, given_rows=rows)[2]


def track_grouped_lanes(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
                        *, win_size: int = 11, max_iters: int = 30,
                        eps: float = 0.01, min_eig_threshold: float = 1e-4,
                        level_fn=None):
    """Track G point groups, each with its own image pair, through the
    pyramid: `lk_pyramid` (one launch of kernel A on the card), or, given
    a `level_fn` with `lk_level_plain`'s signature, the level loop calling
    it once per level over all G * N points.

    tmpl_pyramids / tgt_pyramids: lists (level 0 finest) of (G, H, W);
    pts / initial_pts (G, N, 2); masks (G, N) bool. Returns
    (cur_pts (G, N, 2), status (G, N))."""
    kw = dict(win_size=win_size, max_iters=max_iters, eps=eps,
              min_eig_threshold=min_eig_threshold)
    if level_fn is None:
        uv, status, _ = lk_pyramid(tmpl_pyramids, tgt_pyramids, pts,
                                   initial_pts, masks, **kw)
    else:
        uv, status, _ = _levels_loop(tmpl_pyramids, tgt_pyramids, pts,
                                     initial_pts, masks, level_fn=level_fn,
                                     **kw)
    return uv, status
