"""Pyramidal Lucas-Kanade sparse optical flow (counterpart of `ops/lk.py`).

Two routes, chosen as the reference chooses them:
  * the lanes route (kernel A, `ops/lk_lanes.py`): the port's default on
    every device, so a CPU run is the card's algorithm;
  * the per-level route (`_track_level`), taken where a pyramid level is
    too small for the lanes search windows (`lk_lanes.levels_ok`), where
    the caller forbids windowing (`windowed=False`), or where it asks for
    `pallas_mode="xla"` or `"pallas"`. A full-image level runs the
    reference's XLA loop in PyTorch, sampling the full edge-padded level; a
    windowed level gathers a (P, P) window once per point
    (`ops/gather.py`) and runs kernel C (`ops/lk_iterate.py`, "pallas") or
    its plain version ("xla") over the windows.

`track_batched` folds its G groups into one call per level on both routes,
where the reference vmaps the per-level route; per point the results are
the same, because a frozen point never moves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereovision_slam_torch.ops import gather, lk_iterate, lk_lanes
from stereovision_slam_torch.ops import image as imops

_WINDOW_MARGIN = lk_iterate.WINDOW_MARGIN   # px a point may travel per level
_MODES = (None, "lanes", "xla", "pallas")


def _edge_pad(imgs: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(imgs[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]


def _track_level(prev_img, cur_img, prev_pts, guesses, frozen0, *, N: int,
                 win_size: int, max_iters: int, eps: float,
                 min_eig_threshold: float, windowed=None, pallas_mode=None):
    """One pyramid level for G groups of N points.

    prev_img / cur_img: (G, H, W) edge-padded level images; prev_pts,
    guesses (G*N, 2) in padded coordinates; frozen0 (G*N,) bool, the slots
    not to iterate. windowed=None windows a level on a CUDA tensor with
    H*W > 32768 (the reference's "backend is not CPU"); a level smaller
    than the window is never windowed. On a windowed level pallas_mode
    "pallas" runs kernel C, None or "xla" its plain version; a full-image
    level runs the PyTorch loop. Returns (pts, ok)."""
    G, H, W = prev_img.shape
    n = prev_pts.shape[0]
    dev = prev_img.device
    group = torch.arange(n, device=dev) // N
    ix, iy = imops.scharr_gradients(prev_img)
    (tmpl, gx, gy), tmpl_ok = imops.sample_patches_multi(
        torch.stack([prev_img, ix, iy]), prev_pts, win_size, group=group)
    tmpl_f, gx_f, gy_f = (p.reshape(n, -1) for p in (tmpl, gx, gy))
    gxx = torch.sum(gx_f * gx_f, dim=1)
    gxy = torch.sum(gx_f * gy_f, dim=1)
    gyy = torch.sum(gy_f * gy_f, dim=1)
    det = gxx * gyy - gxy * gxy
    tr_half = 0.5 * (gxx + gyy)
    min_eig = (tr_half - torch.sqrt(torch.clamp(tr_half * tr_half - det,
                                                min=0.0)))
    min_eig = min_eig / (win_size * win_size)
    solvable = (min_eig > min_eig_threshold) & (det > 1e-12)
    det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))

    half = (win_size - 1) / 2.0
    S = win_size + 1                      # raw patch with its bilinear apron
    P = S + 2 * _WINDOW_MARGIN
    if windowed is None:
        windowed = dev.type == "cuda" and H * W > 32768
    windowed = windowed and min(H, W) >= P
    if windowed:
        # the windowed GN loop: kernel C ("pallas") or its plain version
        # ("xla") over windows gathered once per point
        corner = imops.floor_int(guesses - half) - _WINDOW_MARGIN
        cx = torch.clamp(corner[:, 0], 0, max(W - P, 0))
        cy = torch.clamp(corner[:, 1], 0, max(H - P, 0))
        corner_f = torch.stack([cx, cy], dim=1).to(guesses.dtype)
        i32 = torch.int32
        corners = (cur_img.contiguous(), group.to(i32), cy.to(i32),
                   cx.to(i32), P)
        inputs = (tmpl.contiguous(), gx.contiguous(), gy.contiguous(),
                  torch.stack([gxx, gxy, gyy, det_safe], dim=1),
                  torch.stack([solvable, frozen0], dim=1).to(torch.float32),
                  guesses.contiguous(), corner_f)
        kw = dict(S=S, P=P, max_iters=max_iters, eps=eps, W=W, H=H)
        if pallas_mode == "pallas":
            out = lk_iterate.lk_iterate(gather.gather_windows(*corners),
                                        *inputs, **kw)
        else:
            out = lk_iterate.lk_iterate_plain(
                gather.gather_windows_plain(*corners), *inputs, **kw)
        out_pts, left_win = out[:, :2], out[:, 3] > 0.5
    else:
        # The reference leaves its loop once every point is frozen. Off the
        # CPU that test would cost a device->host read per step, so there
        # every point runs all max_iters steps; the result is the same,
        # because a frozen point never moves and its flags never change.
        pts, frozen = guesses, frozen0
        left_win = torch.zeros_like(frozen0)
        for _ in range(max_iters):
            if dev.type == "cpu" and bool(frozen.all()):
                break
            cur, inb = imops.sample_patches(cur_img, pts, win_size,
                                            group=group)
            diff = cur.reshape(n, -1) - tmpl_f
            bx = torch.sum(diff * gx_f, dim=1)
            by = torch.sum(diff * gy_f, dim=1)
            dx = (gyy * bx - gxy * by) / det_safe
            dy = (gxx * by - gxy * bx) / det_safe
            delta = torch.stack([dx, dy], dim=-1)
            step_ok = solvable & inb & ~frozen
            pts = torch.where(step_ok[:, None], pts - delta, pts)
            converged = torch.sum(delta * delta, dim=-1) < eps * eps
            frozen = frozen | (converged & step_ok) | ~(solvable & inb)
        out_pts = pts
    tl = out_pts - half
    final_inb = ((tl[:, 0] >= 0.0) & (tl[:, 1] >= 0.0)
                 & (tl[:, 0] + win_size < W) & (tl[:, 1] + win_size < H))
    return out_pts, tmpl_ok & solvable & final_inb & ~left_win


def _track_levels(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
                  win_size: int, max_iters: int, eps: float,
                  min_eig_threshold: float, windowed, pallas_mode):
    """The per-level route for G groups: one `_track_level` call per
    level over all G * N points."""
    G, N, _ = pts.shape
    n = G * N
    num_levels = len(tmpl_pyramids)
    prev_pts = pts.reshape(n, 2)
    guesses = initial_pts.reshape(n, 2) * (0.5 ** (num_levels - 1))
    status = torch.ones(n, dtype=torch.bool, device=pts.device)
    frozen0 = ~masks.reshape(n)
    # edge-pad every level by the window apron, so patches at and slightly
    # past the image border stay defined
    pad = win_size // 2 + 2
    for level in range(num_levels - 1, -1, -1):
        s = 0.5 ** level
        guesses, ok = _track_level(
            _edge_pad(tmpl_pyramids[level], pad),
            _edge_pad(tgt_pyramids[level], pad), prev_pts * s + pad,
            guesses + pad, frozen0, N=N, win_size=win_size,
            max_iters=max_iters, eps=eps, min_eig_threshold=min_eig_threshold,
            windowed=windowed, pallas_mode=pallas_mode)
        guesses = guesses - pad
        if level == 0:
            # conditioning is required at the finest level only
            status = status & ok
        else:
            guesses = guesses * 2.0
    H, W = tgt_pyramids[0].shape[-2:]
    inb = ((guesses[:, 0] >= 0.0) & (guesses[:, 0] < W)
           & (guesses[:, 1] >= 0.0) & (guesses[:, 1] < H))
    return guesses.reshape(G, N, 2), (status & inb).reshape(G, N)


def track_batched(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
                  win_size: int = 11, max_iters: int = 30, eps: float = 0.01,
                  min_eig_threshold: float = 1e-4, windowed=None,
                  pallas_mode=None):
    """Track G independent groups, each with its own image pair, in one
    call per level. Levels are (G, H, W); pts / initial_pts (G, N, 2);
    masks (G, N). Returns (cur_pts (G, N, 2), status (G, N)).

    pallas_mode: None or "lanes" take the lanes route (kernel A) unless a
    level is too small for its windows or windowed=False, and then the
    per-level route; "xla" and "pallas" take the per-level route with its
    PyTorch loop or kernel C on windowed levels."""
    if pallas_mode not in _MODES:
        raise ValueError(f"unknown pallas_mode {pallas_mode!r}")
    kw = dict(win_size=win_size, max_iters=max_iters, eps=eps,
              min_eig_threshold=min_eig_threshold)
    if (pallas_mode in (None, "lanes") and windowed is not False
            and lk_lanes.levels_ok(tmpl_pyramids, win_size)):
        return lk_lanes.track_grouped_lanes(
            tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, **kw)
    return _track_levels(
        tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, **kw,
        windowed=windowed,
        pallas_mode="pallas" if pallas_mode == "pallas" else "xla")


def track(prev_pyramid, cur_pyramid, prev_pts, initial_pts=None, *,
          win_size: int = 11, max_iters: int = 30, eps: float = 0.01,
          min_eig_threshold: float = 1e-4, mask=None, windowed=None,
          pallas_mode=None):
    """Track (N, 2) points from the previous image into the current one.

    prev_pyramid / cur_pyramid: lists of (H, W) images, level 0 finest.
    initial_pts: (N, 2) guesses in the current image (default prev_pts).
    mask: (N,) bool; False slots are not iterated. windowed / pallas_mode:
    the route, as in `track_batched`.
    Returns (cur_pts (N, 2), status (N,) bool)."""
    if initial_pts is None:
        initial_pts = prev_pts
    if mask is None:
        mask = torch.ones(prev_pts.shape[0], dtype=torch.bool,
                          device=prev_pts.device)
    uv, st = track_batched(
        [lv[None] for lv in prev_pyramid], [lv[None] for lv in cur_pyramid],
        prev_pts[None], initial_pts[None], mask[None], win_size=win_size,
        max_iters=max_iters, eps=eps, min_eig_threshold=min_eig_threshold,
        windowed=windowed, pallas_mode=pallas_mode)
    return uv[0], st[0]
