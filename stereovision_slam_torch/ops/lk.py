"""Pyramidal Lucas-Kanade sparse optical flow (counterpart of `ops/lk.py`).

Both entry points go to kernel A (`ops/lk_lanes.py`): the CUDA kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor. `track_batched`
folds its G groups into one launch per level, where the JAX main path vmaps
them; per point the results are the same, because a frozen point never
moves. Where a pyramid level is too small for the search windows, the JAX
package falls back to its full-image XLA path; the port raises ValueError
there instead.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.ops import lk_lanes


def _check_levels(pyramid, win_size: int) -> None:
    if not lk_lanes.levels_ok(pyramid, win_size):
        raise ValueError(
            "a pyramid level is smaller than the LK search window; the "
            "full-image LK path is not ported")


def track(prev_pyramid, cur_pyramid, prev_pts, initial_pts=None, *,
          win_size: int = 11, max_iters: int = 30, eps: float = 0.01,
          min_eig_threshold: float = 1e-4, mask=None):
    """Track (N, 2) points from the previous image into the current one.

    prev_pyramid / cur_pyramid: lists of (H, W) images, level 0 finest.
    initial_pts: (N, 2) guesses in the current image (default prev_pts).
    mask: (N,) bool; False slots are not iterated.
    Returns (cur_pts (N, 2), status (N,) bool)."""
    _check_levels(prev_pyramid, win_size)
    if initial_pts is None:
        initial_pts = prev_pts
    if mask is None:
        mask = torch.ones(prev_pts.shape[0], dtype=torch.bool,
                          device=prev_pts.device)
    uv, st = lk_lanes.track_grouped_lanes(
        [lv[None] for lv in prev_pyramid], [lv[None] for lv in cur_pyramid],
        prev_pts[None], initial_pts[None], mask[None], win_size=win_size,
        max_iters=max_iters, eps=eps, min_eig_threshold=min_eig_threshold)
    return uv[0], st[0]


def track_batched(tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks, *,
                  win_size: int = 11, max_iters: int = 30, eps: float = 0.01,
                  min_eig_threshold: float = 1e-4):
    """Track G independent groups, each with its own image pair, in one
    kernel launch per level. Levels are (G, H, W); pts / initial_pts
    (G, N, 2); masks (G, N). Returns (cur_pts (G, N, 2), status (G, N))."""
    _check_levels(tmpl_pyramids, win_size)
    return lk_lanes.track_grouped_lanes(
        tmpl_pyramids, tgt_pyramids, pts, initial_pts, masks,
        win_size=win_size, max_iters=max_iters, eps=eps,
        min_eig_threshold=min_eig_threshold)
