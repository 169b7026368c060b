"""Kernel C: the windowed LK Gauss-Newton loop over pre-gathered windows
(counterpart of `ops/lk_pallas.py`, whose `_iterate_kernel` the CUDA kernel
of `csrc/lk_iterate.cu` replaces).

`lk_iterate` takes exactly the inputs of the reference's
`lk_iterate_window`: (N, P, P) windows of the current level (gathered once
per level, `ops/gather.py`), the (N, R, R) template and gradient patches
(R = S - 1 = win), the structure-tensor coefficients, the solvability and
initial freeze flags, the guesses and the window corners, all in padded
level coordinates. It launches the kernel on a CUDA tensor and runs
`lk_iterate_plain` on a CPU tensor.

Both sum in the kernel's order, so they agree bit for bit: up to R = 16
each patch row splits into two halves of ceil(R/2) and floor(R/2) columns,
each half sums diff * gx and diff * gy over its columns in order, the two
halves of a row are added, and the rows, padded to 16 with zeros, are added
as a pairwise tree (row i + row i + 8, then + 4, + 2, + 1): the kernel's
warp butterfly. Above R = 16 each row sums its columns in order and the
rows, padded to 32, are added as a pairwise tree from + 16 down.
The reference streams the rows in order instead, which is why the tests
hold this version to the reference's kernel within 1e-3 px.
"""

from __future__ import annotations

import ctypes

import torch

from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.ops.image import floor_int

OUT_COLS = 5     # [x, y, frozen, left_win, iterations]
MAX_WIN = 31     # the kernel's patch sizes: 1 to 31
WINDOW_MARGIN = 10   # its windows: P = S + 2 * 10 (`ops/lk.py`'s)
launch_count = 0
# lk_iterate_launch(win, tmpl, gx, gy, coef, flags, pts, corner, out, N, S, P,
#                   max_iters, W, H, eps2, stream)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _row_tree(e: torch.Tensor) -> torch.Tensor:
    """(N, R, R) -> (N,) in the kernel's order: per row the sums of its two
    column halves (columns in order), added; then the rows, padded to 16
    with zeros, as a pairwise tree. Above R = 16: per row the sum of its
    columns in order, then the rows padded to 32, as a pairwise tree."""
    N, R, _ = e.shape
    split = R <= 16
    h0 = (R + 1) // 2 if split else R

    def cols(lo, hi):
        if hi <= lo:
            return torch.zeros_like(e[:, :, 0])
        acc = e[:, :, lo]
        for c in range(lo + 1, hi):
            acc = acc + e[:, :, c]
        return acc

    rows = cols(0, h0) + cols(h0, R) if split else cols(0, R)
    x = torch.cat([rows, rows.new_zeros((N, (16 if split else 32) - R))],
                  dim=1)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def lk_iterate_plain(win, tmpl, gx, gy, coef, flags, guesses, corner, *,
                     S: int, P: int, max_iters: int, eps: float, W: int,
                     H: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same (N, 5) out."""
    gxx, gxy, gyy, det_safe = coef.unbind(1)
    solvable, frozen = flags[:, 0] > 0.5, flags[:, 1] > 0.5
    N = win.shape[0]
    R = S - 1
    half = (S - 2) / 2.0
    dev = win.device
    px, py = guesses[:, 0].clone(), guesses[:, 1].clone()
    cx, cy = corner[:, 0], corner[:, 1]
    left_win = torch.zeros(N, dtype=torch.bool, device=dev)
    iters = torch.zeros(N, dtype=torch.float32, device=dev)
    ar = torch.arange(N, device=dev)[:, None, None]
    rS = torch.arange(S, device=dev)
    eps2 = eps * eps
    for _ in range(max_iters):
        # off the CPU every point runs all max_iters steps rather than read
        # the all-frozen test back each step: frozen points never move
        if dev.type == "cpu" and bool(frozen.all()):
            break
        tlx, tly = px - half, py - half
        g_ok = (tlx >= 0.0) & (tly >= 0.0) & (tlx + R < W) & (tly + R < H)
        locx, locy = tlx - cx, tly - cy
        in_win = ((locx >= 0.0) & (locy >= 0.0)
                  & (locx + S <= P) & (locy + S <= P))
        fx = (locx - torch.floor(locx))[:, None, None]
        fy = (locy - torch.floor(locy))[:, None, None]
        x0 = torch.clamp(floor_int(locx), 0, P - S)
        y0 = torch.clamp(floor_int(locy), 0, P - S)
        raw = win[ar, (y0[:, None] + rS)[:, :, None],
                  (x0[:, None] + rS)[:, None, :]]
        cur = ((1 - fy) * (1 - fx) * raw[:, :-1, :-1]
               + (1 - fy) * fx * raw[:, :-1, 1:]
               + fy * (1 - fx) * raw[:, 1:, :-1] + fy * fx * raw[:, 1:, 1:])
        diff = cur - tmpl
        bx, by = _row_tree(diff * gx), _row_tree(diff * gy)
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
    return torch.stack([px, py, frozen.float(), left_win.float(), iters],
                       dim=1)


def lk_iterate(win, tmpl, gx, gy, coef, flags, guesses, corner, *, S: int,
               P: int, max_iters: int, eps: float, W: int,
               H: int) -> torch.Tensor:
    """The windowed GN loop for N points.

    win (N, P, P); tmpl, gx, gy (N, S-1, S-1); coef (N, 4) [gxx, gxy, gyy,
    det_safe]; flags (N, 2) [solvable, frozen0] as 0/1; guesses and corner
    (N, 2) (x, y); all float32. W, H: the padded level's size. Returns
    (N, 5) [x, y, frozen, left_win, iterations]. The kernel takes S - 1 <=
    MAX_WIN, P = S + 2 * WINDOW_MARGIN and a 16-byte aligned `win`."""
    kw = dict(S=S, P=P, max_iters=max_iters, eps=eps, W=W, H=H)
    if win.device.type == "cpu":
        return lk_iterate_plain(win, tmpl, gx, gy, coef, flags, guesses,
                                corner, **kw)
    if win.device.type != "cuda":
        raise ValueError(f"lk_iterate: unsupported device {win.device}")
    N, R = win.shape[0], S - 1
    shapes = {"win": (N, P, P), "tmpl": (N, R, R), "gx": (N, R, R),
              "gy": (N, R, R), "coef": (N, 4), "flags": (N, 2),
              "guesses": (N, 2), "corner": (N, 2)}
    args = (win, tmpl, gx, gy, coef, flags, guesses, corner)
    for (name, shape), t in zip(shapes.items(), args):
        if (t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != win.device):
            raise ValueError(f"lk_iterate: {name} must be a contiguous "
                             f"float32 {shape} tensor on {win.device}")
    if not 1 <= R <= MAX_WIN or P != S + 2 * WINDOW_MARGIN:
        raise ValueError(f"lk_iterate: patch {R} and window {P}: the kernel "
                         f"takes patches of 1 to {MAX_WIN} and windows of "
                         f"patch + {2 * WINDOW_MARGIN + 1}")
    if win.data_ptr() % 16:
        raise ValueError("lk_iterate: win must be 16-byte aligned")
    out = torch.empty((N, OUT_COLS), dtype=torch.float32, device=win.device)
    fn = _cuda.function("lk_iterate", "lk_iterate_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    _cuda.launch(fn, "lk_iterate", win, *(t.data_ptr() for t in args),
                 out.data_ptr(), N, S, P, max_iters, W, H, float(eps * eps))
    return out
