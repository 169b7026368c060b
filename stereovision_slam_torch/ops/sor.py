"""Statistical outlier removal (counterpart of `ops/sor.py`).

PCL's StatisticalOutlierRemoval as the reference's dense tool uses it
(meanK 50, sigma 1.0): each point's mean distance to its k nearest
neighbours, then a point is kept when that mean is at most the mean of all
points' means plus `std_ratio` standard deviations. The k-NN is brute force
against a reference set of at most `max_ref` points (a seeded uniform
subsample of larger clouds): squared distances ||q||^2 + ||r||^2 - 2 q.r
clamped at 0, then the k + 1 smallest by `torch.topk`. A zero-distance
hit is the query itself and is dropped; a query outside the reference set
drops its (k + 1)-th neighbour instead.

The three-term dot products and norms are written out as elementwise
float32 sums (never a matmul, so never TF32 on the card), the square roots
are taken in float64 and rounded (the card's float32 `torch.sqrt` is not
correctly rounded: 314 of 52,224 roots an ulp off the CPU's,
tests/torch_sor_bits.py), and each row's k + 1 distances are summed as a
pairwise tree of elementwise adds: the means, and so the keep-mask, are
the same bits on the CPU and on the card.
The JAX package sums in XLA's orders, and its float32 cancellation in
||q||^2 + ||r||^2 - 2 q.r resolves a squared distance only to about 1e-4
m^2 for points tens of metres out, so the keep decisions of points whose
mean sits at the threshold follow rounding (ROADMAP.md queue 3).

Only the exact k-NN is ported: the reference's `"approx"` method is
`lax.approx_min_k`, a TPU primitive.
"""

from __future__ import annotations

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device

# Rows are independent, so a launch takes as many `chunk`-row tiles as keep
# its (rows, R) float32 distance matrix within 1 GiB.
LAUNCH_ELEMS = 1 << 28


def _sq_norm(a: torch.Tensor) -> torch.Tensor:
    """Squared norms of the columns of a (3, n) tensor, x then y then z."""
    return a[0] * a[0] + a[1] * a[1] + a[2] * a[2]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square roots on every device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _tree_sum(d: torch.Tensor) -> torch.Tensor:
    """Row sums of (C, n) by pairwise halving (zero padding to a power of
    two), the same order on every device."""
    n = d.shape[1]
    width = 1 << max(n - 1, 0).bit_length()
    d = torch.nn.functional.pad(d, (0, width - n))
    while d.shape[1] > 1:
        half = d.shape[1] // 2
        d = d[:, :half] + d[:, half:]
    return d[:, 0]


def mean_knn_chunk(q: torch.Tensor, ref_t: torch.Tensor, k: int,
                   r2: torch.Tensor | None = None) -> torch.Tensor:
    """Mean distance of each (C, 3) query to its k nearest points of the
    reference set, given transposed as (3, R) (`_mean_knn_chunk`); `r2`
    the reference's squared norms, if already computed."""
    if r2 is None:
        r2 = _sq_norm(ref_t)
    q_t = q.T.contiguous()
    dot = torch.outer(q_t[0], ref_t[0])             # q . ref, x then y, z
    dot.add_(torch.outer(q_t[1], ref_t[1]))
    dot.add_(torch.outer(q_t[2], ref_t[2]))
    d2 = _sq_norm(q_t)[:, None] + r2[None, :]
    d2.sub_(dot.mul_(2.0)).clamp_(min=0.0)
    del dot
    d = _sqrt(torch.topk(d2, k + 1, dim=1, largest=False,
                         sorted=True).values)          # ascending
    is_self = d[:, 0] < 1e-6
    drop = torch.where(is_self, d[:, 0], d[:, k])
    return (_tree_sum(d) - drop) / torch.full((), float(k), dtype=d.dtype,
                                               device=d.device)


def mean_knn_distances(points: np.ndarray, mean_k: int = 50,
                       max_ref: int = 16384, chunk: int = 1024,
                       seed: int = 0, device="cuda"):
    """Each point's mean k-NN distance (N,) float32 numpy, and k; None
    where the cloud is too small to have neighbours."""
    N = len(points)
    pts = np.asarray(points, np.float32)
    k = min(mean_k, N - 1, min(N, max_ref) - 1)
    if k < 1:
        return None, k
    dev = resolve_device(device)
    if N > max_ref:
        sel = np.random.default_rng(seed).choice(N, max_ref, replace=False)
        ref = pts[sel]
    else:
        ref = pts
    ref_t = torch.from_numpy(np.ascontiguousarray(ref.T)).to(dev)
    r2 = _sq_norm(ref_t)
    nc = -(-N // chunk)
    padded = np.zeros((nc * chunk, 3), np.float32)
    padded[:N] = pts
    queries = torch.from_numpy(padded).to(dev)
    rows = chunk * max(1, LAUNCH_ELEMS // (chunk * len(ref)))
    mean_d = torch.cat([mean_knn_chunk(queries[s:s + rows], ref_t, k, r2)
                        for s in range(0, len(queries), rows)])
    return mean_d[:N].cpu().numpy(), k


def statistical_outlier_removal(points: np.ndarray, mean_k: int = 50,
                                std_ratio: float = 1.0,
                                max_ref: int = 16384, chunk: int = 1024,
                                seed: int = 0, method: str | None = None,
                                device="cuda") -> np.ndarray:
    """Boolean keep-mask over `points` (N, 3), PCL SOR semantics.

    mean_k: neighbours per point; std_ratio: the sigma multiplier; max_ref:
    the reference set's cap (larger clouds are subsampled with
    `default_rng(seed)`); chunk: queries per distance-matrix tile (a
    launch takes as many tiles as fit LAUNCH_ELEMS; the results do not
    depend on either). `method` "exact" or None; "approx" is refused."""
    if method not in (None, "exact"):
        raise ValueError(
            f"method={method!r}: only the exact k-NN is ported (the "
            "reference's 'approx' is lax.approx_min_k, a TPU primitive)")
    N = len(points)
    if N == 0:
        return np.zeros((0,), bool)
    mean_d, _ = mean_knn_distances(points, mean_k, max_ref, chunk, seed,
                                   device)
    if mean_d is None:
        return np.ones((N,), bool)
    return keep_mask(mean_d, std_ratio)


def keep_mask(mean_d: np.ndarray, std_ratio: float = 1.0) -> np.ndarray:
    """Points whose mean k-NN distance is at most the mean of all plus
    `std_ratio` standard deviations."""
    mu = float(mean_d.mean())
    sigma = float(mean_d.std())
    return mean_d <= mu + std_ratio * sigma


def threshold_margin(mean_d: np.ndarray, std_ratio: float = 1.0):
    """|mean_d - threshold| / threshold per point: how close each point's
    mean k-NN distance sits to the keep threshold, relative."""
    th = float(mean_d.mean()) + std_ratio * float(mean_d.std())
    return np.abs(mean_d - th) / th
