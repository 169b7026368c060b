"""Batched symmetric eigendecomposition of tiny matrices by cyclic Jacobi
sweeps (counterpart of `geometry/symeig.py`).

The same rotations as the reference, in the same order, so both packages pick
the same eigenvectors (and the same signs) for the triangulation's null
vector; `torch.linalg.eigh` would not.
"""

from __future__ import annotations

import torch


def _jacobi_rotation(B: torch.Tensor, p: int, q: int, d: int) -> torch.Tensor:
    """Batched rotation G zeroing B[:, p, q]: B' = G^T B G."""
    app = B[:, p, p]
    aqq = B[:, q, q]
    apq = B[:, p, q]
    small = torch.abs(apq) <= 1e-20 * (torch.abs(app) + torch.abs(aqq) + 1e-30)
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    root = torch.sqrt(1.0 + tau * tau)
    t = torch.sign(tau) / (torch.abs(tau) + root)
    t = torch.where(torch.sign(tau) == 0.0, 1.0 / (tau + root), t)
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    eye = torch.eye(d, dtype=B.dtype, device=B.device)
    # the unit matrices built on the device (a captured CUDA graph takes no
    # copy from the host)
    i = torch.arange(d, device=B.device)
    Epp_qq = torch.diag(((i == p) | (i == q)).to(B.dtype))
    Epq = ((i[:, None] == p) & (i[None, :] == q)).to(B.dtype)
    return (eye[None] + (c - 1.0)[:, None, None] * Epp_qq[None]
            + s[:, None, None] * Epq[None] - s[:, None, None] * Epq.T[None])


def symeig_small(B: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of (N, d, d) symmetric matrices.

    Returns (eigvals (N, d) ascending, eigvecs (N, d, d)) with eigvecs[n, :, i]
    the eigenvector of eigvals[n, i] (the `eigh` convention)."""
    N, d, _ = B.shape
    V = torch.eye(d, dtype=B.dtype, device=B.device).expand(N, d, d)
    for _ in range(sweeps):
        for p in range(d - 1):
            for q in range(p + 1, d):
                G = _jacobi_rotation(B, p, q, d)
                B = torch.einsum("nji,njk,nkl->nil", G, B, G)
                V = torch.einsum("nij,njk->nik", V, G)
    lam = torch.diagonal(B, dim1=-2, dim2=-1)
    # stable ascending order, as the reference's rank-count permutation
    lam_sorted, order = torch.sort(lam, dim=-1, stable=True)
    V_sorted = torch.gather(V, 2, order[:, None, :].expand(N, d, d))
    return lam_sorted, V_sorted
