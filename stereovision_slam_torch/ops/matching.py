"""Hamming matching of binary descriptors (counterpart of `ops/matching.py`):
the full distance matrix by XOR and popcount, the best match per query row
by argmin (the lowest index on ties), and the reference's distance gate
d <= max(2 * d_min, 30).

Descriptors are packed 32-bit words held in int32 tensors (the bits of the
reference's uint32). PyTorch has no popcount operator, so the words are
widened to int64 and counted with the usual mask-and-add steps.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit words held in int64 (0 <= x < 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, W) x (Nb, W) packed descriptors -> (Na, Nb) int32 distances."""
    x = (a.to(torch.int64)[:, None, :] ^ b.to(torch.int64)[None, :, :]) & _M32
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def match(query, query_ok, train, train_ok, dist_floor: float = 30.0):
    """Best match per query row with the reference's distance gate.
    Returns (idx (Na,) int64, dist (Na,) int32, good (Na,) bool)."""
    big = torch.full((), 10_000, dtype=torch.int32, device=query.device)
    d = hamming_matrix(query, train)
    d = torch.where(train_ok[None, :], d, big)
    d = torch.where(query_ok[:, None], d, big)
    idx = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, idx[:, None])[:, 0]
    valid = query_ok & (dist < big)
    d_min = torch.min(torch.where(valid, dist, big))
    thresh = torch.maximum(2 * d_min, torch.full(
        (), int(dist_floor), dtype=torch.int32, device=query.device))
    good = valid & (dist <= thresh)
    return idx, dist, good
