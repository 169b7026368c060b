"""Peaks of the card and the least time of kernels A and B.

Frozen copies of `bound_ms`, `lk_bound` and `pose_bound` of chip_smoke.py
(commit 49562ac9c19ec4b6e01f6dee472fed199e03dcff): each input byte read
once and each output byte written once, the operations that these inputs
need (for kernel A the iterations each point and level took, from the
call's own rows). Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W
limit, float32 outside the tensor cores (both kernels compute in float32
on the CUDA cores).
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flop_per_s": 67e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the card named `kind`; KeyError for a card without
    published peaks here."""
    return PEAKS[kind]


def bound_ms(nbytes: float, flops: float, peak: dict):
    """(least ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / peak["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peak["fp32_flop_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lk_counts(args, rows, win: int):
    """Kernel A, one call: (bytes, operations). Every level's two images
    read once; points, initial points and masks in; positions, status and
    the per-level rows out; per point and level the template and gradients
    (~95 operations a pixel) and 12 a pixel for each iteration this call
    took."""
    L, n = rows.shape[:2]
    nbytes = (4 * sum(t.numel() for t in list(args[0]) + list(args[1]))
              + n * (4 * 2 + 4 * 2 + 1) + n * (4 * 2 + 1) + 4 * rows.numel())
    flops = (L * n * 95.0 + float(rows[:, :, 5].sum()) * 12.0) * win * win
    return nbytes, flops


def pose_counts(args, out, kw):
    """Kernel B, one call: (bytes, operations). Inputs read and outputs
    written once; per valid observation and pass (rounds x (iters + 1) +
    the final one) the projection, Jacobian and the 28 sums, ~240
    operations."""
    S = args[6].shape[-3]
    passes = kw["rounds"] * (kw["iters"] + 1) + 1
    flops = S * passes * float(args[4].sum() + args[5].sum()) * 240.0
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + sum(o.numel() * o.element_size() for o in out))
    return nbytes, flops
