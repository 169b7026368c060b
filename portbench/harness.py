"""What the drivers share: the seed's draws, state snapshots and the
per-layer record's statistics."""

from __future__ import annotations

import statistics

import numpy as np
import torch


def rng(seed: int, salt: int = 0) -> np.random.Generator:
    """The seed's generator (any whole number, negative or past 64 bits)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), salt])


def tex_phase(seed: int, spec: dict, salt: int = 0) -> float:
    """A texture phase from the seed: base + step * k, k < count."""
    k = int(rng(seed, 100 + salt).integers(spec["count"]))
    return float(spec["base"] + spec["step"] * k)


def tree_map(fn, x):
    """`fn` over the tensors of a (nested) tuple or NamedTuple; other
    leaves pass through."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if isinstance(x, list):
        return [tree_map(fn, v) for v in x]
    return x


def clone(x):
    return tree_map(lambda t: t.clone(), x)


def to_cpu(x):
    return tree_map(lambda t: t.detach().cpu(), x)


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) by linear interpolation."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def median(values) -> float:
    return float(statistics.median(values))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
