"""What the comparisons share: the control's lower precision and the
judgement of a run's numbers against their limits."""

from __future__ import annotations

import math

import torch


def lower(x, control: bool):
    """x, or with `control` every float tensor in it (a tensor, or a dict,
    tuple or list of them) stored in bfloat16 and read back."""
    if not control:
        return x
    if torch.is_tensor(x):
        return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() \
            else x
    if isinstance(x, dict):
        return {k: lower(v, control) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(lower(v, control) for v in x)
    return x


def reduce(values: list) -> float:
    """A run's number: the largest of its samples' values (inf where one
    is not finite, or where there is none)."""
    if not values or not all(math.isfinite(v) for v in values):
        return float("inf")
    return float(max(values))


def judge(vals: dict, limits: dict) -> list:
    """[{"name", "value", "limit"}] of every number that has a limit, each
    reduced over its samples. A number with a limit and no sample reads
    inf, so that a run that never reached a stage is not correct."""
    return [{"name": name, "value": reduce(vals.get(name, [])),
             "limit": limit} for name, limit in limits.items()]
