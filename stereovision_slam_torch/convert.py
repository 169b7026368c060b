"""Carry state across from the JAX package.

Turns the JAX package's values, given as array-likes (numpy arrays, or any
object `np.asarray` accepts), into the port's tensors: `Camera`, `MapState`,
`FrontendState`, `ArchiveState` and `SlamConfig` fields. Both packages keep
the same fixed capacities and slot order, so a converted state is the same
state, and tests can start both packages from one mid-sequence state. A
stacked multi-stream state (every field with a leading (B, ...) axis,
pyramid levels (B, H, W)) converts the same way, into the state of
`slam/batched.py`. `to_numpy` goes the other way for comparisons.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.frontend import FrontendState
from stereovision_slam_torch.slam.fused import ArchiveState
from stereovision_slam_torch.slam.map_state import MapState


def tensor(x, device="cpu") -> torch.Tensor:
    a = np.array(np.asarray(x))           # a writable copy
    return torch.from_numpy(a).to(device)


def _fields(cls, src, device):
    return cls(*(tensor(getattr(src, f), device) for f in cls._fields))


def camera(src, device="cpu") -> Camera:
    return _fields(Camera, src, device)


def map_state(src, device="cpu") -> MapState:
    return _fields(MapState, src, device)


def archive_state(src, device="cpu") -> ArchiveState:
    return _fields(ArchiveState, src, device)


def frontend_state(src, device="cpu") -> FrontendState:
    vals = {}
    for f in FrontendState._fields:
        v = getattr(src, f)
        if f in ("pyr", "ref_pyr"):
            vals[f] = tuple(tensor(lv, device) for lv in v)
        else:
            vals[f] = tensor(v, device)
    return FrontendState(**vals)


def slam_config(src) -> SlamConfig:
    names = [f.name for f in dataclasses.fields(SlamConfig)]
    return SlamConfig(**{n: getattr(src, n) for n in names if hasattr(src, n)})


def to_numpy(state) -> dict:
    """{field: numpy array} of a port NamedTuple (pyramids as tuples)."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, (tuple, list)):
            out[f] = tuple(t.detach().cpu().numpy() for t in v)
        else:
            out[f] = v.detach().cpu().numpy()
    return out
