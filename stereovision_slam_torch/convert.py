"""Carry state across from the JAX package.

Turns the JAX package's values, given as array-likes (numpy arrays, or any
object `np.asarray` accepts), into the port's tensors: `Camera`, `MapState`,
`FrontendState`, `ArchiveState`, `LoopState`, `PoseGraph`, `SlamConfig`
fields, and PlaceNet's and MobileNet-V2's weights; `tensor` also reads checkpoint arrays. Both
packages keep the same fixed capacities and slot order, so a converted
state is the same state, and tests can start both packages from one
mid-sequence state. A
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
from stereovision_slam_torch.slam.pose_graph import PoseGraph


def tensor(x, device="cpu") -> torch.Tensor:
    """A tensor of an array-like; uint32 words (packed descriptors) become
    int32 with the same bits."""
    a = np.array(np.asarray(x))           # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
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


def pose_graph(src, device="cpu") -> PoseGraph:
    """A `PoseGraph`, its `edge_info` kept as None where the source has
    none."""
    return PoseGraph(*(None if getattr(src, f) is None
                       else tensor(getattr(src, f), device)
                       for f in PoseGraph._fields))


def loop_state(src, device="cpu"):
    """A `slam.fused_loop.LoopState` (packed descriptors as int32 bits)."""
    from stereovision_slam_torch.slam.fused_loop import LoopState
    return _fields(LoopState, src, device)


def place_net_params(src, device="cpu") -> dict:
    """PlaceNet's weights for `models.place_net`: from the reference's
    params ({"convs": [{"w", "b"}], "proj": {"w", "b"}}) or its npz layout
    (conv{i}_w, conv{i}_b, proj_w, proj_b). Convolution weights turn from
    HWIO to OIHW."""
    if "convs" in src:
        convs = [(c["w"], c["b"]) for c in src["convs"]]
        proj = (src["proj"]["w"], src["proj"]["b"])
    else:
        n = sum(1 for k in src if k.startswith("conv") and k.endswith("_w"))
        convs = [(src[f"conv{i}_w"], src[f"conv{i}_b"]) for i in range(n)]
        proj = (src["proj_w"], src["proj_b"])
    return {"convs": [{"w": tensor(np.asarray(w, np.float32).transpose(
                           3, 2, 0, 1), device),
                       "b": tensor(np.asarray(b, np.float32), device)}
                      for w, b in convs],
            "proj": {"w": tensor(np.asarray(proj[0], np.float32), device),
                     "b": tensor(np.asarray(proj[1], np.float32), device)}}


def mobilenet_params(src, device="cpu") -> dict:
    """MobileNet-V2's parameter tree for `models.mobilenet_v2` from the
    reference's: every convolution weight from HWIO to OIHW (a depthwise
    (3, 3, 1, C) to (C, 1, 3, 3)), batch norm as it is."""
    def conv(p):
        return {"w": tensor(np.asarray(p["w"], np.float32).transpose(
                    3, 2, 0, 1), device),
                "bn": {k: tensor(np.asarray(v, np.float32), device)
                       for k, v in p["bn"].items()}}
    return {"stem": conv(src["stem"]),
            "blocks": [{k: conv(v) for k, v in b.items()}
                       for b in src["blocks"]],
            "head": conv(src["head"])}


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
