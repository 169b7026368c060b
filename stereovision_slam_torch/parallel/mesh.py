"""The (dp, mp) rank mesh of the distributed backend (counterpart of
`parallel/mesh.py`).

dp shards the BA observations, mp its landmark blocks. The port keeps every
rank of the mesh on one device: a rank is an index of a leading tensor axis
(local blocks have shape (n_dp, n_mp, ...)), a `psum` over an axis is a sum
over that tensor axis or one launch of kernel D over it
(`parallel/ring_reduce.py`), and `axis_index` is an `arange`. That is the
layout the reference validates on its virtual 8-device CPU mesh, here on one
card. Ranks on several cards or hosts are not ported (ROADMAP.md queue 1,
item 18).
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.device import resolve_device


class Mesh:
    """Axis names ("dp", "mp"), their sizes, and one device per rank (rank
    r = i * mp + j for axis indices (i, j), the reference's row-major
    order), all the same device."""

    axis_names = ("dp", "mp")

    def __init__(self, dp: int, mp: int, device: torch.device):
        self.shape = {"dp": int(dp), "mp": int(mp)}
        self.device = device
        self.size = int(dp) * int(mp)
        self.devices = [device] * self.size

    @property
    def mesh_axes(self) -> tuple[tuple[str, int], ...]:
        """(name, size) per axis in order, as `ring_psum` takes them."""
        return tuple((n, self.shape[n]) for n in self.axis_names)

    def axis_index(self, name: str) -> torch.Tensor:
        return torch.arange(self.shape[name], device=self.device)


def _canonical(device) -> torch.device:
    """The device with its index ("cuda" -> "cuda:<current>"), so that it
    compares equal to the device of the tensors made on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_ba_mesh(n_devices: int | None = None, dp: int | None = None,
                 mp: int | None = None, devices=None,
                 device: str | torch.device = "cuda") -> Mesh:
    """A (dp, mp) mesh of `n_devices` ranks on `device`.

    `devices`, if given, lists one device per rank (cut to `n_devices`); they
    must all be one device. Without `n_devices` or `devices` the rank count
    is dp * mp. Default split as the reference's: mp = 2, else 4, when the
    count divides by it and leaves dp >= 2; otherwise mp = 1."""
    if devices is not None:
        devices = [_canonical(d) for d in devices]
        if n_devices is not None:
            devices = devices[:n_devices]
        if len(set(devices)) > 1:
            raise NotImplementedError(
                "a mesh over several devices is not ported: all ranks live "
                "on one device (ROADMAP.md queue 1, item 18)")
        dev = devices[0]
        n = len(devices)
    else:
        dev = _canonical(device)
        if n_devices is None:
            if dp is None or mp is None:
                raise ValueError("give n_devices, devices, or both dp and mp")
            n_devices = dp * mp
        n = int(n_devices)
    if dp is None or mp is None:
        mp, dp = 1, n
        for cand in (2, 4):
            if n % cand == 0 and n // cand >= 2:
                mp, dp = cand, n // cand
                break
    if dp * mp != n:
        raise ValueError(f"dp ({dp}) * mp ({mp}) != ranks ({n})")
    return Mesh(dp, mp, dev)


def make_local_mesh(device: str | torch.device = "cuda") -> Mesh:
    """One rank per local device of `device`'s type (the reference's
    `jax.make_mesh((jax.device_count(),), ...)`, as the dense tool's
    `--mesh` takes it); several cards raise, as `make_ba_mesh` does."""
    dev = _canonical(device)
    if dev.type == "cuda":
        return make_ba_mesh(devices=[torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count())])
    return make_ba_mesh(devices=[dev])
