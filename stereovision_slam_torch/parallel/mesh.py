"""The (dp, mp) rank mesh of the distributed backend (counterpart of
`parallel/mesh.py`).

dp shards the BA observations, mp its landmark blocks. Rank r = i * mp + j
for axis indices (i, j), the reference's row-major order. Three layouts:

  - one process, one device: every rank is an index of a leading tensor axis
    (local blocks have shape (n_dp, n_mp, ...)), a `psum` over an axis is a
    sum over that tensor axis or one launch of kernel D over it
    (`parallel/ring_reduce.py`). That is the layout the reference validates
    on its virtual 8-device CPU mesh;
  - one process, one device per rank (`devices=` lists them; `per_rank`):
    the reference's layout over the chips of one host. The serving streams
    and dense keyframes run per rank on its device; the sharded BA and PGO
    run each rank's share on its device and join the ranks with the
    per-rank collectives below (`psum_ranks`, `gather_ranks`, kernel D
    across the cards). The same code runs whatever the devices are, so
    `devices=["cpu"] * 4` drives it on the CPU;
  - several processes (`initialize_multihost`, torch.distributed): process
    p owns the contiguous ranks [p c, (p + 1) c), c = size / processes,
    held as the leading tensor axes of its local blocks on its own device
    `cuda:(local_rank % device_count)` (or the CPU). A reduction is the
    local sum over the process's ranks followed by `all_reduce` over the
    processes of the same ring, or kernel D across the processes
    (`ring_reduce`, a table of peer pointers).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from stereovision_slam_torch.device import resolve_device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device: str | torch.device = "cuda") -> None:
    """Join this process to a torch.distributed process group (one process
    per card or host), the counterpart of `jax.distributed.initialize`.

    A no-op for `num_processes <= 1`, as the reference's is. The address is
    "host:port" (or any torch.distributed init method with "://"); without
    it the `env://` variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
    are read. Afterwards `make_ba_mesh` lays its ranks over every process.

    The backend, unless `backend` names one:
      - "nccl" where `device` is a card and every process of this host has
        a card of its own (LOCAL_WORLD_SIZE, else `num_processes`, at most
        `torch.cuda.device_count()`): the collectives run on the device,
        the counterpart of XLA's. The process first binds
        `cuda:LOCAL_RANK` (else `cuda:process_id`), before the group forms;
      - "gloo" on the CPU, and for several processes on one card, which
        NCCL refuses (gloo's `all_reduce` takes CUDA tensors and stages
        them through the host).
    A failed start raises; an NCCL group is never retried over gloo."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", -1)) if num_processes is None \
        else int(num_processes)
    rank = int(os.environ.get("RANK", -1)) if process_id is None \
        else int(process_id)
    if backend is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if dev.type == "cuda" and \
            0 < local_world <= torch.cuda.device_count() else "gloo"
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        card = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)


def barrier(group=None) -> None:
    """`dist.barrier` over `group`, naming this process's card where the
    group runs NCCL (which otherwise guesses a device from the rank)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def _spans_processes() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


class Mesh:
    """Axis names ("dp", "mp"), their sizes, one device per rank, and, for a
    mesh over processes, the process group and the ranks this process owns.

    `local_rows` / `local_cols` are the (dp, mp) index ranges of this
    process's ranks: whole dp rows when the ranks per process divide by mp,
    else a run of mp columns of one row. `device` is the device of this
    process's first rank. `per_rank`: every rank runs on its own entry of
    `devices` in this process (the per-rank route)."""

    axis_names = ("dp", "mp")

    def __init__(self, dp: int, mp: int, devices, group=None,
                 ranks: range | None = None, per_rank: bool = False):
        self.shape = {"dp": int(dp), "mp": int(mp)}
        self.size = int(dp) * int(mp)
        self.devices = list(devices)
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for {self.size} "
                             "ranks")
        self.group = group
        self.per_rank = bool(per_rank)
        self.ranks = range(self.size) if ranks is None else ranks
        self.device = self.devices[self.ranks[0]]
        c, r0, mp = len(self.ranks), self.ranks.start, int(mp)
        if c % mp == 0:
            self.local_rows = range(r0 // mp, (r0 + c) // mp)
            self.local_cols = range(mp)
        elif mp % c == 0:
            self.local_rows = range(r0 // mp, r0 // mp + 1)
            self.local_cols = range(r0 % mp, r0 % mp + c)
        else:
            raise ValueError(f"{c} ranks per process neither divide by nor "
                             f"into mp = {mp}")
        self._groups = {"dp": None, "mp": None, None: None}
        if group is not None:
            self._make_groups()

    def _make_groups(self) -> None:
        """The process subgroups of the dp rings (processes holding the
        same mp columns) and of the mp rows (processes holding the same dp
        rows); None where an axis stays inside this process. Every process
        creates every subgroup, in the same order, as `new_group` asks."""
        W, p = dist.get_world_size(self.group), dist.get_rank(self.group)
        per_row = self.shape["mp"] // len(self.local_cols)
        self._groups[None] = self.group
        for axis, key in (("dp", lambda q: q % per_row),
                          ("mp", lambda q: q // per_row)):
            members = {}
            for q in range(W):
                members.setdefault(key(q), []).append(q)
            for ranks in members.values():
                if len(ranks) == W:
                    g = self.group
                elif len(ranks) > 1:
                    g = dist.new_group(ranks)
                else:
                    g = None
                if p in ranks:
                    self._groups[axis] = g

    @property
    def mesh_axes(self) -> tuple[tuple[str, int], ...]:
        """(name, size) per axis in order, as `ring_psum` takes them."""
        return tuple((n, self.shape[n]) for n in self.axis_names)

    @property
    def local_shape(self) -> tuple[int, int]:
        """(dp rows, mp columns) of this process's ranks."""
        return len(self.local_rows), len(self.local_cols)

    def axis_index(self, name: str) -> torch.Tensor:
        """This process's indices along the axis (all of them in one
        process)."""
        idx = self.local_rows if name == "dp" else self.local_cols
        return torch.arange(idx.start, idx.stop, device=self.device)

    def all_reduce(self, t: torch.Tensor, axis: str | None = None):
        """The sum of `t` over the processes that share this process's ring
        along `axis` (None: every process); `t` itself where the axis stays
        inside this process."""
        g = self._groups[axis]
        if g is None:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=g)
        return out

    def all_reduce_gather(self, part: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, ...) from this process's (local extent, ...) slice of
        it: each process writes its slice into zeros and `all_reduce` adds
        them (x + 0 = x, so the values pass unchanged)."""
        if self._groups[axis] is None:
            return part
        idx = self.local_rows if axis == "dp" else self.local_cols
        full = part.new_zeros((self.shape[axis],) + part.shape[1:])
        full[idx.start:idx.stop] = part
        dist.all_reduce(full, group=self._groups[axis])
        return full

    # the per-rank route's collectives: lists indexed by rank
    def ring_of(self, r: int, axis: str | None) -> list[int]:
        """The ranks of rank r's ring along `axis` (None: every rank), in
        rank order."""
        dp, mp = self.shape["dp"], self.shape["mp"]
        if axis == "dp":
            return [k * mp + r % mp for k in range(dp)]
        if axis == "mp":
            return [(r // mp) * mp + k for k in range(mp)]
        return list(range(self.size))

    def _per_ring(self, parts: list, axis: str | None, join) -> list:
        """join(the ring's parts on its first rank's device) for every ring
        along `axis`, with a tensor of its own on each rank's device."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for {self.size} ranks")
        out = [None] * self.size
        for r in range(self.size):
            if out[r] is not None:
                continue
            ring = self.ring_of(r, axis)
            dev = parts[ring[0]].device
            joined = join([parts[q].to(dev) for q in ring])
            for q in ring:
                out[q] = joined if q == ring[0] else joined.to(
                    self.devices[q], copy=True)
        return out

    def psum_ranks(self, parts: list, axis: str | None = None) -> list:
        """Per-rank tensors -> each rank's sum over its ring along `axis`:
        the plain sum in rank order, folded on the ring's first device and
        copied to each rank's."""
        return self._per_ring(parts, axis, fold)

    def gather_ranks(self, parts: list, axis: str) -> list:
        """Per-rank slices -> each rank's concatenation of its ring's
        slices along `axis` in rank order (a tiled all-gather)."""
        return self._per_ring(parts, axis, torch.cat)

    def check_rank_devices(self) -> None:
        """The per-rank route runs every rank on the CPU or every rank on a
        card; kernel D and the copies between ranks take nothing else."""
        kinds = {d.type for d in self.devices}
        if kinds not in ({"cpu"}, {"cuda"}):
            raise ValueError(f"a per-rank mesh runs its ranks on the CPU or "
                             f"on CUDA cards, not on {sorted(kinds)}")


def fold(xs) -> torch.Tensor:
    """x[0] + x[1] + ... in that order: the sum over ranks that every
    layout takes, so that the per-rank route and the ranks as tensor axes
    add the same numbers in the same order."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _canonical(device) -> torch.device:
    """The device as the tensors made on it report theirs ("cuda" ->
    "cuda:<current>", "cpu:0" -> "cpu"), so that the two compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    return dev


def _process_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device in a mesh over processes: the CPU, or
    `cuda:(local_rank % device_count)` (LOCAL_RANK, else the global rank)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _split(n: int, dp: int | None, mp: int | None) -> tuple[int, int]:
    """The reference's default split: mp = 2, else 4, when the count
    divides by it and leaves dp >= 2; otherwise mp = 1."""
    if dp is None or mp is None:
        mp, dp = 1, n
        for cand in (2, 4):
            if n % cand == 0 and n // cand >= 2:
                mp, dp = cand, n // cand
                break
    if dp * mp != n:
        raise ValueError(f"dp ({dp}) * mp ({mp}) != ranks ({n})")
    return dp, mp


def make_ba_mesh(n_devices: int | None = None, dp: int | None = None,
                 mp: int | None = None, devices=None,
                 device: str | torch.device = "cuda") -> Mesh:
    """A (dp, mp) mesh of `n_devices` ranks.

    `devices`, if given, lists one device per rank (cut to `n_devices`) in
    this process. Otherwise, after `initialize_multihost` with several
    processes, the ranks are split evenly over the processes, each on its
    `_process_device(device)`; else all on `device`. Without `n_devices` or
    `devices` the rank count is dp * mp."""
    if devices is not None:
        devices = [_canonical(d) for d in devices]
        if n_devices is not None:
            devices = devices[:n_devices]
        dp, mp = _split(len(devices), dp, mp)
        return Mesh(dp, mp, devices, per_rank=True)
    if n_devices is None:
        if dp is None or mp is None:
            raise ValueError("give n_devices, devices, or both dp and mp")
        n_devices = dp * mp
    n = int(n_devices)
    dp, mp = _split(n, dp, mp)
    if not _spans_processes():
        return Mesh(dp, mp, [_canonical(device)] * n)
    W, p = dist.get_world_size(), dist.get_rank()
    if n % W:
        raise ValueError(f"{n} ranks do not divide over {W} processes")
    c = n // W
    mine = _process_device(device)
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    names = [None] * W
    dist.all_gather_object(names, str(mine))
    per_rank = [torch.device(names[r // c]) for r in range(n)]
    per_rank[p * c:(p + 1) * c] = [mine] * c
    return Mesh(dp, mp, per_rank, group=dist.group.WORLD,
                ranks=range(p * c, (p + 1) * c))


def make_local_mesh(device: str | torch.device = "cuda") -> Mesh:
    """One rank per local device of `device`'s type (the reference's
    `jax.make_mesh((jax.device_count(),), ...)`, as the dense tool's
    `--mesh` takes it): every card, or the one CPU."""
    dev = _canonical(device)
    if dev.type == "cuda":
        return make_ba_mesh(devices=[torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count())])
    return make_ba_mesh(devices=[dev])
