"""Kernel D: the all-reduce along one mesh axis (counterpart of
`parallel/ring_reduce.py`, whose `_ring_kernel` the CUDA kernel of
`csrc/ring_reduce.cu` replaces).

The mesh's ranks are the leading axis of a tensor (`parallel/mesh.py`).
`ring_all_reduce_flat` all-reduces an (n_ranks, R, 128) float32 payload
along `axis_name` (every ring of the mesh in one launch): the kernel on a
CUDA tensor, `ring_all_reduce_plain` on a CPU tensor. Both compute chunk c
of a ring (rows [c R / n, (c + 1) R / n)) as the reference's reduce-scatter
folds it: start from the rank at ring position c, then add the ranks at
c + 1, c + 2, ... in turn. So they agree bit for bit with each other and
with the reference; that order is not that of `x.sum(axis)`. `ring_psum` is
the `psum` over a tuple, list or dict of tensors of shape (*mesh_shape,
...): one all-reduce of the concatenated leaves, padded as the reference
pads them.

The route is chosen by where the ranks are, and by nothing else:
  - every rank on one card, in one process: one launch of the table form
    over all the rings (`ring_all_reduce_flat`; `ring_all_reduce_ranks`
    with every payload on one card);
  - ranks on several cards, every launch of a call on a card of its own:
    in one process (`ring_all_reduce_ranks`, a per-rank mesh) or one
    process a card (`mesh=` over processes whose cards all differ). The
    owner form: chunk c of a ring belongs to the card holding the ring's
    rank at position c (`owned_chunks`); each card launches once over its
    chunks, reads them from every rank (its peers' over NVLink, peer access
    enabled once a pair, and a pair without it raises), and stores each
    sum into every rank's output (its peers' as remote stores). The cards
    order themselves inside the kernel through flag blocks allocated once
    per set of cards (across processes mapped through CUDA IPC) and an
    epoch that grows by one every call (`OwnedRoute`): no CUDA event, no
    cross-device wait, no host synchronize or barrier. A kernel waits for
    its peers up to SPIN_TIMEOUT_S, so the processes of a call may reach it
    that far apart; a kernel whose peer never launches then traps, and the
    next synchronize raises (the context is then unusable);
  - several processes on one card (`mesh=` over processes sharing a card):
    the table form once a process over the table of every rank's input
    (peers' through CUDA IPC) and its own ranks' outputs, between two host
    barriers (the peers' inputs are written; no process overwrites an
    input a peer still reads). Contexts on one card are time-sliced, so a
    kernel that spun for a peer could wait a whole slice.
A build or launch failure raises on every route; nothing falls back to
another. Every route is bit for bit the one-card launch: the fold is the
same. `ring_all_reduce_owned_plain` runs the owner form's bookkeeping
(ownership and pushes, chunk by chunk) on the CPU; `ring_all_reduce_owned`
launches the owner form on one card, once per owner in turn with the
handshake compiled out. On CPU tensors across processes the payloads are
all-gathered and `ring_all_reduce_plain` runs in every process.
"""

from __future__ import annotations

import array
import ctypes
import math
import time

import torch
import torch.distributed as dist

from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.parallel.mesh import barrier

LANES = 128
# kernel D's launches, both forms; `owned_launch_count`: those of the owner
# form alone
launch_count = 0
owned_launch_count = 0
# how long the owner form's kernel waits for a peer card before it traps: a
# detector of a dead peer, not a latency budget (NCCL's watchdog is longer)
SPIN_TIMEOUT_S = 30.0
# ring_reduce_launch(x_ptrs, out_ptrs, n_ranks, n, ring_stride, chunk4,
#                    stream)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# ring_reduce_owned_launch(tables, devices, streams, n_launch, out_ptrs,
#                          n_ranks, n, ring_stride, chunk4, epoch, timeout_ns)
_OWNED_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] \
    + [ctypes.c_int] * 4 + [ctypes.c_uint64] * 2
_MAX_RANKS = 64     # csrc/ring_reduce.cu kMaxRanks
_MAX_CARDS = 16     # csrc/ring_reduce.cu kMaxCards
_FLAG_WORDS = 2 * _MAX_CARDS + 1   # arrived, done, the block counter
_TABLE_CACHE = 8    # packed tables kept per route (shape, input pointers)
# a list: the cross-process routes append one entry per call (CUDA events
# around the launch, host time in synchronizes and barriers); `read_trace`
# turns them into {"device_ms", "sync_ms"}. None: nothing is timed.
trace: list | None = None
_peer_cache: dict = {}
_peers_enabled: set = set()
_card_routes: dict = {}


class _OwnedTable(ctypes.Structure):
    """csrc/ring_reduce.cu's `OwnedTable`: one card's launch of the owner
    form (addresses as that card sees them)."""
    _fields_ = [("x", ctypes.c_uint64 * _MAX_RANKS),
                ("out", ctypes.c_uint64 * _MAX_RANKS),
                ("flags", ctypes.c_uint64 * _MAX_CARDS),
                ("owned", ctypes.c_int32 * _MAX_RANKS),
                ("n_owned", ctypes.c_int32),
                ("me", ctypes.c_int32),
                ("n_cards", ctypes.c_int32)]


def _ring(axis_name: str, mesh_axes) -> tuple[int, int, list[int], int]:
    """(ring size n, stride of the ring axis in the linear rank, the mesh
    sizes, the ring axis's position)."""
    names = [name for name, _ in mesh_axes]
    sizes = [int(size) for _, size in mesh_axes]
    a = names.index(axis_name)
    return sizes[a], math.prod(sizes[a + 1:]), sizes, a


def _ring_base(ring: int, n: int, stride: int) -> int:
    """The rank at position 0 of ring `ring` (position q: base + q stride),
    csrc/ring_reduce.cu's `base`."""
    return (ring // stride) * n * stride + ring % stride


def _check_payload(shape, n: int, sizes: list[int]) -> None:
    if len(shape) != 3 or shape[0] != math.prod(sizes) or shape[2] != LANES:
        raise ValueError(f"ring all-reduce: payload {tuple(shape)} is not "
                         f"({math.prod(sizes)}, R, {LANES})")
    if shape[1] % (8 * n):
        raise ValueError(f"ring all-reduce: R = {shape[1]} does not divide "
                         f"by 8 * {n}")


def ring_all_reduce_plain(x: torch.Tensor, axis_name: str,
                          mesh_axes) -> torch.Tensor:
    """Plain PyTorch version: the kernel's fold, over all rings and chunks
    at once."""
    n, _, sizes, a = _ring(axis_name, mesh_axes)
    if n == 1:
        return x
    _check_payload(x.shape, n, sizes)
    N, R, C = x.shape
    others = sizes[:a] + sizes[a + 1:]
    # (ring position, other ranks, chunk, R / n, 128)
    buf = x.reshape(*sizes, R, C).movedim(a, 0).reshape(n, -1, n, R // n, C)
    c = torch.arange(n, device=x.device)
    acc = buf[c, :, c]                       # (chunk, other ranks, R / n, 128)
    for k in range(1, n):
        acc = acc + buf[(c + k) % n, :, c]
    per_rank = acc.movedim(0, 1)             # (other ranks, chunk, ...)
    out = per_rank.expand(n, *per_rank.shape)
    return out.reshape(n, *others, R, C).movedim(0, a).reshape(N, R, C)


def owned_chunks(owner_of_rank, n: int, stride: int) -> dict[int, list[int]]:
    """The owner form's placement: {card: the ids ring * n + c of the chunks
    it owns}, chunk c of a ring owned by the card of the ring's rank at
    position c (`owner_of_rank[r]`: rank r's card). The ids are in ring,
    then chunk order; this is the table each card's launch gets."""
    N = len(owner_of_rank)
    table: dict[int, list[int]] = {}
    for ring in range(N // n):
        base = _ring_base(ring, n, stride)
        for c in range(n):
            table.setdefault(int(owner_of_rank[base + c * stride]),
                             []).append(ring * n + c)
    return dict(sorted(table.items()))


def ring_all_reduce_owned_plain(xs: list, owner_of_rank, axis_name: str,
                                mesh_axes) -> list:
    """The owner form's bookkeeping in plain PyTorch, on any device: xs[r]
    is rank r's (R, 128) payload and `owner_of_rank[r]` its card (an
    integer). Card by card, each chunk it owns (`owned_chunks`) is folded
    from every rank of its ring in the reference order and stored into
    that chunk of every rank's output, as the kernel's launch on that card
    does. The outputs start as NaN, so an element no card writes shows."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if len(owner_of_rank) != len(xs):
        raise ValueError(f"ring all-reduce: {len(owner_of_rank)} owners for "
                         f"{len(xs)} ranks")
    if n == 1:
        return list(xs)
    _check_payload((len(xs),) + tuple(xs[0].shape), n, sizes)
    h = xs[0].shape[0] // n
    outs = [torch.full_like(x, float("nan")) for x in xs]
    for ids in owned_chunks(owner_of_rank, n, stride).values():
        for i in ids:
            ring, c = divmod(i, n)
            base = _ring_base(ring, n, stride)
            rows = slice(c * h, (c + 1) * h)
            acc = xs[base + c * stride][rows]
            for k in range(1, n):
                acc = acc + xs[base + (c + k) % n * stride][rows]
            for q in range(n):
                outs[base + q * stride][rows] = acc
    return outs


def _check_kernel_payload(x: torch.Tensor, N: int) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("ring all-reduce: the payload must be contiguous, "
                         "16-byte aligned float32")
    if N > _MAX_RANKS:
        raise ValueError(f"ring all-reduce: {N} ranks, at most {_MAX_RANKS}")


def _launch(x_ptrs: list[int], out_ptrs: list[int], n: int, stride: int,
            R: int, like: torch.Tensor) -> None:
    """One launch of the table form over the rank table (0: no output
    here), on `like`'s card and stream."""
    N = len(x_ptrs)
    ptrs = array.array("Q", x_ptrs + out_ptrs)
    fn = _cuda.function("ring_reduce", "ring_reduce_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    base = ptrs.buffer_info()[0]
    _cuda.launch(fn, "ring_reduce", like, base, base + 8 * N, N, n, stride,
                 R // n * LANES // 4)


class OwnedRoute:
    """What the owner form needs for one set of cards besides a call's
    outputs: every card's flag block as this process addresses it
    (`flag_ptrs[j]`, card j of the set; all 0: no handshake), the cards
    this process launches on (`mine`), the epoch, and the packed tables,
    cached per (owners, ring, R, input pointers): a call rebuilds nothing
    while its inputs stay where they were (`hits` and `misses` count the
    lookups). `keep` holds what the flag blocks and mapped buffers live
    in. Host side only: nothing here touches a card."""

    def __init__(self, flag_ptrs, mine, keep=()):
        if not 1 <= len(flag_ptrs) <= _MAX_CARDS:
            raise ValueError(f"ring all-reduce: {len(flag_ptrs)} cards, "
                             f"at most {_MAX_CARDS}")
        self.flag_ptrs = list(flag_ptrs)
        self.mine = list(mine)
        self.keep = keep
        self.epoch = 0
        self.hits = self.misses = 0
        self._tables: dict = {}

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def tables(self, x_ptrs, owner_of_rank, n: int, stride: int,
               R: int) -> list:
        """The `_OwnedTable` of each card of `mine` for these inputs."""
        key = (tuple(x_ptrs), tuple(owner_of_rank), n, stride, R)
        hit = self._tables.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        if len(x_ptrs) > _MAX_RANKS:
            raise ValueError(f"ring all-reduce: {len(x_ptrs)} ranks, at most "
                             f"{_MAX_RANKS}")
        chunks = owned_chunks(owner_of_rank, n, stride)
        hit = []
        for k in self.mine:
            t = _OwnedTable()
            t.x[:len(x_ptrs)] = list(x_ptrs)
            t.flags[:len(self.flag_ptrs)] = self.flag_ptrs
            t.owned[:len(chunks[k])] = chunks[k]
            t.n_owned, t.me, t.n_cards = len(chunks[k]), k, \
                len(self.flag_ptrs)
            hit.append(t)
        if len(self._tables) >= _TABLE_CACHE:
            self._tables.pop(next(iter(self._tables)))
        self._tables[key] = hit
        return hit


def _launch_owned(tables: list, devices: list[int], out_ptrs: list[int],
                  n: int, stride: int, R: int, epoch: int) -> None:
    """Launches of the owner form, tables[i] on card devices[i] and its
    current stream, all with this call's outputs, in one call into the
    library: the wrapper's host time is paid once a call, not once a
    card."""
    k, N = len(tables), len(out_ptrs)
    addrs = array.array("Q", [ctypes.addressof(t) for t in tables])
    cards = array.array("i", devices)
    streams = array.array("Q", [torch._C._cuda_getCurrentRawStream(d)
                                for d in devices])
    outs = array.array("Q", out_ptrs)
    fn = _cuda.function("ring_reduce", "ring_reduce_owned_launch",
                        _OWNED_ARGTYPES)
    global launch_count, owned_launch_count
    launch_count += k
    owned_launch_count += k
    _cuda.check(fn(addrs.buffer_info()[0], cards.buffer_info()[0],
                   streams.buffer_info()[0], k, outs.buffer_info()[0], N, n,
                   stride, R // n * LANES // 4, epoch,
                   int(SPIN_TIMEOUT_S * 1e9)),
                "ring_reduce (owner form)")


def enable_peer_access(cards) -> None:
    """Let every card of `cards` (CUDA device indices) read every other's
    memory, once per ordered pair; raises where the hardware cannot."""
    cards = sorted(set(cards))
    fn = None
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers_enabled:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"ring all-reduce: cuda:{a} cannot access "
                                   f"cuda:{b}'s memory (no peer access), "
                                   "and kernel D reads its peers in place")
            if fn is None:
                fn = _cuda.function("ring_reduce", "ring_reduce_enable_peer",
                                    [ctypes.c_int, ctypes.c_int])
            _cuda.check(fn(a, b), f"enabling peer access cuda:{a} -> "
                        f"cuda:{b}")
            _peers_enabled.add((a, b))


def ring_all_reduce_flat(x: torch.Tensor, axis_name: str,
                         mesh_axes, mesh=None) -> torch.Tensor:
    """All-reduce the (n_ranks, R, 128) payload along `axis_name`; R must
    divide by 8 * n. On a CUDA tensor one launch of kernel D, which reads
    nothing back to the host. With `mesh` over processes, `x` is this
    process's (c, R, 128) block of ranks (see the module's docstring)."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return x   # a ring of one: nothing to add, and nothing to launch
    if mesh is not None and mesh.group is not None:
        return _across_processes(x, axis_name, mesh_axes, mesh)
    if x.device.type == "cpu":
        return ring_all_reduce_plain(x, axis_name, mesh_axes)
    if x.device.type != "cuda":
        raise ValueError(f"ring all-reduce: unsupported device {x.device}")
    _check_payload(x.shape, n, sizes)
    N, R, _ = x.shape
    _check_kernel_payload(x, N)
    out = torch.empty_like(x)
    rank_bytes = R * LANES * x.element_size()
    # the rank table: every rank's input, then every rank's output
    _launch([x.data_ptr() + r * rank_bytes for r in range(N)],
            [out.data_ptr() + r * rank_bytes for r in range(N)],
            n, stride, R, x)
    return out


def _check_ranks(xs: list, n: int, sizes: list[int]) -> str:
    """Check per-rank payloads of one shape; return their device type."""
    kinds = {x.device.type for x in xs}
    _check_payload((len(xs),) + tuple(xs[0].shape), n, sizes)
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError("ring all-reduce: the ranks' payloads differ in "
                         "shape")
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"ring all-reduce: unsupported devices {kinds}")
    if kinds == {"cuda"}:
        for x in xs:
            _check_kernel_payload(x, len(xs))
    return kinds.pop()


def ring_all_reduce_owned(xs: list, owner_of_rank, axis_name: str,
                          mesh_axes) -> list:
    """Kernel D's owner form with every rank on one card: xs[r] is rank r's
    (R, 128) payload and `owner_of_rank[r]` the card it stands for (0, 1,
    ... in the set). One launch per owner in turn on the card's stream,
    each over the chunks its owner owns, storing each sum into every
    rank's output; the handshake is compiled out (stream order stands in
    for it). Bit for bit `ring_all_reduce_owned_plain`, which CPU tensors
    run instead."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return list(xs)
    cards = sorted(set(int(k) for k in owner_of_rank))
    if len(owner_of_rank) != len(xs) or cards != list(range(len(cards))):
        raise ValueError(f"ring all-reduce: owners {list(owner_of_rank)} "
                         f"are not 0, 1, ... for {len(xs)} ranks")
    if _check_ranks(xs, n, sizes) == "cpu":
        return ring_all_reduce_owned_plain(xs, owner_of_rank, axis_name,
                                           mesh_axes)
    if len({x.device for x in xs}) != 1:
        raise ValueError("ring all-reduce: the owner form on one card takes "
                         "payloads on one card")
    key = ("one card", len(cards))
    route = _card_routes.get(key)
    if route is None:
        route = _card_routes[key] = OwnedRoute([0] * len(cards), cards)
    R = xs[0].shape[0]
    tables = route.tables([x.data_ptr() for x in xs], owner_of_rank, n,
                          stride, R)
    outs = [torch.empty_like(x) for x in xs]
    _launch_owned(tables, [xs[0].device.index] * len(cards),
                  [o.data_ptr() for o in outs], n, stride, R, 0)
    return outs


def _cards_route(cards: tuple) -> OwnedRoute:
    """The owner form's route over `cards` (device indices) in this
    process: a zeroed flag block on each card, made once per set."""
    route = _card_routes.get(cards)
    if route is None:
        enable_peer_access(cards)
        flags = [torch.zeros(_FLAG_WORDS, dtype=torch.int64,
                             device=torch.device("cuda", c)) for c in cards]
        for c in cards:
            # zero before any peer can store into it
            torch.cuda.synchronize(c)
        route = _card_routes[cards] = OwnedRoute(
            [f.data_ptr() for f in flags], range(len(cards)), keep=flags)
    return route


def ring_all_reduce_ranks(xs: list, axis_name: str,
                          mesh_axes) -> list:
    """All-reduce along `axis_name` of per-rank (R, 128) float32 payloads,
    xs[r] on rank r's device (a per-rank mesh): on the CPU the plain
    version over the stacked payloads; on one card one launch of the table
    form; over several cards the owner form, one launch a card (see the
    module's docstring). Returns the per-rank results, each on its rank's
    device, bit for bit the one-card launch."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return list(xs)
    if _check_ranks(xs, n, sizes) == "cpu":
        return list(ring_all_reduce_plain(torch.stack(xs), axis_name,
                                          mesh_axes).unbind(0))
    R = xs[0].shape[0]
    cards = tuple(sorted({x.device.index for x in xs}))
    outs = [torch.empty_like(x) for x in xs]
    x_ptrs = [x.data_ptr() for x in xs]
    out_ptrs = [o.data_ptr() for o in outs]
    if len(cards) == 1:
        _launch(x_ptrs, out_ptrs, n, stride, R, xs[0])
        return outs
    route = _cards_route(cards)
    owner = [cards.index(x.device.index) for x in xs]
    _launch_owned(route.tables(x_ptrs, owner, n, stride, R), list(cards),
                  out_ptrs, n, stride, R, route.next_epoch())
    return outs


def _open_peer(rebuild, args, like: torch.Tensor, p: int, q: int):
    """Process q's exposed tensor (`reduce_tensor`'s rebuild and args),
    mapped through CUDA IPC in the context of this process's card.

    The handle is opened with this process's card current, not the peer's
    (`rebuild_cuda_tensor` opens it on the card the buffer lives on): the
    mapping then belongs to this card's context, which is the one kernel D
    runs in. Mapped in the peer card's context, the kernel's loads of it
    faulted (an illegal address on an H100 machine with four cards), peer
    access or not. Peer access from this card to the peer's is enabled
    first, and a pair without it raises."""
    import inspect

    names = list(inspect.signature(rebuild).parameters)
    at = names.index("storage_device")
    if args[at] != like.device.index:
        enable_peer_access([like.device.index, args[at]])
    args = args[:at] + (like.device.index,) + args[at + 1:]
    try:
        return rebuild(*args)
    except Exception as e:
        raise RuntimeError(f"ring all-reduce: process {p} cannot map "
                           f"process {q}'s buffer through CUDA IPC: "
                           f"{e}") from e


def _peer_entry(mesh, like: torch.Tensor) -> dict:
    """This process's exposed input and output buffers of `like`'s shape
    and its flag block, and every process's base addresses of its own
    (peers' mapped through CUDA IPC), made once per mesh group, shape and
    device. `route` is the owner form's `OwnedRoute` where every process
    has a card of its own (the cards' UUIDs all differ), else None."""
    from torch.multiprocessing.reductions import reduce_tensor

    key = (id(mesh.group), tuple(like.shape), like.device)
    hit = _peer_cache.get(key)
    if hit is not None:
        return hit
    own = (torch.empty_like(like), torch.empty_like(like),
           torch.zeros(_FLAG_WORDS, dtype=torch.int64, device=like.device))
    # the flag block is zero before the all-gather lets a peer store into it
    torch.cuda.synchronize(like.device)
    # the library is loaded (built, where it is missing) before the
    # all-gather too: the first launch then follows every process's
    # all-gather closely, and never a peer's build
    _cuda.load("ring_reduce")
    W, p = dist.get_world_size(mesh.group), dist.get_rank(mesh.group)
    uuid = str(torch.cuda.get_device_properties(like.device).uuid)
    shared = [None] * W
    dist.all_gather_object(shared, (uuid, [reduce_tensor(t) for t in own]),
                           group=mesh.group)
    bases, keep = [], list(own)
    for q, (_, handles) in enumerate(shared):
        if q == p:
            bases.append([t.data_ptr() for t in own])
            continue
        mapped = [_open_peer(rebuild, args, like, p, q)
                  for rebuild, args in handles]
        keep += mapped
        bases.append([t.data_ptr() for t in mapped])
    distinct = len({card for card, _ in shared}) == W
    entry = dict(buf=own[0], out=own[1], x_bases=[b[0] for b in bases],
                 out_bases=[b[1] for b in bases], keep=keep,
                 route=OwnedRoute([b[2] for b in bases], [p])
                 if distinct else None)
    _peer_cache[key] = entry
    return entry


def release_peer_buffers() -> None:
    """Drop the IPC mappings and the exposed buffers (call on every process,
    before `destroy_process_group`): this process's launches are waited
    for, then every process's, then the mappings go."""
    groups = {key[0] for key in _peer_cache}
    for card in {key[2] for key in _peer_cache}:
        torch.cuda.synchronize(card)
    if groups and dist.is_initialized():
        barrier()
    _peer_cache.clear()


def read_trace() -> list[dict]:
    """`trace`'s entries as {"device_ms", "sync_ms"} (waits for their
    events)."""
    out = []
    for start, end, sync_ms in trace or []:
        end.synchronize()
        out.append({"device_ms": start.elapsed_time(end), "sync_ms": sync_ms})
    return out


def _across_processes(x: torch.Tensor, axis_name: str, mesh_axes,
                      mesh) -> torch.Tensor:
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    c = len(mesh.ranks)
    N = math.prod(sizes)
    if x.dim() != 3 or x.shape[0] != c:
        raise ValueError(f"ring all-reduce: payload {tuple(x.shape)} is not "
                         f"this process's {c} ranks")
    if x.device.type == "cpu":
        parts = [torch.empty_like(x) for _ in range(N // c)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        full = ring_all_reduce_plain(torch.cat(parts), axis_name, mesh_axes)
        return full[mesh.ranks.start:mesh.ranks.stop].clone()
    if x.device.type != "cuda":
        raise ValueError(f"ring all-reduce: unsupported device {x.device}")
    _check_payload((N,) + tuple(x.shape[1:]), n, sizes)
    R = x.shape[1]
    peers = _peer_entry(mesh, x)
    buf = peers["buf"]
    _check_kernel_payload(buf, N)
    rank_bytes = R * LANES * x.element_size()
    x_ptrs = [peers["x_bases"][r // c] + (r % c) * rank_bytes
              for r in range(N)]
    stream = torch.cuda.current_stream(x.device)
    buf.copy_(x)
    route = peers["route"]
    if route is not None:
        # a card a process: the owner form, the cards ordered in the kernel
        out_ptrs = [peers["out_bases"][r // c] + (r % c) * rank_bytes
                    for r in range(N)]
        owner = [r // c for r in range(N)]
        tables = route.tables(x_ptrs, owner, n, stride, R)
        start = _trace_event(stream)
        _launch_owned(tables, [x.device.index], out_ptrs, n, stride, R,
                      route.next_epoch())
        _traced(start, _trace_event(stream), 0.0)
        # a copy: the caller may hold the result past the next call
        return peers["out"].clone()
    out = torch.empty_like(x)
    r0 = mesh.ranks.start
    out_ptrs = [out.data_ptr() + (r - r0) * rank_bytes
                if r in mesh.ranks else 0 for r in range(N)]
    t0 = time.perf_counter()
    torch.cuda.synchronize(x.device)
    barrier(mesh.group)
    t1 = time.perf_counter()
    start = _trace_event(stream)
    _launch(x_ptrs, out_ptrs, n, stride, R, x)
    end = _trace_event(stream)
    t2 = time.perf_counter()
    torch.cuda.synchronize(x.device)
    barrier(mesh.group)
    t3 = time.perf_counter()
    _traced(start, end, 1e3 * ((t1 - t0) + (t3 - t2)))
    return out


def _trace_event(stream):
    """A timing event recorded on `stream` where `trace` is on, else None."""
    if trace is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _traced(start, end, sync_ms: float) -> None:
    if start is not None:
        trace.append((start, end, sync_ms))


def _leaves(tree):
    """(leaves, rebuild) of a tensor, tuple, list or dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda xs: type(tree)(xs)
    raise TypeError(f"ring_psum: unsupported tree {type(tree)}")


def _pack(leaves, sizes: list[int], n: int) -> torch.Tensor:
    """The leaves (leading with `sizes`) flattened per rank, concatenated
    and zero-padded to a multiple of 128 x 8 x n floats: (N, R, 128)."""
    N = math.prod(sizes)
    for leaf in leaves:
        if list(leaf.shape[:len(sizes)]) != sizes:
            raise ValueError(f"ring_psum: leaf {tuple(leaf.shape)} does not "
                             f"lead with the mesh shape {tuple(sizes)}")
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(N, -1).to(dtype) for leaf in leaves], 1)
    row = LANES * 8 * n
    total = -(-flat.shape[1] // row) * row
    flat = torch.nn.functional.pad(flat, (0, total - flat.shape[1]))
    return flat.reshape(N, -1, LANES)


def _unpack(red: torch.Tensor, leaves, sizes: list[int]) -> list:
    red = red.reshape(math.prod(sizes), -1)
    out, off = [], 0
    for leaf in leaves:
        size = leaf[(0,) * len(sizes)].numel()
        out.append(red[:, off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return out


def ring_psum(tree, axis_name: str, mesh_axes, mesh=None):
    """`psum` over `axis_name` of a tree whose leaves have the mesh's shape
    as their leading axes: one ring all-reduce of the leaves flattened per
    rank, concatenated and zero-padded to a multiple of 128 * 8 * n floats
    (the reference's layout, so its chunk boundaries). With `mesh` over
    processes the leaves lead with this process's `mesh.local_shape`."""
    leaves, rebuild = _leaves(tree)
    n, _, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return tree
    if mesh is not None and mesh.group is not None:
        sizes = list(mesh.local_shape)
    red = ring_all_reduce_flat(_pack(leaves, sizes, n), axis_name,
                               mesh_axes, mesh)
    return rebuild(_unpack(red, leaves, sizes))


def ring_psum_ranks(trees: list, axis_name: str, mesh_axes) -> list:
    """`ring_psum` on a per-rank mesh: trees[r] is rank r's tree (leaves of
    the rank's own shapes, on its device); one all-reduce of the packed
    payloads (`ring_all_reduce_ranks`). Returns the per-rank trees."""
    n, _, _, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return list(trees)
    parts = [_leaves(t) for t in trees]
    red = ring_all_reduce_ranks([_pack(leaves, [], n)[0]
                                 for leaves, _ in parts], axis_name,
                                mesh_axes)
    return [rebuild(_unpack(r, leaves, []))
            for r, (leaves, rebuild) in zip(red, parts)]
