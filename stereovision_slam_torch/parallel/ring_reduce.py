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

On a mesh over processes (`mesh=` with a process group) the payload is this
process's (c, R, 128) block of ranks. On CUDA tensors every process copies
it into a buffer it exposes once to the others through CUDA IPC (cached:
the sharded BA reduces a payload of one shape every LM iteration), and
launches kernel D once over a table of every rank's input, its own and its
peers' pointers, with output entries for its own ranks only; a barrier
before the launch (the peers' inputs are written) and one after it (no
process overwrites an input a peer still reads) order the processes. On
CPU tensors the payloads are all-gathered and `ring_all_reduce_plain`
runs in every process. Both are bit for bit the one-process result.

On a per-rank mesh over several cards of one process (`Mesh.per_rank`,
`ring_psum_ranks`) each rank's payload lives on its own card. Each card
makes one launch over the table of every rank's input pointer, its
peers' read over NVLink (peer access is enabled once between every pair
of the cards, and a pair without it raises: nothing is staged through
the host), and writes its own ranks' outputs. CUDA events order the
cards, with no host wait: each card's stream waits for every peer's
stream to have written its inputs, and after the launches every stream
waits for every peer's launch, so that no card's next write to an input
(or reuse of its memory) overtakes a peer still reading it. Bit for bit
the one-card launch: the table and the fold are the same.
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
launch_count = 0
# ring_reduce_launch(x_ptrs, out_ptrs, n_ranks, n, ring_stride, chunk4,
#                    stream)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MAX_RANKS = 64     # csrc/ring_reduce.cu kMaxRanks
# a list: the cross-process route appends {"device_ms", "sync_ms"} per call
# (CUDA events around the launch; host time in the synchronizes and
# barriers around it). None: nothing is timed.
trace: list | None = None
_peer_cache: dict = {}
_peers_enabled: set = set()


def _ring(axis_name: str, mesh_axes) -> tuple[int, int, list[int], int]:
    """(ring size n, stride of the ring axis in the linear rank, the mesh
    sizes, the ring axis's position)."""
    names = [name for name, _ in mesh_axes]
    sizes = [int(size) for _, size in mesh_axes]
    a = names.index(axis_name)
    return sizes[a], math.prod(sizes[a + 1:]), sizes, a


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


def _check_kernel_payload(x: torch.Tensor, N: int) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("ring all-reduce: the payload must be contiguous, "
                         "16-byte aligned float32")
    if N > _MAX_RANKS:
        raise ValueError(f"ring all-reduce: {N} ranks, at most {_MAX_RANKS}")


def _launch(x_ptrs: list[int], out_ptrs: list[int], n: int, stride: int,
            R: int, like: torch.Tensor) -> None:
    """One launch of kernel D over the rank table (0: no output here), on
    `like`'s card and stream."""
    N = len(x_ptrs)
    ptrs = array.array("Q", x_ptrs + out_ptrs)
    fn = _cuda.function("ring_reduce", "ring_reduce_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    base = ptrs.buffer_info()[0]
    _cuda.launch(fn, "ring_reduce", like, base, base + 8 * N, N, n, stride,
                 R // n * LANES // 4)


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


def ring_all_reduce_ranks(xs: list, axis_name: str,
                          mesh_axes) -> list:
    """All-reduce along `axis_name` of per-rank (R, 128) float32 payloads,
    xs[r] on rank r's device (a per-rank mesh): on the CPU the plain
    version over the stacked payloads; on the cards one launch of kernel D
    per card (see the module's docstring). Returns the per-rank results,
    each on its rank's device, bit for bit the one-card launch."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return list(xs)
    N = len(xs)
    kinds = {x.device.type for x in xs}
    _check_payload((N,) + tuple(xs[0].shape), n, sizes)
    if any(x.shape != xs[0].shape for x in xs):
        raise ValueError("ring all-reduce: the ranks' payloads differ in "
                         "shape")
    if kinds == {"cpu"}:
        return list(ring_all_reduce_plain(torch.stack(xs), axis_name,
                                          mesh_axes).unbind(0))
    if kinds != {"cuda"}:
        raise ValueError(f"ring all-reduce: unsupported devices {kinds}")
    for x in xs:
        _check_kernel_payload(x, N)
    R = xs[0].shape[0]
    first = {}                    # card -> its first rank's payload
    for x in xs:
        first.setdefault(x.device.index, x)
    enable_peer_access(first)
    streams = {c: torch.cuda.current_stream(c) for c in first}

    def cross_wait():
        """Each card's stream waits for what every other card's stream
        has queued so far."""
        if len(streams) > 1:
            events = {c: s.record_event() for c, s in streams.items()}
            for c, s in streams.items():
                for o, e in events.items():
                    if o != c:
                        s.wait_event(e)

    outs = [torch.empty_like(x) for x in xs]
    x_ptrs = [x.data_ptr() for x in xs]
    cross_wait()                  # every input written
    for c, like in first.items():
        _launch(x_ptrs, [o.data_ptr() if o.device.index == c else 0
                         for o in outs], n, stride, R, like)
    cross_wait()                  # every launch done before inputs change
    return outs


def _peer_bases(mesh, like: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """This process's exposed input buffer of `like`'s shape and every
    process's base address of its own (peers' mapped through CUDA IPC),
    made once per mesh group, shape and device.

    A peer's handle is opened with this process's card current, not the
    peer's (`rebuild_cuda_tensor` opens it on the card the buffer lives
    on): the mapping then belongs to this card's context, which is the one
    kernel D runs in. Mapped in the peer card's context, the kernel's
    loads of it faulted (an illegal address on an H100 machine with four
    cards), peer access or not. Peer access from this card to the peer's
    is enabled first, and a pair without it raises."""
    import inspect
    from torch.multiprocessing.reductions import reduce_tensor

    key = (id(mesh.group), tuple(like.shape), like.device)
    hit = _peer_cache.get(key)
    if hit is not None:
        return hit[0], hit[1]
    buf = torch.empty_like(like)
    W, p = dist.get_world_size(mesh.group), dist.get_rank(mesh.group)
    handles = [None] * W
    dist.all_gather_object(handles, reduce_tensor(buf), group=mesh.group)
    peers, bases = [], []
    for q, (rebuild, args) in enumerate(handles):
        if q == p:
            bases.append(buf.data_ptr())
            continue
        names = list(inspect.signature(rebuild).parameters)
        at = names.index("storage_device")
        if args[at] != like.device.index:
            enable_peer_access([like.device.index, args[at]])
        args = args[:at] + (like.device.index,) + args[at + 1:]
        try:
            t = rebuild(*args)
        except Exception as e:
            raise RuntimeError(f"ring all-reduce: process {p} cannot map "
                               f"process {q}'s buffer through CUDA IPC: "
                               f"{e}") from e
        peers.append(t)
        bases.append(t.data_ptr())
    _peer_cache[key] = (buf, bases, peers)
    return buf, bases


def release_peer_buffers() -> None:
    """Drop the IPC mappings and the exposed buffers (call on every process,
    before `destroy_process_group`)."""
    groups = {key[0] for key in _peer_cache}
    _peer_cache.clear()
    if groups and dist.is_initialized():
        barrier()


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
    buf, bases = _peer_bases(mesh, x)
    _check_kernel_payload(buf, N)
    buf.copy_(x)
    out = torch.empty_like(x)
    rank_bytes = R * LANES * x.element_size()
    r0 = mesh.ranks.start
    x_ptrs = [bases[r // c] + (r % c) * rank_bytes for r in range(N)]
    out_ptrs = [out.data_ptr() + (r - r0) * rank_bytes
                if r in mesh.ranks else 0 for r in range(N)]
    t0 = time.perf_counter()
    torch.cuda.synchronize(x.device)
    barrier(mesh.group)
    t1 = time.perf_counter()
    if trace is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(torch.cuda.current_stream(x.device))
    _launch(x_ptrs, out_ptrs, n, stride, R, x)
    if trace is not None:
        ev[1].record(torch.cuda.current_stream(x.device))
    t2 = time.perf_counter()
    torch.cuda.synchronize(x.device)
    barrier(mesh.group)
    t3 = time.perf_counter()
    if trace is not None:
        trace.append({"device_ms": ev[0].elapsed_time(ev[1]),
                      "sync_ms": 1e3 * ((t1 - t0) + (t3 - t2))})
    return out


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
