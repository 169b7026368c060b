"""Kernel D: the ring all-reduce along one mesh axis (counterpart of
`parallel/ring_reduce.py`, whose `_ring_kernel` the CUDA kernel of
`csrc/ring_reduce.cu` replaces).

The mesh's ranks are the leading axis of a tensor on one device
(`parallel/mesh.py`). `ring_all_reduce_flat` all-reduces an
(n_ranks, R, 128) float32 payload along `axis_name` (every ring of the mesh
in one launch): the kernel on a CUDA tensor, `ring_all_reduce_plain` on a
CPU tensor. The plain version repeats the kernel's schedule hop by hop with
tensor ops over all ranks at once, so both add the same numbers in the same
order and agree bit for bit; that order is the reference's, and not that of
`x.sum(axis)`. `ring_psum` is the `psum` over a tuple, list or dict of
tensors of shape (*mesh_shape, ...): one fused ring for the concatenated
leaves, padded as the reference pads them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stereovision_slam_torch.ops import _cuda

LANES = 128
launch_count = 0
# ring_reduce_launch(x, out, mbox, flags, err, n_ranks, n, ring_stride,
#                    chunk4, bpr, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_THREADS = 256
_errors: dict[torch.device, torch.Tensor] = {}


def _ring(axis_name: str, mesh_axes) -> tuple[int, int, list[int], int]:
    """(ring size n, stride of the ring axis in the linear rank, the mesh
    sizes, the ring axis's position)."""
    names = [name for name, _ in mesh_axes]
    sizes = [int(size) for _, size in mesh_axes]
    a = names.index(axis_name)
    return sizes[a], math.prod(sizes[a + 1:]), sizes, a


def _check_payload(x: torch.Tensor, n: int, sizes: list[int]) -> None:
    if x.dim() != 3 or x.shape[0] != math.prod(sizes) or x.shape[2] != LANES:
        raise ValueError(f"ring all-reduce: payload {tuple(x.shape)} is not "
                         f"({math.prod(sizes)}, R, {LANES})")
    if x.shape[1] % (8 * n):
        raise ValueError(f"ring all-reduce: R = {x.shape[1]} does not divide "
                         f"by 8 * {n}")


def ring_all_reduce_plain(x: torch.Tensor, axis_name: str,
                          mesh_axes) -> torch.Tensor:
    """Plain PyTorch version: the kernel's 2(n - 1) hops over all ranks."""
    n, _, sizes, a = _ring(axis_name, mesh_axes)
    if n == 1:
        return x
    _check_payload(x, n, sizes)
    N, R, C = x.shape
    Rc = R // n
    others = sizes[:a] + sizes[a + 1:]
    # (ring position, other ranks, chunk, Rc, 128)
    buf = x.reshape(*sizes, R, C).movedim(a, 0).reshape(n, -1, n, Rc, C)
    buf = buf.clone()
    me = torch.arange(n, device=x.device)
    left = (me - 1) % n
    for g in range(2 * (n - 1)):
        if g < n - 1:
            send, recv = (me - g) % n, (me - g - 1) % n
        else:
            s = g - (n - 1)
            send, recv = (me + 1 - s) % n, (me - s) % n
        incoming = buf[me, :, send][left]      # what the left neighbour sent
        if g < n - 1:
            buf[me, :, recv] = buf[me, :, recv] + incoming
        else:
            buf[me, :, recv] = incoming
    return buf.reshape(n, *others, R, C).movedim(0, a).reshape(N, R, C)


def _error_word(dev: torch.device) -> torch.Tensor:
    err = _errors.get(dev)
    if err is None:
        err = _errors[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return err


def check_errors(dev: torch.device) -> None:
    """Raise if a launch on `dev` since the last check timed out in a spin
    (reads the kernel's error word: one device->host copy)."""
    err = _error_word(torch.device(dev))
    code = int(err.item())
    if code:
        err.zero_()
        what = {1: "a credit", 2: "a mailbox flag"}.get(code, str(code))
        raise RuntimeError(f"ring all-reduce: timed out waiting for {what}")


def ring_all_reduce_flat(x: torch.Tensor, axis_name: str, mesh_axes,
                         check: bool = True) -> torch.Tensor:
    """All-reduce the (n_ranks, R, 128) payload along `axis_name`; R must
    divide by 8 * n. On a CUDA tensor one launch of kernel D; with `check`
    the wrapper then reads the kernel's error word (`check_errors`)."""
    n, stride, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return x   # zero hops: nothing to send, and nothing to launch
    if x.device.type == "cpu":
        return ring_all_reduce_plain(x, axis_name, mesh_axes)
    if x.device.type != "cuda":
        raise ValueError(f"ring all-reduce: unsupported device {x.device}")
    _check_payload(x, n, sizes)
    if x.dtype != torch.float32 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("ring all-reduce: the payload must be contiguous, "
                         "16-byte aligned float32")
    N, R, _ = x.shape
    chunk4 = R // n * LANES // 4
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bpr = max(1, min(sms // N, -(-chunk4 // _THREADS)))
    out = torch.empty_like(x)
    mbox = torch.empty((N, 2, chunk4 * 4), dtype=torch.float32,
                       device=x.device)
    flags = torch.zeros(N * bpr * 3, dtype=torch.int32, device=x.device)
    err = _error_word(x.device)
    fn = _cuda.function("ring_reduce", "ring_reduce_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    code = fn(x.data_ptr(), out.data_ptr(), mbox.data_ptr(), flags.data_ptr(),
              err.data_ptr(), N, n, stride, chunk4, bpr,
              _cuda.stream_handle(x))
    _cuda.check(code, "ring_reduce")
    if check:
        check_errors(x.device)
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


def ring_psum(tree, axis_name: str, mesh_axes):
    """`psum` over `axis_name` of a tree whose leaves have the mesh's shape
    as their leading axes: one ring all-reduce of the leaves flattened per
    rank, concatenated and zero-padded to a multiple of 128 * 8 * n floats
    (the reference's layout, so its chunk boundaries)."""
    leaves, rebuild = _leaves(tree)
    n, _, sizes, _ = _ring(axis_name, mesh_axes)
    if n == 1:
        return tree
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
    red = ring_all_reduce_flat(flat.reshape(N, -1, LANES), axis_name,
                               mesh_axes).reshape(N, -1)
    out, off = [], 0
    for leaf in leaves:
        size = leaf[(0,) * len(sizes)].numel()
        out.append(red[:, off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return rebuild(out)
