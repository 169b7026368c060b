"""Port parity, kernel D's plain version: the ring all-reduce.

The port's `ring_psum` (plain ring on the CPU) against the reference's
`ring_psum(..., interpret=True)` under `shard_map` on the 8 virtual CPU
devices of tests/conftest.py, with the same per-rank inputs (numpy, one
distinct scale per rank). Where the reference runs one fused ring (R at
most the interpreter's `max_rows`, ring_reduce.py:176-182) both add the
same numbers in the same order, and the results are equal bit for bit.
Beyond it the interpreter splits the payload into segments with their own
chunk boundaries, so the sum order differs: rtol 1e-6 there.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from stereovision_slam_tpu.parallel.ring_reduce import ring_psum as jring_psum
from stereovision_slam_torch.parallel import ring_reduce as rr

torch.set_num_threads(1)


def _ranked(shapes, dp, mp, seed=0):
    """{name: (dp, mp, *shape) float32}, rank (i, j) scaled by 1 + 2i + j."""
    rng = np.random.default_rng(seed)
    scale = (1.0 + 2.0 * np.arange(dp)[:, None] + np.arange(mp)[None, :])
    out = {}
    for k, shape in shapes.items():
        x = rng.normal(size=shape).astype(np.float32)
        s = scale.reshape((dp, mp) + (1,) * len(shape)).astype(np.float32)
        out[k] = x[None, None] * s
    return out


def _jax_ring(tree, axis, dp, mp):
    mesh = JMesh(np.array(jax.devices()).reshape(dp, mp), ("dp", "mp"))
    mesh_axes = tuple((n, mesh.shape[n]) for n in mesh.axis_names)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P("dp", "mp"),
                       out_specs=P("dp", "mp"), check_vma=False)
    def f(t):
        local = jax.tree.map(lambda x: x[0, 0], t)
        red = jring_psum(local, axis, mesh_axes, interpret=True)
        return jax.tree.map(lambda x: x[None, None], red)

    return {k: np.asarray(v) for k, v in f(tree).items()}


_TREE = {"a": (8, 5, 7), "b": (13,), "c": (3, 3)}


@pytest.mark.parametrize("axis,dp,mp", [("dp", 8, 1), ("dp", 4, 2),
                                        ("mp", 2, 4)])
def test_ring_psum_matches_reference_bit_for_bit(axis, dp, mp):
    """The reference test's tree (302 floats per rank: one fused ring on
    the reference's side too) along one axis of a 2-D mesh."""
    tree = _ranked(_TREE, dp, mp)
    ref = _jax_ring(tree, axis, dp, mp)
    got = rr.ring_psum({k: torch.from_numpy(v) for k, v in tree.items()},
                       axis, (("dp", dp), ("mp", mp)))
    for k in tree:
        assert got[k].shape == tree[k].shape
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_ring_psum_segmented_reference_within_rtol():
    """20000 floats per rank along dp = 4: 40 rows of 128 x 8 x 4 floats,
    past the interpreter's 128-row segments; rtol 1e-6."""
    tree = _ranked({"g": (100, 200)}, 4, 2, seed=1)
    ref = _jax_ring(tree, "dp", 4, 2)
    got = rr.ring_psum({"g": torch.from_numpy(tree["g"])}, "dp",
                       (("dp", 4), ("mp", 2)))
    np.testing.assert_allclose(got["g"].numpy(), ref["g"], rtol=1e-6,
                               atol=1e-6)


def test_plain_ring_at_the_path_payload_matches_float64_sum():
    """The sharded BA's payload at K = 16, La = 2048 (615,072 floats padded
    to 618,496 per rank), mesh (4, 2) along dp: every rank within 1e-6 of
    the float64 sum, relative to the sum of magnitudes (a 4-term float32
    sum is off by at most 3 ulps of it)."""
    sizes = [16 * 36, 16 * 6, 2048 * 9, 2048 * 3, 2048 * 16 * 18]
    assert sum(sizes) == 615072
    rng = np.random.default_rng(2)
    leaves = [torch.from_numpy(rng.normal(size=(4, 2, s)).astype(np.float32))
              for s in sizes]
    out = rr.ring_psum(tuple(leaves), "dp", (("dp", 4), ("mp", 2)))
    for x, y in zip(leaves, out):
        x64 = x.double()
        ref = x64.sum(0, keepdim=True).expand_as(x64)
        mag = x64.abs().sum(0, keepdim=True).expand_as(x64)
        assert bool(((y.double() - ref).abs() <= 1e-6 * mag).all())
        # every rank of a ring holds the same bits
        assert bool((y == y[:1]).all())


def test_ring_psum_singleton_axis_is_identity():
    x = torch.arange(40, dtype=torch.float32).reshape(1, 8, 5)
    assert rr.ring_psum(x, "dp", (("dp", 1), ("mp", 8))) is x
    flat = torch.zeros((8, 64, 128))
    assert rr.ring_all_reduce_flat(flat, "dp", (("dp", 1), ("mp", 8))) \
        is flat


def test_plain_ring_sums_in_ring_order():
    """1e8, 1, -1e8 and 1 over the four ranks: float32 in the ring's order
    gives a per-chunk result that is not `sum(0)`'s, and each chunk starts
    from its own rank (chunk c folds ranks c, c + 1, ... in turn)."""
    n = 4
    vals = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    x = torch.from_numpy(np.repeat(vals, 8 * n * 128).reshape(n, 8 * n, 128))
    y = rr.ring_all_reduce_plain(x, "dp", (("dp", n), ("mp", 1)))
    chunks = y[0].reshape(n, -1)
    want = []
    for c in range(n):
        acc = np.float32(vals[c])
        for k in range(1, n):
            acc = np.float32(vals[(c + k) % n] + acc)
        want.append(acc)
    np.testing.assert_array_equal(chunks[:, 0].numpy(), np.array(want))
    assert bool((chunks == chunks[:, :1]).all())
    # sum(0) adds in rank order: (1e8 + 1) - 1e8 + 1 = 1, not the ring's
    assert float(x.sum(0)[0, 0]) == 1.0
    assert want != [np.float32(1.0)] * n


def test_ring_payload_checks():
    ma = (("dp", 4), ("mp", 2))
    with pytest.raises(ValueError):
        rr.ring_all_reduce_plain(torch.zeros((8, 20, 128)), "dp", ma)
    with pytest.raises(ValueError):
        rr.ring_all_reduce_plain(torch.zeros((4, 32, 128)), "dp", ma)
    with pytest.raises(ValueError):
        rr.ring_psum({"a": torch.zeros((2, 4, 3))}, "dp", ma)
