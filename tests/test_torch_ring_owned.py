"""Kernel D's owner form, its bookkeeping on the CPU.

Across cards each card launches once over the chunks it owns (chunk c of a
ring belongs to the card of the ring's rank at position c), folds them from
every rank and stores the sums into every rank's output.
`ring_all_reduce_owned_plain` runs that placement and those pushes chunk by
chunk on CPU tensors with integer "cards"; here it is held bit for bit to
the plain ring (`ring_all_reduce_plain`) and to the reference's interpreted
ring, over meshes, axes and layouts of ranks on 1-4 cards, even and uneven.
The owner table (`owned_chunks`, what each card's launch gets) writes every
output element exactly once, and the host's cached launch tables
(`OwnedRoute`) follow the inputs' pointers and step the epoch every call.
"""

import numpy as np
import pytest
import torch

from stereovision_slam_torch.parallel import ring_reduce as rr
from tests.test_torch_ring_reduce import _TREE, _jax_ring, _ranked

torch.set_num_threads(1)

# rank r's card: one card; round robin over 2 and 4; uneven (the first
# ranks on card 0, one rank on each of the others)
LAYOUTS = {
    "one card": lambda N: [0] * N,
    "2 cards": lambda N: [r % 2 for r in range(N)],
    "4 cards": lambda N: [r % 4 for r in range(N)],
    "uneven": lambda N: [max(0, r - N + 3) for r in range(N)],
}


def _payload(N: int, n: int, seed: int) -> torch.Tensor:
    """(N, R, 128) float32 of mixed magnitudes (a sum-order fault changes
    the bits), R = 8 n x 3 rows."""
    rng = np.random.default_rng(seed)
    R = 8 * n * 3
    x = rng.normal(size=(N, R, rr.LANES)) \
        * 10.0 ** rng.integers(-4, 5, size=(N, R, rr.LANES))
    return torch.from_numpy(x.astype(np.float32))


def _cases():
    for dp in (2, 4, 8):
        for mp in (1, 2):
            for axis in ("dp", "mp") if mp > 1 else ("dp",):
                for layout in LAYOUTS:
                    yield axis, dp, mp, layout


@pytest.mark.parametrize("axis,dp,mp,layout", list(_cases()))
def test_owned_plain_is_the_plain_ring_bit_for_bit(axis, dp, mp, layout):
    ma = (("dp", dp), ("mp", mp))
    n = dp if axis == "dp" else mp
    N = dp * mp
    x = _payload(N, n, dp * 10 + mp)
    owner = LAYOUTS[layout](N)
    got = rr.ring_all_reduce_owned_plain(list(x.unbind(0)), owner, axis, ma)
    want = rr.ring_all_reduce_plain(x, axis, ma)
    assert torch.equal(torch.stack(got), want)
    # the one-card wrapper takes the plain version on CPU tensors
    cards = sorted(set(owner))
    again = rr.ring_all_reduce_owned(list(x.unbind(0)),
                                     [cards.index(k) for k in owner], axis,
                                     ma)
    assert torch.equal(torch.stack(again), want)


@pytest.mark.parametrize("axis,dp,mp", [("dp", 8, 1), ("dp", 4, 2),
                                        ("mp", 2, 4)])
def test_owned_plain_matches_reference_bit_for_bit(axis, dp, mp):
    """The reference test's tree (302 floats per rank, one fused ring on
    the reference's side) packed as `ring_psum` packs it, over 4 cards
    round robin, against the reference's interpreted ring."""
    tree = _ranked(_TREE, dp, mp)
    ref = _jax_ring(tree, axis, dp, mp)
    n = dp if axis == "dp" else mp
    leaves = [torch.from_numpy(tree[k]) for k in tree]
    flat = rr._pack(leaves, [dp, mp], n)
    owner = [r % 4 for r in range(dp * mp)]
    red = torch.stack(rr.ring_all_reduce_owned_plain(
        list(flat.unbind(0)), owner, axis, (("dp", dp), ("mp", mp))))
    got = rr._unpack(red, leaves, [dp, mp])
    for k, g in zip(tree, got):
        np.testing.assert_array_equal(g.numpy(), ref[k])


@pytest.mark.parametrize("axis,dp,mp,layout", list(_cases()))
def test_every_output_element_is_written_once(axis, dp, mp, layout):
    """Each (rank, chunk) of the output is stored by exactly one launch:
    the owner table partitions the chunks of every ring, and a card owns
    exactly the positions of its own ranks."""
    _, stride, _, _ = rr._ring(axis, (("dp", dp), ("mp", mp)))
    n = dp if axis == "dp" else mp
    N = dp * mp
    owner = LAYOUTS[layout](N)
    table = rr.owned_chunks(owner, n, stride)
    writes = np.zeros((N, n), np.int64)
    for card, ids in table.items():
        assert ids == sorted(ids)
        for i in ids:
            ring, c = divmod(i, n)
            base = rr._ring_base(ring, n, stride)
            assert owner[base + c * stride] == card
            for q in range(n):
                writes[base + q * stride, c] += 1
    assert (writes == 1).all()
    assert sorted(table) == sorted(set(owner))
    assert sum(map(len, table.values())) == N
    # no element is left unwritten (the plain version starts from NaN)
    x = _payload(N, n, 7)
    got = rr.ring_all_reduce_owned_plain(list(x.unbind(0)), owner, axis,
                                         (("dp", dp), ("mp", mp)))
    assert not any(bool(g.isnan().any()) for g in got)


def test_owner_tables_are_cached_per_pointer_set_and_the_epoch_grows():
    """A call with the same inputs reuses its packed tables; moved inputs
    rebuild them; the lookups are counted; every call takes the next
    epoch. Host side only: the
    flag addresses and pointers are made up, nothing is launched."""
    flags = [0x7000, 0x8000]
    route = rr.OwnedRoute(flags, [0, 1])
    owner = [0, 1, 0, 1]
    ptrs = [0x1000, 0x2000, 0x3000, 0x4000]
    first = route.tables(ptrs, owner, 4, 1, 64)
    assert route.tables(list(ptrs), owner, 4, 1, 64) is first
    for k, t in enumerate(first):
        assert list(t.x[:4]) == ptrs and list(t.flags[:2]) == flags
        assert (t.me, t.n_cards) == (k, 2)
        assert list(t.owned[:t.n_owned]) == rr.owned_chunks(owner, 4, 1)[k]
    moved = [p + 0x10000 for p in ptrs]
    rebuilt = route.tables(moved, owner, 4, 1, 64)
    assert rebuilt is not first
    assert all(list(t.x[:4]) == moved for t in rebuilt)
    # another shape is another table, with the same pointers
    assert route.tables(ptrs, owner, 4, 1, 128) is not first
    assert (route.hits, route.misses) == (1, 3)
    epochs = [route.next_epoch() for _ in range(3)]
    assert epochs == [1, 2, 3]
    # the cache is bounded: the oldest tables go first
    for i in range(rr._TABLE_CACHE + 1):
        route.tables([p + 0x100000 * (i + 2) for p in ptrs], owner, 4, 1, 64)
    assert route.tables(ptrs, owner, 4, 1, 64) is not first
    with pytest.raises(ValueError):
        rr.OwnedRoute([0] * (rr._MAX_CARDS + 1), [0])


def test_owned_plain_checks_its_inputs():
    ma = (("dp", 4), ("mp", 1))
    xs = list(torch.zeros((4, 32, rr.LANES)).unbind(0))
    with pytest.raises(ValueError):
        rr.ring_all_reduce_owned_plain(xs, [0, 1, 2], "dp", ma)
    with pytest.raises(ValueError):
        rr.ring_all_reduce_owned_plain([x[:20] for x in xs], [0] * 4, "dp",
                                       ma)
    with pytest.raises(ValueError):
        rr.ring_all_reduce_owned(xs, [0, 2, 0, 2], "dp", ma)
