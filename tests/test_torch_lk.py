"""Port parity, kernel A (ops/lk_lanes.py, ops/lk.py).

The plain PyTorch version of the LK level kernel against the reference's
`track_grouped_lanes(..., interpret=True)` (the Pallas kernel run by its
interpreter) on the scenes of tests/test_lk_lanes.py. Both take the same
float32 steps; only the order of the 121-term sums differs, so positions
agree within 1e-3 px and statuses are equal. The CUDA kernel itself is held
to the plain version in tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.ops import lk as jlk
from stereovision_slam_tpu.ops import lk_lanes as jlanes
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.ops import lk as tlk
from stereovision_slam_torch.ops import lk_lanes as tlanes
from tests import synthetic


@pytest.fixture(scope="module")
def frames():
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(3, step=0.4, yaw_rate=0.003)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=188, W=620, rig=rig)
    return np.array(lefts[0]), np.array(lefts[1]), np.array(rights[0])


def _pts(n, seed=0, border=False):
    rng = np.random.default_rng(seed)
    lo, hi_x, hi_y = (3, 617, 185) if border else (20, 600, 168)
    return np.stack([rng.uniform(lo, hi_x, n),
                     rng.uniform(lo, hi_y, n)], axis=1).astype(np.float32)


def _both(prev, cur, pts, init, mask, max_iters):
    jp = [lv[None] for lv in jimg.build_pyramid(jnp.asarray(prev), 4)]
    jc = [lv[None] for lv in jimg.build_pyramid(jnp.asarray(cur), 4)]
    uj, sj = jlanes.track_grouped_lanes(
        jp, jc, jnp.asarray(pts)[None], jnp.asarray(init)[None],
        jnp.asarray(mask)[None], max_iters=max_iters, interpret=True)
    tp = [lv[None] for lv in timg.build_pyramid(torch.from_numpy(prev), 4)]
    tc = [lv[None] for lv in timg.build_pyramid(torch.from_numpy(cur), 4)]
    ut, st = tlanes.track_grouped_lanes(
        tp, tc, torch.from_numpy(pts)[None], torch.from_numpy(init)[None],
        torch.from_numpy(mask)[None], max_iters=max_iters)
    return (np.asarray(uj[0]), np.asarray(sj[0]), ut[0].numpy(),
            st[0].numpy())


def test_plain_matches_interpreted_kernel(frames):
    prev, cur, _ = frames
    pts = _pts(256, border=True)
    mask = np.ones(256, bool)
    mask[200:] = False
    uj, sj, ut, st = _both(prev, cur, pts, pts, mask, 12)
    np.testing.assert_array_equal(st, sj)
    both = sj & st
    assert both.sum() > 150
    np.testing.assert_allclose(ut[both], uj[both], atol=1e-3)


def test_plain_matches_interpreted_kernel_stereo(frames):
    """L->R with same-position guesses: the coarse-level margins carry the
    full disparity sweep."""
    prev, _, right = frames
    pts = _pts(128, seed=3)
    mask = np.ones(128, bool)
    uj, sj, ut, st = _both(prev, right, pts, pts, mask, 30)
    np.testing.assert_array_equal(st, sj)
    assert st.sum() > 90
    np.testing.assert_allclose(ut[st], uj[st], atol=1e-3)
    assert (pts[st, 0] - ut[st, 0]).max() > 10.0


def _pyr(img):
    return timg.build_pyramid(torch.from_numpy(img), 4)


def test_folded_groups_and_entry_points(frames):
    """track_batched's G=2 fold equals two G=1 calls (frozen points never
    move, so one launch per level is exact), and lk.track is the G=1 case."""
    prev, cur, right = (_pyr(f) for f in frames)
    pts = torch.from_numpy(_pts(128, seed=5))
    mask = torch.ones(128, dtype=torch.bool)
    ua, sa = tlk.track(prev, cur, pts, mask=mask, max_iters=10)
    ub, sb = tlk.track(prev, right, pts, mask=mask, max_iters=10)
    ug, sg = tlk.track_batched(
        [torch.stack([p, p]) for p in prev],
        [torch.stack([c, r]) for c, r in zip(cur, right)],
        torch.stack([pts, pts]), torch.stack([pts, pts]),
        torch.stack([mask, mask]), max_iters=10)
    torch.testing.assert_close(ug[0], ua, rtol=0, atol=0)
    torch.testing.assert_close(ug[1], ub, rtol=0, atol=0)
    assert torch.equal(sg[0], sa) and torch.equal(sg[1], sb)


def test_masked_nan_slots_flat_image_and_level_guard(frames):
    prev, cur = _pyr(frames[0]), _pyr(frames[1])
    pts = torch.from_numpy(_pts(64))
    pts[10:20] = float("nan")
    mask = torch.ones(64, dtype=torch.bool)
    mask[10:20] = False
    uv, st = tlk.track(prev, cur, pts, mask=mask, max_iters=8)
    assert torch.isfinite(uv[mask]).all()
    assert not st[~mask].any()
    flat = timg.build_pyramid(torch.zeros((188, 620)), 4)
    _, st = tlk.track(flat, flat, pts.nan_to_num(), max_iters=5)
    assert not st.any()
    # an 8-row strip: level 3 is one row, too small for the lanes windows,
    # so both packages fall back to their per-level full-image route
    # (statuses equal, positions within 1e-3 px: sums in another order)
    strips = [np.ascontiguousarray(f[90:98]) for f in frames[:2]]
    sp = np.stack([np.linspace(30.0, 590.0, 24), np.full(24, 4.0)],
                  1).astype(np.float32)
    tiny = [timg.build_pyramid(torch.from_numpy(s), 4) for s in strips]
    assert not tlanes.levels_ok(tiny[0], 11)
    ut, st = tlk.track(tiny[0], tiny[1], torch.from_numpy(sp), max_iters=20)
    uj, sj = jlk.track(*(jimg.build_pyramid(jnp.asarray(s), 4)
                         for s in strips), jnp.asarray(sp), max_iters=20)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st.sum() >= 12
    np.testing.assert_allclose(ut.numpy()[st.numpy()],
                               np.asarray(uj)[np.asarray(sj)], atol=1e-3)


@pytest.mark.parametrize("H,windows", [
    (188, [(32, 32), (32, 40), (40, 48), (32, 64)]),
    (8, None)])
def test_kernel_a_level_table(H, windows):
    """Kernel A's level table (pad, padded sizes, search windows and the fit
    of each level) against `level_window_shape` and `levels_ok`, on the
    circuit's 188x620 pyramid (its windows written out) and on an 8-row
    strip whose smallest level is one row, too small for its window."""
    win = 11
    pyr = timg.build_pyramid(torch.zeros((H, 620)), 4)
    pad, shapes = tlanes.level_table(pyr, win)
    assert pad == win // 2 + 2 and len(shapes) == 4
    for level, (lv, sh) in enumerate(zip(pyr, shapes)):
        assert (sh.H, sh.W) == tuple(lv.shape)
        assert (sh.Hp, sh.Wp) == (sh.H + 2 * pad, sh.W + 2 * pad)
        assert (sh.Py, sh.Px) == tlanes.level_window_shape(level, sh.Hp,
                                                           sh.Wp, win)
        assert tlanes.levels_ok([lv], win) == sh.fits
    assert all(sh.fits for sh in shapes) == tlanes.levels_ok(pyr, win)
    if windows is None:
        assert not tlanes.levels_ok(pyr, win)
        assert [sh.fits for sh in shapes] == [True, True, True, False]
        assert shapes[3].Py > shapes[3].Hp
    else:
        assert tlanes.levels_ok(pyr, win)
        assert [(sh.Py, sh.Px) for sh in shapes] == windows


def test_replay_levels_reproduces_the_loop(frames):
    """`lk_pyramid` on the CPU is the level loop over `lk_level_plain`, with
    its rows; `replay_levels`, which rebuilds each level's meta from the
    previous level's rows (as chip_smoke.py and the card tests hold each
    level of the kernel to the plain version), gives those rows back bit
    for bit, NaN slots included."""
    prev, cur = _pyr(frames[0]), _pyr(frames[1])
    pts = torch.from_numpy(_pts(96, seed=7))[None]
    init = pts + torch.tensor([1.5, -0.75])
    masks = torch.ones((1, 96), dtype=torch.bool)
    masks[0, :6] = False
    pts[0, :3] = float("nan")
    pyr_p, pyr_c = [lv[None] for lv in prev], [lv[None] for lv in cur]
    args = (pyr_p, pyr_c, pts, init, masks)
    calls = []

    def record(*a, **kw):
        calls.append(a[2])
        return tlanes.lk_level_plain(*a, **kw)

    uv_r, st_r = tlanes.track_grouped_lanes(*args, max_iters=8,
                                            level_fn=record)
    uv, st, rows = tlanes.lk_pyramid(*args, max_iters=8)
    exact = dict(rtol=0, atol=0, equal_nan=True)   # NaN slots stay NaN
    assert len(calls) == 4 and rows.shape == (4, 96, tlanes.OUT_COLS)
    torch.testing.assert_close(uv, uv_r, **exact)
    assert torch.equal(st, st_r)
    assert st.sum() > 60 and not st[0, :3].any()   # the NaN slots
    torch.testing.assert_close(
        tlanes.replay_levels(*args, rows, max_iters=8), rows, **exact)
    pad = tlanes.level_table(pyr_p, 11)[0]
    torch.testing.assert_close(tlanes.next_guesses(rows[0], pad, 0),
                               uv.reshape(96, 2), **exact)
