"""Port parity, the per-level LK route, kernel C and the window gather
(ops/lk.py `_track_level`, ops/lk_iterate.py, ops/gather.py).

The scene of tests/test_gftt_lk.py:197-250: a smooth texture shifted by
(3.7, -2.3) px, 64 GFTT corners, three levels. The reference runs its
per-level route as its own tests do on the CPU: the XLA loop (`"xla"`) or
kernel C under the Pallas interpreter (`"interpret"`). Tolerances:
  * kernel C's plain version against the interpreted kernel, and the
    windowed `"pallas"` route against the reference's: statuses equal,
    positions within 1e-3 px (both stream the patch row by row; only the
    order of each row's 11-term sum differs);
  * the `"xla"` route, windowed or full-image: statuses equal, positions
    within 1e-3 px (the same float32 steps, sums in another order);
  * patch sampling and the window gather: bit-equal (integer windows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.ops import gftt as jgftt
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.ops import lk as jlk
from stereovision_slam_tpu.ops.lk_pallas import lk_iterate_window
from stereovision_slam_torch.ops import gather, lk_iterate
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.ops import lk as tlk
from tests import synthetic

POS_TOL = 1e-3
torch.set_num_threads(1)   # parallel workers: see tests/test_torch_serving.py


@pytest.fixture(scope="module")
def scene():
    img0 = synthetic.smooth_texture(jax.random.PRNGKey(0), 200, 320)
    img1 = synthetic.translate_image(img0, 3.7, -2.3)
    pts, valid, _ = jgftt.detect(img0, max_corners=64, min_distance=10)
    return (np.array(img0), np.array(img1), np.array(pts, np.float32),
            np.array(valid))


def _jax_track(img0, img1, pts, valid, levels=3, **kw):
    u, s = jlk.track(jimg.build_pyramid(jnp.asarray(img0), levels),
                     jimg.build_pyramid(jnp.asarray(img1), levels),
                     jnp.asarray(pts), mask=jnp.asarray(valid), **kw)
    return np.asarray(u), np.asarray(s)


def _torch_track(img0, img1, pts, valid, levels=3, **kw):
    u, s = tlk.track(timg.build_pyramid(torch.from_numpy(img0), levels),
                     timg.build_pyramid(torch.from_numpy(img1), levels),
                     torch.from_numpy(pts), mask=torch.from_numpy(valid),
                     **kw)
    return u.numpy(), s.numpy()


def _agree(a, b, valid):
    (ua, sa), (ub, sb) = a, b
    np.testing.assert_array_equal(sa[valid], sb[valid])
    np.testing.assert_allclose(ua[valid], ub[valid], atol=POS_TOL)


def _level_inputs(img0, img1, pts, seed=0):
    """Kernel C's inputs on level 0 of the scene, edge-padded as `track`
    pads it: guesses scattered up to 12 px from the truth, eight points 6 px
    off at their window's edge (they leave it), and frozen slots, two of
    them with NaN guesses."""
    rng = np.random.default_rng(seed)
    win, margin = 11, 10
    S, P, pad, half = win + 1, win + 1 + 2 * margin, win // 2 + 2, 5.0
    prev, cur = (torch.nn.functional.pad(torch.from_numpy(im)[None, None],
                                         (pad,) * 4, mode="replicate")[0, 0]
                 for im in (img0, img1))
    H, W = prev.shape
    p = torch.from_numpy(pts) + pad
    n = p.shape[0]
    ix, iy = timg.scharr_gradients(prev)
    (tmpl, gx, gy), _ = timg.sample_patches_multi(
        torch.stack([prev, ix, iy]), p, win)
    gf, hf = gx.reshape(n, -1), gy.reshape(n, -1)
    gxx, gxy, gyy = (gf * gf).sum(1), (gf * hf).sum(1), (hf * hf).sum(1)
    det = gxx * gyy - gxy * gxy
    det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))
    guesses = p + torch.tensor([3.7, -2.3]) + torch.from_numpy(
        rng.uniform(-12, 12, (n, 2)).astype(np.float32))
    guesses[:8] = p[:8] + torch.tensor([3.7 + 6.0, -2.3])
    frozen0 = torch.zeros(n, dtype=torch.bool)
    frozen0[-4:] = True
    guesses[-2:] = float("nan")
    corner = timg.floor_int(guesses - half) - margin
    corner[:8, 0] += 9     # these start 1 px from their window's left edge
    corner = torch.stack([corner[:, 0].clamp(0, W - P),
                          corner[:, 1].clamp(0, H - P)], 1)
    win_t = gather.gather_windows(cur[None], torch.zeros(n, dtype=torch.int32),
                                  corner[:, 1].int(), corner[:, 0].int(), P)
    return dict(win=win_t, tmpl=tmpl, gx=gx, gy=gy, gxx=gxx, gxy=gxy,
                gyy=gyy, det_safe=det_safe, solvable=det > 1e-12,
                guesses=guesses, frozen0=frozen0, corner=corner.float(),
                S=S, P=P, W=W, H=H)


def test_lk_iterate_plain_matches_interpreted_kernel(scene):
    img0, img1, pts, _ = scene
    a = _level_inputs(img0, img1, pts)
    kw = dict(S=a["S"], P=a["P"], max_iters=30, eps=0.01, W=a["W"],
              H=a["H"])
    names = ("win", "tmpl", "gx", "gy", "gxx", "gxy", "gyy", "det_safe",
             "solvable", "guesses", "frozen0", "corner")
    jp, jfrozen, jleft = lk_iterate_window(
        *(jnp.asarray(a[k].numpy()) for k in names), interpret=True, **kw)
    out = lk_iterate.lk_iterate(
        a["win"], a["tmpl"], a["gx"], a["gy"],
        torch.stack([a["gxx"], a["gxy"], a["gyy"], a["det_safe"]], 1),
        torch.stack([a["solvable"], a["frozen0"]], 1).float(), a["guesses"],
        a["corner"], **kw).numpy()
    np.testing.assert_array_equal(out[:, 2] > 0.5, np.asarray(jfrozen))
    np.testing.assert_array_equal(out[:, 3] > 0.5, np.asarray(jleft))
    np.testing.assert_allclose(out[:, :2], np.asarray(jp), atol=POS_TOL)
    live = ~a["frozen0"].numpy()
    # the case covers points that converge and points that leave the window
    assert (out[live, 3] > 0.5).sum() >= 3
    assert ((out[live, 3] < 0.5) & (out[live, 2] > 0.5)).sum() >= 20


def test_windowed_pallas_route_matches_interpreted_reference(scene):
    img0, img1, pts, valid = scene
    ref = _jax_track(img0, img1, pts, valid, windowed=True,
                     pallas_mode="interpret")
    port = _torch_track(img0, img1, pts, valid, windowed=True,
                        pallas_mode="pallas")
    _agree(port, ref, valid)
    assert port[1][valid].sum() >= 40


@pytest.mark.parametrize("windowed", [True, False])
def test_per_level_xla_route_matches_reference(scene, windowed):
    img0, img1, pts, valid = scene
    ref = _jax_track(img0, img1, pts, valid, windowed=windowed,
                     pallas_mode="xla")
    port = _torch_track(img0, img1, pts, valid, windowed=windowed,
                        pallas_mode="xla")
    _agree(port, ref, valid)
    np.testing.assert_allclose((port[0] - pts)[valid & port[1]].mean(0),
                               [3.7, -2.3], atol=0.05)


def test_folded_groups_equal_single_calls(scene):
    """track_batched folds G groups into one call per level, where the
    reference vmaps the per-level route: per point the result is the same
    bits as a G=1 call."""
    img0, img1, pts, valid = scene
    p0, p1 = (timg.build_pyramid(torch.from_numpy(im), 3)
              for im in (img0, img1))
    t, m = torch.from_numpy(pts), torch.from_numpy(valid)
    guess = t + torch.tensor([1.0, 0.5])
    for mode in ("pallas", "xla"):
        ug, sg = tlk.track_batched(
            [torch.stack([a, a]) for a in p0],
            [torch.stack([b, a]) for a, b in zip(p0, p1)],
            torch.stack([t, t]), torch.stack([t, guess]), torch.stack([m, m]),
            windowed=True, pallas_mode=mode)
        for g, (tgt, init) in enumerate(((p1, t), (p0, guess))):
            u, s = tlk.track(p0, tgt, t, init, mask=m, windowed=True,
                             pallas_mode=mode)
            assert torch.equal(ug[g], u) and torch.equal(sg[g], s)


def test_serving_lanes_mode_falls_back_on_small_levels(scene):
    """The serving path asks for pallas_mode="lanes" explicitly. The
    reference then takes the lanes kernel without its level guard, and on a
    level smaller than the lanes windows zero-fills them; the port's
    `track_batched` falls back to the per-level route instead, the same
    bits as pallas_mode="xla"."""
    img0, img1, pts, valid = scene
    strips = [timg.build_pyramid(torch.from_numpy(im[96:104].copy()), 4)
              for im in (img0, img1)]
    sp = torch.from_numpy(np.stack([np.linspace(20.0, 300.0, 16),
                                    np.full(16, 4.0)], 1).astype(np.float32))
    args = ([lv[None] for lv in strips[0]], [lv[None] for lv in strips[1]],
            sp[None], sp[None], torch.ones((1, 16), dtype=torch.bool))
    ul, sl = tlk.track_batched(*args, pallas_mode="lanes")
    ux, sx = tlk.track_batched(*args, pallas_mode="xla")
    assert torch.equal(ul, ux) and torch.equal(sl, sx)
    assert sl.sum() >= 8


def test_window_exit_contract():
    """A point that moves 14 px within one level leaves its window: the
    windowed routes report status False, as the reference's kernel does;
    the full-image route follows it."""
    H, W = 160, 200
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")

    def blob(cx):
        return (200.0 * np.exp(-((xx - cx) ** 2 + (yy - 80.0) ** 2)
                               / (2 * 144.0))).astype(np.float32)

    img0, img1 = blob(100.0), blob(114.0)
    pts = np.array([[100.0, 80.0]], np.float32)
    one = np.ones(1, bool)
    kw = dict(levels=1, max_iters=60)
    _, s_ref = _jax_track(img0, img1, pts, one, windowed=True,
                          pallas_mode="interpret", **kw)
    for mode in ("pallas", "xla"):
        _, s = _torch_track(img0, img1, pts, one, windowed=True,
                            pallas_mode=mode, **kw)
        assert not s[0] and not s_ref[0]
    u, s = _torch_track(img0, img1, pts, one, windowed=False, **kw)
    assert s[0]
    np.testing.assert_allclose(u[0, 0] - 100.0, 14.0, atol=0.3)


def test_patch_sampling_and_window_gather_bit_equal(scene):
    img0, img1, _, _ = scene
    rng = np.random.default_rng(1)
    centers = rng.uniform(-3, 330, (50, 2)).astype(np.float32)
    stack = np.stack([img0, img1, img0 * 0.5])
    jp, jv = jimg.sample_patches_multi(jnp.asarray(stack),
                                       jnp.asarray(centers), 11)
    tp, tv = timg.sample_patches_multi(torch.from_numpy(stack),
                                       torch.from_numpy(centers), 11)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # G = 2 images, each point from its own group
    P = 32
    cy = rng.integers(0, 200 - P + 1, 40).astype(np.int32)
    cx = rng.integers(0, 320 - P + 1, 40).astype(np.int32)
    group = rng.integers(0, 2, 40).astype(np.int32)
    imgs = np.stack([img0, img1])
    got = gather.gather_windows(torch.from_numpy(imgs),
                                torch.from_numpy(group), torch.from_numpy(cy),
                                torch.from_numpy(cx), P).numpy()
    for g in (0, 1):
        want = jimg._gather_patches_mxu(jnp.asarray(imgs[g]), jnp.asarray(cy),
                                        jnp.asarray(cx), P - 1)
        np.testing.assert_array_equal(got[group == g],
                                      np.asarray(want)[group == g])
