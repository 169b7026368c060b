"""Port parity, image ops and GFTT (modules ops/image.py and ops/gftt.py).

Inputs are the port's rendered arena views (numpy, seed-free) and numpy
points from a seed, given to both packages. The filters are the same
float32 shift-adds in the same order, so pyramids and gradients agree to
2 ulps of the 0..255 intensity range (3e-5); the GFTT response inherits
that, and the detection (threshold, NMS, stable top-k) is compared exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stereovision_slam_tpu.ops import gftt as jgftt
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_torch import scenes
from stereovision_slam_torch.ops import gftt as tgftt
from stereovision_slam_torch.ops import image as timg

PIX_TOL = 3e-5


@pytest.fixture(scope="module")
def views():
    rig = scenes.make_stereo_rig(fx=150.0, fy=150.0, cx=96.0, cy=48.0)
    poses = scenes.forward_motion_poses(2, step=0.4, yaw_rate=0.02)
    lefts, rights = scenes.render_arena_stereo_sequence(
        poses, H=96, W=192, rig=rig, center=(0.0, 6.0), radius=25.0)
    return lefts.numpy(), rights.numpy()


def _close(j, t, atol=PIX_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_pyramids_and_gradients(views):
    lefts, rights = views
    img = lefts[0]
    for a, b in zip(jimg.build_pyramid(jnp.asarray(img), 4),
                    timg.build_pyramid(torch.from_numpy(img.copy()), 4)):
        assert a.shape == b.shape
        _close(a, b)
    stack = np.stack([lefts[0], rights[0]])
    for a, b in zip(jimg.build_pyramid_batched(jnp.asarray(stack), 3),
                    timg.build_pyramid_batched(torch.from_numpy(stack), 3)):
        _close(a, b)
    for jf, tf in ((jimg.scharr_gradients, timg.scharr_gradients),
                   (jimg.sobel_gradients, timg.sobel_gradients)):
        for a, b in zip(jf(jnp.asarray(img)), tf(torch.from_numpy(img.copy()))):
            _close(a, b, atol=4 * PIX_TOL)  # gradients sum 6 taps


def test_sample_patches(views):
    img = views[0][0]
    rng = np.random.default_rng(0)
    pts = np.c_[rng.uniform(-3, 195, 64), rng.uniform(-3, 99, 64)].astype(
        np.float32)
    pj, vj = jimg.sample_patches(jnp.asarray(img), jnp.asarray(pts), 11)
    pt, vt = timg.sample_patches(torch.from_numpy(img.copy()),
                                 torch.from_numpy(pts), 11)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    _close(pj, pt, atol=1e-4)   # 4-term bilinear of values up to 255
    raw = rng.uniform(0, 255, (8, 5, 5)).astype(np.float32)
    frac = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    _close(jimg._bilinear_combine(jnp.asarray(raw), jnp.asarray(frac)),
           timg._bilinear_combine(torch.from_numpy(raw), torch.from_numpy(frac)),
           atol=1e-4)


def test_bilinear_sample(views):
    """Point samples, in bounds and out (the same 4-term bilinear as the
    patches, 1e-4 on 0..255), the validity equal."""
    img = views[0][0]
    rng = np.random.default_rng(1)
    pts = np.c_[rng.uniform(-3, 195, 200), rng.uniform(-3, 99, 200)].astype(
        np.float32)
    pts[:4] = [[0.0, 0.0], [190.0, 94.0], [190.5, 10.0], [-0.5, 3.0]]
    vj, okj = jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(pts))
    vt, okt = timg.bilinear_sample(torch.from_numpy(img.copy()),
                                   torch.from_numpy(pts))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt[:2].all() and not okt[2:4].any()
    _close(vj, vt, atol=1e-4)


def test_gftt_response_mask_and_detect(views):
    img = views[0][0]
    # the response is tr/2 - sqrt(...): a cancellation of terms up to the
    # response's maximum, so it agrees to a few ulps of that maximum
    rj = np.asarray(jgftt.min_eig_response(jnp.asarray(img)))
    resp_tol = 1e-6 * float(np.abs(rj).max())
    _close(rj, tgftt.min_eig_response(torch.from_numpy(img.copy())),
           atol=resp_tol)
    rng = np.random.default_rng(1)
    pts = np.c_[rng.uniform(0, 192, 40), rng.uniform(0, 96, 40)].astype(
        np.float32)
    pv = rng.uniform(size=40) > 0.3
    mj = jgftt.occupancy_mask((96, 192), jnp.asarray(pts), jnp.asarray(pv), 5)
    mt = tgftt.occupancy_mask((96, 192), torch.from_numpy(pts),
                              torch.from_numpy(pv), 5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    for mask in (None, mj):
        dj = jgftt.detect(jnp.asarray(img), 64, min_distance=10, mask=mask)
        dt = tgftt.detect(torch.from_numpy(img.copy()), 64, min_distance=10,
                          mask=None if mask is None
                          else torch.from_numpy(np.asarray(mask)))
        assert np.asarray(dj[1]).sum() > 10
        np.testing.assert_array_equal(dt[1].numpy(), np.asarray(dj[1]))
        ok = np.asarray(dj[1])
        np.testing.assert_array_equal(dt[0].numpy()[ok], np.asarray(dj[0])[ok])
        _close(dj[2], dt[2], atol=resp_tol)
