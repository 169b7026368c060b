"""Port parity, dense block matching: `ops/stereo_bm.compute_disparity`
against the JAX package on the same numpy inputs.

Tolerance: every step is elementwise or a min/argmin except the texture
gate's image mean (the port accumulates it in float64, the reference in
float32), so disparity and validity must be equal on every pixel whose
texture statistic is not within 1e-5 (relative) of its threshold; the
disparity is compared bit for bit there. The count of pixels within that
margin is reported (0 on these inputs). Block matching against OpenCV's
StereoBM keeps the reference's own golden bounds (tests/test_opencv_golden.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.ops import stereo_bm as jbm
from stereovision_slam_torch.ops import stereo_bm
from tests import synthetic

torch.set_num_threads(1)

GATE_MARGIN = 1e-5


def _hold(left, right, **kw):
    """The port's (disp, valid) on the CPU, held to the reference's on
    every pixel outside the texture gate's margin."""
    jd, jv = jbm.compute_disparity(jnp.asarray(left), jnp.asarray(right),
                                   **kw)
    jd, jv = np.asarray(jd), np.asarray(jv)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    d, v = stereo_bm.compute_disparity(lt, rt, **kw)
    d, v = d.numpy(), v.numpy()
    margin = stereo_bm.texture_margin(
        lt, kw.get("block_size", 15)).numpy()
    away = margin > GATE_MARGIN
    print(f"pixels within {GATE_MARGIN} of the texture gate: "
          f"{int((~away).sum())}")
    np.testing.assert_array_equal(v[away], jv[away])
    np.testing.assert_array_equal(d[away], jd[away])
    return d, v


def _texture(seed, H, W):
    return np.array(synthetic.smooth_texture(jax.random.PRNGKey(seed), H, W),
                    np.float32)


def _shift(img, dx):
    return np.array(synthetic.translate_image(jnp.asarray(img), dx, 0.0),
                    np.float32)


def test_disparity_constant_shift():
    H, W = 96, 320
    img = _texture(0, H, W)
    d_true = 17.0
    disp, valid = _hold(img, _shift(img, -d_true), num_disparities=64,
                        block_size=11)
    assert valid.sum() > 2000
    assert np.median(np.abs(disp[valid] - d_true)) < 0.5


def test_disparity_two_planes():
    H, W = 96, 320
    img = _texture(1, H, W)
    right = np.concatenate([_shift(img, -8.0)[:, :W // 2],
                            _shift(img, -24.0)[:, W // 2:]], axis=1)
    d, v = _hold(img, right, num_disparities=48, block_size=11)
    mid = W // 2
    assert abs(np.median(d[:, :mid - 16][v[:, :mid - 16]]) - 8.0) < 1.0
    assert abs(np.median(d[:, mid + 16:][v[:, mid + 16:]]) - 24.0) < 1.0


@pytest.fixture(scope="module")
def textured_pair():
    """A rendered textured stereo pair at the loader's 188x620."""
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(1, step=0.0)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=188, W=620, rig=rig)
    return (np.array(lefts[0], np.float32),
            np.array(rights[0], np.float32))


def test_textured_pair_full_size(textured_pair):
    """The reference's defaults (D 128, block 15) at 188x620."""
    _, v = _hold(*textured_pair, num_disparities=128, block_size=15)
    assert v.sum() > 5000


def test_stack_equals_images_one_by_one():
    """A (B, H, W) stack (the batched keyframe path) gives each image's
    own result, bit for bit; an all-zero pad image is all invalid."""
    H, W = 64, 200
    lefts = [_texture(10 + i, H, W) for i in range(3)]
    rights = [_shift(im, -(6.0 + 3 * i)) for i, im in enumerate(lefts)]
    lefts.append(np.zeros((H, W), np.float32))
    rights.append(np.zeros((H, W), np.float32))
    kw = dict(num_disparities=32, block_size=9)
    d, v = stereo_bm.compute_disparity(torch.from_numpy(np.stack(lefts)),
                                       torch.from_numpy(np.stack(rights)),
                                       **kw)
    for b in range(4):
        d1, v1 = stereo_bm.compute_disparity(torch.from_numpy(lefts[b]),
                                             torch.from_numpy(rights[b]), **kw)
        assert torch.equal(d[b], d1) and torch.equal(v[b], v1)
    assert not v[3].any()
    assert v[:3].sum() > 1000


def test_argmin_takes_the_first_of_tied_costs():
    """The reference's argmin takes the first minimum; a volume with exact
    ties (a periodic texture repeats every 8 columns) must pick the same
    disparity in both packages."""
    H, W = 48, 160
    x = np.arange(W, dtype=np.float32)
    row = np.where(x % 8 < 4, 200.0, 20.0).astype(np.float32)
    img = np.tile(row, (H, 1)) + np.arange(H, dtype=np.float32)[:, None]
    right = np.roll(img, -3, axis=1)
    costs = stereo_bm.cost_volume(torch.from_numpy(img),
                                  torch.from_numpy(right), 32, 5)
    best = torch.argmin(costs, dim=0)
    first = (costs == costs.amin(dim=0, keepdim=True)).to(torch.int64)
    assert torch.equal(best, torch.argmax(first, dim=0))
    ties = (first.sum(dim=0) > 1)
    assert int(ties.sum()) > 1000
    np.testing.assert_array_equal(
        best.numpy(), np.asarray(jnp.argmin(jnp.asarray(costs.numpy()),
                                            axis=0)))
    _hold(img, right, num_disparities=32, block_size=5, texture_threshold=0.0)


def test_stereo_bm_agrees_with_opencv(textured_pair):
    """The golden check of tests/test_opencv_golden.py, on the port."""
    cv2 = pytest.importorskip("cv2")
    left, right = textured_pair
    disp, valid = stereo_bm.compute_disparity(
        torch.from_numpy(left), torch.from_numpy(right),
        num_disparities=128, block_size=15)
    disp, valid = disp.numpy(), valid.numpy()
    u8 = [np.clip(im, 0, 255).astype(np.uint8) for im in (left, right)]
    bm = cv2.StereoBM_create(numDisparities=128, blockSize=15)
    cv_disp = bm.compute(*u8).astype(np.float32) / 16.0
    both = valid & (cv_disp > 0)
    assert both.sum() > 5000, f"only {both.sum()} jointly-valid pixels"
    diff = np.abs(disp[both] - cv_disp[both])
    assert np.median(diff) < 1.0
    assert float(np.mean(diff <= 2.0)) > 0.85
