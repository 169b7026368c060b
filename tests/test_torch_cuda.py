"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel A runs the plain version's float32 steps (built with
--fmad=false) and differs only in its sum order, so flags are equal and
positions agree within 1e-3 px; kernel B's pose agrees within 1e-4 and its
inlier sets are equal.
"""

import numpy as np
import pytest
import torch

from stereovision_slam_torch import scenes
from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.ops import gftt, image as imops, lk_lanes
from stereovision_slam_torch.ops import pose_kernel as pk

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_lk_level_kernel_matches_plain(dev):
    lefts, rights, _, _, _ = scenes.circuit(device=dev)
    prev, cur, right = (imops.build_pyramid(torch.as_tensor(f, device=dev), 4)
                        for f in (lefts[0], lefts[1], rights[1]))
    pts, valid, _ = gftt.detect(prev[0], 256)
    pairs = []

    def record(*args, **kw):
        p = lk_lanes.lk_level_plain(*args, **kw)
        pairs.append((lk_lanes.lk_level(*args, **kw), p))
        return p

    lk_lanes.track_grouped_lanes(
        [torch.stack([p, p]) for p in prev],
        [torch.stack([c, r]) for c, r in zip(cur, right)],
        torch.stack([pts, pts]), torch.stack([pts, pts - 10.0]),
        torch.stack([valid, valid]), max_iters=12, level_fn=record)
    assert len(pairs) == 4
    for k, p in pairs:
        assert torch.equal(k[:, 2:5], p[:, 2:5])
        torch.testing.assert_close(k[:, :2], p[:, :2], rtol=0, atol=1e-3)


def test_pose_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    left, right = (c.to(dev) for c in scenes.make_stereo_rig())
    T_gt = se3.se3_exp(torch.tensor([0.3, -0.1, 0.5, 0.02, -0.03, 0.01],
                                    device=dev))
    F = 256
    pts = torch.tensor(np.c_[rng.uniform(-8, 8, (F, 1)), rng.uniform(
        -3, 3, (F, 1)), rng.uniform(6, 40, (F, 1))], dtype=torch.float32,
        device=dev)
    uv = torch.cat([jacobians.project_points(c, T_gt, pts)[0]
                    for c in (left, right)], 1)
    uv = uv + torch.tensor(rng.normal(0, 0.3, (F, 4)), dtype=torch.float32,
                           device=dev)
    uv[:10, 0] += 30.0
    valid = torch.tensor(rng.uniform(size=(F, 2)) > 0.1, device=dev).float()
    T0 = torch.stack([T_gt, se3.se3_identity(device=dev),
                      se3.se3_compose(se3.se3_exp(torch.full(
                          (6,), 0.02, device=dev)), T_gt)])
    camp = torch.stack([pk.cam_params(left), pk.cam_params(right)])
    args = (camp.contiguous(), pts, uv.contiguous(), valid.contiguous(),
            T0.contiguous())
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    Tk, ik, ck, _ = pk.pose_lm(*args, **kw)
    Tp, ip, cp, _ = pk.pose_lm_plain(*args, **kw)
    best = int(torch.argmin(cp))
    torch.testing.assert_close(Tk[best], Tp[best], rtol=0, atol=1e-4)
    assert torch.equal(ik[best], ip[best])
    torch.testing.assert_close(ck, cp, rtol=1e-4, atol=1e-3)


def test_wrappers_check_their_inputs(dev):
    img = torch.zeros((1, 40, 60), device=dev)
    meta = torch.zeros((4, lk_lanes.META_COLS), device=dev)
    kw = dict(N=4, pad=7, Py=32, Px=32, win=11, max_iters=3, eps=0.01,
              min_eig_threshold=1e-4)
    lk_lanes.lk_level(img, img, meta, **kw)
    with pytest.raises(ValueError):
        lk_lanes.lk_level(img, img, meta.double(), **kw)
    with pytest.raises(ValueError):
        lk_lanes.lk_level(img, img, meta[:, :5].contiguous(), **kw)
    with pytest.raises(ValueError):
        pk.pose_lm(torch.zeros((2, 16), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 3), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 4), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 2), device=dev),
                   torch.zeros((1, 3, 4), device=dev), chi2_th=5.991,
                   rounds=3, iters=6)
