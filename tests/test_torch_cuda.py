"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernels A and C run the plain versions' float32 steps (built
with --fmad=false) and differ at most in sum order, so flags are equal and
positions agree within 1e-3 px (kernel A: each level from the kernel's own
start, and the whole call); the window gather copies pixels, bit for
bit; kernel B's pose agrees within 1e-4 and its inlier sets are equal, for
one stream and for every (stream, start) of a batched launch; kernel D (the
ring all-reduce) adds the plain version's numbers in its order, bit for bit.
"""

import numpy as np
import pytest
import torch

from stereovision_slam_torch import scenes
from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.ops import gather, gftt, image as imops, lk
from stereovision_slam_torch.ops import lk_iterate, lk_lanes
from stereovision_slam_torch.ops import pose_kernel as pk
from stereovision_slam_torch.parallel import ring_reduce as rr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hold_kernel_a(args, **kw):
    """Kernel A on one call: each level's rows against `lk_level_plain`
    fed the meta rebuilt from the kernel's rows at the level above (flags
    equal, positions within 1e-3 px), and the whole call against the
    plain level loop (status equal, positions within 1e-3 px)."""
    before = lk_lanes.launch_count
    uv, st, rows = lk_lanes.lk_pyramid(*args, **kw)
    assert lk_lanes.launch_count == before + 1
    replay = lk_lanes.replay_levels(*args, rows, **kw)
    for k, p in zip(rows, replay):
        assert torch.equal(k[:, 2:], p[:, 2:])
        torch.testing.assert_close(k[:, :2], p[:, :2], rtol=0, atol=1e-3,
                                   equal_nan=True)
    uv_p, st_p = lk_lanes.track_grouped_lanes(
        *args, level_fn=lk_lanes.lk_level_plain, **kw)
    assert torch.equal(st, st_p)
    torch.testing.assert_close(uv, uv_p, rtol=0, atol=1e-3, equal_nan=True)
    return uv, st


def test_lk_level_kernel_matches_plain(dev):
    """Kernel A (`lk_pyramid`, every level in one launch) on the circuit's
    pyramids at G = 1 and G = 2, with a masked slot at NaN coordinates and
    points within a window of the image's edges."""
    lefts, rights, _, _, _ = scenes.circuit(device=dev)
    prev, cur, right = (imops.build_pyramid(torch.as_tensor(f, device=dev), 4)
                        for f in (lefts[0], lefts[1], rights[1]))
    pts, valid, _ = gftt.detect(prev[0], 256)
    H, W = prev[0].shape
    pts = pts.clone()
    pts[0] = float("nan")
    valid = valid.clone()
    valid[0] = False
    edge = torch.tensor([[2.0, 50.0], [W - 3.0, H - 2.5], [300.0, 1.0],
                         [6.5, H - 6.0]], device=dev)
    pts[1:5] = edge
    valid[1:5] = True
    kw = dict(max_iters=12)
    uv, st = _hold_kernel_a(([lv[None] for lv in prev],
                             [lv[None] for lv in cur], pts[None], pts[None],
                             valid[None]), **kw)
    assert not bool(st[0, 0]) and int(st.sum()) > 150
    assert bool(torch.isfinite(uv[0, 1:5]).all())
    _hold_kernel_a(([torch.stack([p, p]) for p in prev],
                    [torch.stack([c, r]) for c, r in zip(cur, right)],
                    torch.stack([pts, pts]), torch.stack([pts, pts - 10.0]),
                    torch.stack([valid, valid]),), **kw)


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


def _record(monkeypatch, module, name):
    """Record the calls to module.name (still calling it); returns the list
    and the original function."""
    fn, calls = getattr(module, name), []

    def rec(*a, **kw):
        calls.append((a, kw))
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, rec)
    return calls, fn


def test_lk_iterate_and_gather_kernels_match_plain(dev, monkeypatch):
    """Kernel C and the window gather on the windowed levels (0 and 1) of a
    G = 2 per-level track: the gather bit for bit, kernel C with equal flags
    and positions within 1e-3 px."""
    lefts, rights, _, _, _ = scenes.circuit(device=dev)
    prev, cur, right = (imops.build_pyramid(torch.as_tensor(f, device=dev), 4)
                        for f in (lefts[0], lefts[1], rights[1]))
    pts, valid, _ = gftt.detect(prev[0], 256)
    it_calls, it_fn = _record(monkeypatch, lk_iterate, "lk_iterate")
    g_calls, g_fn = _record(monkeypatch, gather, "gather_windows")
    lk.track_batched([torch.stack([p, p]) for p in prev],
                     [torch.stack([c, r]) for c, r in zip(cur, right)],
                     torch.stack([pts, pts]), torch.stack([pts, pts - 10.0]),
                     torch.stack([valid, valid]), max_iters=12,
                     pallas_mode="pallas")
    assert len(it_calls) == 2 and len(g_calls) == 2
    for a, kw in g_calls:
        assert torch.equal(g_fn(*a, **kw), gather.gather_windows_plain(*a, **kw))
    for a, kw in it_calls:
        k, p = it_fn(*a, **kw), lk_iterate.lk_iterate_plain(*a, **kw)
        assert torch.equal(k[:, 2:], p[:, 2:])
        torch.testing.assert_close(k[:, :2], p[:, :2], rtol=0, atol=1e-3)


def test_pose_kernel_over_streams_matches_plain(dev):
    """B = 2 streams x S = 3 starts in one launch: every (b, s) against the
    plain version after one LM step (the starts still apart) and at the
    end, within 1e-4."""
    rng = np.random.default_rng(1)
    left, right = (c.to(dev) for c in scenes.make_stereo_rig())
    camp = torch.stack([pk.cam_params(left), pk.cam_params(right)])
    F, B = 200, 2
    pts = torch.tensor(np.c_[rng.uniform(-8, 8, (B, F, 1)), rng.uniform(
        -3, 3, (B, F, 1)), rng.uniform(6, 40, (B, F, 1))],
        dtype=torch.float32, device=dev)
    pts = pts.reshape(B, F, 3)
    T_gt = se3.se3_exp(torch.tensor([[0.3, -0.1, 0.5, 0.02, -0.03, 0.01],
                                     [-0.2, 0.1, 0.3, 0.0, 0.02, -0.01]],
                                    device=dev))
    uv = torch.cat([jacobians.project_points(c, T_gt[:, None], pts)[0]
                    for c in (left, right)], -1)
    uv = uv + torch.tensor(rng.normal(0, 0.3, (B, F, 4)),
                           dtype=torch.float32, device=dev)
    valid = torch.tensor(rng.uniform(size=(B, F, 2)) > 0.1,
                         device=dev).float()
    d = torch.tensor(rng.normal(0, 0.05, (B, 3, 6)), dtype=torch.float32,
                     device=dev)
    T0 = se3.se3_compose(se3.se3_exp(d), T_gt[:, None])
    args = (camp.contiguous(), pts.contiguous(), uv.contiguous(),
            valid.contiguous(), T0.contiguous())
    for kw in (dict(rounds=1, iters=1), dict(rounds=3, iters=6)):
        Tk, ik, ck, _ = pk.pose_lm(*args, chi2_th=5.991, **kw)
        Tp, ip, cp, _ = pk.pose_lm_plain(*args, chi2_th=5.991, **kw)
        assert Tk.shape == (B, 3, 3, 4)
        torch.testing.assert_close(Tk, Tp, rtol=0, atol=1e-4)
        assert torch.equal(ik, ip)
        torch.testing.assert_close(ck, cp, rtol=1e-4, atol=1e-3)


def test_wrappers_check_their_inputs(dev):
    prev = [torch.zeros((1, 40 >> k, 60 >> k), device=dev) for k in range(3)]
    pts = torch.full((1, 4, 2), 10.0, device=dev)
    masks = torch.ones((1, 4), dtype=torch.bool, device=dev)
    kw = dict(max_iters=3)
    uv, st, rows = lk_lanes.lk_pyramid(prev, prev, pts, pts, masks, **kw)
    assert rows.shape == (3, 4, lk_lanes.OUT_COLS) and not st.any()
    with pytest.raises(ValueError):      # float64 points
        lk_lanes.lk_pyramid(prev, prev, pts.double(), pts.double(), masks)
    with pytest.raises(ValueError):      # masks not bool
        lk_lanes.lk_pyramid(prev, prev, pts, pts, masks.float())
    with pytest.raises(ValueError):      # the levels of the pyramids differ
        lk_lanes.lk_pyramid(prev, prev[:2], pts, pts, masks)
    with pytest.raises(ValueError):      # a level smaller than its window
        tiny = [torch.zeros((1, 8 >> k, 60 >> k), device=dev)
                for k in range(4)]
        lk_lanes.lk_pyramid(tiny, tiny, pts, pts, masks)
    with pytest.raises(ValueError):
        pk.pose_lm(torch.zeros((2, 16), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 3), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 4), device=dev),
                   torch.zeros((pk.MAX_POINTS + 1, 2), device=dev),
                   torch.zeros((1, 3, 4), device=dev), chi2_th=5.991,
                   rounds=3, iters=6)
    ma = (("dp", 4), ("mp", 2))
    x = torch.zeros((8, 33, rr.LANES), device=dev)
    with pytest.raises(ValueError):      # not contiguous
        rr.ring_all_reduce_flat(x[:, 1:], "dp", ma)
    with pytest.raises(ValueError):      # R does not divide by 8 * 4
        rr.ring_all_reduce_flat(x[:, :24].contiguous(), "dp", ma)


# (2, 4) along dp is a ring of two; the 48- and 192-row cases and the
# sharded BA's payload at K = 16, La = 2048 (the last case) have chunks
# whose float4 slices do not fill the last block
@pytest.mark.parametrize("axis,dp,mp,R", [
    ("dp", 8, 1, 64), ("dp", 4, 2, 32), ("mp", 2, 4, 32), ("dp", 2, 4, 48),
    ("mp", 1, 8, 192), ("dp", 4, 2, 4832)])
def test_ring_reduce_kernel_matches_plain(dev, axis, dp, mp, R):
    """Kernel D against its plain version, bit for bit, twice in a row; one
    call reads nothing back to the host (no synchronising operation); the
    singleton axis launches nothing."""
    ma = (("dp", dp), ("mp", mp))
    g = torch.Generator(device=dev).manual_seed(R)
    x = torch.randn((dp * mp, R, rr.LANES), generator=g, device=dev)
    want = rr.ring_all_reduce_plain(x, axis, ma)
    before = rr.launch_count
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rr.ring_all_reduce_flat(x, axis, ma)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert rr.launch_count == before + 2
    single = (("dp", 1), ("mp", dp * mp))
    assert rr.ring_all_reduce_flat(x, "dp", single) is x
    assert rr.launch_count == before + 2
    with pytest.raises(ValueError):
        rr.ring_all_reduce_flat(x.double(), axis, ma)
