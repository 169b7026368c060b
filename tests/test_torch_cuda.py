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


@pytest.mark.parametrize("win", [21, 31])
def test_lk_kernel_wide_windows_match_plain(dev, win):
    """Kernel A at OpenCV's default window (21) and at its largest (31, a
    block above 48 KB of shared memory) on the circuit's pyramids, held as
    above; `lk.track(win_size=21)` takes the lanes route, one launch, and
    agrees with the plain level loop."""
    lefts, rights, _, _, _ = scenes.circuit(device=dev)
    prev, cur, right = (imops.build_pyramid(torch.as_tensor(f, device=dev), 4)
                        for f in (lefts[0], lefts[1], rights[1]))
    pts, valid, _ = gftt.detect(prev[0], 256)
    kw = dict(win_size=win, max_iters=12)
    _hold_kernel_a(([torch.stack([p, p]) for p in prev],
                    [torch.stack([c, r]) for c, r in zip(cur, right)],
                    torch.stack([pts, pts]), torch.stack([pts, pts - 10.0]),
                    torch.stack([valid, valid])), **kw)
    before = lk_lanes.launch_count
    uv, st = lk.track(prev, cur, pts, mask=valid, **kw)
    assert lk_lanes.launch_count == before + 1
    uv_p, st_p = lk_lanes.track_grouped_lanes(
        [lv[None] for lv in prev], [lv[None] for lv in cur], pts[None],
        pts[None], valid[None], level_fn=lk_lanes.lk_level_plain, **kw)
    assert torch.equal(st, st_p[0]) and int(st.sum()) > 150
    torch.testing.assert_close(uv, uv_p[0], rtol=0, atol=1e-3,
                               equal_nan=True)


def _pose_streams(dev, B, S, F=200, seed=0):
    """Kernel B's inputs for B streams of F points (not a multiple of the
    kernel's 128 threads per start) with pixel noise and gross outliers,
    and S starts around each stream's pose: start 1 half a turn about y
    (every point behind the cameras, no valid residual), start 2 a copy of
    start 0 (their costs tie)."""
    rng = np.random.default_rng(seed)
    left, right = (c.to(dev) for c in scenes.make_stereo_rig())
    T_gt = se3.se3_exp(torch.tensor(rng.normal(0, [0.3, 0.1, 0.3, 0.02, 0.03,
                                                   0.02], (B, 6)),
                                    dtype=torch.float32, device=dev))
    pts = torch.tensor(np.stack([rng.uniform(-8, 8, (B, F)),
                                 rng.uniform(-3, 3, (B, F)),
                                 rng.uniform(6, 40, (B, F))], -1),
                       dtype=torch.float32, device=dev)
    uv_l, uv_r = (jacobians.project_points(c, T_gt[:, None], pts)[0]
                  + torch.tensor(rng.normal(0, 0.3, (B, F, 2)),
                                 dtype=torch.float32, device=dev)
                  for c in (left, right))
    uv_l[:, :10] += 30.0
    vl = torch.tensor(rng.uniform(size=(B, F)) > 0.1, device=dev)
    vr = vl & torch.tensor(rng.uniform(size=(B, F)) > 0.1, device=dev)
    d = torch.tensor(rng.normal(0, 0.05, (B, S, 6)), dtype=torch.float32,
                     device=dev)
    d[:, 1] = torch.tensor([0.0, 0.0, 0.0, 0.0, np.pi, 0.0], device=dev)
    d[:, 2] = d[:, 0]
    T0 = se3.se3_compose(se3.se3_exp(d), T_gt[:, None])
    return (pk.camera_block(left, right), pts.contiguous(),
            uv_l.contiguous(), uv_r.contiguous(), vl, vr, T0.contiguous())


@pytest.mark.parametrize("B,S,F", [(1, 3, 200), (4, 3, 200), (1, 8, 200),
                                   (1, 3, 1025), (1, 3, 2048), (2, 8, 2048)])
def test_pose_kernel_matches_plain(dev, B, S, F):
    """Kernel B against its plain version on every (stream, start), after
    one LM step (the starts still apart) and after 3 x 6: T within 1e-4,
    inliers equal, costs within 1e-4; a start with no point in front of the
    cameras keeps no inlier; of two tied starts the first is chosen, and the
    chosen outputs are the kernel's own per-start outputs there. F above
    1024 takes the kernel's unstaged layout (observations read from global
    memory, inlier flags in the output)."""
    args = _pose_streams(dev, B, S, F)
    for kw in (dict(rounds=1, iters=1), dict(rounds=3, iters=6)):
        k = pk.pose_lm(*args, chi2_th=5.991, **kw)
        p = pk.pose_lm_plain(*args, chi2_th=5.991, **kw)
        assert k.T_all.shape == (B, S, 3, 4) and k.inlier.shape == (B, 2 * F)
        torch.testing.assert_close(k.T_all, p.T_all, rtol=0, atol=1e-4)
        assert torch.equal(k.inl_all, p.inl_all)
        torch.testing.assert_close(k.cost, p.cost, rtol=1e-4, atol=1e-3)
        assert not bool(k.inl_all[:, 1].any())
        assert torch.equal(k.cost[:, 0], k.cost[:, 2])
        best = torch.argmin(k.cost, dim=-1)
        assert not bool((best == 2).any())
        rows = torch.arange(B, device=dev)
        assert torch.equal(k.T, k.T_all[rows, best])
        assert torch.equal(k.inlier, k.inl_all[rows, best].reshape(B, -1))
        assert torch.equal(k.n_inliers,
                           k.inl_all[rows, best, 0].sum(-1).int())
        torch.testing.assert_close(k.T, p.T, rtol=0, atol=1e-4)


def test_pose_kernel_over_streams_matches_plain(dev):
    """B = 2 streams x S = 3 starts in one launch, held as above."""
    test_pose_kernel_matches_plain(dev, 2, 3, 200)


@pytest.mark.parametrize("B,S,F", [(1, 3, 200), (2, 8, 2048)])
def test_pose_kernel_trace(dev, B, S, F):
    """Kernel B with `trace`: the same outputs, bit for bit, as without;
    its decisions in the plain version's layout; the plain version
    following them lands on the kernel's poses within 1e-4, and any
    decision of its own that differs is a float32 tie (chip_smoke.py's
    POSE_ACC_TIE and POSE_LEVEL_TIE)."""
    args = _pose_streams(dev, B, S, F)
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    plain_out = pk.pose_lm(*args, **kw)
    tr = {}
    traced = pk.pose_lm(*args, **kw, trace=tr)
    assert all(torch.equal(a, b) for a, b in zip(plain_out, traced))
    assert tr["acc"].shape == (B, S, 3, 6) and tr["lev"].shape == (
        B, S, 3, 2, F)
    assert torch.equal(tr["lev"][:, :, 0], torch.stack(
        [args[4], args[5]], 1)[:, None].expand(B, S, 2, F))
    fol = {}
    p = pk.pose_lm_plain(*args, **kw, follow=tr, trace=fol)
    torch.testing.assert_close(traced.T_all, p.T_all, rtol=0, atol=1e-4)
    assert torch.equal(traced.inl_all, p.inl_all)
    assert fol["acc_tie"] <= 1e-5 and fol["lev_tie"] <= 1e-3


def test_solve_pose_multi_lr_is_one_launch(dev):
    """One `solve_pose_multi_lr` call at the slice's shape is one kernel B
    launch and waits for nothing (sync debug mode); S > 8 starts and no
    round are refused."""
    camp, pts, uv_l, uv_r, vl, vr, T0 = (
        x[0] if i else x for i, x in enumerate(_pose_streams(dev, 1, 3, 256)))
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    before = pk.launch_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        T, inl, n = pk.solve_pose_multi_lr(camp, T0, pts, uv_l, uv_r, vl, vr,
                                           **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pk.launch_count == before + 1
    assert T.shape == (3, 4) and inl.shape == (512,) and inl.dtype == torch.bool
    assert n.dtype == torch.int32 and int(n) == int(inl[:256].sum()) > 150
    many = se3.se3_identity(device=dev).expand(pk.MAX_STARTS + 1, 3, 4)
    with pytest.raises(ValueError):
        pk.solve_pose_multi_lr(camp, many.contiguous(), pts, uv_l, uv_r, vl,
                               vr, **kw)
    with pytest.raises(ValueError):
        pk.pose_lm(camp, pts, uv_l, uv_r, vl, vr, T0, chi2_th=5.991,
                   rounds=0, iters=6)
    with pytest.raises(ValueError):      # the valid masks as float
        pk.pose_lm(camp, pts, uv_l, uv_r, vl.float(), vr, T0, **kw)
    assert pk.launch_count == before + 1


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


def _window_inputs(dev, win):
    """Kernel C's inputs on the circuit's first frame against a blend of two
    shifted copies of it (about 1.5 px right and 0.5 px up), edge-padded as
    `lk.track` pads a level, for
    patch size `win`: 256 GFTT corners with guesses up to 2 px off, eight
    of them 6 px off at their window's left edge (they leave it), two
    unsolvable, four frozen slots, two of them with NaN guesses."""
    rng = np.random.default_rng(win)
    lefts, _, _, _, _ = scenes.circuit(device=dev)
    prev_img = torch.as_tensor(lefts[0], device=dev)
    cur_img = 0.5 * (torch.roll(prev_img, (-1, 1), (0, 1))
                     + torch.roll(prev_img, (0, 2), (0, 1)))
    pts, _, _ = gftt.detect(prev_img, 256)
    S, pad, half = win + 1, win // 2 + 2, (win - 1) / 2.0
    P = S + 2 * lk_iterate.WINDOW_MARGIN
    prev, cur = (torch.nn.functional.pad(im[None, None], (pad,) * 4,
                                         mode="replicate")[0, 0]
                 for im in (prev_img, cur_img))
    H, W = prev.shape
    p = pts + pad
    n = p.shape[0]
    ix, iy = imops.scharr_gradients(prev)
    (tmpl, gx, gy), _ = imops.sample_patches_multi(
        torch.stack([prev, ix, iy]), p, win)
    gf, hf = gx.reshape(n, -1), gy.reshape(n, -1)
    gxx, gxy, gyy = (gf * gf).sum(1), (gf * hf).sum(1), (hf * hf).sum(1)
    det = gxx * gyy - gxy * gxy
    det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))
    solvable = det > 1e-12
    solvable[8:10] = False
    guesses = p + torch.tensor(rng.uniform(-2, 2, (n, 2)),
                               dtype=torch.float32, device=dev)
    guesses[:8] = p[:8] + torch.tensor([6.0, 0.0], device=dev)
    frozen0 = torch.zeros(n, dtype=torch.bool, device=dev)
    frozen0[-4:] = True
    guesses[-2:] = float("nan")
    corner = imops.floor_int(guesses - half) - lk_iterate.WINDOW_MARGIN
    corner[:8, 0] += lk_iterate.WINDOW_MARGIN - 1   # 1 px from the left edge
    corner = torch.stack([corner[:, 0].clamp(0, W - P),
                          corner[:, 1].clamp(0, H - P)], 1)
    wins = gather.gather_windows(cur[None], torch.zeros(n, dtype=torch.int32,
                                                        device=dev),
                                 corner[:, 1].int(), corner[:, 0].int(), P)
    args = (wins, tmpl.contiguous(), gx.contiguous(), gy.contiguous(),
            torch.stack([gxx, gxy, gyy, det_safe], 1),
            torch.stack([solvable, frozen0], 1).float(), guesses.contiguous(),
            corner.float().contiguous())
    return args, dict(S=S, P=P, max_iters=30, eps=0.01, W=W, H=H)


@pytest.mark.parametrize("win", [7, 11, 16, 17, 21, 31])
def test_lk_iterate_kernel_edge_cases_bit_equal(dev, win):
    """Kernel C against its plain version, bit for bit (NaN slots
    included), at patch sizes 7 to 31 (two lanes a row up to 16, one
    above): points that leave their window, unsolvable points, frozen and
    NaN slots; one call is one launch."""
    args, kw = _window_inputs(dev, win)
    before = lk_iterate.launch_count
    k = lk_iterate.lk_iterate(*args, **kw)
    assert lk_iterate.launch_count == before + 1
    p = lk_iterate.lk_iterate_plain(*args, **kw)
    torch.testing.assert_close(k, p, rtol=0, atol=0, equal_nan=True)
    live = ~args[5][:, 1].bool()
    assert int((k[live, 3] > 0.5).sum()) >= 4           # left the window
    assert bool((k[8:10, 2] > 0.5).all() and (k[8:10, 4] == 1).all())
    assert int(((k[live, 3] < 0.5) & (k[live, 2] > 0.5)).sum()) >= 100
    assert bool(torch.isnan(k[-2:, :2]).all() and (k[-4:, 4] == 0).all())
    with pytest.raises(ValueError):      # a window the kernel does not take
        lk_iterate.lk_iterate(args[0][:, :-1, :-1].contiguous(), *args[1:],
                              **dict(kw, P=kw["P"] - 1))


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
    with pytest.raises(ValueError):      # a window above kernel A's 31
        lk_lanes.lk_pyramid(prev, prev, pts, pts, masks, win_size=33)
    # more points than the kernel stages (1024) run and agree with the
    # plain version: once refused, now taken
    args = _pose_streams(dev, 1, 3, 1500)
    kw6 = dict(chi2_th=5.991, rounds=3, iters=6)
    k, p = pk.pose_lm(*args, **kw6), pk.pose_lm_plain(*args, **kw6)
    torch.testing.assert_close(k.T_all, p.T_all, rtol=0, atol=1e-4)
    assert torch.equal(k.inl_all, p.inl_all)
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


def test_classic_pipeline_cuda_matches_cpu(dev):
    """The classic pipeline (`VisualOdometry`, BA after every keyframe)
    over the circuit's first 10 frames on the card and on the CPU: the
    same keyframe frame ids, poses within 1e-2 (rounding differences of
    the kernels against their plain versions compound over the frames)."""
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.backend import Backend
    from stereovision_slam_torch.slam.config import SlamConfig
    from stereovision_slam_torch.slam.pipeline import VisualOdometry

    lefts, rights, _, _, rig = scenes.circuit(120, 188, 620, device=dev)
    trajectories = []
    for device in (dev, "cpu"):
        vo = VisualOdometry(SlamConfig(num_features=250,
                                       num_features_needed_for_keyframe=160),
                            ArraySequenceDataset(lefts[:10], rights[:10],
                                                 list(rig)),
                            backend=Backend(), device=device)
        vo.initialize()
        vo.run()
        trajectories.append(vo.trajectory())
    card, cpu = trajectories
    assert sorted(card) == sorted(cpu) and len(card) >= 3
    for f in card:
        np.testing.assert_allclose(card[f], cpu[f], rtol=0, atol=1e-2)


def _circuit_run(cls, dev, n: int, **kw):
    """`cls` over the circuit's first n frames on `dev` with the bench's
    settings; the launch counters of kernels A and B read around the run."""
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.config import SlamConfig

    lefts, rights, _, _, rig = scenes.circuit(120, 188, 620, device=dev)
    cfg = SlamConfig(num_features=250, num_features_needed_for_keyframe=160,
                     lk_max_iters=12, pose_rounds=3, pose_iters_per_round=6,
                     ba_lm_iters=6)
    vo = cls(cfg, ArraySequenceDataset(lefts[:n], rights[:n], list(rig)),
             max_total_keyframes=512, max_total_landmarks=1 << 16,
             device=dev, **kw)
    vo.initialize()
    before = (lk_lanes.launch_count, pk.launch_count)
    vo.run()
    return vo, (lk_lanes.launch_count - before[0], pk.launch_count - before[1])


def test_chunked_capture_matches_eager(dev):
    """`ScanVisualOdometry` (chunk 5: two padded rows) over the circuit's
    first 12 frames on the card against the eager `FusedVisualOdometry`:
    the track and keyframe graphs replayed, kernels A and B launched from
    them (the counters: one launch per LK call and per pose solve, plus
    the warm-ups'), the same keyframes and inlier counts, every float state
    tensor within 1e-5 relative to max(1, |value|), the rest equal."""
    from stereovision_slam_torch.slam import fused, graphs

    eager, (a_e, b_e) = _circuit_run(fused.FusedVisualOdometry, dev, 12)
    scan, (a_s, b_s) = _circuit_run(fused.ScanVisualOdometry, dev, 12,
                                    chunk_size=5)
    r = scan.runner
    assert r.replays >= 11 and {"track", ("keyframe", True)} <= set(r.graphs)
    warm = r.warm_launches
    assert a_s == a_e + warm[lk_lanes.__name__] and a_e > 0
    assert b_s == b_e + warm[pk.__name__] and b_e == 11
    fe, fs = eager.outputs, scan.outputs
    assert [int(o.n_inliers) for _, o in fe] == \
        [int(o.n_inliers) for _, o in fs]
    assert [bool(o.kf_inserted) for _, o in fe] == \
        [bool(o.kf_inserted) for _, o in fs]
    for name in ("fs", "ms", "arc"):
        for x, y in zip(graphs.leaves(getattr(eager, name)),
                        graphs.leaves(getattr(scan, name))):
            if x.dtype.is_floating_point:
                gap = ((x - y).abs() / y.abs().clamp(min=1.0)).max()
                assert float(gap) <= 1e-5, name
            else:
                assert torch.equal(x, y), name


def test_graph_runner_raises_on_a_host_read(dev):
    """A host read inside the captured function makes the capture fail:
    the runner raises, keeps no graph and makes none of the function's
    writes, and the process goes on using the card. In a child process,
    so that a failed capture cannot touch the other tests."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import torch
        from stereovision_slam_torch.slam.graphs import GraphRunner
        runner = GraphRunner("cuda")
        x = torch.arange(4.0, device="cuda")
        out = torch.zeros((), device="cuda")

        def fn():
            y = x * 2 if bool(x.sum() > 0) else x
            return [(out, y.sum())]
        try:
            runner.run("read", fn)
        except RuntimeError as e:
            print("raised a RuntimeError:", type(e).__name__)
        print("graphs", len(runner.graphs), "out", float(out))
        print("after", float((x + 1).sum()))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "raised a RuntimeError" in res.stdout, res.stdout + res.stderr
    assert "graphs 0 out 0.0" in res.stdout
    assert "after 10.0" in res.stdout


def test_graph_runner_counts_launches_per_replay(dev):
    """Kernel A inside a captured function: the warm-up launches it once,
    the capture launches nothing, and every replay adds one launch to its
    counter; the replayed result equals an eager call's, and follows new
    inputs copied into the static buffers."""
    from stereovision_slam_torch.slam.graphs import GraphRunner

    lefts, _, _, _, _ = scenes.circuit(120, 188, 620, device=dev)
    pyr = [imops.build_pyramid(torch.as_tensor(lefts[i], device=dev), 3)
           for i in (0, 1)]
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand((1, 64, 2), generator=g) * torch.tensor([560., 140.])
           + torch.tensor([30., 20.])).to(dev)
    prev = [lv[None].clone() for lv in pyr[0]]
    cur = [lv[None].clone() for lv in pyr[1]]
    mask = torch.ones((1, 64), dtype=torch.bool, device=dev)
    uv = torch.zeros_like(pts)
    runner = GraphRunner(dev)

    def fn():
        out, _, _ = lk_lanes.lk_pyramid(prev, cur, pts, pts, mask)
        return [(uv, out)]
    before = lk_lanes.launch_count
    for i in range(3):
        runner.run("lk", fn)
        assert lk_lanes.launch_count == before + 2 + i   # warm-up + replays
    assert runner.replays == 3 and runner.warm_launches[lk_lanes.__name__] == 1
    want, _, _ = lk_lanes.lk_pyramid(prev, cur, pts, pts, mask)
    assert torch.equal(uv, want)
    pts.add_(1.0)
    runner.run("lk", fn)
    want, _, _ = lk_lanes.lk_pyramid(prev, cur, pts, pts, mask)
    assert torch.equal(uv, want)


# ---------------------------------------------------------------------
# The dense tool, FAST and MobileNet-V2: plain PyTorch on the card, held
# to the same calls on the CPU.

def _circuit_pair(n: int = 1):
    lefts, rights, _, _, _ = scenes.circuit(max(n, 2), 188, 620)
    return lefts[:n], rights[:n]


def test_stereo_bm_cuda_matches_cpu(dev):
    """The cost volume, disparity and validity: elementwise steps and
    min/argmin, the same bits on the card; a stack of 4 as the images one
    by one."""
    from stereovision_slam_torch.ops import stereo_bm
    lefts, rights = _circuit_pair(3)
    L, R = torch.from_numpy(lefts), torch.from_numpy(rights)
    assert torch.equal(stereo_bm.cost_volume(L[0], R[0], 128, 15),
                       stereo_bm.cost_volume(L[0].to(dev), R[0].to(dev),
                                             128, 15).cpu())
    d, v = stereo_bm.compute_disparity(L.to(dev), R.to(dev))
    for b in range(3):
        dc, vc = stereo_bm.compute_disparity(L[b], R[b])
        assert torch.equal(d[b].cpu(), dc) and torch.equal(v[b].cpu(), vc)
    assert int(v.sum()) > 10000


def test_sor_cuda_matches_cpu(dev, monkeypatch):
    """Mean k-NN distances and the keep-mask: elementwise sums, topk and a
    pairwise tree, the same bits on the card, for any tiles per launch."""
    from stereovision_slam_torch.ops import sor
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-10, 10, 20000), rng.uniform(-2, 2, 20000),
                    rng.uniform(5, 40, 20000)], axis=1).astype(np.float32)
    cpu, _ = sor.mean_knn_distances(pts, max_ref=8192, device="cpu")
    for tiles in (1, 4, None):
        if tiles:
            monkeypatch.setattr(sor, "LAUNCH_ELEMS", tiles * 1024 * 8192)
        else:
            monkeypatch.undo()
        card, _ = sor.mean_knn_distances(pts, max_ref=8192, device=dev)
        np.testing.assert_array_equal(card, cpu)
    np.testing.assert_array_equal(
        sor.statistical_outlier_removal(pts, max_ref=8192, device=dev),
        sor.statistical_outlier_removal(pts, max_ref=8192, device="cpu"))


def test_fast_cuda_matches_cpu(dev):
    from stereovision_slam_torch.ops import fast
    img = torch.from_numpy(_circuit_pair()[0][0])
    r = fast.fast_response(img.to(dev)).cpu()
    np.testing.assert_allclose(r.numpy(), fast.fast_response(img).numpy(),
                               rtol=1e-5, atol=0)
    p, v, s = fast.detect(img.to(dev), 250, min_distance=20)
    pc, vc, sc = fast.detect(img, 250, min_distance=20)
    assert torch.equal(p.cpu(), pc) and torch.equal(v.cpu(), vc)
    np.testing.assert_allclose(s.cpu().numpy(), sc.numpy(), rtol=1e-5)


def test_mobilenet_convolutions_cuda_match_cpu(dev):
    """MobileNet-V2's depthwise (groups = C) and pointwise convolutions on
    bf16-rounded operands, cuDNN against the CPU: float32 sums of exact
    products (TF32 changes nothing on bf16 operands), other orders."""
    from stereovision_slam_torch.models import mobilenet_v2 as mnv2
    p = mnv2.init_params(seed=0, device="cpu")
    x = torch.rand(1, 96, 56, 56) * 6.0
    for w, stride, groups in ((p["blocks"][1]["depthwise"]["w"], 2, 96),
                              (p["blocks"][1]["project"]["w"], 1, 1),
                              (p["blocks"][2]["expand"]["w"], 1, 1)):
        xi = x[:, :w.shape[1] * groups]
        a = mnv2._conv(xi, w, stride, groups)
        b = mnv2._conv(xi.to(dev), w.to(dev), stride, groups).cpu()
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-4)
    img = torch.from_numpy(_circuit_pair()[0][0])
    e = mnv2.embed_image(p, img)
    ec = mnv2.embed_image(mnv2.init_params(seed=0, device=dev),
                          img.to(dev)).cpu()
    cos = float(e @ ec)
    assert cos > 0.999 and float((e - ec).abs().max()) < 5e-3
