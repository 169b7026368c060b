"""The BA kernel (`ops/ba_kernel.py`, `csrc/ba_window.cu`) on the card:
windows to hold it to the plain route, and a timing tool.

    python -m tests.torch_ba_cases [--cases cell,coupled]

Two windows of the benchmark cell's shapes (K = 16 slots, F = 256
features, L = 4096 landmarks, 10 active keyframes): `window` is the state
that the last BA pass of the circuit's first frames through
`FusedVisualOdometry` at the benchmark's settings started from (there
each landmark is seen from one keyframe, so each free keyframe with its
landmarks is held in place by the damping alone), `coupled` projects
landmarks into keyframes, so that most are seen from several and the
Schur complement couples the keyframes, and perturbs it with seeded
noise, the gauge keyframe kept. `CASES` derive the windows the tests
hold the kernel to the plain route on (`hold`, `held`). The tool prints,
per case, the kernel's gaps, its device time alone (warm and
L2-flushed), the plain route's time and the number of operators it
dispatches, and the bound.
It needs the card; `tests/test_torch_cuda.py` and `chip_smoke.py` use the
helpers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

NOISE, SEED = (0.01, 0.1), 5     # tangent, landmark metres
# Tolerances of the kernel against the plain route on one window. The sums
# run in another order (float64 blocks rounded once, float32 Schur sums
# over other partitions, block Gauss-Jordan against LU, the costs summed
# by blocks). Near the optimum an LM step changes the robust cost by about
# its float32 rounding (1e-6 of it), so there the kernel and the plain
# route may take another accept decision, which moves every later step.
# So the plain route, and the same pass in float64, follow the kernel's
# decisions (`decisions`), and each of their own that differs must be a
# tie: a relative cost change within ACC_TIE. Then the statistics, the
# unlinked observations and the counts are equal; the landmarks the pass
# does not solve (inactive, or left out by the compaction) are copied
# unchanged; each keyframe's pose is held within POSE_TOL of the plain
# route's, and each solved landmark within LM_TOL m of it; or, where the
# plain route's own float32 rounding moved it from the float64 pass, the
# kernel's within DRIFT times that gap (and at least the tolerance) of the
# float64 pass. Landmarks the window barely constrains (far, or seen from
# one keyframe) amplify the rounding of their solves: there the plain
# route itself sits up to 4e-2 m from its float64 pass.
POSE_TOL, LM_TOL, DRIFT, ACC_TIE = 1e-4, 1e-3, 2.0, 1e-5


def window(dev, frames: int = 60):
    """(map, cam_left, cam_right) that the last BA pass of the circuit's
    first `frames` frames at the benchmark's settings started from."""
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam import fused
    from stereovision_slam_torch.slam.config import SlamConfig

    cfg = SlamConfig()
    cfg.num_features = 250
    cfg.num_features_needed_for_keyframe = 160
    cfg.lk_max_iters = 12
    cfg.pose_rounds = 3
    cfg.pose_iters_per_round = 6
    cfg.ba_lm_iters = 6
    lefts, rights, _, _, rig = scenes.circuit(frames, 188, 620, device=dev)
    vo = fused.FusedVisualOdometry(
        cfg, ArraySequenceDataset(lefts, rights, list(rig)),
        max_total_keyframes=128, max_total_landmarks=1 << 14, device=dev)
    seen = []
    run = fused.optimize_window

    def last(m, *args, **kw):
        seen[:] = [m]
        return run(m, *args, **kw)
    fused.optimize_window = last
    try:
        vo.initialize()
        vo.run()
    finally:
        fused.optimize_window = run
    return seen[0], vo.cam_left, vo.cam_right


def _perturb(m, seed: int = SEED):
    """Seeded noise on the poses (but the gauge's) and the landmarks."""
    from stereovision_slam_torch.geometry import se3

    K, L = m.kf_pose.shape[0], m.lm_pos.shape[0]
    dev = m.kf_pose.device
    rng = np.random.default_rng(seed)
    oldest = torch.min(torch.where(m.kf_valid, m.kf_id,
                                   torch.full_like(m.kf_id, 2 ** 31 - 1)))
    free = (m.kf_valid & (m.kf_id != oldest))[:, None, None]
    dxi = torch.tensor(rng.normal(0, NOISE[0], (K, 6)), dtype=torch.float32,
                       device=dev)
    dl = torch.tensor(rng.normal(0, NOISE[1], (L, 3)), dtype=torch.float32,
                      device=dev)
    return m._replace(
        kf_pose=torch.where(free, se3.se3_compose(se3.se3_exp(dxi),
                                                  m.kf_pose), m.kf_pose),
        lm_pos=torch.where(m.lm_valid[:, None], m.lm_pos + dl, m.lm_pos))


def coupled(dev, n_kf: int = 10, n_lm: int = 1500, seed: int = SEED):
    """(map, cam_left, cam_right): n_kf keyframes 0.5 m apart with a little
    yaw, in scattered slots; n_lm landmarks ahead of them in scattered
    slots, each keyframe observing up to 250 that both its cameras see,
    with 0.5 px of noise; perturbed. The ~1,100 landmarks seen overflow a
    1024 compaction by about what the cell's passes do."""
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.geometry import jacobians
    from stereovision_slam_torch.slam import map_state as mapmod

    K, F, L = 16, 256, 4096
    rng = np.random.default_rng(seed)
    cl, cr = scenes.make_stereo_rig(device=dev)
    poses = scenes.forward_motion_poses(n_kf, step=0.5, yaw_rate=0.02)
    pts = np.stack([rng.uniform(-12, 12, n_lm), rng.uniform(-4, 4, n_lm),
                    rng.uniform(8, 45, n_lm)], axis=1).astype(np.float32)
    kf_slot = rng.permutation(K)[:n_kf]
    lm_slot = rng.permutation(L)[:n_lm]
    m = mapmod.empty_map(K, F, L)
    obs_lm = np.full((K, F), -1, np.int32)
    uv_l = np.zeros((K, F, 2), np.float32)
    uv_r = np.zeros((K, F, 2), np.float32)
    has_r = np.zeros((K, F), bool)
    count = np.zeros(L, np.int32)
    P = torch.from_numpy(pts)
    for i, k in enumerate(kf_slot):
        T = poses[i].expand(n_lm, 3, 4)
        ul, pl = jacobians.project_points(cl.to("cpu"), T, P)
        ur, _ = jacobians.project_points(cr.to("cpu"), T, P)
        ul, ur, z = ul.numpy(), ur.numpy(), pl[:, 2].numpy()

        def inside(u):
            return ((u[:, 0] >= 0) & (u[:, 0] < 620) & (u[:, 1] >= 0)
                    & (u[:, 1] < 188))
        seen = np.nonzero((z > 0.5) & inside(ul) & inside(ur))[0]
        seen = rng.permutation(seen)[:250]
        n = len(seen)
        obs_lm[k, :n] = lm_slot[seen]
        uv_l[k, :n] = ul[seen] + rng.normal(0, 0.5, (n, 2))
        uv_r[k, :n] = ur[seen] + rng.normal(0, 0.5, (n, 2))
        has_r[k, :n] = True
        np.add.at(count, lm_slot[seen], 1 + has_r[k, :n])
    kf_valid = np.zeros(K, bool)
    kf_valid[kf_slot] = True
    kf_id = np.full(K, -1, np.int32)
    kf_id[kf_slot] = 100 + np.arange(n_kf)
    kf_pose = m.kf_pose.clone()
    kf_pose[torch.from_numpy(kf_slot)] = poses
    lm_pos = m.lm_pos.clone()
    lm_pos[torch.from_numpy(lm_slot)] = P
    m = m._replace(
        kf_pose=kf_pose, kf_id=torch.from_numpy(kf_id),
        kf_valid=torch.from_numpy(kf_valid), lm_pos=lm_pos,
        lm_valid=torch.from_numpy(count > 0), lm_obs_count=torch.from_numpy(
            count), obs_uv_l=torch.from_numpy(uv_l),
        obs_uv_r=torch.from_numpy(uv_r), obs_lm=torch.from_numpy(obs_lm),
        obs_has_r=torch.from_numpy(has_r),
        obs_valid=torch.from_numpy(obs_lm >= 0))
    m = mapmod.MapState(*(t.to(dev) for t in m))
    return _perturb(m), cl, cr


def _keep_newest(m, n: int):
    """The window with only its n newest keyframes valid."""
    ids = torch.where(m.kf_valid, m.kf_id, torch.full_like(m.kf_id, -1))
    keep = torch.zeros_like(m.kf_valid)
    keep[torch.argsort(ids, descending=True)[:n]] = True
    return m._replace(kf_valid=m.kf_valid & keep), {}


def _duplicate_link(m):
    """A second valid feature of the fullest keyframe takes the landmark of
    the feature with the lowest landmark slot (two features of one
    keyframe on one landmark, as LocalFusion's relinking may leave it; the
    lowest slot, so that any compaction solves it). Watches that
    landmark."""
    linked = m.obs_valid & (m.obs_lm >= 0) & m.kf_valid[:, None]
    k = int(torch.argmax(linked.sum(dim=1)))
    feats = torch.nonzero(linked[k]).reshape(-1)
    f0 = int(feats[torch.argmin(m.obs_lm[k, feats])])
    f1 = int(feats[0] if int(feats[0]) != f0 else feats[1])
    obs_lm = m.obs_lm.clone()
    obs_lm[k, f1] = obs_lm[k, f0]
    return m._replace(obs_lm=obs_lm), {"duplicate": int(obs_lm[k, f0])}


def _singular(m):
    """An active landmark with no observation left (H_ll = 0, its damped
    determinant at the inverse's threshold) and one seen by a single left
    observation (H_ll of rank 2), the two lowest slots seen twice or more.
    Watches both."""
    linked = m.obs_valid & (m.obs_lm >= 0) & m.kf_valid[:, None]
    lms = m.obs_lm[linked]
    counts = torch.bincount(lms.long(), minlength=m.lm_pos.shape[0])
    seen = torch.nonzero(counts >= 2).reshape(-1)
    a, b = int(seen[0]), int(seen[1])
    obs_lm = torch.where(m.obs_lm == a, torch.full_like(m.obs_lm, -1),
                         m.obs_lm)
    hits = torch.nonzero(obs_lm == b)
    keep = hits[0]
    drop = (obs_lm == b)
    drop[keep[0], keep[1]] = False
    obs_lm = torch.where(drop, torch.full_like(obs_lm, -1), obs_lm)
    has_r = m.obs_has_r.clone()
    has_r[keep[0], keep[1]] = False
    return (m._replace(obs_lm=obs_lm, obs_has_r=has_r),
            {"no_observation": a, "rank_2": b})


def _behind(m):
    """Every landmark mirrored behind the cameras (z -> -z; the coupled
    window's cameras look down +z from z < 5): no observation in front,
    every weight 0, every observation an outlier."""
    flip = torch.tensor([1.0, 1.0, -1.0], device=m.lm_pos.device)
    return m._replace(lm_pos=m.lm_pos * flip), {}


# name -> (window, transform, optimize_window keywords); a transform
# returns the case's map and {name: landmark slot} of the landmarks `hold`
# reports and asserts on by name. "cell" is the benchmark cell's call (K
# 16, F 256, L 4096 compacted to 1024, 6 steps)
CASES = {
    "cell": ("circuit", None, dict(iters=6, max_active_landmarks=1024)),
    "perturbed": ("circuit", lambda m: (_perturb(m), {}),
                  dict(iters=6, max_active_landmarks=1024)),
    "coupled": ("coupled", None, dict(iters=6, max_active_landmarks=1024)),
    "overflow": ("circuit", None, dict(iters=6, max_active_landmarks=256)),
    "no_compaction": ("coupled", None,
                      dict(iters=10, max_active_landmarks=None)),
    "la2048": ("coupled", None, dict(iters=10, max_active_landmarks=2048)),
    "two_keyframes": ("coupled", lambda m: _keep_newest(m, 2),
                      dict(iters=6, max_active_landmarks=1024)),
    "one_keyframe": ("coupled", lambda m: _keep_newest(m, 1),
                     dict(iters=6, max_active_landmarks=1024)),
    "duplicate_link": ("coupled", _duplicate_link,
                       dict(iters=6, max_active_landmarks=1024)),
    "singular_hll": ("coupled", _singular,
                     dict(iters=6, max_active_landmarks=1024)),
    "all_outliers": ("coupled", _behind,
                     dict(iters=6, max_active_landmarks=2048)),
}


def bases(dev) -> dict:
    """{window name: (map, cam_left, cam_right)} of the cases' windows."""
    return {"circuit": window(dev), "coupled": coupled(dev)}


def case(windows: dict, name: str):
    """(map, cam_left, cam_right, keywords, watched landmarks) of case
    `name`."""
    base, fn, kw = CASES[name]
    m, cl, cr = windows[base]
    m, watch = (m, {}) if fn is None else fn(m)
    return m, cl, cr, dict(chi2_th=5.991, outlier_rounds=5, **kw), watch


def _f64(x):
    """A copy of a map or camera with its float tensors in float64."""
    return type(x)(*(t.double() if t.is_floating_point() else t for t in x))


def solved_landmarks(m, kw) -> torch.Tensor:
    """(L,) bool: the landmarks the pass solves, the active ones (valid,
    observed) in slot order up to `max_active_landmarks`."""
    on = m.lm_valid & (m.lm_obs_count > 0)
    La = kw.get("max_active_landmarks")
    if La is None:
        return on
    keep = torch.zeros_like(on)
    keep[torch.nonzero(on).reshape(-1)[:La]] = True
    return keep


def decisions(m, cl, cr, kw) -> list:
    """The kernel's accept decisions, one a step: the pass run to each
    number of steps in turn; a step was accepted where it moved the poses
    or the landmarks (a rejected step leaves both as they were; an
    accepted one lowered the cost, so moved them)."""
    from stereovision_slam_torch.slam import backend

    outs = [backend.optimize_window(m, cl, cr, **dict(kw, iters=i))[0]
            for i in range(kw["iters"] + 1)]
    return [not (torch.equal(a.kf_pose, b.kf_pose)
                 and torch.equal(a.lm_pos, b.lm_pos))
            for a, b in zip(outs, outs[1:])]


def hold(m, cl, cr, kw, watch: dict | None = None) -> dict:
    """One pass of the kernel (one launch), and of the plain route and the
    plain route in float64 taking the kernel's accept decisions, on the
    card. Asserts that every decision of the plain route's own that
    differs is a tie (ACC_TIE), that the statistics, the unlinked
    observations and the counts of the kernel and the plain route are
    equal, that the landmarks the pass does not solve are copied
    unchanged, and that each watched landmark ({name: slot}) is solved and
    held (`_within`). Returns the statistics; the kernel's decisions
    (`accepts`), how many of the plain route's own differ (`flips`) and
    the largest relative cost change among them (`tie`); per keyframe and
    per solved landmark, the largest gap of the kernel to the plain route
    (`pose`, `lm`, in m for landmarks), of the kernel to the float64 pass
    (`pose_f64`, `lm_f64`) and of the plain route to it (`pose_plain_f64`,
    `lm_plain_f64`); how many poses and solved landmarks are not held
    (`pose_over`, `lm_over`, of `solved`); the worst three landmarks
    (slot, gap to plain, to float64, plain's to float64); and the watched
    landmarks' gaps."""
    from stereovision_slam_torch.ops import ba_kernel
    from stereovision_slam_torch.slam import backend

    acc = decisions(m, cl, cr, kw)
    before = ba_kernel.launch_count
    k, ks = backend.optimize_window(m, cl, cr, **kw)
    assert ba_kernel.launch_count == before + 1
    own = []
    p, ps = backend.optimize_window_plain(m, cl, cr, **kw, follow=acc,
                                          trace=own)
    e, _ = backend.optimize_window_plain(_f64(m), _f64(cl), _f64(cr), **kw,
                                         follow=acc)
    flips = [abs(g) for (d, g), a in zip(own, acc) if d != a]
    tie = max(flips, default=0.0)
    assert tie <= ACC_TIE, (acc, own)
    stats = [float(x) for x in ks]
    assert stats == [float(x) for x in ps], (stats, [float(x) for x in ps])
    for f in ("obs_lm", "obs_has_r", "lm_obs_count"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    for f in k._fields:
        if f not in ("kf_pose", "lm_pos", "obs_lm", "obs_has_r",
                     "lm_obs_count"):
            assert getattr(k, f) is getattr(m, f), f
    solved = solved_landmarks(m, kw)
    assert torch.equal(k.lm_pos[~solved], m.lm_pos[~solved])

    def pose_gap(a, b):
        return (a.kf_pose.double() - b.kf_pose.double()).abs().amax((1, 2))

    def lm_gap(a, b):
        return torch.linalg.vector_norm(
            a.lm_pos.double() - b.lm_pos.double(), dim=1)
    pk, pe, ppe = pose_gap(k, p), pose_gap(k, e), pose_gap(p, e)
    lk, le, lpe = lm_gap(k, p), lm_gap(k, e), lm_gap(p, e)
    pose_ok = _within(pk, pe, ppe, POSE_TOL)
    lm_ok = _within(lk, le, lpe, LM_TOL)
    idx = torch.nonzero(solved).reshape(-1)
    excess = le[idx] / torch.clamp(DRIFT * lpe[idx], min=LM_TOL)
    worst = idx[torch.argsort(excess, descending=True)[:3]].tolist()
    watched = {}
    for name, slot in (watch or {}).items():
        watched[name] = (slot, float(lk[slot]), float(le[slot]),
                         float(lpe[slot]))
        assert bool(solved[slot]), f"{name}: landmark {slot} not solved"
        assert bool(lm_ok[slot]), f"{name}: {watched[name]}"

    def top(x, mask):
        return float(x[mask].max()) if bool(mask.any()) else 0.0
    every = torch.ones_like(m.kf_valid)
    return dict(stats=stats,
                accepts="".join("A" if x else "r" for x in acc),
                flips=len(flips), tie=tie,
                pose=top(pk, every), pose_f64=top(pe, every),
                pose_plain_f64=top(ppe, every),
                pose_over=int((~pose_ok).sum()), lm=top(lk, solved),
                lm_f64=top(le, solved), lm_plain_f64=top(lpe, solved),
                lm_over=int((~lm_ok & solved).sum()),
                solved=int(solved.sum()),
                worst=[(i, float(lk[i]), float(le[i]), float(lpe[i]))
                       for i in worst],
                watched=watched)


def _within(to_plain, to_f64, plain_to_f64, tol):
    """Each entry within `tol` of the plain route, or within DRIFT times
    the plain route's own gap to the float64 pass (and at least `tol`) of
    that pass."""
    return (to_plain <= tol) | (to_f64 <= torch.clamp(DRIFT * plain_to_f64,
                                                      min=tol))


def held(h: dict) -> bool:
    """Every pose and every solved landmark of `hold` within the
    tolerances (POSE_TOL, LM_TOL, DRIFT)."""
    return h["pose_over"] == 0 and h["lm_over"] == 0


def bound_ms(m, kw) -> tuple[float, str]:
    """The least time of one pass on an H100 (3.35 TB/s, 67 TFLOP/s fp32)
    and what bounds it: each input byte read once and each output byte
    written once, against the float operations the pass needs at this
    window, counted from its work: per residual evaluation (iters + 1) of a
    live observation ~280 (residual, both Jacobians, weight and cost), per
    LM step and live observation ~180 (its weighted blocks), per solved
    landmark ~60 and per (landmark, keyframe) group ~130 (inverse, G
    H_ll^-1, back-substitution), ~180 per landmark and pair of the free
    keyframes it is seen in (i <= j), and LU's 2/3 n^3 + 2 n^2 on the n = 6
    x free keyframes unknowns."""
    K, F = m.obs_lm.shape
    L = m.lm_pos.shape[0]
    base = m.obs_valid & (m.obs_lm >= 0) & m.kf_valid[:, None]
    live = torch.cat([base, base & m.obs_has_r]).reshape(-1)
    lm = torch.cat([m.obs_lm, m.obs_lm]).reshape(-1)[live].long()
    kf = torch.arange(K, device=lm.device).repeat_interleave(F).repeat(2)
    kf = kf[live]
    oldest = m.kf_id[m.kf_valid].min()
    free = m.kf_valid & (m.kf_id != oldest)
    La = kw.get("max_active_landmarks") or L
    active = m.lm_valid & (m.lm_obs_count > 0)
    groups = torch.unique(lm * K + kf)
    g_lm, g_free = groups // K, free[groups % K]
    per_lm = torch.bincount(g_lm[g_free], minlength=L).double()
    n_obs, n_groups = float(live.sum()), float(groups.numel())
    n_lm = float(min(int(active.sum()), La))
    pairs = float((per_lm * (per_lm + 1) / 2).sum())
    n = 6.0 * float(free.sum())
    it = kw["iters"]
    flops = (280 * (it + 1) * n_obs + it * (180 * n_obs + 60 * n_lm
             + 130 * n_groups + 180 * pairs + 2 / 3 * n ** 3 + 2 * n ** 2))
    nbytes = sum(t.numel() * t.element_size() for t in m)
    nbytes += sum(t.numel() * t.element_size() for t in (
        m.kf_pose, m.lm_pos, m.obs_lm, m.obs_has_r, m.lm_obs_count))
    t_b, t_f = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    return (t_b, "bytes") if t_b > t_f else (t_f, "operations")


def dispatched_ops(fn) -> int:
    """Non-view ATen operators that fn() dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def main() -> None:
    import chip_smoke as cs
    from stereovision_slam_torch.slam import backend

    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="cell,coupled,no_compaction")
    args = ap.parse_args()
    dev = "cuda"
    print(cs.smi_line())
    windows = bases(dev)
    for name in args.cases.split(","):
        m, cl, cr, kw, watch = case(windows, name)
        print(f"{name}: {hold(m, cl, cr, kw, watch)}")
        plain = cs.cuda_ms(lambda: backend.optimize_window_plain(
            m, cl, cr, **kw), 5)
        n_ops = dispatched_ops(lambda: backend.optimize_window_plain(
            m, cl, cr, **kw))
        b, by = bound_ms(m, kw)
        print(f"{name}: plain route {plain:.4f} ms a pass, {n_ops} "
              f"operators dispatched; bound {b:.6f} ms ({by})")
        t = cs.kernel_times(lambda: backend.optimize_window(m, cl, cr, **kw),
                            20)
        print(f"{name}: {cs.times_line(t)}")


if __name__ == "__main__":
    main()
