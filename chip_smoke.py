#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Usage: python3 chip_smoke.py [--profile N]

Phases, in order; any failure exits non-zero:
  1. environment: the card's name and power limit, and the build of every
     CUDA kernel of `stereovision_slam_torch/csrc/` (one nvcc per source, in
     parallel);
  2. kernel A (LK level) against its plain PyTorch version at the main
     path's shapes (n = 256 and 512, all 4 levels) on pyramids of the
     rendered scene, with kernel, plain and bound times;
  3. kernel B (multi-start LM pose solve) the same, at S = 3, F = 256, and
     over a stream axis at (B, S) = (4, 3);
  4. the slice: the 120-frame 188x620 circuit through `FusedVisualOdometry`
     on "cuda" with the bench settings, the bench's gates, keyframe ATE < 2%
     of the path, and the launch counters against the frame and keyframe
     counts;
  5. the first frames again on "cpu" (the kernels' plain versions), held to
     the card's run;
  6. kernel C (windowed LK loop) and the window gather against their plain
     versions at the serving shapes (N = 1024 and 2048 on levels 0 and 1),
     with kernel, plain, bound and library times;
  7. multi-stream serving: 4 streams of 90 frames of the circuit through
     `BatchedFusedVisualOdometry(kf_stagger=4)` on "cuda", with launch
     counters and the aggregate fps; twice: with the bench's settings,
     whose BA landmark compaction (1024) overflows here (its per-stream ATE
     and the overflow are printed, the ATE not gated), then with the
     compaction sized to the serving window (`serving_config`, 2048), the
     gated cell: the reference's per-stream gates;
  8. kernel C on the path: from the gated serving run's state at steps 20,
     40 and 60, 20 serving frames each with the per-level LK
     (`pallas_mode="pallas"`); every launch of kernel C and of the gather
     held to its plain version on its inputs, the poses to ground truth
     and to the same frames on the lanes LK;
  9. the first serving frames again on "cpu", held to the card's run;
 10. kernel D (ring all-reduce) against its plain version, bit for bit, at
     the reference test's three meshes and at the sharded BA's payload
     (8 ranks x 2.5 MB), with kernel, plain, bound and torch.sum times;
 11. the distributed BA (`build_sharded_ba`, mesh (dp 4, mp 2), 6 LM
     iterations, compaction 2048) on the slice's final window, the dp
     reduction by a sum and by kernel D (6 launches, each held to its plain
     version), against each other, against the single-card BA and against
     the same call on "cpu", with the wall time of each;
 12. a pose graph over the slice's keyframes (one loop edge from ground
     truth, one with rank-deficient information) through
     `optimize_pose_graph` and `build_sharded_pgo` (8 ranks) on the card.

The last lines are the kernel table (JSON), the nvidia-smi line, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores

# stated tolerances of the kernel-vs-plain comparisons (see PERF.md)
LK_POS_TOL = 1e-2        # px, points whose frozen/left_win/solvable agree
LK_FLAG_AGREE = 0.99     # share of points with identical flags per launch
POSE_T_TOL = 1e-3        # max |T_kernel - T_plain|, every start and the chosen
POSE_INLIER_AGREE = 0.99  # share of equal inlier flags, every start
POSE_COST_TOL = 1e-4     # relative robust-cost difference, every start
POSE_STEP_TOL = 1e-4     # max |T_kernel - T_plain| after one LM step
# the slice is chaotic: rounding differences between the CPU and the card
# (sum orders, BA's scatter atomics) flip LM acceptances and BA outlier
# decisions, and the poses drift apart at a fraction of the trajectory error;
# held to 1% of the path driven in the compared frames, half the ATE gate
CPU_POSE_TOL_PER_M = 1e-2
CPU_FRAMES = 16
# multi-stream serving: B streams of T frames, stream b starting at frame
# STRIDE * b of the circuit, the keyframe branch on one stream per frame
SERVE_B, SERVE_T, SERVE_STRIDE, SERVE_STAGGER = 4, 90, 10, 4
SERVE_ATE_PER_M = 0.05     # the reference's staggered-mode gate
PALLAS_FROMS, PALLAS_STEPS = (20, 40, 60), 20
# per-level LK (kernel C) against the lanes LK (kernel A) on the same
# frames: two LK algorithms with other search windows, so inlier sets part
# and each run drifts its own way. Camera centres 0.0061-0.2219 m apart
# over the 12 (start, stream) runs of phase 8 (H100); held at about twice
# the largest. Each kernel C launch is held to its plain version instead.
PALLAS_DRIFT_TOL = 0.5   # m
CPU_SERVE_STEPS = 8
# kernel D: bit-equal to its plain version; each rank within RING_F64_TOL
# of the float64 sum, relative to the sum of the magnitudes (a 4- or 8-term
# float32 sum is off by at most 7 ulps of it)
RING_F64_TOL = 1e-6
# the five BA blocks at K = 16, La = 2048 (615,072 floats) padded to a
# multiple of 128 x 8 x 4: 4832 rows of 128 per rank
RING_PATH_ROWS = 4832
SHARDED_LA = 2048
SHARD_NOISE, SHARD_SEED = (0.01, 0.1), 3   # tangent, landmark metres
# (poses, landmarks in m, landmarks per m of distance from the gauge
# keyframe's camera); a landmark is held to max(2nd, 3rd x distance).
# Ring vs xla (tests/test_ring_reduce.py:64-65) and sharded vs single-card
# (tests/test_sharded_ba.py:38-44): the tests' tolerances, which they
# hold on windows whose landmarks are at most 45 m deep, so per metre
# their landmark tolerance / 45 m. The slice's window holds landmarks
# 200-300 m deep seen by one keyframe only, whose position along the ray
# is barely observable: single-card BA (adjugate 3x3 inverse, incumbent
# cost from the linearization) and sharded BA (LU inverse, cost evaluated
# twice) part there by 0.127 m at 260 m after 6 iterations on the CPU
# (4.9e-4 of the distance), 2e-3 m after 1. Cpu vs card: the poses to
# 1e-4, and a landmark to 1e-4 per metre, the lever arm of a 1e-4 rotation
# (readings on the H100: poses 3.6e-6, landmarks 3.4e-4 m at 38 m, 8.8e-6
# of the distance; the tests' 1e-4 m flat failed on 105 landmarks).
# Ring vs xla cannot show a sum-order fault of kernel D on this window: each
# cross block G[l, k] gets at most two non-zero terms (the left and right
# observation of one feature), and ring chunk 0, which holds H_pp, b_p, H_ll
# and b_l, sums in rank order as `sum(0)` does, so the two agree bit for
# bit. `ring_held` holds every launch of the path to its plain version.
SHARD_RING_TOL = (1e-5, 1e-4, 1e-4 / 45)
SHARD_SINGLE_TOL = (5e-3, 5e-2, 5e-2 / 45)
SHARD_CPU_TOL = (1e-4, 1e-4, 1e-4)
PGO_SHARD_TOL = 5e-2     # tests/test_sharded_pgo.py:30-31


def check(ok: bool, msg: str) -> None:
    """A gate of the run (kept under python -O, unlike assert)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_lk(rendered, dev):
    """Kernel A against its plain version on every level launch of one
    frame-to-frame track (G=1) and one batched track (G=2)."""
    import torch
    from stereovision_slam_torch.ops import gftt, image as imops, lk_lanes

    lefts, rights = rendered
    L0, L1 = (imops.build_pyramid(torch.as_tensor(lefts[i], device=dev), 4)
              for i in (0, 1))
    R1 = imops.build_pyramid(torch.as_tensor(rights[1], device=dev), 4)
    pts, valid, _ = gftt.detect(L0[0], max_corners=256, min_distance=20)
    records = []

    def compare(prev, cur, meta, **kw):
        k = lk_lanes.lk_level(prev, cur, meta, **kw)
        p = lk_lanes.lk_level_plain(prev, cur, meta, **kw)
        torch.cuda.synchronize()
        flags_eq = (k[:, 2:5] == p[:, 2:5]).all(dim=1)
        err = (k[:, :2] - p[:, :2]).abs().amax(dim=1)
        err = err[flags_eq & torch.isfinite(err)]
        records.append(dict(args=(prev, cur, meta), kw=kw,
                            n=int(meta.shape[0]), out=p,
                            agree=float(flags_eq.float().mean()),
                            err=float(err.max()) if err.numel() else 0.0))
        return p

    uv_a, st_a = lk_lanes.track_grouped_lanes(
        [lv[None] for lv in L0], [lv[None] for lv in L1], pts[None],
        pts[None], valid[None], max_iters=12, level_fn=compare)
    guess_r = uv_a[0] - torch.tensor([12.0, 0.0], device=dev)
    lk_lanes.track_grouped_lanes(
        [torch.stack([a, b]) for a, b in zip(L0, L1)],
        [torch.stack([a, b]) for a, b in zip(L1, R1)],
        torch.stack([pts, uv_a[0]]), torch.stack([uv_a[0], guess_r]),
        torch.stack([valid, valid & st_a[0]]), max_iters=12,
        level_fn=compare)
    for r in records:
        print(f"kernel A n={r['n']} flags agree {r['agree']:.4f} "
              f"max pos err {r['err']:.3e} px")
        check(r["agree"] >= LK_FLAG_AGREE and r["err"] <= LK_POS_TOL,
              f"kernel A disagrees with its plain version: {r['agree']}, "
              f"{r['err']}")
    # times of every level launch; the table row is the largest one
    # (level 0 of the G=2 batched call)
    per_level = []
    for r in records:
        fn = lambda r=r: lk_lanes.lk_level(*r["args"], **r["kw"])
        per_level.append(cuda_ms(fn, 50))
    print("kernel A per-launch ms (G=1 levels 3..0, G=2 levels 3..0): "
          + " ".join(f"{t:.4f}" for t in per_level))
    big = records[-1]
    prev, cur, meta = big["args"]
    plain_ms = cuda_ms(lambda: lk_lanes.lk_level_plain(*big["args"],
                                                       **big["kw"]), 5)
    iters = float(big["out"][:, 5].sum())
    n = big["n"]
    win = big["kw"]["win"]
    flops = n * win * win * 95.0 + iters * win * win * 12.0
    nbytes = 4 * (prev.numel() + cur.numel() + meta.numel()
                  + n * lk_lanes.OUT_COLS)
    b, by = bound_ms(nbytes, flops)
    return dict(name="lk_level", route="cuda",
                source="stereovision_slam_torch/csrc/lk_level.cu",
                replaces="stereovision_slam_tpu/ops/lk_lanes.py:112",
                max_abs_err=max(r["err"] for r in records),
                ms=per_level[-1], plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None)


def pose_problem(dev, seed: int = 0):
    """Kernel B's main-path shape: S = 3 starts, F = 256 points."""
    import numpy as np
    import torch
    from stereovision_slam_torch.geometry import jacobians, se3
    from stereovision_slam_torch.scenes import make_stereo_rig

    F = 256
    rng = np.random.default_rng(seed)
    left, right = (c.to(dev) for c in make_stereo_rig())
    T_gt = se3.se3_exp(torch.tensor([0.3, -0.1, 0.5, 0.02, -0.03, 0.01],
                                    device=dev) + 0.05 * seed)
    pts = torch.tensor(np.stack([rng.uniform(-8, 8, F), rng.uniform(-3, 3, F),
                                 rng.uniform(6, 40, F)], 1), dtype=torch.float32,
                       device=dev)
    uv_l = jacobians.project_points(left, T_gt, pts)[0]
    uv_r = jacobians.project_points(right, T_gt, pts)[0]
    uv_l = uv_l + torch.tensor(rng.normal(0, 0.3, (F, 2)), dtype=torch.float32,
                               device=dev)
    uv_r = uv_r + torch.tensor(rng.normal(0, 0.3, (F, 2)), dtype=torch.float32,
                               device=dev)
    uv_l[:12] += 35.0
    vl = torch.tensor(rng.uniform(size=F) > 0.1, device=dev)
    vr = vl & torch.tensor(rng.uniform(size=F) > 0.1, device=dev)
    starts = [torch.tensor(d, device=dev) for d in (
        [0.1, 0.04, -0.16, 0.02, 0.01, -0.02], [0.0] * 6,
        [-0.2, 0.0, 0.2, 0.0, 0.02, 0.0])]
    T0 = torch.stack([se3.se3_compose(se3.se3_exp(d), T_gt) for d in starts])
    return left, right, T0, pts, uv_l, uv_r, vl, vr


def pose_args(dev, seed: int = 0):
    """(camp, pts, uv, valid, T0): kernel B's inputs for one stream."""
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    left, right, T0, pts, uv_l, uv_r, vl, vr = pose_problem(dev, seed)
    camp = torch.stack([pk.cam_params(left), pk.cam_params(right)]).contiguous()
    uv = torch.cat([uv_l, uv_r], 1).contiguous()
    valid = torch.stack([vl, vr], 1).float().contiguous()
    return camp, pts.contiguous(), uv, valid, T0.contiguous()


def check_pose_streams(dev) -> None:
    """Kernel B over (B, S) = (4, 3): every (stream, start) against the
    plain version after one LM step (the starts still apart) and at the
    end; prints the kernel's time per launch."""
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    per = [pose_args(dev, seed) for seed in range(SERVE_B)]
    args = (per[0][0], *(torch.stack(x).contiguous()
                         for x in list(zip(*per))[1:]))
    for kw, tol in ((dict(rounds=1, iters=1), POSE_STEP_TOL),
                    (dict(rounds=3, iters=6), POSE_T_TOL)):
        Tk, ik, ck, _ = pk.pose_lm(*args, chi2_th=5.991, **kw)
        Tp, ip, cp, _ = pk.pose_lm_plain(*args, chi2_th=5.991, **kw)
        torch.cuda.synchronize()
        t_err = float((Tk - Tp).abs().max())
        agree = float((ik == ip).float().mean(dim=(2, 3)).min())
        c_err = float(((ck - cp).abs() / cp.abs().clamp(min=1.0)).max())
        print(f"kernel B (B, S) = {tuple(Tk.shape[:2])}, {kw}: max |T| err "
              f"{t_err:.3e} over every (b, s), inlier agree >= {agree:.4f}, "
              f"cost err {c_err:.3e}")
        check(t_err <= tol and agree >= POSE_INLIER_AGREE
              and c_err <= POSE_COST_TOL,
              f"kernel B over streams disagrees with its plain version {kw}")
    ms = cuda_ms(lambda: pk.pose_lm(*args, chi2_th=5.991, rounds=3,
                                    iters=6), 50)
    print(f"kernel B (B, S) = ({SERVE_B}, 3), F = 256: {ms:.4f} ms per launch")


def check_pose(dev):
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    args = pose_args(dev)
    T0, pts = args[4], args[1]
    Tk, ik, ck, nk = pk.pose_lm(*args, **kw)
    Tp, ip, cp, npl = pk.pose_lm_plain(*args, **kw)
    torch.cuda.synchronize()
    # every start against its plain counterpart, then the chosen one: the
    # starts may converge to one cost, so the two argmins may differ
    t_err = (Tk - Tp).abs().amax(dim=(1, 2))
    agree = (ik == ip).float().mean(dim=(1, 2))
    c_err = (ck - cp).abs() / cp.abs().clamp(min=1.0)
    bk, bp = int(torch.argmin(ck)), int(torch.argmin(cp))
    chosen = float((Tk[bk] - Tp[bp]).abs().max())
    err = max(float(t_err.max()), chosen)
    for s in range(T0.shape[0]):
        print(f"kernel B start {s}: max |T| err {float(t_err[s]):.3e} "
              f"inlier agree {float(agree[s]):.4f} cost "
              f"{float(ck[s]):.4f}/{float(cp[s]):.4f} inliers "
              f"{int(nk[s])}/{int(npl[s])}")
    print(f"kernel B best start {bk}/{bp} max |T| err {chosen:.3e}")
    check(float(t_err.max()) <= POSE_T_TOL
          and float(agree.min()) >= POSE_INLIER_AGREE
          and float(c_err.max()) <= POSE_COST_TOL and chosen <= POSE_T_TOL,
          "kernel B disagrees with its plain version")
    # all starts converge to one pose, so a start that read another start's
    # input would pass the check above; after one LM step they are still
    # apart, and each must match its own plain counterpart
    one = dict(chi2_th=5.991, rounds=1, iters=1)
    T1k = pk.pose_lm(*args, **one)[0]
    T1p = pk.pose_lm_plain(*args, **one)[0]
    step_err = float((T1k - T1p).abs().max())
    apart = min(float((T1p[a] - T1p[b]).abs().max())
                for a in range(len(T1p)) for b in range(a))
    print(f"kernel B one step: max |T| err {step_err:.3e}, starts apart by "
          f"at least {apart:.3e}")
    check(step_err <= POSE_STEP_TOL and apart > 10 * POSE_STEP_TOL,
          "kernel B's starts after one step disagree with the plain version")
    ms = cuda_ms(lambda: pk.pose_lm(*args, **kw), 50)
    plain_ms = cuda_ms(lambda: pk.pose_lm_plain(*args, **kw), 3)
    S, F = T0.shape[0], pts.shape[0]
    steps = kw["rounds"] * kw["iters"]
    # per observation and step: projection + Jacobian + 27 sums (~200) and
    # the candidate's projection and robust cost (~40)
    flops = S * steps * 2 * F * 240.0
    nbytes = sum(4 * t.numel() for t in args) + 4 * (S * 12 + S * 2 * F + 2 * S)
    b, by = bound_ms(nbytes, flops)
    return dict(name="pose_lm", route="cuda",
                source="stereovision_slam_torch/csrc/pose_lm.cu",
                replaces="stereovision_slam_tpu/ops/pose_pallas.py:38",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


def bench_config():
    from stereovision_slam_torch.slam.config import SlamConfig
    cfg = SlamConfig()
    cfg.num_features = 250
    cfg.num_features_needed_for_keyframe = 160
    cfg.lk_max_iters = 12
    cfg.pose_rounds = 3
    cfg.pose_iters_per_round = 6
    cfg.ba_lm_iters = 6
    return cfg


def slice_vo(lefts, rights, rig, device):
    """An initialized `FusedVisualOdometry` over the frames."""
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused import FusedVisualOdometry

    vo = FusedVisualOdometry(bench_config(), ArraySequenceDataset(
        lefts, rights, list(rig)), max_total_keyframes=512,
        max_total_landmarks=1 << 16, device=device)
    vo.initialize()
    return vo


def run_slice(lefts, rights, rig, device):
    import torch

    vo = slice_vo(lefts, rights, rig, device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo.run()
    dt = time.perf_counter() - t0
    return vo, dt


def profile_run(label: str, run, units: int, unit: str = "frames") -> None:
    """Device busy share and the top kernels while `run()` does `units`
    units of work (frames, calls), under torch.profiler, then the
    profiler's tables."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"profile {label}: {units} {unit} in {dt * 1e3:.1f} ms (under the "
          f"profiler), device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (dt * 1e3):.1f}% of that, {launches} device "
          f"kernels = {launches / units:.0f} per {unit.rstrip('s')}")
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    print(f"profile {label} top kernels: " + "; ".join(
        f"{e.key[:48]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in top))
    sort = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    print(ka.table(sort_by=sort, row_limit=30))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


@contextlib.contextmanager
def held_to_plain(records: list):
    """While active, every launch of kernel C and of the window gather (as
    `lk._track_level` makes them) is compared with its plain version on the
    same inputs; `records` gets one dict per launch, the last call's inputs
    under "args". The path's own result is returned unchanged."""
    import torch
    from stereovision_slam_torch.ops import gather, lk_iterate

    kernel_c, kernel_g = lk_iterate.lk_iterate, gather.gather_windows

    def c(*a, **kw):
        k = kernel_c(*a, **kw)
        p = lk_iterate.lk_iterate_plain(*a, **kw)
        flags_eq = (k[:, 2:4] == p[:, 2:4]).all(dim=1)
        err = (k[:, :2] - p[:, :2]).abs().amax(dim=1)
        err = err[flags_eq & torch.isfinite(err)]
        records.append(dict(name="lk_iterate", args=(a, kw),
                            agree=float(flags_eq.float().mean()),
                            err=float(err.max()) if err.numel() else 0.0))
        return k

    def g(*a, **kw):
        k = kernel_g(*a, **kw)
        p = gather.gather_windows_plain(*a, **kw)
        records.append(dict(name="gather_windows", args=(a, kw),
                            agree=float(torch.equal(k, p)),
                            err=float((k - p).abs().max())))
        return k

    lk_iterate.lk_iterate, gather.gather_windows = c, g
    try:
        yield
    finally:
        lk_iterate.lk_iterate, gather.gather_windows = kernel_c, kernel_g


def check_held(records: list, label: str) -> tuple[float, float]:
    """Gates the comparisons of `held_to_plain`: kernel C's flags equal on
    LK_FLAG_AGREE of the points and positions within LK_POS_TOL, the gather
    bit-equal. Returns the largest kernel C and gather errors."""
    cs = [r for r in records if r["name"] == "lk_iterate"]
    gs = [r for r in records if r["name"] == "gather_windows"]
    c_agree = min(r["agree"] for r in cs)
    c_err = max(r["err"] for r in cs)
    g_err = max(r["err"] for r in gs)
    g_equal = all(r["agree"] == 1.0 for r in gs)
    print(f"{label}: {len(cs)} kernel C launches against the plain version, "
          f"flags agree >= {c_agree:.4f}, max pos err {c_err:.3e} px; "
          f"{len(gs)} gather launches, all bit-equal {g_equal} (max err "
          f"{g_err:.1e})")
    check(c_agree >= LK_FLAG_AGREE and c_err <= LK_POS_TOL,
          f"{label}: kernel C disagrees with its plain version: {c_agree}, "
          f"{c_err}")
    check(g_equal, f"{label}: the window gather is not bit-equal")
    return c_err, g_err


def serving_streams(lefts, rights, gt):
    """SERVE_B streams of SERVE_T circuit frames, stream b from frame
    SERVE_STRIDE * b, with ground truth re-based to its first frame."""
    import numpy as np

    def inv(T):
        R = T[:, :3].T
        return np.concatenate([R, -R @ T[:, 3:]], 1)

    def compose(A, B):
        return np.concatenate([A[:, :3] @ B[:, :3],
                               A[:, :3] @ B[:, 3:] + A[:, 3:]], 1)

    out = []
    for b in range(SERVE_B):
        s = slice(SERVE_STRIDE * b, SERVE_STRIDE * b + SERVE_T)
        base = inv(gt[s.start])
        out.append((lefts[s], rights[s],
                    np.stack([compose(T, base) for T in gt[s]])))
    return out


def check_lk_window(streams, dev):
    """Kernel C and the window gather against their plain versions on
    every launch of the serving path's two per-level LK calls (G = B and
    G = 2B groups of 256 points, windowed levels 0 and 1), on the first
    two frames of the serving streams."""
    import torch
    from stereovision_slam_torch.ops import gather, gftt, image as imops, lk
    from stereovision_slam_torch.ops import lk_iterate

    def levels(side, i):
        return [torch.stack(lv) for lv in zip(*(imops.build_pyramid(
            torch.as_tensor(s[side][i], device=dev), 4) for s in streams))]

    prev, cur, right = levels(0, 0), levels(0, 1), levels(1, 1)
    det = [gftt.detect(prev[0][b], max_corners=256, min_distance=20)
           for b in range(len(streams))]
    pts = torch.stack([d[0] for d in det])
    valid = torch.stack([d[1] for d in det])
    records = []
    with held_to_plain(records):
        uv_a, st_a = lk.track_batched(prev, cur, pts, pts, valid,
                                      max_iters=12, pallas_mode="pallas")
        lk.track_batched(
            [torch.cat([p, c]) for p, c in zip(prev, cur)],
            [torch.cat([c, r]) for c, r in zip(cur, right)],
            torch.cat([pts, uv_a]),
            torch.cat([uv_a, uv_a - torch.tensor([12.0, 0.0], device=dev)]),
            torch.cat([valid, valid & st_a]), max_iters=12,
            pallas_mode="pallas")
    check(len(records) == 8, f"{len(records)} kernel C and gather launches, "
          "not 4 each")
    for r in records:
        if r["name"] == "lk_iterate":
            a, kw = r["args"]
            print(f"kernel C N={a[0].shape[0]} H x W={kw['H']}x{kw['W']}: "
                  f"flags agree {r['agree']:.4f}, max pos err "
                  f"{r['err']:.3e} px")
    c_err, g_err = check_held(records, "phase 6")

    # times at the largest launch: level 0 of the G = 2B call
    a, kw = next(r["args"] for r in reversed(records)
                 if r["name"] == "lk_iterate")
    ga, gkw = next(r["args"] for r in reversed(records)
                   if r["name"] == "gather_windows")
    win, tmpl = a[0], a[1]
    N, P, R = win.shape[0], win.shape[1], tmpl.shape[1]
    iters = float(lk_iterate.lk_iterate_plain(*a, **kw)[:, 4].sum())
    # per pixel and iteration: 4-term bilinear (7), diff (1), two
    # multiply-adds (4)
    flops = iters * R * R * 12.0
    nbytes = 4 * (sum(t.numel() for t in a) + N * lk_iterate.OUT_COLS)
    b_c, by_c = bound_ms(nbytes, flops)
    c_row = dict(name="lk_iterate", route="cuda",
                 source="stereovision_slam_torch/csrc/lk_iterate.cu",
                 replaces="stereovision_slam_tpu/ops/lk_pallas.py:46",
                 max_abs_err=c_err,
                 ms=cuda_ms(lambda: lk_iterate.lk_iterate(*a, **kw), 50),
                 plain_ms=cuda_ms(
                     lambda: lk_iterate.lk_iterate_plain(*a, **kw), 3),
                 bound_ms=b_c, bound_by=by_c, library_ms=None)
    imgs, group, cy, cx = ga[:4]
    G, H, W = imgs.shape
    r = torch.arange(P, device=dev)
    gi = group.long()[:, None, None]
    rows = (cy.long()[:, None] + r)[:, :, None]
    cols = (cx.long()[:, None] + r)[:, None, :]
    nbytes = 4 * (imgs.numel() + 3 * N + N * P * P)
    b_g, by_g = bound_ms(nbytes, 0.0)
    g_row = dict(name="gather_windows", route="cuda",
                 source="stereovision_slam_torch/csrc/gather_windows.cu",
                 replaces="benchmarks/probe_gather.py:48",
                 max_abs_err=g_err,
                 ms=cuda_ms(lambda: gather.gather_windows(*ga, **gkw), 50),
                 plain_ms=cuda_ms(
                     lambda: gather.gather_windows_plain(*ga, **gkw), 50),
                 bound_ms=b_g, bound_by=by_g,
                 library_ms=cuda_ms(lambda: imgs[gi, rows, cols], 50))
    print(f"kernel C N={N} (G={G}) level {H}x{W}: {c_row['ms']:.4f} ms, "
          f"plain {c_row['plain_ms']:.3f} ms, bound {b_c:.6f} ms ({by_c}); "
          f"gather {g_row['ms']:.4f} ms, plain {g_row['plain_ms']:.4f} ms, "
          f"indexing {g_row['library_ms']:.4f} ms, bound {b_g:.6f} ms")
    return c_row, g_row


def serving_config():
    """The gated serving cell: the bench's settings, with BA's landmark
    compaction sized to the serving window. The bench's 1024 overflows
    there: with a keyframe every fourth frame each of the ten window
    keyframes brings up to 250 new landmarks, BA passes leave active
    landmarks out (silently, in both packages), and a stream's pose jumps
    (phase 7 prints the bench run's overflow and ATE). With room for 2048
    no pass overflows."""
    cfg = bench_config()
    cfg.ba_max_active_landmarks = 2048
    return cfg


def make_serving(streams, rig, device, cfg=None):
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.batched import BatchedFusedVisualOdometry

    return BatchedFusedVisualOdometry(
        cfg or serving_config(), [ArraySequenceDataset(l, r, list(rig))
                                  for l, r, _ in streams],
        max_total_keyframes=512, max_total_landmarks=1 << 16,
        kf_stagger=SERVE_STAGGER, device=device)


def stream_ate(traj, gt) -> float:
    import numpy as np

    def center(p):
        return -p[:, :3].T @ p[:, 3]
    errs = [np.linalg.norm(center(p) - center(gt[f])) for f, p in traj.items()]
    return float(np.sqrt(np.mean(np.square(errs))))


@contextlib.contextmanager
def ba_overflow(passes: list):
    """While active, `passes` gets each serving BA pass's count of active
    landmarks left out by the compaction (a device tensor, read later)."""
    from stereovision_slam_torch.slam import batched

    optimize = batched.optimize_window

    def counted(*a, **kw):
        out = optimize(*a, **kw)
        passes.append(out[1][3])
        return out
    batched.optimize_window = counted
    try:
        yield
    finally:
        batched.optimize_window = optimize


def run_serving(streams, rig, counters, dev, cfg, label: str,
                gate_ate: bool):
    """Phase 7: one serving run on the card, with the launch counters set
    to 0 before it; gates keyframes, inliers and launches, and the ATE
    where `gate_ate`. Returns (vo, the states after each of PALLAS_FROMS
    steps, launches)."""
    import numpy as np
    import torch

    for mod in counters.values():
        mod.launch_count = 0
    vo = make_serving(streams, rig, dev, cfg)
    vo.initialize()
    passes, snaps = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ba_overflow(passes):
        while True:
            if vo._step_idx in PALLAS_FROMS:
                snaps[vo._step_idx] = (vo.fs, vo.ms, vo.arc,
                                       list(vo.kf_count))
            if not vo.step():
                break
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: m.launch_count for k, m in counters.items()}
    over = [int(p) for p in passes if int(p) > 0]
    steps = vo._step_idx
    frames = SERVE_B * steps
    outputs = vo.outputs
    inserted = sum(int(o.kf_inserted) for out in outputs for _, o in out)
    print(f"serving ({label}, ba_max_active_landmarks "
          f"{cfg.ba_max_active_landmarks}): {SERVE_B} streams x {steps} "
          f"tracked frames in {dt:.3f} s = {frames / dt:.2f} frames/s "
          f"aggregate (host clock, ends in synchronize), {inserted} keyframe "
          f"steps, launches {launches}; {len(passes)} BA passes, {len(over)} "
          f"left active landmarks out, up to {max(over, default=0)}")
    path = 0.35 * SERVE_T
    for b, (traj, out) in enumerate(zip(vo.trajectories(), outputs)):
        n_in = np.array([int(o.n_inliers) for _, o in out])
        ate = stream_ate(traj, streams[b][2])
        met = ate < SERVE_ATE_PER_M * path
        print(f"  stream {b}: {len(traj)} keyframes, keyframe ATE {ate:.4f} m "
              f"over {path:.1f} m ({100 * ate / path:.3f}%, the 5% gate "
              f"{'met' if met else 'MISSED'}"
              f"{'' if gate_ate else ', not gated'}), n_inliers "
              f"{n_in.min()}-{n_in.max()}")
        check(len(traj) >= 2, f"stream {b}: only {len(traj)} keyframes")
        check(met or not gate_ate, f"stream {b}: ATE {ate:.3f} m")
        check(len(out) == steps and bool(np.all(n_in > 10)),
              f"stream {b}: tracking collapsed: {n_in.tolist()}")
    want_a = 8 * steps + 4 * (SERVE_B + inserted)
    check(launches["lk_level"] == want_a,
          f"kernel A launched {launches['lk_level']} times, not {want_a}")
    check(launches["pose_lm"] == steps,
          f"kernel B launched {launches['pose_lm']} times, not {steps}")
    check(launches["lk_iterate"] == 0 and launches["gather_windows"] == 0,
          "the lanes path launched kernel C or the gather")
    return vo, snaps, launches


def serve_from(vo, state, start: int, streams, dev, mode: str):
    """PALLAS_STEPS serving steps from `state`, the state after `start`
    steps, with pallas_mode=mode. Returns (n_inliers (T, B), poses (T, B,
    3, 4), keyframe steps (T, B))."""
    import numpy as np
    import torch
    from stereovision_slam_torch.slam.batched import batched_staggered_step

    fs, ms, arc, kfc = state
    n_in, pose, kf = [], [], []
    for i in range(start, start + PALLAS_STEPS):
        f = i + 1                      # frame 0 went to the initialization
        left = torch.as_tensor(np.stack([s[0][f] for s in streams]),
                               device=dev)
        right = torch.as_tensor(np.stack([s[1][f] for s in streams]),
                                device=dev)
        fs, ms, arc, kfc, out = batched_staggered_step(
            fs, ms, arc, kfc, left, right, [f] * SERVE_B, i % SERVE_STAGGER,
            vo.cam_left, vo.cam_right, pallas_mode=mode, **vo._statics())
        n_in.append(out.n_inliers.cpu().numpy())
        pose.append(out.pose.cpu().numpy())
        kf.append(out.kf_inserted)
    return np.stack(n_in), np.stack(pose), np.stack(kf)


def pallas_on_path(vo, snaps, streams, counters, dev):
    """Phase 8: PALLAS_STEPS serving frames from the state after each of
    PALLAS_FROMS steps with the per-level LK (kernel C and the gather on
    levels 0 and 1 of both LK calls), every launch held to its plain
    version; then the same frames with the lanes LK, for comparison."""
    import numpy as np
    import torch

    for m in counters.values():
        m.launch_count = 0
    records = []
    with held_to_plain(records):
        per_level = {s: serve_from(vo, snaps[s], s, streams, dev, "pallas")
                     for s in PALLAS_FROMS}
    torch.cuda.synchronize()
    launches = {k: m.launch_count for k, m in counters.items()}
    lanes = {s: serve_from(vo, snaps[s], s, streams, dev, "lanes")
             for s in PALLAS_FROMS}

    def centres(p):
        return -np.einsum("...ji,...j->...i", p[..., :3], p[..., 3])

    print(f"kernel C on the path: {PALLAS_STEPS} frames x {SERVE_B} streams "
          f"from each of steps {PALLAS_FROMS}, launches {launches}")
    c_err, g_err = check_held(records, "phase 8")
    for s in PALLAS_FROMS:
        (n_p, pose_p, kf_p), (_, pose_l, kf_l) = per_level[s], lanes[s]
        frames = np.arange(s + 1, s + PALLAS_STEPS + 1)
        gt = centres(np.stack([st[2][frames] for st in streams], 1))
        err_p = np.linalg.norm(centres(pose_p) - gt, axis=-1)   # (T, B)
        err_l = np.linalg.norm(centres(pose_l) - gt, axis=-1)
        diff = np.linalg.norm(centres(pose_p) - centres(pose_l), axis=-1)
        gt_tol = SERVE_ATE_PER_M * 0.35 * frames[-1]
        print(f"  from step {s}: n_inliers {n_p.min()}-{n_p.max()}; error to "
              f"ground truth per stream, per-level LK max "
              + " ".join(f"{e:.3f}" for e in err_p.max(0))
              + f" m (gate {gt_tol:.3f}), lanes LK max "
              + " ".join(f"{e:.3f}" for e in err_l.max(0))
              + " m; per-level vs lanes centres apart by up to "
              + " ".join(f"{d:.4f}" for d in diff.max(0))
              + f" m (tolerance {PALLAS_DRIFT_TOL}); keyframes "
              f"{int(kf_p.sum())}/{int(kf_l.sum())}")
        check(bool(np.all(n_p > 10)),
              f"tracking collapsed on kernel C from step {s}")
        check(float(err_p.max()) < gt_tol,
              f"the kernel C run from step {s} is {err_p.max()} m off "
              "ground truth")
        check(float(diff.max()) < PALLAS_DRIFT_TOL,
              f"the kernel C run from step {s} parts from the lanes run by "
              f"{diff.max()} m")
    runs = len(PALLAS_FROMS)
    want = 4 * PALLAS_STEPS * runs
    check(launches["lk_iterate"] == want
          and launches["gather_windows"] == want,
          f"kernel C / gather launched {launches}, not {want} each")
    check(launches["pose_lm"] == PALLAS_STEPS * runs, "kernel B launch count")
    return launches, c_err, g_err


def cpu_serving(streams, rig, vo_card):
    """Phase 9: the first CPU_SERVE_STEPS serving frames on the CPU."""
    import numpy as np

    cut = [(l[:CPU_SERVE_STEPS + 1], r[:CPU_SERVE_STEPS + 1], g)
           for l, r, g in streams]
    t0 = time.perf_counter()
    vo = make_serving(cut, rig, "cpu")
    vo.initialize()
    vo.run()
    dt = time.perf_counter() - t0
    card = vo_card.outputs
    diff = 0.0
    for b, out in enumerate(vo.outputs):
        pc = np.stack([o.pose for _, o in out])
        pg = np.stack([o.pose for _, o in card[b][:len(out)]])
        diff = max(diff, float(np.abs(pc - pg).max()))
    tol = CPU_POSE_TOL_PER_M * 0.35 * CPU_SERVE_STEPS
    print(f"cpu rerun of {CPU_SERVE_STEPS} serving frames x {SERVE_B} "
          f"streams ({dt:.1f} s): max pose diff {diff:.3e} (tolerance "
          f"{tol:.3e})")
    check(diff < tol, f"cuda and cpu serving runs differ by {diff}")


def check_ring(dev):
    """Phase 10: kernel D against its plain version, bit for bit and within
    RING_F64_TOL of the float64 sum, at the reference test's three meshes
    (its 302-float tree per rank, scaled per rank, padded as `ring_psum`
    pads it) and at the sharded BA's payload; times at the latter."""
    import numpy as np
    import torch
    from stereovision_slam_torch.parallel import ring_reduce as rr

    rng = np.random.default_rng(0)
    tree = rng.normal(size=8 * 5 * 7 + 13 + 9).astype(np.float32)
    cases = []
    for axis, dp, mp in (("dp", 8, 1), ("dp", 4, 2), ("mp", 2, 4)):
        n = dp if axis == "dp" else mp
        scale = (1.0 + 2.0 * np.arange(dp)[:, None]
                 + np.arange(mp)[None, :]).reshape(-1, 1).astype(np.float32)
        flat = np.zeros((dp * mp, 8 * n * rr.LANES), np.float32)
        flat[:, :tree.size] = tree[None] * scale
        cases.append((axis, dp, mp, torch.tensor(
            flat.reshape(dp * mp, -1, rr.LANES), device=dev)))
    R = RING_PATH_ROWS
    cases.append(("dp", 4, 2, torch.tensor(
        rng.normal(size=(8, R, rr.LANES)).astype(np.float32), device=dev)))
    err = 0.0
    for axis, dp, mp, x in cases:
        ma = (("dp", dp), ("mp", mp))
        k = rr.ring_all_reduce_flat(x, axis, ma)
        p = rr.ring_all_reduce_plain(x, axis, ma)
        torch.cuda.synchronize()
        ax = 0 if axis == "dp" else 1
        x64 = x.double().reshape(dp, mp, *x.shape[1:])
        ref = x64.sum(ax, keepdim=True).expand_as(x64).reshape(x.shape)
        mag = x64.abs().sum(ax, keepdim=True).expand_as(x64).reshape(x.shape)
        rel = float(((k.double() - ref).abs() / mag.clamp(min=1e-30)).max())
        e = float((k - p).abs().max())
        err = max(err, e)
        print(f"kernel D mesh ({dp}, {mp}) along {axis}, payload "
              f"{tuple(x.shape)}: bit-equal {torch.equal(k, p)}, largest "
              f"error to the float64 sum {rel:.2e} of the magnitudes")
        check(torch.equal(k, p), f"kernel D differs from its plain version "
              f"on mesh ({dp}, {mp}) along {axis}: {e}")
        check(rel <= RING_F64_TOL, f"kernel D is {rel} off the float64 sum")
    axis, dp, mp, x = cases[-1]
    ma = (("dp", dp), ("mp", mp))
    ms = cuda_ms(lambda: rr.ring_all_reduce_flat(x, axis, ma, check=False),
                 50)
    rr.check_errors(x.device)
    plain_ms = cuda_ms(lambda: rr.ring_all_reduce_plain(x, axis, ma), 5)
    lib_ms = cuda_ms(lambda: x.view(dp, mp, R, rr.LANES).sum(0), 50)
    # each input read once, each output written once; n - 1 adds for each
    # element of each ring's sum
    b, by = bound_ms(2 * 4 * x.numel(), x.numel() * (dp - 1) / dp)
    print(f"kernel D at the sharded BA payload (8 ranks x {R} x 128): "
          f"{ms:.4f} ms per launch, plain {plain_ms:.3f} ms, torch.sum over "
          f"the ring axis {lib_ms:.4f} ms, bound {b:.6f} ms ({by})")
    return dict(name="ring_all_reduce", route="cuda",
                source="stereovision_slam_torch/csrc/ring_reduce.cu",
                replaces="stereovision_slam_tpu/parallel/ring_reduce.py:39",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms)


@contextlib.contextmanager
def ring_held(records: list):
    """While active, every launch of kernel D is compared with its plain
    version on the same payload; `records` gets one dict per launch. The
    path's own result is returned unchanged."""
    import torch
    from stereovision_slam_torch.parallel import ring_reduce as rr

    kernel = rr.ring_all_reduce_flat

    def held(x, axis_name, mesh_axes):
        k = kernel(x, axis_name, mesh_axes)
        p = rr.ring_all_reduce_plain(x, axis_name, mesh_axes)
        records.append(dict(shape=tuple(x.shape), equal=torch.equal(k, p),
                            err=float((k - p).abs().max())))
        return k

    rr.ring_all_reduce_flat = held
    try:
        yield
    finally:
        rr.ring_all_reduce_flat = kernel


def timed(fn):
    """(result, host seconds) of fn(), ending in synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_ba_phase(vo, counters, dev, err_d: float, profile: bool):
    """Phase 11: the distributed BA on the slice's final window, mesh
    (dp 4, mp 2) on the card, "xla" and "ring" (kernel D, every launch held
    to its plain version), against each other, against the single-card
    BA, and the ring run again on the CPU. Returns (launches, the largest
    kernel D error)."""
    import numpy as np
    import torch
    from stereovision_slam_torch.geometry import se3
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.slam.backend import optimize_window

    cfg = bench_config()
    m, cl, cr = vo.ms, vo.cam_left, vo.cam_right
    K, F = m.obs_lm.shape
    L = m.lm_pos.shape[0]
    iters, La = cfg.ba_lm_iters, SHARDED_LA
    active = int((m.lm_valid & (m.lm_obs_count > 0)).sum())
    n_obs = int((m.obs_valid & (m.obs_lm >= 0) & m.kf_valid[:, None]).sum())
    # the slice's last BA pass left this window at its minimum: seeded
    # noise on the poses (but the gauge-fixed oldest) and the landmarks
    # gives the solvers work, on the slice's own observations
    rng = np.random.default_rng(SHARD_SEED)
    oldest = torch.min(torch.where(m.kf_valid, m.kf_id,
                                   torch.full_like(m.kf_id, 2 ** 31 - 1)))
    free = (m.kf_valid & (m.kf_id != oldest))[:, None, None]
    dxi = torch.tensor(rng.normal(0, SHARD_NOISE[0], (K, 6)),
                       dtype=torch.float32, device=dev)
    dl = torch.tensor(rng.normal(0, SHARD_NOISE[1], (L, 3)),
                      dtype=torch.float32, device=dev)
    m = m._replace(
        kf_pose=torch.where(free, se3.se3_compose(se3.se3_exp(dxi),
                                                  m.kf_pose), m.kf_pose),
        lm_pos=torch.where(m.lm_valid[:, None], m.lm_pos + dl, m.lm_pos))
    print(f"sharded BA window: K {K}, F {F}, L {L}, {int(m.kf_valid.sum())} "
          f"keyframes, {active} active landmarks, {n_obs} left "
          f"observations, La {La}, {iters} LM iterations, mesh (4, 2); "
          f"poses and landmarks perturbed by N(0, {SHARD_NOISE[0]}) tangent "
          f"and N(0, {SHARD_NOISE[1]}) m noise, seed {SHARD_SEED}")
    check(active <= La, f"{active} active landmarks overflow La = {La}")
    mesh = make_ba_mesh(dp=4, mp=2, device=dev)
    kw = dict(chi2_th=cfg.chi2_th, iters=iters, max_active_landmarks=La)
    run_x = build_sharded_ba(mesh, K, F, L, reduce_impl="xla", **kw)
    run_r = build_sharded_ba(mesh, K, F, L, reduce_impl="ring", **kw)
    kx, lx = run_x(m, cl, cr)
    for mod in counters.values():
        mod.launch_count = 0
    records = []
    with ring_held(records):
        kr, lr = run_r(m, cl, cr)
        torch.cuda.synchronize()
    launches = {k: mod.launch_count for k, mod in counters.items()}
    equal = all(r["equal"] for r in records)
    err = max([r["err"] for r in records] + [err_d])
    print(f"sharded BA ring: launches {launches}; {len(records)} kernel D "
          f"launches on payload {records[0]['shape'] if records else None}, "
          f"all bit-equal to the plain version: {equal}")
    check(launches["ring_all_reduce"] == iters,
          f"kernel D launched {launches['ring_all_reduce']} times, not "
          f"{iters}")
    check(equal, "a kernel D launch of the sharded BA differs from its "
          "plain version")
    ms1, _ = optimize_window(m, cl, cr, chi2_th=cfg.chi2_th, iters=iters,
                             outlier_rounds=0, max_active_landmarks=La)
    kv, lv = m.kf_valid, m.lm_valid

    # landmarks are held within max(tol[1], tol[2] x distance from the
    # gauge keyframe's camera): see SHARD_RING_TOL
    gauge = m.kf_pose[int(torch.argmax((m.kf_id == oldest).int()))]
    centre = -gauge[:, :3].T @ gauge[:, 3]
    dist = torch.linalg.vector_norm(m.lm_pos - centre, dim=-1).clamp(min=1.0)

    def compare(name, k_a, l_a, k_b, l_b, tol):
        dk = float((k_a - k_b).abs()[kv].max())
        dl = (l_a - l_b).abs().amax(-1).to(dist.device)[lv]
        rel = dl / dist[lv]
        worst = int(torch.argmax(rel))
        over = dl > torch.clamp(tol[2] * dist[lv], min=tol[1])
        print(f"  {name}: poses {dk:.3e} (tolerance {tol[0]}), landmarks "
              f"{float(dl.max()):.3e} m, {float(rel.max()):.3e} of their "
              f"distance (worst {float(dl[worst]):.3e} m at "
              f"{float(dist[lv][worst]):.1f} m), {int(over.sum())} over "
              f"max({tol[1]}, {tol[2]:.2e} x distance)")
        return dk <= tol[0] and not bool(over.any()), f"{name}: {dk}, " \
            f"{float(dl.max())}"

    m_cpu = type(m)(*(t.cpu() for t in m))
    kc, lc = build_sharded_ba(make_ba_mesh(dp=4, mp=2, device="cpu"), K, F,
                              L, reduce_impl="ring", **kw)(
        m_cpu, cl.to("cpu"), cr.to("cpu"))
    print(f"sharded BA moved the poses by up to "
          f"{float((kr - m.kf_pose).abs().max()):.3e}; differences:")
    results = [
        compare("ring vs xla", kr, lr, kx, lx, SHARD_RING_TOL),
        compare("xla vs single-card BA", kx, lx, ms1.kf_pose, ms1.lm_pos,
                SHARD_SINGLE_TOL),
        compare("ring vs single-card BA", kr, lr, ms1.kf_pose, ms1.lm_pos,
                SHARD_SINGLE_TOL),
        compare("cpu ring vs card ring", kc.to(dev), lc.to(dev), kr, lr,
                SHARD_CPU_TOL)]
    for ok, msg in results:
        check(ok, f"sharded BA out of tolerance, {msg}")
    check(bool(torch.isfinite(kr).all() and torch.isfinite(lr).all()),
          "sharded BA gave non-finite values")
    # wall time of one call each, warm
    for _ in range(2):
        _, t_r = timed(lambda: run_r(m, cl, cr))
        _, t_x = timed(lambda: run_x(m, cl, cr))
        _, t_1 = timed(lambda: optimize_window(
            m, cl, cr, chi2_th=cfg.chi2_th, iters=iters, outlier_rounds=0,
            max_active_landmarks=La))
    print(f"sharded BA wall time per call (host clock, ends in "
          f"synchronize): ring {t_r * 1e3:.1f} ms, xla {t_x * 1e3:.1f} ms; "
          f"single-card optimize_window {t_1 * 1e3:.1f} ms")
    if profile:
        profile_run("sharded BA (ring)", lambda: run_r(m, cl, cr), 1,
                    "calls")
        profile_run("single-card BA", lambda: optimize_window(
            m, cl, cr, chi2_th=cfg.chi2_th, iters=iters, outlier_rounds=0,
            max_active_landmarks=La), 1, "calls")
    return launches, err


def pgo_phase(keyframes, gt, dev, profile: bool) -> None:
    """Phase 12: a pose graph over the slice's keyframes (consecutive edges
    from the estimated poses, first -> last from ground truth, one loop
    edge with rank-deficient information), optimized on the card by
    `optimize_pose_graph` and by `build_sharded_pgo` over 8 ranks."""
    import numpy as np
    import torch
    from stereovision_slam_torch.geometry import se3
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
    from stereovision_slam_torch.slam import pose_graph as pg

    kfs = sorted(keyframes.values(), key=lambda fp: fp[0])
    fids = [f for f, _ in kfs]
    P = torch.tensor(np.stack([p for _, p in kfs]), dtype=torch.float32,
                     device=dev)
    G = torch.tensor(np.asarray(gt)[fids], dtype=torch.float32, device=dev)
    T = len(kfs)
    mid = T // 2
    ei = list(range(1, T)) + [T - 1, mid]
    ej = list(range(0, T - 1)) + [0, 0]
    meas = se3.se3_compose(P[1:], se3.se3_inverse(P[:-1]))
    loop = se3.se3_compose(G[T - 1], se3.se3_inverse(G[0]))
    # the mid -> first edge from ground truth, wrong by 0.5 m along a
    # direction its information cannot see
    u = torch.tensor([0.0, 0.45, 0.0, 0.2, 0.0, 0.0], device=dev)
    u = u / torch.linalg.vector_norm(u)
    blind = se3.se3_compose(se3.se3_exp(0.5 * u), se3.se3_compose(
        G[mid], se3.se3_inverse(G[0])))
    meas = torch.cat([meas, loop[None], blind[None]])
    E = meas.shape[0]
    A = se3.se3_adjoint(blind)
    H = A.T @ (torch.eye(6, device=dev) - torch.outer(u, u)) @ A
    H = H / torch.linalg.eigvalsh(H).max()
    info = torch.eye(6, device=dev).repeat(E, 1, 1)
    info[-1] = H
    ones = torch.ones(T, dtype=torch.bool, device=dev)
    g = pg.PoseGraph(P, ones, torch.tensor(ei, device=dev),
                     torch.tensor(ej, device=dev), meas,
                     torch.ones(E, dtype=torch.bool, device=dev), info)
    rank = int(torch.linalg.matrix_rank(info[-1]))
    # each timed twice: the first call on the card pays one-time set-up
    out1, t1_cold = timed(lambda: pg.optimize_pose_graph(g))
    _, t1 = timed(lambda: pg.optimize_pose_graph(g))
    mesh = make_ba_mesh(8, device=dev)
    outs, ts_cold = timed(lambda: build_sharded_pgo(mesh)(g))
    _, ts = timed(lambda: build_sharded_pgo(mesh)(g))

    def chi2(poses):
        r, _, _ = pg._linearize(pg._edge_ranks(g._replace(poses=poses)),
                                jacobians_too=False)
        return float(r.square().sum())

    def centre(T34):
        return -T34[..., :3, :3].transpose(-1, -2).matmul(
            T34[..., :3, 3:]).squeeze(-1)

    def end_err(poses):
        return float(torch.linalg.vector_norm(centre(poses[-1])
                                              - centre(G[-1])))

    d = float((outs - out1).abs().max())
    c0, c1, cs = chi2(P), chi2(out1), chi2(outs)
    e0, e1, es = end_err(P), end_err(out1), end_err(outs)
    print(f"PGO: {T} keyframes, {E} edges (padded to a multiple of the "
          f"{mesh.size} ranks; the blind loop edge's info of rank {rank}); "
          f"single {t1_cold:.2f} s first, {t1:.2f} s again, sharded "
          f"{ts_cold:.2f} s, {ts:.2f} s (host clock); "
          f"sharded vs single {d:.3e} (tolerance {PGO_SHARD_TOL}); chi2 "
          f"{c0:.4e} -> {c1:.4e} single, {cs:.4e} sharded; last keyframe "
          f"{e0:.4f} m from ground truth before, {e1:.4f} m after "
          f"(sharded {es:.4f} m)")
    check(rank < 6, "the loop edge's information is not rank-deficient")
    check(bool(torch.isfinite(out1).all() and torch.isfinite(outs).all()),
          "PGO gave non-finite poses")
    check(d <= PGO_SHARD_TOL and cs <= c1 * 1.05 + 1e-8,
          f"sharded PGO differs from single PGO: {d}, chi2 {cs} vs {c1}")
    check(e1 < e0 and es < e0, f"PGO did not bring the last keyframe closer "
          f"to ground truth: {e0} -> {e1}, {es}")
    if profile:
        profile_run("PGO", lambda: pg.optimize_pose_graph(g), 1, "solves")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", type=int, default=0,
                    help="also profile this many frames of the slice and "
                         "of the serving streams, and one call each of the "
                         "sharded BA, the single-card BA and PGO")
    args = ap.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from stereovision_slam_torch import scenes
        from stereovision_slam_torch.ops import (
            _cuda, gather, lk_iterate, lk_lanes, pose_kernel)
        from stereovision_slam_torch.parallel import ring_reduce
    except ImportError as e:
        print(f"chip_smoke: the port is missing: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"

    # 1. environment and build
    smi = smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"built {', '.join(_cuda.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in _cuda.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    lefts, rights, gt, dist, rig = scenes.circuit(120, 188, 620, device=dev)
    print(f"rendered the circuit ({lefts.shape}) in "
          f"{time.perf_counter() - t0:.1f} s, path {dist:.1f} m")

    # 2-3. kernels against their plain versions
    kernels = [check_lk((lefts, rights), dev), check_pose(dev)]
    check_pose_streams(dev)

    # 4. the slice on the card, counters read around this run only
    counters = {"lk_level": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    T = len(lefts)
    for mod in counters.values():
        mod.launch_count = 0
    vo, dt = run_slice(lefts, rights, rig, dev)
    launches = {k: m.launch_count for k, m in counters.items()}
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])
    kf_counts = [int(f.kf_count) for _, f in frames]
    inserted = [bool(f.kf_inserted) for _, f in frames]
    print(f"slice: {T} frames in {dt:.3f} s = {T / dt:.2f} fps "
          f"(host clock, ends in synchronize), {len(keyframes)} keyframes, "
          f"{len(landmarks)} landmarks, launches {launches}")
    check(len(keyframes) >= 2, f"only {len(keyframes)} keyframes")
    check(len(landmarks) > 50, f"only {len(landmarks)} landmarks")
    check(bool(np.all(n_in[1:] > 10)), f"tracking collapsed: {n_in.tolist()}")
    check(kf_counts[0] == 0, "stereo initialization failed on frame 0")

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    errs = [np.linalg.norm(center(pose) - center(gt[fid]))
            for fid, pose in sorted(keyframes.values())]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"keyframe ATE {ate:.4f} m over {dist:.1f} m "
          f"({100 * ate / dist:.3f}%)")
    check(bool(np.isfinite(ate)) and ate < 0.02 * dist,
          f"ATE {ate:.3f} m over {dist:.1f} m")
    tracked = T - 1
    kf_steps = sum(inserted)
    want_lk = 4 * (2 * tracked + kf_steps)
    check(launches["lk_level"] == want_lk,
          f"kernel A launched {launches['lk_level']} times, not {want_lk}")
    check(launches["pose_lm"] == tracked,
          f"kernel B launched {launches['pose_lm']} times, not {tracked}")
    check(launches["lk_iterate"] == 0 and launches["gather_windows"] == 0,
          "the slice launched kernel C or the gather")
    by_path = {"slice": launches}

    if args.profile:
        n = args.profile
        profile_run("slice", slice_vo(lefts[:n], rights[:n], rig, dev).run,
                    n - 1)

    # 5. the first frames again on the CPU (plain versions)
    n_cpu = CPU_FRAMES
    vo_cpu, dt_cpu = run_slice(lefts[:n_cpu], rights[:n_cpu], rig, "cpu")
    pc = np.stack([f.pose for _, f in vo_cpu.outputs])
    pg = np.stack([f.pose for _, f in frames[:n_cpu]])
    per_frame = np.abs(pc - pg).reshape(n_cpu, -1).max(axis=1)
    diff = float(per_frame.max())
    tol = CPU_POSE_TOL_PER_M * dist * n_cpu / T
    kf_c = [bool(f.kf_inserted) for _, f in vo_cpu.outputs]
    print(f"cpu rerun of {n_cpu} frames ({dt_cpu:.1f} s): max pose diff "
          f"{diff:.3e} (tolerance {tol:.3e}), keyframe decisions equal: "
          f"{kf_c == inserted[:n_cpu]}; per frame: "
          + " ".join(f"{d:.1e}" for d in per_frame))
    check(diff < tol, f"cuda and cpu runs differ by {diff}")

    # 6. kernel C and the gather at the serving shapes
    streams = serving_streams(lefts, rights, gt)
    kernels += list(check_lk_window(streams, dev))

    # 7-8. multi-stream serving (the bench's settings, then the gated
    # cell), then kernel C on its path
    _, _, by_path["serving_bench"] = run_serving(
        streams, rig, counters, dev, bench_config(), "bench settings",
        gate_ate=False)
    vo_s, snaps, by_path["serving"] = run_serving(
        streams, rig, counters, dev, serving_config(), "gated cell",
        gate_ate=True)
    by_path["serving_pallas"], c_err, g_err = pallas_on_path(
        vo_s, snaps, streams, counters, dev)
    for k, e in zip(kernels[2:], (c_err, g_err)):
        k["max_abs_err"] = max(k["max_abs_err"], e)

    if args.profile:
        n = min(args.profile, SERVE_T - 1)
        vo_p = make_serving([(l[:n + 1], r[:n + 1], g) for l, r, g in streams],
                            rig, dev)
        vo_p.initialize()
        profile_run("serving", vo_p.run, SERVE_B * n)

    # 9. the first serving frames again on the CPU
    cpu_serving(streams, rig, vo_s)

    # 10-12. kernel D, the sharded BA on the slice's final window, PGO
    kernels.append(check_ring(dev))
    by_path["sharded_ba"], kernels[-1]["max_abs_err"] = sharded_ba_phase(
        vo, counters, dev, kernels[-1]["max_abs_err"], bool(args.profile))
    pgo_phase(keyframes, gt, dev, bool(args.profile))

    # launches: kernels A and B on the slice (the main path), kernel C and
    # the gather on the serving run with the per-level LK, kernel D on the
    # sharded BA; every path's counts beside them
    main_path = {"lk_level": "slice", "pose_lm": "slice",
                 "lk_iterate": "serving_pallas",
                 "gather_windows": "serving_pallas",
                 "ring_all_reduce": "sharded_ba"}
    for k in kernels:
        path = main_path[k["name"]]
        k["launches"] = by_path[path][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
    print(json.dumps({"kernels": [
        {k: kern[k] for k in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms",
                              "launches_by_path")}
        for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
