#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Usage: python3 chip_smoke.py [--profile N]

Phases, in order; any failure exits non-zero:
  1. environment: the card's name and power limit, and the build of every
     CUDA kernel of `stereovision_slam_torch/csrc/` (one nvcc per source, in
     parallel);
  2. kernel A (pyramidal LK, one launch per call over every level)
     against its plain PyTorch version at the main path's shapes (G = 1 and
     2 groups of 256 points, 4 levels) on pyramids of the rendered scene:
     each level from the kernel's own start, and the whole call; kernel,
     plain and bound times per call;
  3. kernel B (multi-start LM pose solve and the choice of the best start)
     the same, every start and the chosen one, at S = 3, F = 256, and over
     a stream axis at (B, S) = (4, 3); one `solve_pose_multi_lr` call is
     one launch with no other operator and no device->host read; times
     back to back, alone (warm and with the L2 flushed) and on the host;
  3b. the BA kernel (the keyframe window's whole BA pass in one launch)
     against the plain route on the windows of tests/torch_ba_cases.py
     (the benchmark cell's shapes, other compactions, few keyframes, a
     duplicated link, singular landmark blocks, every observation an
     outlier), one launch a pass; its time at the cell's shapes beside the
     plain route's and the bound;
  4. the slice: the 120-frame 188x620 circuit through `FusedVisualOdometry`
     on "cuda" with the bench settings, the bench's gates, keyframe ATE < 2%
     of the path, and the launch counters against the frame and keyframe
     counts (kernel A once per LK call);
  5. the first frames again on "cpu" (the kernels' plain versions), held to
     the card's run;
  6. kernel C (windowed LK loop) and the window gather against their plain
     versions at the serving shapes (N = 1024 and 2048 on levels 0 and 1);
     one kernel C call is one launch; kernel, plain, bound and library
     times as in phase 3 (the gather beside advanced indexing);
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
 10. kernel D (all-reduce along a mesh axis, one pass) against its plain
     version, bit for bit, at the reference test's three meshes and at the
     sharded BA's payload (8 ranks x 2.5 MB); one call is one launch with
     no memset and no device->host read; warm and cold (L2 flushed) times,
     plain, bound and torch.sum times; then its owner form (the route
     across cards) on the card, the 8 ranks as 4 cards of 2, one launch a
     card in turn with the handshake compiled out, bit for bit its plain
     version and the one launch, with its times;
 11. the distributed BA (`build_sharded_ba`, mesh (dp 4, mp 2), 6 LM
     iterations, compaction 2048) on the slice's final window, the dp
     reduction by a sum and by kernel D (6 launches, each held to its plain
     version), against each other, against the single-card BA and against
     the same call on "cpu", with the wall time of each;
 12. a pose graph over the slice's keyframes (one loop edge from ground
     truth, one with rank-deficient information) through
     `optimize_pose_graph` and `build_sharded_pgo` (8 ranks) on the card.

 13. the bench's main path, loop closure included: the circuit, then the
     480-frame multi-lap circuit (`scenes.circuit_long`), through
     `FusedLoopVisualOdometry` on "cuda" with the bench's settings,
     `PLACENET_LOOP_GATES` and the shipped PlaceNet weights (tracking,
     keyframes, BA, the keyframe hook: embedding, candidate scan, ORB
     descriptors, Hamming match, PnP RANSAC, LocalFusion; then shutdown
     PGO); the bench's gates (a loop, ATE after PGO < 2% of the path, PGO
     no worse than odometry), fps, the hook's host reads, the launch
     counters against the frame and keyframe counts, and every kernel A and
     B launch of the phase held to its plain version after the run;
 14. the command line on a KITTI sequence: the circuit written as KITTI
     PNGs (376x1240) and calib.txt, read back through `io.kitti` (cameras
     and frames checked); `apps.run_slam` on "cuda" with the bench's
     settings and `PLACENET_LOOP_GATES`, in classic mode (host loop
     closure, viewer transcript; the first 30 frames' kernel A and B
     launches held to their plain versions) and in fused mode, each with
     the bench's gates, fps, ATE before and after PGO, `pgo_s` and the
     launches; a fused run checkpointed every 50 frames and resumed from
     frame 100, its keyframes.txt held to the uninterrupted run's; and the
     loops the config's default gates close with PlaceNet (printed only).
 15. the chunked modes, each frame CUDA-graph replays of the fused step's
     branches (`slam/graphs.py`): (a) `ScanLoopVisualOdometry(chunk_size=
     8)` over the circuit's first 15 frames (the init, keyframes with BA,
     a padded row) held to `FusedLoopVisualOdometry`: float state within
     1e-5 relative to max(1, |value|), integers and flags equal, the
     launch counters those of the eager run plus the graphs' warm-ups;
     (b) `ScanLoopVisualOdometry` on both loop scenes with the bench's
     settings and gates, PGO through its graph, fps, host ms a frame,
     replays a frame, keyframes, loops, ATE and pgo_s beside phase 13's,
     and the first frame whose pose parts from phase 13's by more than
     1e-4; a torch.profiler count of device kernels, host kernel launches
     and graph launches a frame over 32 circuit frames of both paths;
     (c) `ScanVisualOdometry` (chunk 32) and `UnrolledVisualOdometry`
     (chunk 8) on the slice with its gates; (d) PGO's graph (one LM
     iteration, replayed 22 times a solve) held to the eager
     `optimize_pose_graph` within 1e-6 relative, both timed.

 16. the dense tool (`apps.run_dense_reconstruction`) on "cuda" over
     phase 14's fused run (cameras 2 / 3, colour PNGs whose channels
     differ; 128 disparities, block 15, SOR meanK 50 sigma 1, voxel 0.02
     m): points after each filter, ms a keyframe by stage, wall time and
     peak memory; (a) the first keyframe held to the card machine's CPU,
     (b) batches of 4 keyframes equal to the serial run bit for bit, (c)
     the share of kept points on the arena's ground or wall, (d) the PCD
     read back with the frames' colours;
 17. MobileNet-V2: a seeded torchvision-layout state dict written as ONNX
     and loaded back, the embedding on the card held to the CPU and timed,
     then `FusedLoopVisualOdometry` with it over the circuit and the
     classic command line with `dnn_weights_path` at the file ('auto'
     picks MobileNet): every frame tracked, keyframe ATE under 2%; loops
     and ATE after PGO printed; `ScanLoopVisualOdometry` with the
     MobileNet hook in its graphs held to the eager run as in 15 (a);
 18. FAST (`keypoint_feature_detector: ORB`): `fast.detect` on the card
     held to the CPU, `FusedVisualOdometry` with ORB over the circuit
     with the slice's gates, `ScanVisualOdometry` with FAST in its
     keyframe graph held to the eager run as in 15 (a), and the serving
     cell's four streams with ORB under phase 7's gates but the ATE's.
 19. the distributed backend across processes: (a) two processes spawned
     on the card (gloo on 127.0.0.1, both on cuda:0, 4 of the 8 ranks of
     the (dp 4, mp 2) mesh each): kernel D across them over a table of
     peer pointers (CUDA IPC) bit for bit against the one-process launch
     on phase 11's payload shape, its device time and the barriers around
     it beside gloo's all_reduce; the sharded BA ("ring", "xla") on phase
     11's window within phase 11's ring tolerance of the one-process runs,
     and the sharded PGO on phase 12's graph within its tolerance of the
     single solve, wall times beside phases 11 and 12; (b) serving phase
     7's four streams under `serving_config()` over a two-rank mesh on
     cuda:0 (the per-frame step) with phase 7's per-stream gates, the pose
     gap to phase 7's run printed; (c) the dense tool with `--mesh` and
     over a two-rank mesh, bit for bit phase 16's batched cloud. The card's
     machine has no libpng, so the native frame loader is not run here
     (the CPU tests hold it).
 20. the reference's loop-scene scenarios (tests/test_loop_scenes.py,
     test_hard_scene.py, test_long_sequence.py), rendered on "cuda" by
     `scenes`, with the reference's settings (`shared_cfg`, 256 keyframes
     and 32,768 landmarks of archive) and its assertions: (a) the
     112-frame figure-eight closes >= 2 loops, one spanning >= 40
     keyframes, PGO no worse; (b) the 4-fold aliased arena and (c) the
     straight corridor accept no loop; (d) PlaceNet's candidate precision
     and recall on the 96-frame circuit >= 0.7; (e) a seeded MobileNet-V2
     at the reference's gates over a 40-frame circle, no loop; (f) the
     hard scene's renderer, then 100 hard frames (inliers > 10 on > 90%
     of frames, ATE after PGO < 3%), chunked and again eager with every
     kernel A and B launch held to its plain version; (g) the 150-frame
     corridor with `SlamConfig()` through `ScanVisualOdometry`, drift < 2%
     through `trajectory()`. The loop scenarios run
     `ScanLoopVisualOdometry` (chunk 8); fps, keyframes, loops and ATE of
     each;
 21. PlaceNet's training tool (`apps.train_place_net`) at its defaults
     on the card into a temporary file: a falling, finite loss, the new
     weights through the reference's held-out world test, the validation
     table beside the shipped weights', the shipped file unchanged.
 22. the per-rank route of the distributed backend (a mesh of one device
     per rank in one process, the reference's layout over the chips of a
     host; over several cards in `tests/torch_multicard.py`) with its four
     ranks on cuda:0: the sharded BA at (dp 2, mp 2) on phase 11's window,
     "ring" (every kernel D call held to its plain version bit for bit)
     and "xla", within SHARD_RING_TOL of the tensor-axis route at the same
     split; the sharded PGO over the four ranks on phase 12's graph within
     PGO_SHARD_TOL of the single solve; wall times beside phases 11-12.
 23. the recorder (`utils/profiling.py`) on the loop path over TRACE_T
     frames of the long circuit: the traced run's poses bit for bit the
     untraced run's, each keyframe frame's device spans positive and
     within its host-to-synchronize window, and with the recorder off
     each graph's kernels per replay those of a capture with every
     recorder call stubbed out (`tests/torch_tracing.py` runs it alone).

Phases 2, 3 and 6 also check the sizes the kernels once refused (kernel
A's windows 21 and 31, kernel B at 2048 points, kernel C's patch 21) and
time them. The last lines are the kernel table (JSON), the nvidia-smi
line, and {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
NVLINK_BYTES_PER_S = 450e9  # H100 SXM data sheet, each way
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores

# stated tolerances of the kernel-vs-plain comparisons (see PERF.md)
LK_POS_TOL = 1e-2        # px, points whose frozen/left_win/solvable agree
LK_FLAG_AGREE = 0.99     # share of points with identical flags per launch
POSE_T_TOL = 1e-3        # max |T_kernel - T_plain|, every start and the chosen
POSE_INLIER_AGREE = 0.99  # share of equal inlier flags, every start
POSE_COST_TOL = 1e-4     # relative robust-cost difference, every start
POSE_STEP_TOL = 1e-4     # max |T_kernel - T_plain| after one LM step
# a path launch over POSE_T_TOL is replayed: the plain version takes the
# kernel's decisions (`follow`) and is held to POSE_T_TOL again, and each of
# its own decisions that differs must be a float32 tie: an acceptance whose
# two costs are within POSE_ACC_TIE of each other (relative; a sum of a few
# hundred float32 terms is good to ~1e-6 of it), an inlier whose chi2 is
# within POSE_LEVEL_TIE of the threshold (relative)
POSE_ACC_TIE = 1e-5
POSE_LEVEL_TIE = 1e-3
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
# phase 10: kernel D's owner form on the card, phase 10's 8 ranks standing
# for OWNED_CARDS cards of 2 ranks (the 8-rank mesh over 4 cards)
OWNED_CARDS = 4
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
# phase 19 (a): two processes on the one card, each joined by gloo; the
# payload of kernel D across them (phase 11's shape) from DIST_SEED, timed
# over DIST_RING_REPS calls; the workers are killed after DIST_TIMEOUT_S.
# The two-process BA against phase 11's one-process runs: "ring" within
# SHARD_RING_TOL (its reduction is kernel D's fold, bit for bit; measured
# equal), "xla" within SHARD_CPU_TOL, phase 11's tolerance for the same
# float32 sums in another order: its dp sum adds each process's two ranks
# and then the processes' partials, where one process adds four ranks in
# turn (measured 5.9e-5 on the poses, 1.4e-3 m at 37 m, H100)
DIST_PROCS, DIST_SEED, DIST_RING_REPS, DIST_TIMEOUT_S = 2, 19, 20, 300
# phase 22: the per-rank route (one device per rank in one process) with
# its ranks on the one card
PER_RANK_RANKS = 4
# sizes the kernels once refused (kernel A's window above 15, kernel C's
# patch above 11, kernel B's points above 1024), checked in phases 2, 3, 6
WIDE_WINS, WIDE_R, WIDE_F = (21, 31), 21, 2048
LONG_T = 480     # the bench's multi-lap circuit (benchmarks/render_scene.py)
# phase 14: the classic CLI run's kernel A and B launches held over its
# first frames; the fused run checkpointed every 50 frames (the last
# checkpoint, at frame 100, is resumed)
CLI_HOLD_FRAMES = 30
CLI_CHECKPOINT_EVERY = 50
# phase 15: the chunked modes. (a) holds the chunked loop path to the eager
# one over the circuit's first frames (two chunks of 8, one padded row):
# float state within CHUNK_STATE_TOL relative to max(1, |value|) (landmarks
# lie up to 300 m deep), integers and flags equal; (d) holds PGO's graph
# to the eager solve within PGO_GRAPH_TOL, relative the same way.
CHUNK_HOLD_FRAMES = 15
CHUNK_STATE_TOL = 1e-5
PGO_GRAPH_TOL = 1e-6
CHUNK_PROFILE_FRAMES = 32
# phase 16: the dense tool on phase 14's fused run. (a) card against the
# card machine's CPU on the first keyframe: texture-gate and SOR-threshold
# margins as tests/test_torch_stereo_bm.py and test_torch_sor.py state
# them, points within 1e-5 relative; (c) the share of kept points within
# ARENA_BAND of the arena's ground plane or wall
DENSE_GATE_MARGIN = 1e-5
DENSE_KEEP_MARGIN = 1e-4
DENSE_POINT_RTOL = 1e-5
ARENA_BAND = 0.5          # m
ARENA_GROUND_Y, ARENA_CENTER, ARENA_RADIUS = 1.7, (0.0, 6.0), 25.0
DENSE_BATCH = 4
# phase 17: MobileNet-V2 on the card against the CPU (the tolerances of
# tests/test_torch_mobilenet.py against the reference)
MNV2_COS_MIN = 0.999
MNV2_EMB_TOL = 5e-3
# phase 16 (c): the JAX package's dense cloud of the card's fused run's 34
# keyframes, on the CPU, keeps 96.84% of its points on the arena (96.57% at
# the 33 keyframes of the port's CPU run; tests/torch_slice9_reference.py
# --dense; the port on the card 96.77%); the packages differ only in SOR
# decisions at the threshold and what follows from them, so the gate sits
# below both
DENSE_ARENA_MIN = 0.95
# phase 20: the reference's loop-scene scenarios (tests/test_loop_scenes.py,
# test_hard_scene.py, test_long_sequence.py) with their settings, capacities
# and assertions; every loop scenario through the chunked loop path, the
# hard scene also eager, its kernel A and B launches recorded and held
SCEN_MAX_KF, SCEN_MAX_LM = 256, 1 << 15
SCEN_CHUNK = 8
# phase 21: PlaceNet training at the tool's defaults; the loss's first and
# last LOSS_WINDOW steps are compared
LOSS_WINDOW = 100


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


def host_ms(fn, reps: int) -> float:
    """Host time per call of fn() back to back, without waiting for the
    device (the wrapper's own time, as long as the queue does not fill)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call of fn() back to back, the device's work alone:
    a sleep kernel holds the stream until all reps calls are queued, so the
    host's time per call does not show."""
    import torch
    ahead = host_ms(fn, reps) * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * ahead * 2e6))   # cycles; clocks <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Device time of fn() with a cold L2: before each timed call 128 MB
    are written and another 128 MB read (so the 50 MB L2 holds clean lines
    of neither fn's inputs nor its outputs), then a sleep kernel holds the
    stream while fn() is queued; CUDA events around fn() only."""
    import torch
    wipe = torch.empty(2, 32 << 20, dtype=torch.float32, device="cuda")
    ahead = host_ms(fn, 3)
    total = 0.0
    for _ in range(reps):
        wipe[0].fill_(1.0)
        wipe[1].sum()
        torch.cuda._sleep(int(3 * ahead * 2e6))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_times(call, reps: int = 50) -> dict:
    """A kernel row's timing columns for `call`: CUDA events around reps
    back-to-back calls (`ms`, the host's pace wherever the wrapper's host
    time is the larger), the kernel alone behind a sleep kernel
    (`device_ms`), with the L2 flushed (`cold_ms`), and the wrapper's host
    time per call (`host_ms`)."""
    return dict(ms=cuda_ms(call, reps), device_ms=device_ms(call, reps),
                cold_ms=cuda_ms_cold(call, 20), host_ms=host_ms(call, reps))


def times_line(t: dict) -> str:
    return (f"{t['ms']:.4f} ms per call back to back, the kernel alone "
            f"{t['device_ms']:.4f} ms warm, {t['cold_ms']:.4f} ms cold (L2 "
            f"flushed), host time {t['host_ms']:.4f} ms per call")


def one_launch(fn, kernel: str, module, reps: int = 5) -> None:
    """Gate that each call of fn() launches `kernel` once and does nothing
    else on the device: the wrapper's launch counter (`module.launch_count`)
    moves by one per call; the only PyTorch operators it reaches allocate
    or make views (a TorchDispatchMode sees every one: no fill, memset, copy
    or read back); torch's sync debug mode raises on any operation that
    waits for the device. torch.profiler's record of the device work of
    `reps` calls is printed, and gated where it recorded any: only
    `kernel`, at most `reps` launches. The profiler drops records of these
    ctypes launches at times (it has recorded none of kernel D's, and 0 to
    4 of 5 of kernel C's on an H100), so a short count is printed, not
    failed: the launch counter above is the count that is gated."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = {}

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func)] = func
            return func(*args, **(kwargs or {}))

    def moves_no_data(func) -> bool:
        # an allocation, or a view (an input aliased, not written)
        return (func.overloadpacket.__name__ in
                ("empty", "empty_like", "empty_strided")
                or any(a.alias_info is not None and not a.alias_info.is_write
                       for a in func._schema.arguments))

    fn()
    torch.cuda.synchronize()
    before = module.launch_count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with Ops():
                for _ in range(reps):
                    fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    launched = module.launch_count - before
    work = {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    other = sorted(op for op, func in ops.items() if not moves_no_data(func))
    print(f"{reps} calls of {kernel}: {launched} launches, operators "
          f"{sorted(ops)}, no synchronising operation; the profiler's "
          f"device work {work}")
    check(launched == reps, f"{reps} calls of {kernel} launched it "
          f"{launched} times")
    check(not other, f"a call of {kernel} reaches operators {other}")
    check(not work or (len(work) == 1 and kernel in next(iter(work))
                       and sum(work.values()) <= reps),
          f"{reps} calls of {kernel} ran {work} on the device")
    if work and sum(work.values()) < reps:
        print(f"  the profiler recorded {sum(work.values())} of the {reps} "
              f"launches of {kernel}")


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ring_least_ms(mesh_axes, axis: str, rows: int, card_of_rank, card: int,
                  launches: int = 1):
    """Kernel D's least time on `card` for one call at `rows` x 128 float32
    a rank, shared evenly by the `launches` launches made there (processes
    sharing the card): (ms, "bytes" or "operations", what bounds it).
    card_of_rank[r] is rank r's card. The function's least work on the
    card: it reads each of its ranks' inputs and writes each of their
    outputs once in its memory; for each ring spread over M >= 2 cards it
    takes in and sends out 2 (M - 1) / M of a rank over NVLink (the ring's
    per-card partial sums reduce-scattered, then all-gathered: the least
    that an all-reduce adding at the end points moves); and it does its
    share, 1 / M, of the ring's n - 1 additions per element."""
    names = [name for name, _ in mesh_axes]
    sizes = [size for _, size in mesh_axes]
    a = names.index(axis)
    n, stride = sizes[a], math.prod(sizes[a + 1:])
    floats = rows * 128
    own = sum(1 for c in card_of_rank if c == card)
    link, flops = 0.0, 0.0
    for ring in range(len(card_of_rank) // n):
        base = (ring // stride) * n * stride + ring % stride
        cards = {card_of_rank[base + q * stride] for q in range(n)}
        if card in cards:
            M = len(cards)
            link += 2 * (M - 1) / M * 4 * floats
            flops += (n - 1) * floats / M
    t = max((2 * own * 4 * floats / HBM_BYTES_PER_S, "bytes", "HBM"),
            (link / NVLINK_BYTES_PER_S, "bytes", "NVLink"),
            (flops / FP32_FLOP_PER_S, "operations", "float32"))
    return t[0] * 1e3 / launches, t[1], t[2]


def check_lk(rendered, dev):
    """Kernel A (`lk_pyramid`, every level of one LK call in one launch)
    against its plain version on one frame-to-frame call (G = 1) and one
    batched call (G = 2): each level's rows against `lk_level_plain` fed the
    meta rebuilt from the kernel's own rows at the level above
    (`replay_levels`), and the whole call's positions and status against
    the plain level loop. Times per call, the plain time and the bound."""
    import torch
    from stereovision_slam_torch.ops import gftt, image as imops, lk_lanes

    lefts, rights = rendered
    L0, L1 = (imops.build_pyramid(torch.as_tensor(lefts[i], device=dev), 4)
              for i in (0, 1))
    R1 = imops.build_pyramid(torch.as_tensor(rights[1], device=dev), 4)
    pts, valid, _ = gftt.detect(L0[0], max_corners=256, min_distance=20)
    kw = dict(max_iters=12)
    g1 = ([lv[None] for lv in L0], [lv[None] for lv in L1], pts[None],
          pts[None], valid[None])
    uv_a, st_a, _ = lk_lanes.lk_pyramid(*g1, **kw)
    guess_r = uv_a[0] - torch.tensor([12.0, 0.0], device=dev)
    g2 = ([torch.stack([a, b]) for a, b in zip(L0, L1)],
          [torch.stack([a, b]) for a, b in zip(L1, R1)],
          torch.stack([pts, uv_a[0]]), torch.stack([uv_a[0], guess_r]),
          torch.stack([valid, valid & st_a[0]]))
    err, rows_by_call = 0.0, {}
    for label, args in (("G=1", g1), ("G=2", g2)):
        e, rows = hold_lk_call(label, args, kw)
        err = max(err, e)
        rows_by_call[label] = (args, rows)
    # one launch per call; the table row is the G = 2 call
    for label, (args, rows) in rows_by_call.items():
        call = lambda: lk_lanes.lk_pyramid(*args, **kw)
        if label == "G=2":
            one_launch(call, "lk_pyramid", lk_lanes)
        ms, dev_ms, wrap_ms = cuda_ms(call, 50), device_ms(call, 50), \
            host_ms(call, 50)
        plain_ms = cuda_ms(lambda: lk_lanes.lk_pyramid_plain(*args, **kw), 3)
        b, by = lk_bound(args, rows, 11)
        print(f"kernel A {label} (n={rows.shape[1]}, {rows.shape[0]} "
              f"levels): {ms:.4f} ms per call back to back (one launch; "
              f"CUDA events), the kernel alone {dev_ms:.4f} ms, host time "
              f"{wrap_ms:.4f} ms per call; plain {plain_ms:.3f} ms, bound "
              f"{b:.6f} ms ({by})")
    # the windows once above kernel A's cap (15): OpenCV's default 21, and
    # 31, whose warps need more than 48 KB of shared memory; the G = 2 call
    wide = {}
    for win in WIDE_WINS:
        kw_w = dict(kw, win_size=win)
        e, rows = hold_lk_call(f"G=2 win {win}", g2, kw_w)
        err = max(err, e)
        call = lambda: lk_lanes.lk_pyramid(*g2, **kw_w)
        t = kernel_times(call)
        t["plain_ms"] = cuda_ms(lambda: lk_lanes.lk_pyramid_plain(*g2, **kw_w),
                                3)
        t["bound_ms"], t["bound_by"] = lk_bound(g2, rows, win)
        wide[f"win{win}"] = t
        print(f"kernel A G=2 win {win} (n={rows.shape[1]}): {times_line(t)}; "
              f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")
    return dict(name="lk_pyramid", route="cuda",
                source="stereovision_slam_torch/csrc/lk_pyramid.cu",
                replaces="stereovision_slam_tpu/ops/lk_lanes.py:112",
                max_abs_err=err, ms=ms, device_ms=dev_ms, host_ms=wrap_ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                wide=wide)


def lk_bound(args, rows, win: int):
    """Kernel A's bound for one call: every level's two images read once;
    points, initial points and masks in; positions, status and the
    per-level rows out; per point and level the template and gradients
    (~95 operations a pixel) and 12 a pixel for each iteration this call
    took."""
    L, n = rows.shape[:2]
    nbytes = (4 * sum(t.numel() for t in args[0] + args[1])
              + n * (4 * 2 + 4 * 2 + 1) + n * (4 * 2 + 1) + 4 * rows.numel())
    flops = (L * n * 95.0 + float(rows[:, :, 5].sum()) * 12.0) * win * win
    return bound_ms(nbytes, flops)


def lk_level_gaps(rows, replay):
    """Per level of one kernel A call against its replay: (share of points
    whose flags agree, largest position error where they agree)."""
    import torch

    out = []
    for k, p in zip(rows, replay):
        flags_eq = (k[:, 2:5] == p[:, 2:5]).all(dim=1)
        e = (k[:, :2] - p[:, :2]).abs().amax(dim=1)
        e = e[flags_eq & torch.isfinite(e)]
        out.append((float(flags_eq.float().mean()),
                    float(e.max()) if e.numel() else 0.0))
    return out


def hold_lk_call(label: str, args, kw) -> tuple[float, object]:
    """Kernel A on one call: each level's rows against `lk_level_plain` fed
    the meta rebuilt from the kernel's rows at the level above
    (`replay_levels`), and the whole call against the plain level loop.
    Returns (the largest position error, the kernel's rows)."""
    import torch
    from stereovision_slam_torch.ops import lk_lanes

    uv, st, rows = lk_lanes.lk_pyramid(*args, **kw)
    replay = lk_lanes.replay_levels(*args, rows, **kw)
    uv_p, st_p = lk_lanes.track_grouped_lanes(
        *args, level_fn=lk_lanes.lk_level_plain, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for level, (agree, e) in reversed(list(enumerate(lk_level_gaps(
            rows, replay)))):
        err = max(err, e)
        print(f"kernel A {label} level {level} (n={rows.shape[1]}): flags "
              f"agree {agree:.4f}, max pos err {e:.3e} px")
        check(agree >= LK_FLAG_AGREE and e <= LK_POS_TOL,
              f"kernel A {label} level {level} disagrees with its plain "
              f"version: {agree}, {e}")
    agree = float((st == st_p).float().mean())
    both = st & st_p
    e = float((uv - uv_p).abs()[both].max()) if bool(both.any()) else 0.0
    err = max(err, e)
    print(f"kernel A {label} whole call: status agrees on {agree:.4f} of "
          f"the points ({int(st.sum())} / {int(st_p.sum())} tracked), "
          f"max pos err {e:.3e} px where both track")
    check(agree >= LK_FLAG_AGREE and e <= LK_POS_TOL,
          f"kernel A's {label} call disagrees with the plain level loop: "
          f"{agree}, {e}")
    return err, rows


def pose_problem(dev, seed: int = 0, F: int = 256):
    """Kernel B's inputs at the main path's shape (S = 3 starts, F = 256
    points) or with F points."""
    import numpy as np
    import torch
    from stereovision_slam_torch.geometry import jacobians, se3
    from stereovision_slam_torch.scenes import make_stereo_rig

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


def pose_args(dev, seed: int = 0, F: int = 256):
    """(camp, pts, uv_l, uv_r, valid_l, valid_r, T0): kernel B's inputs for
    one stream."""
    from stereovision_slam_torch.ops import pose_kernel as pk

    left, right, T0, pts, uv_l, uv_r, vl, vr = pose_problem(dev, seed, F)
    return (pk.camera_block(left, right), pts.contiguous(),
            uv_l.contiguous(), uv_r.contiguous(), vl, vr, T0.contiguous())


def hold_pose(k, p, tol: float, label: str) -> float:
    """Gates kernel B's `PoseSolve` k against the plain version's p: every
    (stream, start) within tol on T, POSE_INLIER_AGREE of the inliers and
    POSE_COST_TOL on the cost; the chosen start is the kernel's own argmin
    (its T, inliers and left count are its per-start outputs there) and its
    T within tol of the plain version's chosen T (the starts may converge
    to one cost, so the two argmins may differ). Returns the largest T
    error."""
    import torch

    torch.cuda.synchronize()
    lead = k.cost.shape[:-1]
    T_all, inl_all, cost = (x.reshape(-1, *x.shape[len(lead):])
                            for x in (k.T_all, k.inl_all, k.cost))
    best = torch.argmin(cost, dim=-1)
    rows = torch.arange(best.numel(), device=best.device)
    own = (torch.equal(k.T.reshape(-1, 3, 4), T_all[rows, best])
           and torch.equal(k.inlier.reshape(len(rows), -1),
                           inl_all[rows, best].reshape(len(rows), -1))
           and torch.equal(k.n_inliers.reshape(-1),
                           inl_all[rows, best, 0].sum(-1).int()))
    t_err = float((k.T_all - p.T_all).abs().max())
    agree = float((k.inl_all == p.inl_all).float().mean(dim=(-2, -1)).min())
    c_err = float(((k.cost - p.cost).abs() / p.cost.abs().clamp(min=1.0)).max())
    chosen = float((k.T - p.T).abs().max())
    print(f"kernel B {label}: max |T| err {t_err:.3e} over every (stream, "
          f"start), inlier agree >= {agree:.4f}, cost err {c_err:.3e}; "
          f"chosen start {best.tolist()} (plain "
          f"{torch.argmin(p.cost, dim=-1).reshape(-1).tolist()}), its T err "
          f"{chosen:.3e}, its outputs its own start's: {own}")
    check(t_err <= tol and agree >= POSE_INLIER_AGREE
          and c_err <= POSE_COST_TOL and chosen <= tol and own,
          f"kernel B {label} disagrees with its plain version")
    return max(t_err, chosen)


def check_pose_streams(dev) -> dict:
    """Kernel B over (B, S) = (4, 3): every (stream, start) and the chosen
    one against the plain version after one LM step (the starts still
    apart) and at the end. Returns the kernel's timing columns at that
    shape."""
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    per = [pose_args(dev, seed) for seed in range(SERVE_B)]
    args = (per[0][0], *(torch.stack(x).contiguous()
                         for x in list(zip(*per))[1:]))
    for kw, tol in ((dict(rounds=1, iters=1), POSE_STEP_TOL),
                    (dict(rounds=3, iters=6), POSE_T_TOL)):
        hold_pose(pk.pose_lm(*args, chi2_th=5.991, **kw),
                  pk.pose_lm_plain(*args, chi2_th=5.991, **kw), tol,
                  f"(B, S) = ({SERVE_B}, 3), {kw}")
    t = kernel_times(lambda: pk.pose_lm(*args, chi2_th=5.991, rounds=3,
                                        iters=6))
    print(f"kernel B (B, S) = ({SERVE_B}, 3), F = 256: {times_line(t)}")
    return t


def check_pose(dev):
    """Kernel B at the slice's shape (S = 3, F = 256, 3 x 6 steps): every
    start and the chosen one against the plain version, then after one LM
    step; one `solve_pose_multi_lr` call gated to one launch; times."""
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    args = pose_args(dev)
    k, p = pk.pose_lm(*args, **kw), pk.pose_lm_plain(*args, **kw)
    err = hold_pose(k, p, POSE_T_TOL, "(B, S) = (1, 3)")
    for s in range(k.cost.shape[0]):
        print(f"kernel B start {s}: cost {float(k.cost[s]):.4f}/"
              f"{float(p.cost[s]):.4f} inliers "
              f"{int(k.inl_all[s].sum())}/{int(p.inl_all[s].sum())}")
    # all starts converge to one pose, so a start that read another start's
    # input would pass the check above; after one LM step they are still
    # apart, and each must match its own plain counterpart
    one = dict(chi2_th=5.991, rounds=1, iters=1)
    T1p = pk.pose_lm_plain(*args, **one).T_all
    step_err = hold_pose(pk.pose_lm(*args, **one), pk.pose_lm_plain(
        *args, **one), POSE_STEP_TOL, "(B, S) = (1, 3) after one step")
    apart = min(float((T1p[a] - T1p[b]).abs().max())
                for a in range(len(T1p)) for b in range(a))
    print(f"kernel B one step: max |T| err {step_err:.3e}, starts apart by "
          f"at least {apart:.3e}")
    check(apart > 10 * POSE_STEP_TOL, "kernel B's starts after one step are "
          "not apart")
    camp, pts, uv_l, uv_r, vl, vr, T0 = args
    one_launch(lambda: pk.solve_pose_multi_lr(camp, T0, pts, uv_l, uv_r, vl,
                                              vr, **kw), "pose_lm", pk)
    t = kernel_times(lambda: pk.pose_lm(*args, **kw))
    plain_ms = cuda_ms(lambda: pk.pose_lm_plain(*args, **kw), 3)
    S, F = T0.shape[0], pts.shape[0]
    b, by = pose_bound(args, k, kw)
    print(f"kernel B (B, S) = (1, {S}), F = {F}: {times_line(t)}; plain "
          f"{plain_ms:.3f} ms, bound {b:.6f} ms ({by})")
    # F = WIDE_F, past the 1024 points the kernel stages in shared memory
    # (the layout that reads its observations from global memory)
    args_w = pose_args(dev, F=WIDE_F)
    for kw_w, tol in ((one, POSE_STEP_TOL), (kw, POSE_T_TOL)):
        k_w = pk.pose_lm(*args_w, **kw_w)
        err = max(err, hold_pose(k_w, pk.pose_lm_plain(*args_w, **kw_w), tol,
                                 f"(B, S) = (1, 3), F = {WIDE_F}, "
                                 f"{kw_w['rounds']} x {kw_w['iters']}"))
    t_w = kernel_times(lambda: pk.pose_lm(*args_w, **kw))
    t_w["plain_ms"] = cuda_ms(lambda: pk.pose_lm_plain(*args_w, **kw), 3)
    t_w["bound_ms"], t_w["bound_by"] = pose_bound(args_w, k_w, kw)
    print(f"kernel B (B, S) = (1, 3), F = {WIDE_F}: {times_line(t_w)}; plain "
          f"{t_w['plain_ms']:.3f} ms, bound {t_w['bound_ms']:.6f} ms "
          f"({t_w['bound_by']})")
    return dict(name="pose_lm", route="cuda",
                source="stereovision_slam_torch/csrc/pose_lm.cu",
                replaces="stereovision_slam_tpu/ops/pose_pallas.py:38",
                max_abs_err=max(err, step_err), **t, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                wide={f"F{WIDE_F}": t_w})


def check_ba(dev) -> dict:
    """Phase 3b: the BA kernel against the plain route on each window of
    tests/torch_ba_cases.py (one launch a pass, the module's tolerances,
    every solved landmark and the watched ones by name), then its times at
    the cell's shapes, the plain route's and the bound
    (`tests.torch_ba_cases.bound_ms`). Returns the kernel's row:
    `max_abs_err` the largest landmark gap (m) to the plain route, `cases`
    each window's accept decisions, ties and largest gaps to the plain
    route and to the float64 pass (`hold`'s)."""
    from stereovision_slam_torch.slam import backend
    from tests import torch_ba_cases as bc

    windows = bc.bases(dev)
    cases = {}
    for name in bc.CASES:
        m, cl, cr, kw, watch = bc.case(windows, name)
        try:
            held = bc.hold(m, cl, cr, kw, watch)
        except AssertionError as e:
            check(False, f"BA kernel, window {name}: {e}")
        print(f"BA kernel {name}: {held}")
        check(bc.held(held), f"BA kernel, window {name}: {held}")
        cases[name] = {k: held[k] for k in (
            "accepts", "flips", "tie", "pose", "pose_f64", "pose_plain_f64",
            "lm", "lm_f64", "lm_plain_f64", "solved")}
    m, cl, cr, kw, _ = bc.case(windows, "cell")
    t = kernel_times(lambda: backend.optimize_window(m, cl, cr, **kw), 20)
    plain = cuda_ms(lambda: backend.optimize_window_plain(m, cl, cr, **kw), 5)
    b, by = bc.bound_ms(m, kw)
    print(f"BA kernel at the cell's shapes: {times_line(t)}; plain "
          f"{plain:.3f} ms, bound {b:.6f} ms ({by})")
    return dict(name="ba_window", route="cuda",
                source="stereovision_slam_torch/csrc/ba_window.cu",
                replaces="none (stereovision_slam_tpu/slam/backend.py "
                         "optimize_window is plain XLA)",
                max_abs_err=max(c["lm"] for c in cases.values()), **t,
                plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                cases=cases)


def pose_bound(args, out, kw):
    """Kernel B's bound for one call: inputs read and outputs written once;
    per valid observation and pass (rounds x (iters + 1) + the final one)
    the projection, Jacobian and the 28 sums, ~240 operations."""
    S = args[6].shape[-3]
    passes = kw["rounds"] * (kw["iters"] + 1) + 1
    flops = S * passes * float(args[4].sum() + args[5].sum()) * 240.0
    nbytes = (sum(t_.numel() * t_.element_size() for t_ in args)
              + sum(o.numel() * o.element_size() for o in out))
    return bound_ms(nbytes, flops)


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


def slice_vo(lefts, rights, rig, device, cfg=None, cls=None, **kw):
    """An initialized `FusedVisualOdometry` (or `cls`) over the frames,
    the bench's settings unless `cfg`."""
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused import FusedVisualOdometry

    vo = (cls or FusedVisualOdometry)(
        cfg or bench_config(), ArraySequenceDataset(lefts, rights, list(rig)),
        max_total_keyframes=512, max_total_landmarks=1 << 16, device=device,
        **kw)
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


@contextlib.contextmanager
def recorded(records: list, max_b: int | None = None):
    """While active, every launch of kernel A (`lk_lanes.lk_pyramid`) and
    kernel B (`pose_kernel.pose_lm`) is recorded with its inputs (kept by
    reference: the path builds new tensors and changes none in place) and
    a copy of its outputs, so that `hold_recorded` can hold each to its
    plain version after the run without slowing the run down. With
    `max_b`, recording stops at the launch after the max_b-th kernel B
    launch (on a single-stream path, the first max_b tracked frames)."""
    from stereovision_slam_torch.ops import lk_lanes, pose_kernel

    kernel_a, kernel_b = lk_lanes.lk_pyramid, pose_kernel.pose_lm

    def full() -> bool:
        return max_b is not None and sum(r[0] == "B" for r in records) >= max_b

    def a(*args, **kw):
        out = kernel_a(*args, **kw)
        if not full():
            records.append(("A", args, kw, tuple(o.clone() for o in out)))
        return out

    def b(*args, **kw):
        out = kernel_b(*args, **kw)
        if not full():
            records.append(("B", args, kw,
                            type(out)(*(o.clone() for o in out))))
        return out

    lk_lanes.lk_pyramid, pose_kernel.pose_lm = a, b
    try:
        yield
    finally:
        lk_lanes.lk_pyramid, pose_kernel.pose_lm = kernel_a, kernel_b


def hold_recorded(records: list, label: str, lost_at: int):
    """Gates every recorded launch against its plain version on the same
    inputs: kernel A level by level against `replay_levels` (LK_FLAG_AGREE,
    LK_POS_TOL, as phase 2); kernel B on what the path reads from it. A
    frame whose left inliers are at most `lost_at` is LOST: the path drops
    its pose and reads only that count, so there kernel and plain version
    must both count at most `lost_at`. Elsewhere the chosen start's pose
    within POSE_T_TOL, its [left; right] inliers equal on POSE_INLIER_AGREE
    of the observations and every start's inliers too, the chosen outputs
    the kernel's own start's. A launch whose chosen pose or inliers miss
    that is launched again with its decisions traced (the same bits
    required) and replayed: the plain version follows those decisions and
    is held to the same tolerances, every start's pose included, and each
    decision of its own that differs must be a tie (POSE_ACC_TIE,
    POSE_LEVEL_TIE). Every start's pose and cost gaps are printed beside
    them, and the worst launches with, where the chosen pose is over
    POSE_T_TOL, the plain version's final robust cost at the kernel's pose
    relative to its cost at its own. Phase 3 holds every start on its own
    problem. Returns the largest kernel A and chosen kernel B errors (of
    the replay, where one ran) and the holds missed."""
    import torch
    from stereovision_slam_torch.ops import lk_lanes, pose_kernel

    a_agree, a_err, n_a, n_lost = 1.0, 0.0, 0, 0
    b_err, b_agree, s_err, s_cost, s_over, own = 0.0, 1.0, 0.0, 0.0, 0, True
    same_lost, worst, n_cost, c_gap = True, [], 0, 0.0
    replays, r_err, r_same, flips, acc_tie, lev_tie = 0, 0.0, True, 0, 0.0, 0.0
    for kind, args, kw, out in records:
        if kind == "A":
            n_a += 1
            replay = lk_lanes.replay_levels(*args, out[2], **kw)
            for agree, e in lk_level_gaps(out[2], replay):
                a_agree, a_err = min(a_agree, agree), max(a_err, e)
            continue
        p = pose_kernel.pose_lm_plain(*args, **kw)
        n_k, n_p = int(out.n_inliers.max()), int(p.n_inliers.max())
        e_T = float((out.T - p.T).abs().max())
        worst.append((e_T, len(worst), n_k, n_p))
        if max(n_k, n_p) <= lost_at:
            n_lost += 1
            continue
        same_lost = same_lost and min(n_k, n_p) > lost_at
        lead = out.cost.shape[:-1]
        T_all, inl_all, cost = (x.reshape(-1, *x.shape[len(lead):])
                                for x in (out.T_all, out.inl_all, out.cost))
        best = torch.argmin(cost, dim=-1)
        rows = torch.arange(best.numel(), device=best.device)
        own = (own and torch.equal(out.T.reshape(-1, 3, 4), T_all[rows, best])
               and torch.equal(out.inlier.reshape(len(rows), -1),
                               inl_all[rows, best].reshape(len(rows), -1)))
        agree = min(float((out.inlier == p.inlier).float().mean()),
                    float((out.inl_all == p.inl_all).float()
                          .mean(dim=(-2, -1)).min()))
        if e_T > POSE_T_TOL or agree < POSE_INLIER_AGREE:
            # a decision taken on a tie, or a fault: replay the kernel's
            # decisions in the plain version
            tr, fol = {}, {}
            again = pose_kernel.pose_lm(*args, **kw, trace=tr)
            r_same = r_same and all(torch.equal(x, y)
                                    for x, y in zip(again, out))
            p = pose_kernel.pose_lm_plain(*args, **kw, follow=tr, trace=fol)
            replays += 1
            flips += fol["acc_flips"] + fol["lev_flips"]
            acc_tie = max(acc_tie, fol["acc_tie"])
            lev_tie = max(lev_tie, fol["lev_tie"])
            e_T = float((out.T_all - p.T_all).abs().max())
            r_err = max(r_err, e_T)
            agree = min(float((out.inlier == p.inlier).float().mean()),
                        float((out.inl_all == p.inl_all).float()
                              .mean(dim=(-2, -1)).min()))
        b_err = max(b_err, e_T)
        if e_T > POSE_T_TOL:
            # the plain version's final cost at the kernel's chosen pose
            at_k = pose_kernel.pose_lm_plain(*args[:6], out.T[..., None, :, :],
                                             chi2_th=kw["chi2_th"], rounds=0,
                                             iters=0)
            own_c = p.cost.reshape(-1, p.cost.shape[-1]).min(dim=-1).values
            gap = float(((at_k.cost.reshape(-1) - own_c).abs()
                         / own_c.abs().clamp(min=1.0)).max())
            n_cost, c_gap = n_cost + 1, max(c_gap, gap)
            worst[-1] = worst[-1] + (gap,)
        b_agree = min(b_agree, agree)
        e = float((out.T_all - p.T_all).abs().max())
        s_err, s_over = max(s_err, e), s_over + (e > POSE_T_TOL)
        s_cost = max(s_cost, float(((out.cost - p.cost).abs()
                                    / p.cost.abs().clamp(min=1.0)).max()))
    n_b = len(worst)
    print(f"{label}: {n_a} kernel A launches held level by level, flags "
          f"agree >= {a_agree:.4f}, max pos err {a_err:.3e} px; {n_b} kernel "
          f"B launches, {n_lost} on LOST frames (<= {lost_at} left inliers "
          f"in both; the path drops their pose) and the others held: the "
          f"chosen pose within {b_err:.3e}, inliers (chosen and every "
          f"start's) agree >= {b_agree:.4f}, chosen outputs the kernel's own "
          f"start's: {own}, the LOST decision the same: {same_lost}; every "
          f"start's pose within {s_err:.3e} ({s_over} launches with a start "
          f"over {POSE_T_TOL}), costs within {s_cost:.3e}; {n_cost} chosen "
          f"poses over {POSE_T_TOL}, the plain cost there within {c_gap:.3e} "
          f"of its own; the largest chosen-pose gaps (gap, launch, left "
          f"inliers kernel/plain, cost gap): "
          + ", ".join(f"{w[0]:.2e} #{w[1]} {w[2]}/{w[3]}"
                      + (f" {w[4]:.2e}" if len(w) > 4 else "")
                      for w in sorted(worst, reverse=True)[:4])
          + f"; {replays} launches replayed with the kernel's decisions "
          f"(traced launch the same bits: {r_same}): every start within "
          f"{r_err:.3e}, {flips} decisions of the plain version's own "
          f"differ, acceptances within {acc_tie:.3e} of a tie (held to "
          f"{POSE_ACC_TIE}), inliers within {lev_tie:.3e} of the threshold "
          f"(held to {POSE_LEVEL_TIE})")
    failed = []
    if not (n_a > 0 and a_agree >= LK_FLAG_AGREE and a_err <= LK_POS_TOL):
        failed.append(f"{label}: kernel A disagrees with its plain version: "
                      f"{a_agree}, {a_err}")
    if not (n_b > 0 and b_err <= POSE_T_TOL and b_agree >= POSE_INLIER_AGREE
            and own and same_lost and r_same and acc_tie <= POSE_ACC_TIE
            and lev_tie <= POSE_LEVEL_TIE):
        failed.append(f"{label}: kernel B disagrees with its plain version: "
                      f"chosen pose {b_err:.3e}, inliers {b_agree:.4f}")
    return a_err, b_err, failed


def loop_config():
    """The bench's `make_config` settings with `PLACENET_LOOP_GATES`."""
    from stereovision_slam_torch.slam.config import PLACENET_LOOP_GATES

    cfg = bench_config()
    for k, v in PLACENET_LOOP_GATES.items():
        setattr(cfg, k, v)
    return cfg


def loop_phase(label: str, scene, counters, dev, place_params):
    """Phase 13: the bench's main path on one scene, `FusedLoopVisualOdometry`
    on "cuda" with the shipped PlaceNet weights, the launch counters set to
    0 before it; every kernel A and B launch recorded, then held to its
    plain version; shutdown PGO; the bench's gates. Returns (launches,
    kernel A error, kernel B error, the holds and gates missed), which
    main() gates after reporting everything."""
    import numpy as np
    import torch
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry)

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    vo = FusedLoopVisualOdometry(
        loop_config(), ArraySequenceDataset(lefts, rights, list(rig)),
        place_params=place_params, max_total_keyframes=512,
        max_total_landmarks=1 << 16, device=dev)
    vo.initialize()
    for mod in counters.values():
        mod.launch_count = 0
    records = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(records):
        vo.run()
    dt = time.perf_counter() - t0
    launches = {k: m.launch_count for k, m in counters.items()}
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])
    inserted = sum(bool(f.kf_inserted) for _, f in frames)

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    errs = [np.linalg.norm(center(p) - center(gt[f]))
            for f, p in sorted(keyframes.values())]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    edges = vo.loop_edges()
    # the bench's warm_pgo: PGO's graph captured at this size off the clock
    t0 = time.perf_counter()
    vo.warm_pgo(kf_hint=len(keyframes))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj = vo.run_pgo()
    torch.cuda.synchronize()
    pgo_s = time.perf_counter() - t0
    errs = [np.linalg.norm(center(np.asarray(p)) - center(gt[f]))
            for f, p in traj.items()]
    ate_pgo = float(np.sqrt(np.mean(np.square(errs))))
    tracked = T - 1
    print(f"loop {label}: {T} frames in {dt:.3f} s = {T / dt:.2f} fps (host "
          f"clock, ends in synchronize; PlaceNet, loop hook), "
          f"{len(keyframes)} keyframes, {len(landmarks)} landmarks, "
          f"{len(edges)} loops {[(e.kf_id, e.loop_kf_id) for e in edges]}, "
          f"keyframe ATE {ate:.4f} m, after PGO {ate_pgo:.4f} m over "
          f"{dist:.1f} m ({100 * ate_pgo / dist:.3f}%), pgo_s {pgo_s:.3f} "
          f"(PGO graphs captured {vo.pgo.runner.captures}, replays "
          f"{vo.pgo.replays} with warm_pgo's; warm_pgo {warm_s:.3f} s off "
          f"the clock), "
          f"hook host reads {vo.hook_reads} over {inserted - 1} hooked "
          f"keyframes; launches {launches} for {tracked} tracked frames and "
          f"{inserted} keyframe steps")
    a_err, b_err, failed = hold_recorded(records, f"loop {label}",
                                         vo.cfg.num_features_tracking_bad)
    want_a = 2 * tracked + inserted        # one launch per LK call
    check(launches["lk_pyramid"] == want_a,
          f"loop {label}: kernel A launched {launches['lk_pyramid']} times, "
          f"not {want_a}")
    check(launches["pose_lm"] == tracked,
          f"loop {label}: kernel B launched {launches['pose_lm']} times, "
          f"not {tracked}")
    check(vo.hook_reads <= 2 * (inserted - 1),
          f"loop {label}: {vo.hook_reads} hook host reads")
    check(launches["ba_window"] == inserted - 1,
          f"loop {label}: the BA kernel launched {launches['ba_window']} "
          f"times, not {inserted - 1} (a pass a keyframe step after the "
          f"initialization)")
    # the bench's gates (bench.py:226-269), every failure listed
    gates = {
        f"{len(keyframes)} keyframes, {len(landmarks)} landmarks":
            len(keyframes) >= 2 and len(landmarks) > 50,
        f"tracking collapsed: n_inliers down to {n_in[1:].min()}":
            bool(np.all(n_in[1:] > 10)),
        "ATE not finite": bool(np.isfinite(ate) and np.isfinite(ate_pgo)),
        "no loop closed": len(edges) >= 1,
        f"ATE after PGO {ate_pgo:.4f} m is not under 2% of {dist:.1f} m":
            ate_pgo < 0.02 * dist,
        f"PGO degraded the trajectory: {ate_pgo:.4f} > {ate:.4f} m":
            ate_pgo <= ate + 1e-6}
    missed = [f"loop {label}: {msg}" for msg, ok in gates.items() if not ok]
    print(f"loop {label}: the bench's gates "
          + ("met" if not missed else "MISSED: " + "; ".join(missed)))
    info = dict(fps=T / dt, ms=1e3 * dt / T, keyframes=len(keyframes),
                loops=len(edges), ate=ate, ate_pgo=ate_pgo, pgo_s=pgo_s,
                poses=np.stack([f.pose for _, f in frames]))
    return launches, a_err, b_err, failed + missed, info


def write_png(path: str, img) -> None:
    """An 8-bit PNG of a (H, W) greyscale or (H, W, 3) RGB uint8 array:
    filter 0 on every row, zlib level 1."""
    import struct
    import zlib

    import numpy as np

    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    colour = 2 if img.ndim == 3 else 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def arena_share(points) -> float:
    """The share of points within ARENA_BAND of the circuit arena's ground
    plane (y = 1.7) or cylindrical wall (radius 25 about x, z = 0, 6)."""
    import numpy as np

    p = np.asarray(points, np.float64)
    if not len(p):
        return 0.0
    wall = np.abs(np.hypot(p[:, 0] - ARENA_CENTER[0],
                           p[:, 2] - ARENA_CENTER[1]) - ARENA_RADIUS)
    ground = np.abs(p[:, 1] - ARENA_GROUND_Y)
    return float(np.mean((wall <= ARENA_BAND) | (ground <= ARENA_BAND)))


def rgb_frames(seq):
    """(T, H, W, 3) uint8 colour frames of a greyscale sequence whose three
    channels differ: (0.9 q + 20, q, 1.1 q - 20) of the rounded frame q,
    rounded and clipped, so their mean is q up to the clipping."""
    import numpy as np

    q = np.clip(np.rint(seq), 0, 255)
    return np.stack([np.clip(np.rint(0.9 * q + 20.0), 0, 255), q,
                     np.clip(np.rint(1.1 * q - 20.0), 0, 255)],
                    axis=-1).astype(np.uint8)


def write_kitti_sequence(root: str, lefts, rights, rig):
    """The scene as a KITTI sequence at full resolution: image_0 / image_1
    greyscale and image_2 / image_3 colour (`rgb_frames`) PNGs with every
    pixel of the rounded frame doubled (the loader's 2x nearest-neighbour
    decimation gives the frame back), and a calib.txt of the rig at full
    resolution (P1 and P3 with tx = -fx b). Returns the rounded (T, H, W)
    uint8 frames, left and right."""
    import numpy as np

    left, right = rig
    fx, fy, cx, cy = (2.0 * float(v) for v in (left.fx, left.fy, left.cx,
                                               left.cy))
    b = float(right.baseline)
    rows = [f"P{i}: {fx!r} 0 {cx!r} {-fx * b if i % 2 else 0.0!r} 0 {fy!r} "
            f"{cy!r} 0 0 0 1 0" for i in range(4)]
    os.makedirs(root)
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    out = []
    for sub, seq in (("image_0", lefts), ("image_1", rights)):
        os.makedirs(os.path.join(root, sub))
        q = np.clip(np.rint(seq), 0, 255).astype(np.uint8)
        for i, img in enumerate(q):
            write_png(os.path.join(root, sub, f"{i:06d}.png"),
                      np.repeat(np.repeat(img, 2, axis=0), 2, axis=1))
        out.append(q)
    for sub, seq in (("image_2", lefts), ("image_3", rights)):
        os.makedirs(os.path.join(root, sub))
        for i, img in enumerate(rgb_frames(seq)):
            write_png(os.path.join(root, sub, f"{i:06d}.png"),
                      np.repeat(np.repeat(img, 2, axis=0), 2, axis=1))
    return out


def cli_phase(scene, counters, dev, tmp: str):
    """Phase 14: the command line on a KITTI sequence. The circuit written
    as a KITTI directory and read back by the loader; then
    `apps.run_slam` on "cuda" with the bench's settings and
    `PLACENET_LOOP_GATES`: classic (its first CLI_HOLD_FRAMES frames' kernel
    A and B launches held to their plain versions), fused, fused with
    checkpoints every CLI_CHECKPOINT_EVERY frames and a resume from the
    last one (its keyframes.txt held to the uninterrupted fused run's), and
    a fused run with the config's default (MobileNet-tuned) loop gates, a
    finding only. The counters are set to 0 before each run. The sequence
    and the runs' outputs go under `tmp`, which the caller removes.
    Returns ({path: launches}, kernel A error, kernel B error, the holds
    and gates missed, {"sequence": the KITTI folder, "fused": the fused
    run's output folder}), which main() gates after reporting
    everything."""
    import dataclasses
    import numpy as np
    import torch
    import yaml
    from stereovision_slam_torch.apps import run_slam
    from stereovision_slam_torch.io.kitti import KittiDataset
    from stereovision_slam_torch.slam.config import SlamConfig
    from stereovision_slam_torch.slam.outputs import load_keyframes_file

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    by_path, missed, a_err, b_err = {}, [], 0.0, 0.0

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    def ate(traj: dict) -> float:
        return float(np.sqrt(np.mean([
            np.sum(np.square(center(np.asarray(p)) - center(gt[f])))
            for f, p in traj.items()])))

    def config(name: str, gates: bool = True) -> str:
        cfg = loop_config() if gates else bench_config()
        if not gates:   # the config's default (MobileNet-tuned) loop gates
            base = SlamConfig()
            for k in ("potential_loop_strong_threshold",
                      "potential_loop_weak_threshold",
                      "max_num_weak_threshold",
                      "keyframes_to_skip_in_candidate_search",
                      "keyframes_to_ignore_after_loop",
                      "min_num_acceptable_keypoint_match"):
                setattr(cfg, k, getattr(base, k))
        cfg.dataset_dir = seq
        cfg.output_dir = os.path.join(tmp, name)
        cfg.loopclosure_on = cfg.backend_on = cfg.visualizer_on = 1
        path = os.path.join(tmp, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(cfg), f)
        return path

    def cli(name: str, argv: list, hold: bool = False) -> dict:
        for mod in counters.values():
            mod.launch_count = 0
        records = []
        sync()
        t0 = time.perf_counter()
        with (recorded(records, max_b=CLI_HOLD_FRAMES - 1) if hold
              else contextlib.nullcontext()):
            summary = run_slam.run(run_slam.parse_args(
                [config(name, gates=name != "cli_default_gates"),
                 "--device", str(dev)] + argv))
        summary["wall_s"] = time.perf_counter() - t0
        summary["records"] = records
        by_path[name] = {k: m.launch_count for k, m in counters.items()}
        _, _, frames = load_keyframes_file(
            os.path.join(summary["output"], "keyframes.txt"))
        summary["final"] = {fid: pose for fid, pose in frames}
        return summary

    def report(name: str, r: dict, inliers, kf_steps: int) -> None:
        launches = by_path[name]
        ate_odo, ate_pgo = ate(r["odometry"]), ate(r["final"])
        print(f"{name}: {T} frames, {r['fps']:.2f} fps (the CLI's own clock; "
              f"wall {r['wall_s']:.1f} s with set-up, shutdown and output), "
              f"{len(r['final'])} keyframes, {r['loops']} loops, keyframe ATE "
              f"{ate_odo:.4f} m, after PGO {ate_pgo:.4f} m over {dist:.1f} m "
              f"({100 * ate_pgo / dist:.3f}%), pgo_s {r['pgo_s']:.3f}; "
              f"launches A {launches['lk_pyramid']}, B {launches['pose_lm']}"
              f" for {T - 1} tracked frames and {kf_steps} keyframe steps")
        gates = {
            f"tracking collapsed: n_inliers down to {min(inliers)}":
                min(inliers) > 10,
            "ATE not finite": bool(np.isfinite(ate_odo)
                                   and np.isfinite(ate_pgo)),
            "no loop closed": r["loops"] >= 1,
            f"ATE after PGO {ate_pgo:.4f} m is not under 2% of {dist:.1f} m":
                ate_pgo < 0.02 * dist,
            f"PGO degraded the trajectory: {ate_pgo:.4f} > {ate_odo:.4f} m":
                ate_pgo <= ate_odo + 1e-6,
            f"kernel A launched {launches['lk_pyramid']} times, not "
            f"{2 * (T - 1) + kf_steps}":
                launches["lk_pyramid"] == 2 * (T - 1) + kf_steps,
            f"kernel B launched {launches['pose_lm']} times, not {T - 1}":
                launches["pose_lm"] == T - 1}
        bad = [f"{name}: {m}" for m, ok in gates.items() if not ok]
        print(f"{name}: the bench's gates " + ("met" if not bad else
                                                "MISSED: " + "; ".join(bad)))
        missed.extend(bad)

    # (a) the sequence on disk and the loader
    seq = os.path.join(tmp, "sequence")
    t0 = time.perf_counter()
    ql, qr = write_kitti_sequence(seq, lefts, rights, rig)
    print(f"phase 14: wrote the circuit as a KITTI sequence ({T} frames, "
          f"2 greyscale and 2 colour {ql.shape[1] * 2}x{ql.shape[2] * 2} "
          f"PNGs each) in "
          f"{time.perf_counter() - t0:.1f} s")
    ds = KittiDataset(seq, device=dev)
    ds.initialize()
    cam_err = max(float((a - b.to(a.device)).abs().max())
                  for ca, cb in zip(ds.cameras[:2], rig)
                  for a, b in zip(ca, cb))
    t0 = time.perf_counter()
    frames = [ds.frame_by_id(i) for i in range(T)]
    decode_ms = (time.perf_counter() - t0) * 1e3 / T
    same = all(np.array_equal(f.left, ql[i].astype(np.float32))
               and np.array_equal(f.right, qr[i].astype(np.float32))
               for i, f in enumerate(frames))
    print(f"phase 14: loader cameras within {cam_err:.2e} of the rig, "
          f"{T} frames read back equal to the rounded scene: {same}, "
          f"past the end: {ds.frame_by_id(T)}; decode {decode_ms:.2f} ms "
          f"a stereo frame (Pillow, two PNGs, the card machine's host)")
    if not (cam_err <= 1e-5 and same and ds.frame_by_id(T) is None):
        missed.append(f"phase 14: the loader: cameras {cam_err:.2e}, "
                      f"frames equal {same}")

    # (b) classic, the first frames' kernel launches held
    r = cli("cli_classic", ["--mode", "classic"], hold=True)
    vo = r["vo"]
    report("cli_classic", r, vo.inlier_history, vo.kf_count + 1)
    a_err, b_err, failed = hold_recorded(
        r["records"], f"cli_classic (first {CLI_HOLD_FRAMES} frames)",
        vo.cfg.num_features_tracking_bad)
    missed += failed
    jsonl = os.path.join(vo.cfg.output_dir, "viewer.jsonl")
    with open(jsonl) as f:
        events = [json.loads(line)["event"] for line in f]
    print(f"cli_classic: viewer transcript {len(events)} events "
          f"({', '.join(f'{e} {events.count(e)}' for e in sorted(set(events)))})")
    if not events:
        missed.append("cli_classic: the viewer wrote no transcript")

    # (c) fused
    def fused_report(name: str, r: dict) -> None:
        outs = r["vo"].outputs
        report(name, r, [int(o.n_inliers) for _, o in outs[1:]],
               sum(bool(o.kf_inserted) for _, o in outs))
    fused = cli("cli_fused", ["--mode", "fused"])
    fused_report("cli_fused", fused)

    # (d) checkpoints, then a resume from the last one
    ck = cli("cli_checkpointed", ["--mode", "fused", "--checkpoint-every",
                                  str(CLI_CHECKPOINT_EVERY)])
    last = (T // CLI_CHECKPOINT_EVERY) * CLI_CHECKPOINT_EVERY
    res = cli("cli_resumed", ["--mode", "fused", "--resume", os.path.join(
        ck["vo"].cfg.output_dir, run_slam.CHECKPOINT_NAME)])
    said = f"({last} frames already processed)"
    resumed_at = any(said in line for line in res["lines"])

    def gap(a: dict, b: dict) -> float:
        if sorted(a) != sorted(b):
            return float("inf")
        return max(float(np.abs(a[f] - b[f]).max()) for f in a)
    g_res, g_ck = gap(res["final"], fused["final"]), gap(
        ck["final"], fused["final"])
    print(f"cli_resumed: resumed after frame {last}: {resumed_at}; "
          f"{len(res['final'])} keyframes against the uninterrupted "
          f"run's {len(fused['final'])}, the same frame ids and poses "
          f"within {g_res:.2e} (the checkpointed run's own within "
          f"{g_ck:.2e}); launches A {by_path['cli_resumed']['lk_pyramid']}"
          f", B {by_path['cli_resumed']['pose_lm']} over "
          f"{T - last} frames")
    if not (resumed_at and g_res <= 1e-5):
        missed.append(f"cli_resumed: the resumed run is not the "
                      f"uninterrupted one: resumed at {last} {resumed_at},"
                      f" poses {g_res:.2e}")

    # (e) a finding, no gate: the default gates with PlaceNet
    dflt = cli("cli_default_gates", ["--mode", "fused"])
    print(f"cli_default_gates: the config's default (MobileNet-tuned) "
          f"loop gates with PlaceNet close {dflt['loops']} loop(s) "
          f"({[(e.kf_id, e.loop_kf_id) for e in dflt['vo'].loop_edges()]}"
          f"), keyframe ATE {ate(dflt['odometry']):.4f} m, after PGO "
          f"{ate(dflt['final']):.4f} m (a finding, not a gate)")
    return by_path, a_err, b_err, missed, {"sequence": seq,
                                           "fused": fused["output"]}


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
    two frames of the serving streams; one kernel C call gated to one
    launch; times at the largest launch (level 0 of the G = 2B call)."""
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
    one_launch(lambda: lk_iterate.lk_iterate(*a, **kw), "lk_iterate",
               lk_iterate)
    win = a[0]
    N, P = win.shape[0], win.shape[1]
    b_c, by_c = c_bound(a, kw)
    c_row = dict(name="lk_iterate", route="cuda",
                 source="stereovision_slam_torch/csrc/lk_iterate.cu",
                 replaces="stereovision_slam_tpu/ops/lk_pallas.py:46",
                 max_abs_err=c_err,
                 **kernel_times(lambda: lk_iterate.lk_iterate(*a, **kw)),
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
                 **kernel_times(lambda: gather.gather_windows(*ga, **gkw)),
                 plain_ms=cuda_ms(
                     lambda: gather.gather_windows_plain(*ga, **gkw), 50),
                 bound_ms=b_g, bound_by=by_g)
    lib = kernel_times(lambda: imgs[gi, rows, cols])
    g_row.update(library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                 library_cold_ms=lib["cold_ms"])
    print(f"kernel C N={N} (G={G}) level {H}x{W}: {times_line(c_row)}; "
          f"plain {c_row['plain_ms']:.3f} ms, bound {b_c:.6f} ms ({by_c})")
    print(f"gather N={N}, P={P}: {times_line(g_row)}; plain "
          f"{g_row['plain_ms']:.4f} ms; advanced indexing {times_line(lib)}; "
          f"bound {b_g:.6f} ms ({by_g})")

    # patch WIDE_R, once above kernel C's cap (11): the G = B call, every
    # launch held; times at its first launch (level 1, the smaller window)
    records = []
    with held_to_plain(records):
        lk.track_batched(prev, cur, pts, pts, valid, win_size=WIDE_R,
                         max_iters=12, pallas_mode="pallas")
    check(len(records) == 4, f"{len(records)} kernel C and gather launches "
          f"at patch {WIDE_R}, not 2 each")
    e_c, e_g = check_held(records, f"phase 6, patch {WIDE_R}")
    c_row["max_abs_err"] = max(c_row["max_abs_err"], e_c)
    g_row["max_abs_err"] = max(g_row["max_abs_err"], e_g)
    a, kw = next(r["args"] for r in records if r["name"] == "lk_iterate")
    t = kernel_times(lambda: lk_iterate.lk_iterate(*a, **kw))
    t["plain_ms"] = cuda_ms(lambda: lk_iterate.lk_iterate_plain(*a, **kw), 3)
    t["bound_ms"], t["bound_by"] = c_bound(a, kw)
    c_row["wide"] = {f"R{WIDE_R}": t}
    print(f"kernel C N={a[0].shape[0]} patch {WIDE_R} window "
          f"{a[0].shape[1]} level {kw['H']}x{kw['W']}: {times_line(t)}; "
          f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']})")
    return c_row, g_row


def c_bound(a, kw):
    """Kernel C's bound for one call: inputs read and the (N, 5) rows
    written once; per pixel and iteration the 4-term bilinear (7), the
    difference (1) and two multiply-adds (4), for the iterations these
    inputs take."""
    from stereovision_slam_torch.ops import lk_iterate

    N, R = a[0].shape[0], a[1].shape[1]
    iters = float(lk_iterate.lk_iterate_plain(*a, **kw)[:, 4].sum())
    nbytes = 4 * (sum(t.numel() for t in a) + N * lk_iterate.OUT_COLS)
    return bound_ms(nbytes, iters * R * R * 12.0)


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
    errs = [np.linalg.norm(center(np.asarray(p)) - center(gt[f]))
            for f, p in traj.items()]
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
    # one launch per LK call: two per step, one per stream's stereo
    # initialization and one per keyframe step
    want_a = 2 * steps + SERVE_B + inserted
    check(launches["lk_pyramid"] == want_a,
          f"kernel A launched {launches['lk_pyramid']} times, not {want_a}")
    check(launches["pose_lm"] == steps,
          f"kernel B launched {launches['pose_lm']} times, not {steps}")
    check(launches["lk_iterate"] == 0 and launches["gather_windows"] == 0,
          "the lanes path launched kernel C or the gather")
    check(launches["ba_window"] == len(passes),
          f"the BA kernel launched {launches['ba_window']} times over "
          f"{len(passes)} BA passes")
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
            vo.cam_left, vo.cam_right, pallas_mode=mode, camp=vo.camp,
            **vo._statics())
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
    call = lambda: rr.ring_all_reduce_flat(x, axis, ma)
    lib = lambda: x.view(dp, mp, R, rr.LANES).sum(0)
    one_launch(call, "ring_reduce", rr)
    ms = cuda_ms(call, 50)
    dev_ms, cold, wrap_ms = device_ms(call, 50), cuda_ms_cold(call, 20), \
        host_ms(call, 50)
    plain_ms = cuda_ms(lambda: rr.ring_all_reduce_plain(x, axis, ma), 5)
    lib_ms, lib_dev, lib_cold = cuda_ms(lib, 50), device_ms(lib, 50), \
        cuda_ms_cold(lib, 20)
    # each input read once, each output written once; n - 1 adds for each
    # element of each ring's sum
    b, by = bound_ms(2 * 4 * x.numel(), x.numel() * (dp - 1) / dp)
    print(f"kernel D at the sharded BA payload (8 ranks x {R} x 128, "
          f"{4 * x.numel() / 1e6:.1f} MB in, as much out): {ms:.4f} ms per "
          f"call back to back (CUDA events; {wrap_ms:.4f} ms of host time "
          f"per call); the kernel alone {dev_ms:.4f} ms warm (input and "
          f"output fit in the 50 MB L2, so it can read under the HBM bound), "
          f"{cold:.4f} ms cold (L2 flushed); plain {plain_ms:.3f} ms; "
          f"torch.sum over the ring axis {lib_ms:.4f} ms back to back, "
          f"{lib_dev:.4f} ms warm alone, {lib_cold:.4f} ms cold; bound "
          f"{b:.6f} ms ({by})")
    return dict(name="ring_all_reduce", route="cuda",
                source="stereovision_slam_torch/csrc/ring_reduce.cu",
                replaces="stereovision_slam_tpu/parallel/ring_reduce.py:39",
                max_abs_err=err, ms=ms, device_ms=dev_ms, cold_ms=cold,
                host_ms=wrap_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, library_device_ms=lib_dev,
                library_cold_ms=lib_cold,
                owned=check_ring_owned(x, axis, ma, lib_ms, dev_ms))


def check_ring_owned(x, axis: str, ma, lib_ms: float, one_ms: float) -> dict:
    """Phase 10, kernel D's owner form (its route across cards) on the one
    card: phase 10's payload as OWNED_CARDS cards of ranks (rank r on card
    r // 2), one launch per card in turn on the stream with the handshake
    compiled out, bit for bit its plain version (the owner form's
    bookkeeping) and the table form's launch; times beside the table
    form's (`one_ms`, alone) and torch.sum's (`lib_ms`). On the card it
    moves what the table form does, so their bound is the same."""
    import torch
    from stereovision_slam_torch.parallel import ring_reduce as rr

    xs = list(x.unbind(0))
    owner = [r * OWNED_CARDS // len(xs) for r in range(len(xs))]
    call = lambda: rr.ring_all_reduce_owned(xs, owner, axis, ma)
    before = rr.launch_count
    got = call()
    launches = rr.launch_count - before
    plain = rr.ring_all_reduce_owned_plain(xs, owner, axis, ma)
    one = rr.ring_all_reduce_flat(x, axis, ma)
    torch.cuda.synchronize()
    same = all(torch.equal(g, p) and torch.equal(g, one[r])
               for r, (g, p) in enumerate(zip(got, plain)))
    err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
    check(same, f"kernel D's owner form differs from its plain version or "
          f"the table form: {err}")
    check(launches == OWNED_CARDS, f"kernel D's owner form launched "
          f"{launches} times a call, not {OWNED_CARDS}")
    ms, dev_ms, wrap_ms = cuda_ms(call, 50), device_ms(call, 50), \
        host_ms(call, 50)
    plain_ms = cuda_ms(lambda: rr.ring_all_reduce_owned_plain(
        xs, owner, axis, ma), 5)
    b, by, _ = ring_least_ms(ma, axis, x.shape[1], [0] * len(xs), 0)
    print(f"kernel D's owner form on the card ({OWNED_CARDS} cards of "
          f"{len(xs) // OWNED_CARDS} ranks, one launch each in turn, no "
          f"handshake): bit for bit its plain version and the table form: "
          f"{same}; {ms:.4f} ms per call back to back, {dev_ms:.4f} ms "
          f"alone (the table form {one_ms:.4f}), host {wrap_ms:.4f} ms per "
          f"call; plain {plain_ms:.3f} ms; torch.sum {lib_ms:.4f} ms; bound "
          f"{b:.6f} ms ({by})")
    # one owner of every chunk: the table form's one launch, in the owner
    # kernel (the same blocks and fold); alone, table A, owner B, B, A
    single = lambda: rr.ring_all_reduce_owned(xs, [0] * len(xs), axis, ma)
    table = lambda: rr.ring_all_reduce_flat(x, axis, ma)
    s_same = all(torch.equal(g, one[r]) for r, g in enumerate(single()))
    check(s_same, "kernel D's owner form with one owner differs from the "
          "table form")
    abba = [device_ms(f, 50) for f in (table, single, single, table)]
    print(f"kernel D's owner form with one owner of every chunk (one "
          f"launch, the table form's blocks): bit for bit the table form: "
          f"{s_same}; alone, table form / owner form / owner form / table "
          f"form: {' / '.join(f'{v:.4f}' for v in abba)} ms")
    # launches: counted on the main path's runs (main); the owner form runs
    # there only across cards (tests/torch_multicard.py)
    return dict(name="ring_all_reduce owner form",
                route="cuda",
                source="stereovision_slam_torch/csrc/ring_reduce.cu",
                replaces="stereovision_slam_tpu/parallel/ring_reduce.py:39",
                launches_per_call=launches, max_abs_err=err,
                ms=ms, device_ms=dev_ms, host_ms=wrap_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib_ms,
                table_form_device_ms=one_ms,
                one_owner_abba_device_ms=abba)


class OwnedLaunches:
    """Kernel D's owner-form launches (`owned_launch_count` of
    parallel/ring_reduce.py, a part of its `launch_count`) as a counter the
    phases zero and read beside the modules' `launch_count`."""

    def __init__(self, rr):
        self.rr = rr
        self.__name__ = "ring_reduce owner form"

    @property
    def launch_count(self) -> int:
        return self.rr.owned_launch_count

    @launch_count.setter
    def launch_count(self, n: int) -> None:
        self.rr.owned_launch_count = n


@contextlib.contextmanager
def ring_held(records: list):
    """While active, every launch of kernel D is compared with its plain
    version on the same payload; `records` gets one dict per launch. On a
    mesh over processes the payloads of every process are all-gathered
    first and this process's ranks of the plain result compared. The
    path's own result is returned unchanged."""
    import torch
    import torch.distributed as dist
    from stereovision_slam_torch.parallel import ring_reduce as rr

    kernel = rr.ring_all_reduce_flat

    def held(x, axis_name, mesh_axes, mesh=None):
        k = kernel(x, axis_name, mesh_axes, mesh)
        if mesh is None or mesh.group is None:
            p = rr.ring_all_reduce_plain(x, axis_name, mesh_axes)
        else:
            parts = [torch.empty_like(x, device="cpu")
                     for _ in range(dist.get_world_size(mesh.group))]
            dist.all_gather(parts, x.cpu(), group=mesh.group)
            p = rr.ring_all_reduce_plain(torch.cat(parts).to(x.device),
                                         axis_name, mesh_axes)
            p = p[mesh.ranks.start:mesh.ranks.stop]
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


def sharded_ba_phase(vo, counters, dev, err_d: float, profile: bool,
                     keep: dict | None = None):
    """Phase 11: the distributed BA on the slice's final window, mesh
    (dp 4, mp 2) on the card, "xla" and "ring" (kernel D, every launch held
    to its plain version), against each other, against the single-card
    BA, and the ring run again on the CPU. Returns (launches, the largest
    kernel D error); `keep` gets the window, the runs, their wall times and
    the comparison (phase 19)."""
    import numpy as np
    import torch
    from stereovision_slam_torch.geometry import se3
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.slam.backend import (optimize_window,
                                                      optimize_window_plain)

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
    # the single-card BA's plain route, the sharded BA's formulation (the
    # BA kernel sums in another order: phase 3b holds it to this route)
    ms1, _ = optimize_window_plain(m, cl, cr, chi2_th=cfg.chi2_th,
                                   iters=iters, outlier_rounds=0,
                                   max_active_landmarks=La)
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
    if keep is not None:
        keep.update(m=m, cl=cl, cr=cr, K=K, F=F, L=L, kw=kw, kr=kr, lr=lr,
                    kx=kx, lx=lx, ms_ring=1e3 * t_r, ms_xla=1e3 * t_x,
                    compare=compare)
    if profile:
        profile_run("sharded BA (ring)", lambda: run_r(m, cl, cr), 1,
                    "calls")
        profile_run("single-card BA", lambda: optimize_window(
            m, cl, cr, chi2_th=cfg.chi2_th, iters=iters, outlier_rounds=0,
            max_active_landmarks=La), 1, "calls")
    return launches, err


def pgo_phase(keyframes, gt, dev, profile: bool,
              keep: dict | None = None) -> None:
    """Phase 12: a pose graph over the slice's keyframes (consecutive edges
    from the estimated poses, first -> last from ground truth, one loop
    edge with rank-deficient information), optimized on the card by
    `optimize_pose_graph` and by `build_sharded_pgo` over 8 ranks. `keep`
    gets the graph, the single solve, the times and chi2 (phase 19)."""
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
    if keep is not None:
        keep.update(g=g, out1=out1, c1=c1, s_single_first=t1_cold,
                    s_sharded_first=ts_cold, chi2=chi2)
    if profile:
        profile_run("PGO", lambda: pg.optimize_pose_graph(g), 1, "solves")


def state_gaps(a, b):
    """The largest gap between the float state tensors of two runs,
    relative to max(1, |value|), with its tensor's name, and the names of
    the integer and boolean tensors that differ."""
    import torch
    from stereovision_slam_torch.slam.graphs import leaves

    gap, where, unequal = 0.0, "", []
    for name in ("fs", "ms", "arc", "ls"):
        if getattr(a, name, None) is None:
            continue
        for field, v in getattr(a, name)._asdict().items():
            w = getattr(getattr(b, name), field)
            for j, (x, y) in enumerate(zip(leaves(v), leaves(w))):
                label = f"{name}.{field}" + (f"[{j}]" if isinstance(
                    v, tuple) else "")
                if not x.dtype.is_floating_point:
                    if not torch.equal(x, y):
                        unequal.append(label)
                    continue
                if x.numel():
                    g = float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                    if not g <= gap:
                        gap, where = g, label
    return gap, where, unequal


def loop_vo(cls, lefts, rights, rig, dev, params, cfg=None, **kw):
    """An initialized loop pipeline over the frames, the bench's settings
    with PlaceNet's loop gates unless `cfg`."""
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset

    vo = cls(cfg or loop_config(), ArraySequenceDataset(lefts, rights,
                                                        list(rig)),
             place_params=params, max_total_keyframes=512,
             max_total_landmarks=1 << 16, device=dev, **kw)
    vo.initialize()
    return vo


def warm_counts(runner, counters) -> dict:
    """The graph runner's warm-up launches, by counter name."""
    return {k: runner.warm_launches.get(m.__name__, 0)
            for k, m in counters.items()}


def chunk_hold(label: str, make, counters) -> list:
    """A chunked pipeline (chunks of 8) against its eager counterpart over
    the circuit's first CHUNK_HOLD_FRAMES frames (the init, tracking,
    keyframes with BA and a padded row): `make(chunked)` gives either,
    initialized. Returns the holds missed."""
    import numpy as np

    n = CHUNK_HOLD_FRAMES
    runs = []
    for chunked in (False, True):
        vo = make(chunked)
        for mod in counters.values():
            mod.launch_count = 0
        vo.run()
        runs.append((vo, {k: m.launch_count for k, m in counters.items()}))
    (e, le), (c, lc) = runs
    gap, where, unequal = state_gaps(c, e)
    oe, oc = e.outputs, c.outputs
    pose_gap = float(np.abs(np.stack([o.pose for _, o in oc])
                            - np.stack([o.pose for _, o in oe])).max())
    same_in = ([int(o.n_inliers) for _, o in oc]
               == [int(o.n_inliers) for _, o in oe])
    ins = [bool(o.kf_inserted) for _, o in oc]
    same_kf = ins == [bool(o.kf_inserted) for _, o in oe]
    warm = warm_counts(c.runner, counters)
    want = {k: le[k] + warm[k] for k in ("lk_pyramid", "pose_lm",
                                         "ba_window")}
    pad = int(c.out_buf.n_inliers[n])
    print(f"{label}: {type(c).__name__} against {type(e).__name__}, {n} "
          f"circuit frames, chunks of 8 ({8 - n % 8} "
          f"padded row(s), sentinel n_inliers {pad}): {c.runner.replays} "
          f"graph replays, graphs {sorted(map(str, c.runner.graphs))}; "
          f"{sum(ins)} keyframe steps; largest float gap to the eager run "
          f"{gap:.3e} ({where}; held to {CHUNK_STATE_TOL} relative to "
          f"max(1, |value|)), integer and flag tensors that differ "
          f"{unequal}, frame poses within {pose_gap:.3e}, inlier counts "
          f"equal {same_in}, keyframe decisions equal {same_kf}; launches "
          f"chunked {lc}, eager {le}, warm-ups {warm}")
    missed = []
    if not (gap <= CHUNK_STATE_TOL and not unequal and same_in and same_kf):
        missed.append(f"{label}: the chunked run is not the eager "
                      f"one: {gap:.3e} at {where}, {unequal}")
    if not (sum(ins) >= 2 and n % 8 and pad == -1
            and c.runner.replays >= n - 1):
        missed.append(f"{label}: the frames do not hold a keyframe "
                      "with BA and a padded row")
    if any(lc[k] != want[k] for k in want):
        missed.append(f"{label}: launches {lc}, not {want}")
    return missed


def launch_profile(label: str, vo, warm_steps: int, steps: int,
                   frames: int, tables: bool) -> None:
    """Device kernels, host kernel launches and graph launches a frame
    over `steps` steps after `warm_steps` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm_steps):
        vo.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            vo.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    api = {}
    for e in ka:
        if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                             "cudaGraphLaunch", "cudaMemcpy")):
            api[e.key] = api.get(e.key, 0) + e.count
    launches = sum(v for k, v in api.items() if "aunchKernel" in k)
    graphs = api.get("cudaGraphLaunch", 0)
    print(f"profile {label}: {frames} frames in {dt * 1e3:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms = "
          f"{100 * busy_ms / (dt * 1e3):.1f}%, "
          f"{sum(e.count for e in kernels) / frames:.0f} device kernels a "
          f"frame, {launches / frames:.1f} kernel launches from the host a "
          f"frame, {graphs / frames:.2f} graph launches a frame; runtime "
          f"calls {api}")
    if tables:
        sort = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        print(ka.table(sort_by=sort, row_limit=25))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


def chunked_loop_run(name: str, scene, counters, dev, params,
                     eager: dict) -> tuple[dict, list]:
    """Phase 15 (b): `ScanLoopVisualOdometry` (chunk 8) on one loop scene
    with the bench's settings and gates, PGO through its graph, beside
    phase 13's eager run. Returns (the run's numbers, launches included,
    the gates missed, the pipeline)."""
    import numpy as np
    import torch
    from stereovision_slam_torch.slam.fused_loop import (
        ScanLoopVisualOdometry)

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    vo = loop_vo(ScanLoopVisualOdometry, lefts, rights, rig, dev, params,
                 chunk_size=8)
    for mod in counters.values():
        mod.launch_count = 0
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    vo.run()
    dt, cpu = time.perf_counter() - t0, time.process_time() - c0
    launches = {k: m.launch_count for k, m in counters.items()}
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])
    inserted = sum(bool(f.kf_inserted) for _, f in frames)

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    errs = [np.linalg.norm(center(p) - center(gt[f]))
            for f, p in sorted(keyframes.values())]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    edges = vo.loop_edges()
    t1 = time.perf_counter()
    vo.warm_pgo(kf_hint=len(keyframes))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    replays0 = vo.pgo.replays
    t1 = time.perf_counter()
    traj = vo.run_pgo()
    torch.cuda.synchronize()
    pgo_s = time.perf_counter() - t1
    errs = [np.linalg.norm(center(np.asarray(p)) - center(gt[f]))
            for f, p in traj.items()]
    ate_pgo = float(np.sqrt(np.mean(np.square(errs))))
    poses = np.stack([f.pose for _, f in frames])
    apart = np.nonzero(np.abs(poses - eager["poses"]).reshape(T, -1)
                       .max(axis=1) > 1e-4)[0]
    first = int(apart[0]) if len(apart) else None
    r = vo.runner
    warm = warm_counts(r, counters)
    tracked = T - 1
    info = dict(launches=launches, fps=T / dt,
                fps_warm=T / (dt - r.capture_s), ms=1e3 * dt / T,
                cpu_ms=1e3 * cpu / T, replays=r.replays / T,
                keyframes=len(keyframes), loops=len(edges), ate=ate,
                ate_pgo=ate_pgo, pgo_s=pgo_s, first_apart=first)
    print(f"chunked {name}: {T} frames in {dt:.3f} s = {T / dt:.2f} fps "
          f"(eager, phase 13: {eager['fps']:.2f}); without the graphs' "
          f"{r.captures} captures ({r.capture_s:.3f} s, warm-ups "
          f"included) {info['fps_warm']:.2f} fps; {info['ms']:.2f} ms a "
          f"frame on the host clock (eager {eager['ms']:.2f}), "
          f"{info['cpu_ms']:.2f} ms of host CPU time a frame; "
          f"{info['replays']:.2f} graph replays a frame; {len(keyframes)} "
          f"keyframes (eager {eager['keyframes']}), {len(landmarks)} "
          f"landmarks, {len(edges)} loops "
          f"{[(e.kf_id, e.loop_kf_id) for e in edges]} (eager "
          f"{eager['loops']}), keyframe ATE {ate:.4f} m (eager "
          f"{eager['ate']:.4f}), after PGO {ate_pgo:.4f} m (eager "
          f"{eager['ate_pgo']:.4f}) over {dist:.1f} m "
          f"({100 * ate_pgo / dist:.3f}%), pgo_s {pgo_s:.3f} (eager "
          f"{eager['pgo_s']:.3f}; PGO graphs captured {vo.pgo.runner.captures}"
          f", warm_pgo {warm_s:.3f} s off the clock, run_pgo replays "
          f"{vo.pgo.replays - replays0}); hook host reads {vo.hook_reads} "
          f"over {inserted - 1} hooked keyframes; launches {launches} "
          f"(warm-ups {warm}) for {tracked} tracked frames and {inserted} "
          f"keyframe steps; the first frame whose pose parts from the eager "
          f"run's by more than 1e-4: {first}")
    want_a = 2 * tracked + inserted + warm["lk_pyramid"]
    want_b = tracked + warm["pose_lm"]
    want_ba = inserted - 1 + warm["ba_window"]
    gates = {
        f"kernel A launched {launches['lk_pyramid']} times, not {want_a}":
            launches["lk_pyramid"] == want_a,
        f"kernel B launched {launches['pose_lm']} times, not {want_b}":
            launches["pose_lm"] == want_b,
        f"the BA kernel launched {launches['ba_window']} times, not "
        f"{want_ba}": launches["ba_window"] == want_ba,
        f"{vo.hook_reads} hook host reads":
            vo.hook_reads <= 2 * (inserted - 1),
        f"{len(keyframes)} keyframes, {len(landmarks)} landmarks":
            len(keyframes) >= 2 and len(landmarks) > 50,
        f"tracking collapsed: n_inliers down to {n_in[1:].min()}":
            bool(np.all(n_in[1:] > 10)),
        "ATE not finite": bool(np.isfinite(ate) and np.isfinite(ate_pgo)),
        "no loop closed": len(edges) >= 1,
        f"ATE after PGO {ate_pgo:.4f} m is not under 2% of {dist:.1f} m":
            ate_pgo < 0.02 * dist,
        f"PGO degraded the trajectory: {ate_pgo:.4f} > {ate:.4f} m":
            ate_pgo <= ate + 1e-6,
        "PGO did not run through its graph (a replay an LM iteration)":
            vo.pgo.replays - replays0 == 22 and vo.pgo.runner.captures >= 1}
    missed = [f"chunked {name}: {m}" for m, ok in gates.items() if not ok]
    print(f"chunked {name}: the bench's gates "
          + ("met" if not missed else "MISSED: " + "; ".join(missed)))
    return info, missed, vo


def chunked_slice(scene, dev, slice_fps: float) -> list:
    """Phase 15 (c): `ScanVisualOdometry` (chunk 32) and
    `UnrolledVisualOdometry` (chunk 8) on the slice, with its gates."""
    import numpy as np
    import torch
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused import (ScanVisualOdometry,
                                                     UnrolledVisualOdometry)

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    missed = []
    for cls, chunk in ((ScanVisualOdometry, 32), (UnrolledVisualOdometry, 8)):
        vo = cls(bench_config(), ArraySequenceDataset(lefts, rights,
                                                      list(rig)),
                 max_total_keyframes=512, max_total_landmarks=1 << 16,
                 device=dev, chunk_size=chunk)
        vo.initialize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vo.run()
        dt = time.perf_counter() - t0
        keyframes, landmarks, frames = vo.drain()
        n_in = np.array([int(f.n_inliers) for _, f in frames])
        errs = [np.linalg.norm(-p[:, :3].T @ p[:, 3]
                               + gt[f][:, :3].T @ gt[f][:, 3])
                for f, p in sorted(keyframes.values())]
        ate = float(np.sqrt(np.mean(np.square(errs))))
        r = vo.runner
        print(f"chunked slice, {cls.__name__} (chunk {chunk}): {T} frames "
              f"in {dt:.3f} s = {T / dt:.2f} fps (eager, phase 4: "
              f"{slice_fps:.2f}), {T / (dt - r.capture_s):.2f} fps without "
              f"the {r.captures} captures ({r.capture_s:.3f} s), "
              f"{r.replays / T:.2f} replays a frame, {len(keyframes)} "
              f"keyframes, {len(landmarks)} landmarks, keyframe ATE "
              f"{ate:.4f} m over {dist:.1f} m ({100 * ate / dist:.3f}%)")
        if not (len(keyframes) >= 2 and len(landmarks) > 50
                and np.all(n_in[1:] > 10) and np.isfinite(ate)
                and ate < 0.02 * dist):
            missed.append(f"chunked slice {cls.__name__}: ATE {ate:.4f} m, "
                          f"inliers down to {n_in[1:].min()}")
    return missed


def pgo_graph_hold(vo) -> list:
    """Phase 15 (d): PGO's graph against the eager `optimize_pose_graph` on
    the chunked circuit run's pose graph, both timed (twice each: the
    first eager call pays its one-time set-up), eager with PyTorch's
    default linear-algebra backend and with cuSOLVER, the graph's."""
    import torch
    from stereovision_slam_torch.slam.pose_graph import optimize_pose_graph

    keyframes, _, _ = vo.drain()
    problem = vo.pose_graph(keyframes)
    if problem is None:
        return ["phase 15 (d): the chunked circuit run closed no loop"]
    g, _ = problem

    def timed_solve(fn):
        out, ts = None, []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return out, ts

    eager, t_e = timed_solve(lambda: optimize_pose_graph(g))
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        eager_cs, t_c = timed_solve(lambda: optimize_pose_graph(g))
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    graph, t_g = timed_solve(lambda: vo.pgo.solve(g))

    def gap(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
    gd, gc = gap(graph, eager), gap(graph, eager_cs)
    print(f"phase 15 (d): PGO over {int(g.pose_valid.sum())} keyframes and "
          f"{int(g.edge_valid.sum())} edges (padded {tuple(g.poses.shape)}, "
          f"{tuple(g.edge_i.shape)}): the graph within {gc:.3e} of the eager "
          f"solve on cuSOLVER and {gd:.3e} of the eager solve on the default "
          f"backend (relative to max(1, |value|), held to {PGO_GRAPH_TOL}); "
          f"eager {t_e[0]:.3f} s then {t_e[1]:.3f} s, eager on cuSOLVER "
          f"{t_c[1]:.3f} s, graph {t_g[0]:.4f} s then {t_g[1]:.4f} s (the "
          f"eigh of the edge informations and the copies in and out "
          f"included)")
    if not min(gc, gd) <= PGO_GRAPH_TOL:
        return [f"phase 15 (d): PGO's graph is {gc:.3e} from the eager "
                "solve"]
    return []


def chunked_phase(scenes_loop, slice_scene, counters, dev, params,
                  eager_loop: dict, slice_fps: float, profile: int) -> list:
    """Phase 15: the chunked modes, (a) held to the eager loop path, (b)
    on both loop scenes with the bench's gates beside phase 13, with a
    launch profile of both paths on the circuit, (c) on the slice, (d)
    PGO's graph held to the eager solve. Returns (the launches of the
    chunked loop runs by path, the holds and gates missed)."""
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry, ScanLoopVisualOdometry)

    t0 = time.perf_counter()
    lefts, rights, _, _, rig = scenes_loop["circuit"]
    n = CHUNK_HOLD_FRAMES
    missed = chunk_hold("phase 15 (a)", lambda chunked: loop_vo(
        ScanLoopVisualOdometry if chunked else FusedLoopVisualOdometry,
        lefts[:n], rights[:n], rig, dev, params,
        **({"chunk_size": 8} if chunked else {})), counters)
    runs, paths = {}, {}
    for name, scene in scenes_loop.items():
        info, failed, vo = chunked_loop_run(name, scene, counters, dev,
                                            params, eager_loop[name])
        runs[name], paths[f"chunked_{name}"] = vo, info["launches"]
        missed += failed
    n = CHUNK_PROFILE_FRAMES
    launch_profile("loop eager", loop_vo(
        FusedLoopVisualOdometry, lefts[:2 * n], rights[:2 * n], rig, dev,
        params), n, n, n, bool(profile))
    launch_profile("loop chunked", loop_vo(
        ScanLoopVisualOdometry, lefts[:2 * n], rights[:2 * n], rig, dev,
        params, chunk_size=8), n // 8, n // 8, n, bool(profile))
    missed += chunked_slice(slice_scene, dev, slice_fps)
    missed += pgo_graph_hold(runs["circuit"])
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return paths, missed


def dense_phase(paths: dict, tmp: str, dev,
                save_keyframes: str | None = None,
                keep: dict | None = None) -> list:
    """Phase 16: the dense tool's command line on "cuda" over phase 14's
    fused run (cameras 2 / 3, colour, the reference's defaults): the
    points after each filter, ms per keyframe by stage (`StageTimer`,
    synchronized), wall time and peak memory; (a) the first keyframe held
    to the card machine's CPU (disparity and validity away from the
    texture gate's margin, points within DENSE_POINT_RTOL, the SOR masks
    away from the threshold margin; the pixels and points inside the
    margins counted); (b) `--mesh --per-device-batch DENSE_BATCH` equal to
    the serial run bit for bit; (c) the share of kept points on the arena
    against DENSE_ARENA_MIN; (d) the PCD read back, colours from the RGB
    frames. `save_keyframes`: a path to copy the fused run's keyframes.txt
    to (tests/torch_slice9_reference.py reconstructs them in the JAX
    package). Returns the gates missed; `keep` gets the YAML's path and the
    batched cloud (phase 19)."""
    import numpy as np
    import torch
    from stereovision_slam_torch.apps import run_dense_reconstruction as app
    from stereovision_slam_torch.dense.reconstruction import (
        DenseReconstruction)
    from stereovision_slam_torch.io.pcd import read_pcd
    from stereovision_slam_torch.ops import sor, stereo_bm

    t_phase = time.perf_counter()
    missed = []
    yaml_path = os.path.join(tmp, "dense.yaml")
    with open(yaml_path, "w") as f:
        f.write("%YAML:1.0\n---\n"
                f"slam_output_dir: {os.path.join(paths['fused'], 'keyframes.txt')}\n"
                "left_cam_index: 2\nright_cam_index: 3\nis_color_input: 1\n")
    if save_keyframes:
        os.makedirs(os.path.dirname(os.path.abspath(save_keyframes)),
                    exist_ok=True)
        with open(os.path.join(paths["fused"], "keyframes.txt")) as src, \
                open(save_keyframes, "w") as dst:
            dst.write(src.read())

    card = torch.device(dev).type == "cuda"

    def cli(argv):
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = app.run(app.parse_args([yaml_path, "--device", str(dev)] + argv))
        if card:
            torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["peak_gb"] = (torch.cuda.max_memory_allocated() / 2 ** 30 if card
                        else float("nan"))
        return r

    serial = cli([])
    dr = serial["dr"]
    n_kf = dr.counts["keyframes"]
    stages = dr.timer.summary()
    print(f"phase 16: {n_kf} keyframes, points {dr.counts}; CLI wall "
          f"{serial['wall_s']:.2f} s = {1e3 * serial['wall_s'] / n_kf:.1f} ms "
          f"a keyframe, peak memory {serial['peak_gb']:.2f} GiB")
    print("phase 16: ms a keyframe by stage (synchronized): " + ", ".join(
        f"{k} {1e3 * v['total_s'] / n_kf:.2f}" for k, v in stages.items()))

    # (b) batched over the one-card mesh
    batched = cli(["--mesh", "--per-device-batch", str(DENSE_BATCH)])
    same = (np.array_equal(batched["points"], serial["points"])
            and np.array_equal(batched["colors"], serial["colors"]))
    bst = batched["dr"].timer.summary()
    print(f"phase 16 (b): --mesh --per-device-batch {DENSE_BATCH}: "
          f"{len(batched['points'])} points against {len(serial['points'])}"
          f", bit for bit: {same}; wall {batched['wall_s']:.2f} s, peak "
          f"{batched['peak_gb']:.2f} GiB; disparity "
          f"{1e3 * bst['disparity']['total_s'] / n_kf:.2f} ms a keyframe")
    if not same:
        missed.append("phase 16 (b): the batched cloud is not the serial one")
    if keep is not None:
        keep.update(yaml=yaml_path, points=batched["points"],
                    colors=batched["colors"])

    # (a) the first keyframe, card against CPU
    fid, T_cw = dr.keyframes[0]
    dr_cpu = DenseReconstruction(dr.cfg, device="cpu")
    dr_cpu.initialize()
    l, r, _ = dr._frame_arrays(fid)
    L, R = torch.from_numpy(l), torch.from_numpy(r)
    d_c, v_c = stereo_bm.compute_disparity(L.to(dev), R.to(dev))
    d_h, v_h = stereo_bm.compute_disparity(L, R)
    away = stereo_bm.texture_margin(L) > DENSE_GATE_MARGIN
    px_diff = int(((d_c.cpu() != d_h) | (v_c.cpu() != v_h)).sum())
    px_away = int((((d_c.cpu() != d_h) | (v_c.cpu() != v_h)) & away).sum())
    p_c, ok_c = dr._points(l, r, T_cw)
    p_h, ok_h = dr_cpu._points(l, r, T_cw)
    ok_same = bool(torch.equal(ok_c.cpu(), ok_h))
    ph = p_h[ok_h].numpy()
    pc = p_c[ok_c].cpu().numpy() if ok_same else ph
    p_err = float(np.max(np.abs(pc - ph) / np.maximum(np.abs(ph), 1.0)))
    md_c, _ = sor.mean_knn_distances(ph, device=dev)
    md_h, _ = sor.mean_knn_distances(ph, device="cpu")
    keep_c, keep_h = sor.keep_mask(md_c), sor.keep_mask(md_h)
    sor_away = sor.threshold_margin(md_h) > DENSE_KEEP_MARGIN
    print(f"phase 16 (a): keyframe {fid}: {int(v_h.sum())} valid pixels, "
          f"{px_diff} differ card/CPU ({int((~away).sum())} within "
          f"{DENSE_GATE_MARGIN} of the texture gate, {px_away} differ "
          f"outside it); points {len(ph)}, masks equal {ok_same}, largest "
          f"relative gap {p_err:.2e}; SOR mean distances equal "
          f"{np.array_equal(md_c, md_h)}, keep masks differ on "
          f"{int((keep_c != keep_h).sum())} points "
          f"({int((~sor_away).sum())} within {DENSE_KEEP_MARGIN} of the "
          f"threshold)")
    if not (px_away == 0 and ok_same and p_err <= DENSE_POINT_RTOL
            and np.array_equal(keep_c[sor_away], keep_h[sor_away])):
        missed.append(f"phase 16 (a): card and CPU differ: pixels {px_away}"
                      f", points {ok_same} {p_err:.2e}, SOR")

    # (c) the geometry: kept points on the arena's ground or wall
    share = arena_share(serial["points"])
    print(f"phase 16 (c): {100 * share:.2f}% of the kept points within "
          f"{ARENA_BAND} m of the arena's ground plane or wall (gate "
          f"{100 * DENSE_ARENA_MIN:.1f}%)")
    if not share >= DENSE_ARENA_MIN:
        missed.append(f"phase 16 (c): arena share {share:.4f} < "
                      f"{DENSE_ARENA_MIN}")

    # (d) the PCD read back; colours from the RGB frames, whose channels
    # are (0.9 q + 20, q, 1.1 q - 20) of the grey frame q
    pts, cols = read_pcd(serial["output"])
    rgb_ok = bool(np.array_equal(cols, rgb_frames(
        cols[:, 1].astype(np.float32))))
    pcd_ok = (len(pts) == len(serial["points"])
              and np.array_equal(pts, serial["points"])
              and np.array_equal(cols, serial["colors"]))
    print(f"phase 16 (d): the PCD reads back {len(pts)} points, equal: "
          f"{pcd_ok}; colours from the RGB frames: {rgb_ok} "
          f"({int((cols[:, 0] != cols[:, 2]).sum())} of {len(cols)} with "
          f"R != B); phase 16 {time.perf_counter() - t_phase:.1f} s")
    if not (pcd_ok and rgb_ok and len(pts) > 0):
        missed.append(f"phase 16 (d): PCD {pcd_ok}, colours {rgb_ok}")
    return missed


def mobilenet_phase(scene, paths: dict, tmp: str, counters, dev):
    """Phase 17: MobileNet-V2. A seeded torchvision-layout state dict
    written as ONNX by the port's writer and read back by
    `load_onnx_weights`; `embed_image` on the card held to the CPU
    (cosine, largest difference, ms an embedding); then the circuit
    through `FusedLoopVisualOdometry` with those parameters and the
    bench's settings (the config's default, MobileNet-tuned loop gates),
    and the classic command line with `dnn_weights_path` at the file
    ('auto' must pick MobileNet). Gates: every frame tracked, keyframe ATE
    before PGO under 2% of the path; loops and ATE after PGO printed. Then
    `ScanLoopVisualOdometry` with the MobileNet hook in its CUDA graphs,
    held to the eager run as phase 15 (a). Returns ({path: launches}, the
    gates missed)."""
    import dataclasses

    import numpy as np
    import torch
    import yaml
    from stereovision_slam_torch.apps import run_slam
    from stereovision_slam_torch.models import mobilenet_v2 as mnv2
    from stereovision_slam_torch.models import onnx_reader
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry, ScanLoopVisualOdometry)
    from tests.torch_mnv2_weights import state_dict

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    missed, by_path = [], {}
    onnx = os.path.join(tmp, "mobilenet_v2.onnx")
    onnx_reader.write_onnx_initializers(onnx, state_dict(0))
    params = mnv2.load_onnx_weights(onnx, device=dev)
    params_cpu = mnv2.load_onnx_weights(onnx, device="cpu")
    img = torch.from_numpy(lefts[T // 2])
    e_h = mnv2.embed_image(params_cpu, img)
    e_c = mnv2.embed_image(params, img.to(dev)).cpu()
    cos = float(e_h @ e_c)
    diff = float((e_h - e_c).abs().max())
    ms = (cuda_ms(lambda: mnv2.embed_image(params, img.to(dev)), 20)
          if torch.device(dev).type == "cuda" else float("nan"))
    print(f"phase 17: MobileNet-V2 from ONNX ({os.path.getsize(onnx)} bytes)"
          f": card against CPU cosine {cos:.7f}, largest difference "
          f"{diff:.2e}; {ms:.3f} ms an embedding on the card (preprocess "
          f"and forward, 224x224)")
    if not (cos > MNV2_COS_MIN and diff < MNV2_EMB_TOL):
        missed.append(f"phase 17: card/CPU embedding cos {cos}, diff {diff}")

    def gates(name, n_in, ate_odo, ate_pgo, loops, fps, extra=""):
        print(f"{name}: {T} frames, {fps:.2f} fps, keyframe ATE "
              f"{ate_odo:.4f} m ({100 * ate_odo / dist:.3f}% of {dist:.1f} "
              f"m), {loops} loops, after PGO {ate_pgo:.4f} m (loops and ATE "
              f"after PGO printed, not gated){extra}")
        bad = []
        if not min(n_in) > 10:
            bad.append(f"{name}: tracking collapsed ({min(n_in)} inliers)")
        if not (np.isfinite(ate_odo) and ate_odo < 0.02 * dist):
            bad.append(f"{name}: keyframe ATE {ate_odo:.4f} m")
        missed.extend(bad)

    # the fused loop path with the seeded network
    vo = loop_vo(FusedLoopVisualOdometry, lefts, rights, rig, dev, params,
                 cfg=bench_config())
    for mod in counters.values():
        mod.launch_count = 0
    _, dt = timed(vo.run)
    by_path["mnv2_loop"] = {k: m.launch_count for k, m in counters.items()}
    keyframes, _, frames = vo.drain()
    odo = {f: p for f, p in keyframes.values()}
    traj = vo.run_pgo()
    gates("mnv2 loop", [int(f.n_inliers) for _, f in frames[1:]],
          stream_ate(odo, gt), stream_ate(traj, gt), len(vo.loop_edges()),
          T / dt,
          f"; {len(keyframes)} keyframes, launches A "
          f"{by_path['mnv2_loop']['lk_pyramid']}, B "
          f"{by_path['mnv2_loop']['pose_lm']}")

    # the classic command line, 'auto' with the weights file
    cfg = bench_config()
    cfg.dataset_dir = paths["sequence"]
    cfg.output_dir = os.path.join(tmp, "cli_mnv2")
    cfg.loopclosure_on = cfg.backend_on = 1
    cfg.visualizer_on = 0
    cfg.dnn_weights_path = onnx
    path = os.path.join(tmp, "cli_mnv2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    for mod in counters.values():
        mod.launch_count = 0
    r = run_slam.run(run_slam.parse_args([path, "--device", str(dev),
                                          "--mode", "classic"]))
    by_path["mnv2_cli_classic"] = {k: m.launch_count
                                   for k, m in counters.items()}
    lc = r["vo"].loop_closure
    from stereovision_slam_torch.slam.outputs import load_keyframes_file
    _, _, kfs = load_keyframes_file(os.path.join(r["output"],
                                                 "keyframes.txt"))
    gates("mnv2 cli_classic", r["vo"].inlier_history,
          stream_ate(r["odometry"], gt), stream_ate(dict(kfs), gt),
          r["loops"], r["fps"], f"; embedder {lc.embedder}")
    if lc.embedder != "mobilenet":
        missed.append(f"phase 17: 'auto' picked {lc.embedder}")

    # the hook inside the chunked path's graphs
    n = CHUNK_HOLD_FRAMES
    missed += chunk_hold("phase 17, chunked", lambda chunked: loop_vo(
        ScanLoopVisualOdometry if chunked else FusedLoopVisualOdometry,
        lefts[:n], rights[:n], rig, dev, params, cfg=bench_config(),
        **({"chunk_size": 8} if chunked else {})), counters)
    return by_path, missed


def fast_phase(scene, counters, dev):
    """Phase 18: FAST (`keypoint_feature_detector: ORB`). `fast.detect` on
    the card held to the CPU on a circuit frame (the same corners, scores
    within 1e-5 relative); `FusedVisualOdometry` with ORB and the bench's
    settings over the circuit: fps, keyframes, ATE, with the slice's gates,
    which the reference meets on the same run on the CPU (with its CPU
    LK: 77 keyframes, 115 inliers at least, ATE 0.1414 m = 0.337% of the
    path; with the lanes LK, the port's: 81, 108, 0.1257 m;
    tests/torch_slice9_reference.py --fast [--lk lanes-interpret]);
    `ScanVisualOdometry` with
    ORB, FAST in its keyframe graph, held to the eager run as phase 15 (a);
    the serving cell's streams with ORB, phase 7's gates but the ATE's.
    Returns ({path: launches}, the gates missed)."""
    import numpy as np
    import torch
    from stereovision_slam_torch.ops import fast
    from stereovision_slam_torch.slam.fused import ScanVisualOdometry

    lefts, rights, gt, dist, rig = scene
    T = len(lefts)
    missed = []
    img = torch.from_numpy(lefts[T // 4])
    p_c, v_c, s_c = fast.detect(img.to(dev), 250, min_distance=20)
    p_h, v_h, s_h = fast.detect(img, 250, min_distance=20)
    same = torch.equal(p_c.cpu(), p_h) and torch.equal(v_c.cpu(), v_h)
    s_err = float(((s_c.cpu() - s_h).abs() / s_h.abs().clamp(min=1e-6))
                  [v_h].max())
    print(f"phase 18: fast.detect card/CPU: {int(v_h.sum())} corners, the "
          f"same: {same}, scores within {s_err:.2e} relative")
    if not (same and s_err <= 1e-5):
        missed.append(f"phase 18: fast.detect card/CPU {same} {s_err:.2e}")

    cfg = bench_config()
    cfg.keypoint_feature_detector = "ORB"
    vo = slice_vo(lefts, rights, rig, dev, cfg)
    for mod in counters.values():
        mod.launch_count = 0
    _, dt = timed(vo.run)
    launches = {k: m.launch_count for k, m in counters.items()}
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])
    ate = stream_ate({f: p for f, p in keyframes.values()}, gt)
    print(f"fast slice: {T} frames in {dt:.3f} s = {T / dt:.2f} fps, "
          f"{len(keyframes)} keyframes, {len(landmarks)} landmarks, "
          f"n_inliers min {n_in[1:].min()}, keyframe ATE {ate:.4f} m "
          f"({100 * ate / dist:.3f}% of {dist:.1f} m); launches A "
          f"{launches['lk_pyramid']}, B {launches['pose_lm']}")
    gates = {
        f"{len(keyframes)} keyframes, {len(landmarks)} landmarks":
            len(keyframes) >= 2 and len(landmarks) > 50,
        f"tracking collapsed: n_inliers down to {n_in[1:].min()}":
            bool(np.all(n_in[1:] > 10)),
        f"keyframe ATE {ate:.4f} m over {dist:.1f} m":
            bool(np.isfinite(ate) and ate < 0.02 * dist),
        f"kernel B launched {launches['pose_lm']} times, not {T - 1}":
            launches["pose_lm"] == T - 1}
    missed += [f"fast slice: {m}" for m, ok in gates.items() if not ok]

    n = CHUNK_HOLD_FRAMES
    missed += chunk_hold("phase 18, chunked", lambda chunked: slice_vo(
        lefts[:n], rights[:n], rig, dev, cfg,
        **({"cls": ScanVisualOdometry, "chunk_size": 8} if chunked else {})),
        counters)

    serving = serving_config()
    serving.keypoint_feature_detector = "ORB"
    _, _, serve_launches = run_serving(
        serving_streams(lefts, rights, gt), rig, counters, dev, serving,
        "ORB", gate_ate=False)
    return {"fast_slice": launches, "fast_serving": serve_launches}, missed


def dist_worker(rank: int, world: int, port: int, tmp: str) -> None:
    """Phase 19 (a), process `rank` of `world` (torch.multiprocessing,
    spawned): joins a gloo group on 127.0.0.1:`port`, on cuda:0, and over
    the 8-rank (dp 4, mp 2) mesh, 4 ranks a process, runs kernel D across
    the processes on the payload, the gloo all_reduce beside it, the
    sharded BA with "ring" and "xla" on phase 11's window and the sharded
    PGO on phase 12's graph; writes its results to `tmp`."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from stereovision_slam_torch.geometry.camera import Camera
    from stereovision_slam_torch.parallel import ring_reduce as rr
    from stereovision_slam_torch.parallel.mesh import (
        initialize_multihost, make_ba_mesh)
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
    from stereovision_slam_torch.slam.map_state import MapState
    from stereovision_slam_torch.slam.pose_graph import PoseGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank)
    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    mesh = make_ba_mesh(8, dp=4, mp=2, device="cuda")
    dev = mesh.device
    out = {"device": str(dev), "ranks": [mesh.ranks.start, mesh.ranks.stop]}

    x = inp["payload"][mesh.ranks.start:mesh.ranks.stop].to(dev)
    rows, cols = mesh.local_shape

    def ring():
        return rr.ring_all_reduce_flat(x, "dp", mesh.mesh_axes, mesh)

    def gloo():
        part = x.view(rows, cols, *x.shape[1:]).sum(0)
        dist.all_reduce(part)
        return part

    out["ring"] = ring().cpu()
    ring()
    rr.trace = []
    _, t_ring = timed(lambda: [ring() for _ in range(DIST_RING_REPS)])
    traced = rr.read_trace()
    out["ring_device_ms"] = [t["device_ms"] for t in traced]
    out["ring_sync_ms"] = [t["sync_ms"] for t in traced]
    rr.trace = None
    out["ring_host_ms"] = 1e3 * t_ring / DIST_RING_REPS
    # the same sums in gloo's order: close to kernel D's, not its bits
    out["gloo_err"] = float((gloo() - out["ring"].to(dev).view(
        rows, cols, *x.shape[1:])[0]).abs().max())
    _, t_gloo = timed(lambda: [gloo() for _ in range(DIST_RING_REPS)])
    out["gloo_ms"] = 1e3 * t_gloo / DIST_RING_REPS

    m = MapState(*(t.to(dev) for t in inp["m"]))
    cl, cr = (Camera(*(t.to(dev) for t in inp[c])) for c in ("cl", "cr"))
    K, F, L = inp["KFL"]
    for impl in ("ring", "xla"):
        run = build_sharded_ba(mesh, K, F, L, reduce_impl=impl, **inp["kw"])
        rr.launch_count = rr.owned_launch_count = 0
        records = []
        with ring_held(records):     # each launch against gather + plain
            kf, lm = run(m, cl, cr)
            torch.cuda.synchronize()
        out[f"launches_{impl}"] = rr.launch_count
        out[f"owned_launches_{impl}"] = rr.owned_launch_count
        out[f"held_{impl}"] = [r["equal"] for r in records]
        out[f"kf_{impl}"], out[f"lm_{impl}"] = kf.cpu(), lm.cpu()
        _, t = timed(lambda: run(m, cl, cr))
        out[f"ms_{impl}"] = 1e3 * t

    g = PoseGraph(*(None if t is None else t.to(dev) for t in inp["g"]))
    pgo = build_sharded_pgo(make_ba_mesh(8, device="cuda"))
    poses, t = timed(lambda: pgo(g))
    out["pgo"], out["pgo_s"] = poses.cpu(), t
    torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    rr.release_peer_buffers()
    dist.destroy_process_group()


def dist_phase(ba: dict, pgo: dict, kernel_d: dict, dev):
    """Phase 19 (a): two processes on the card (`dist_worker`), both on
    cuda:0 and joined by gloo. Kernel D across them bit for bit against the
    one-process launch on phase 11's payload shape; the two-process sharded
    BA ("ring", "xla") within SHARD_RING_TOL of phase 11's one-process runs,
    PGO within PGO_SHARD_TOL of phase 12's single solve; the processes'
    replicated results equal. Returns (kernel D's launches per process on
    the ring BA run, the cross-process timings, the gates missed)."""
    import shutil
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from stereovision_slam_torch.parallel import ring_reduce as rr

    t_phase = time.perf_counter()
    missed = []
    tmp = tempfile.mkdtemp(prefix="svslam_dist_")
    rng = np.random.default_rng(DIST_SEED)
    payload = torch.from_numpy(rng.normal(size=(8, RING_PATH_ROWS, rr.LANES))
                               .astype(np.float32))
    g = pgo["g"]
    torch.save(dict(payload=payload,
                    m=[t.cpu() for t in ba["m"]],
                    cl=[t.cpu() for t in ba["cl"]],
                    cr=[t.cpu() for t in ba["cr"]],
                    KFL=[ba["K"], ba["F"], ba["L"]], kw=ba["kw"],
                    g=[None if t is None else t.cpu() for t in g]),
               os.path.join(tmp, "inputs.pt"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(dist_worker, args=(DIST_PROCS, port, tmp),
                             nprocs=DIST_PROCS, join=False,
                             start_method="spawn")
    failure = None
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                failure = f"the workers ran past {DIST_TIMEOUT_S} s"
                break
    except Exception as e:            # a worker raised or died
        failure = f"a worker failed: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    t_run = time.perf_counter() - t_phase
    if failure is not None:
        shutil.rmtree(tmp, ignore_errors=True)
        return 0, {}, [f"phase 19 (a): {failure}"]
    res = [torch.load(os.path.join(tmp, f"result_{i}.pt"))
           for i in range(DIST_PROCS)]
    shutil.rmtree(tmp, ignore_errors=True)

    ma = (("dp", 4), ("mp", 2))
    one = rr.ring_all_reduce_flat(payload.to(dev), "dp", ma).cpu()
    plain = rr.ring_all_reduce_plain(payload.to(dev), "dp", ma).cpu()
    two = torch.cat([r["ring"] for r in res])
    ring_same = torch.equal(two, one) and torch.equal(two, plain)
    # both processes on the one card: the card's least bytes, half a launch
    bound, bound_by, _ = ring_least_ms(ma, "dp", RING_PATH_ROWS, [0] * 8, 0,
                                       launches=DIST_PROCS)
    dev_ms = [v for r in res for v in r["ring_device_ms"]]
    sync_ms = [v for r in res for v in r["ring_sync_ms"]]
    print(f"phase 19 (a): {DIST_PROCS} processes on "
          f"{', '.join(r['device'] for r in res)}, ranks "
          f"{[r['ranks'] for r in res]}, gloo on 127.0.0.1, {t_run:.1f} s "
          f"from spawn to exit; kernel D across the processes on "
          f"(8, {RING_PATH_ROWS}, 128) along dp bit for bit the one-process "
          f"launch and the plain version: {ring_same}; device time a launch "
          f"(CUDA events) median {np.median(dev_ms):.4f} ms, min "
          f"{min(dev_ms):.4f} ms, bound {bound:.6f} ms ({bound_by}) (one "
          f"process, phase 10: {kernel_d['device_ms']:.4f} ms warm, "
          f"{kernel_d['cold_ms']:.4f} ms cold); the synchronizes and "
          f"barriers around it median {np.median(sync_ms):.3f} ms; a call "
          f"{np.mean([r['ring_host_ms'] for r in res]):.3f} ms (host clock); "
          f"gloo all_reduce of the local dp sum "
          f"{np.mean([r['gloo_ms'] for r in res]):.3f} ms a call (up to "
          f"{max(r['gloo_err'] for r in res):.2e} from kernel D's sums)")
    if not ring_same:
        missed.append("phase 19 (a): kernel D across processes differs from "
                      f"the one-process launch by "
                      f"{float((two - one).abs().max())}, from the plain "
                      f"version by {float((two - plain).abs().max())}")
    launches = [r["launches_ring"] for r in res]
    held = [r["held_ring"] for r in res]
    iters = ba["kw"]["iters"]
    print(f"phase 19 (a): sharded BA over two processes: kernel D launches "
          f"per process {launches} (ring), {[r['launches_xla'] for r in res]}"
          f" (xla), each against the all-gathered payloads' plain version: "
          f"{sum(map(sum, held))} of {sum(map(len, held))} bit-equal; wall "
          f"per call ring "
          f"{np.mean([r['ms_ring'] for r in res]):.1f} ms, xla "
          f"{np.mean([r['ms_xla'] for r in res]):.1f} ms (one process, phase "
          f"11: ring {ba['ms_ring']:.1f} ms, xla {ba['ms_xla']:.1f} ms); "
          f"against phase 11's runs:")
    if launches != [iters] * DIST_PROCS:
        missed.append(f"phase 19 (a): kernel D launched {launches} times, "
                      f"not {iters} in each process")
    if not all(all(h) and len(h) >= n for h, n in zip(held, launches)):
        missed.append("phase 19 (a): a kernel D launch of the two-process "
                      "BA differs from the plain version of the gathered "
                      "payloads")
    for impl, (k1, l1), tol in (
            ("ring", (ba["kr"], ba["lr"]), SHARD_RING_TOL),
            ("xla", (ba["kx"], ba["lx"]), SHARD_CPU_TOL)):
        ok, msg = ba["compare"](f"two processes vs one, {impl}",
                                res[0][f"kf_{impl}"].to(dev),
                                res[0][f"lm_{impl}"].to(dev), k1, l1, tol)
        if not ok:
            missed.append(f"phase 19 (a): {msg}")
    for key in ("kf_ring", "lm_ring", "kf_xla", "lm_xla", "pgo"):
        if not torch.equal(res[0][key], res[1][key]):
            missed.append(f"phase 19 (a): the processes' {key} differ")
    d = float((res[0]["pgo"].to(dev) - pgo["out1"]).abs().max())
    c2 = pgo["chi2"](res[0]["pgo"].to(dev))
    print(f"phase 19 (a): sharded PGO over two processes {d:.3e} from the "
          f"single solve (tolerance {PGO_SHARD_TOL}), chi2 {c2:.4e} (single "
          f"{pgo['c1']:.4e}); {res[0]['pgo_s']:.2f} s a solve, the first "
          f"(phase 12, first solves: single {pgo['s_single_first']:.2f} s, "
          f"one-process sharded {pgo['s_sharded_first']:.2f} s)")
    if not (d <= PGO_SHARD_TOL and c2 <= pgo["c1"] * 1.05 + 1e-8):
        missed.append(f"phase 19 (a): two-process PGO {d}, chi2 {c2}")
    timing = dict(device_ms=float(np.median(dev_ms)),
                  bound_ms=bound, bound_by=bound_by,
                  sync_ms=float(np.median(sync_ms)),
                  host_ms=float(np.mean([r["ring_host_ms"] for r in res])),
                  library_ms=float(np.mean([r["gloo_ms"] for r in res])),
                  processes=DIST_PROCS,
                  owned_launches=sum(r["owned_launches_ring"] for r in res))
    return sum(launches), timing, missed


def serving_mesh_phase(streams, rig, counters, dev, mesh=None,
                       label: str = "phase 19 (b)"):
    """Phase 19 (b): phase 7's four streams under `serving_config()` with
    `mesh` (by default `make_ba_mesh(devices=["cuda:0"] * 2, dp=2, mp=1)`:
    two streams a rank), the per-frame step (a mesh takes no kf_stagger),
    each rank's sub-batch stepped in turn on its device; phase 7's
    per-stream gates and the launch counts. Then the same streams
    unsharded on `dev` (mesh=None, the per-frame step): streams never
    interact, so the mesh run's outputs and keyframe trajectories must
    equal it bit for bit. Returns (launches, the gates missed)."""
    import numpy as np
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.slam.batched import BatchedFusedVisualOdometry

    def server(mesh):
        return BatchedFusedVisualOdometry(
            serving_config(), [ArraySequenceDataset(l, r, list(rig))
                               for l, r, _ in streams],
            max_total_keyframes=512, max_total_landmarks=1 << 16, mesh=mesh,
            device=dev)

    missed = []
    if mesh is None:
        mesh = make_ba_mesh(devices=["cuda:0"] * 2, dp=2, mp=1)
    vo = server(mesh)
    for mod in counters.values():
        mod.launch_count = 0
    vo.initialize()
    _, dt = timed(vo.run)
    launches = {k: m.launch_count for k, m in counters.items()}
    steps = vo._step_idx
    outputs = vo.outputs
    inserted = sum(int(o.kf_inserted) for out in outputs for _, o in out)
    print(f"{label}: serving over the mesh ({mesh.size} ranks on "
          f"{', '.join(sorted({str(d) for d in mesh.devices}))}, "
          f"{len(vo.shards[0].streams)} streams each, per-frame step): "
          f"{SERVE_B} streams x {steps} frames in {dt:.3f} s = "
          f"{SERVE_B * steps / dt:.2f} frames/s aggregate, {inserted} "
          f"keyframe steps, launches {launches}")
    plain = server(None)
    plain.initialize()
    _, dt_plain = timed(plain.run)
    ref = plain.outputs
    path = 0.35 * SERVE_T
    for b, (traj, traj_ref, out) in enumerate(zip(
            vo.trajectories(), plain.trajectories(), outputs)):
        n_in = np.array([int(o.n_inliers) for _, o in out])
        ate = stream_ate(traj, streams[b][2])
        gap = np.array([np.abs(o.pose - r.pose).max()
                        for (_, o), (_, r) in zip(out, ref[b])])
        same = (len(out) == len(ref[b]) and all(
            f == g and o.n_inliers == r.n_inliers and o.n_tracked ==
            r.n_tracked and o.kf_inserted == r.kf_inserted and o.kf_count ==
            r.kf_count and np.array_equal(o.pose, r.pose)
            for (f, o), (g, r) in zip(out, ref[b])) and set(traj) ==
            set(traj_ref) and all(np.array_equal(traj[f], traj_ref[f])
                                  for f in traj))
        first = int(np.argmax(gap > 0)) + 1 if np.any(gap > 0) else None
        print(f"  stream {b}: {len(traj)} keyframes, keyframe ATE {ate:.4f} m"
              f" ({100 * ate / path:.3f}% of {path:.1f} m), n_inliers "
              f"{n_in.min()}-{n_in.max()}; against the unsharded per-frame "
              f"run ({dt_plain:.3f} s): bit for bit {same}, pose gap up to "
              f"{gap.max():.3e}, first at frame {first}")
        if not (len(traj) >= 2 and ate < SERVE_ATE_PER_M * path
                and len(out) == steps and bool(np.all(n_in > 10))):
            missed.append(f"{label}: stream {b}: {len(traj)} keyframes,"
                          f" ATE {ate:.3f} m, n_inliers {n_in.min()}")
        if not same:
            missed.append(f"{label}: stream {b} over the mesh is not "
                          f"the unsharded run (pose gap {gap.max():.3e})")
    # per stream and step: two LK calls and one pose solve; one LK call per
    # stream's stereo initialization and per keyframe step
    want_a = SERVE_B * (2 * steps + 1) + inserted
    want_b = SERVE_B * steps
    if launches["lk_pyramid"] != want_a or launches["pose_lm"] != want_b:
        missed.append(f"{label}: kernels A, B launched "
                      f"{launches['lk_pyramid']}, {launches['pose_lm']} "
                      f"times, not {want_a}, {want_b}")
    return launches, missed


def dense_mesh_phase(dense: dict, tmp: str, dev) -> list:
    """Phase 19 (c): the dense tool with `--mesh` (every local card, one
    keyframe a rank and stack), then `dense_reconstruct` over a two-rank
    mesh on cuda:0 (two keyframes a rank and stack), each equal to phase
    16's batched cloud bit for bit. Returns the gates missed."""
    import numpy as np
    from stereovision_slam_torch.apps import run_dense_reconstruction as app
    from stereovision_slam_torch.dense.reconstruction import (
        DenseReconstruction)
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh

    missed = []
    cli, dt_cli = timed(lambda: app.run(app.parse_args(
        [dense["yaml"], "--device", str(dev), "--mesh"])))
    dr = DenseReconstruction(app.load_config(dense["yaml"]), device=dev)
    dr.initialize()
    (pts, cols), dt = timed(lambda: dr.dense_reconstruct(
        output_path=os.path.join(tmp, "dense_mesh2.pcd"),
        mesh=make_ba_mesh(devices=["cuda:0"] * 2), per_device_batch=2))
    for name, p, c, t in (("--mesh", cli["points"], cli["colors"], dt_cli),
                          ("2 ranks x 2", pts, cols, dt)):
        same = (np.array_equal(p, dense["points"])
                and np.array_equal(c, dense["colors"]))
        print(f"phase 19 (c): the dense tool, {name}: {len(p)} points "
              f"against phase 16's batched {len(dense['points'])}, bit for "
              f"bit: {same}; {t:.2f} s")
        if not same:
            missed.append(f"phase 19 (c): {name} is not phase 16's cloud")
    return missed


@contextlib.contextmanager
def ranks_held(records: list):
    """While active, every call of kernel D's per-rank route
    (`ring_all_reduce_ranks`) is compared with the plain version over the
    ranks' payloads gathered onto the first rank's card; `records` gets
    one dict per call. The path's own result is returned unchanged."""
    import torch
    from stereovision_slam_torch.parallel import ring_reduce as rr

    kernel = rr.ring_all_reduce_ranks

    def held(xs, axis_name, mesh_axes):
        k = kernel(xs, axis_name, mesh_axes)
        dev0 = xs[0].device
        p = rr.ring_all_reduce_plain(torch.stack([x.to(dev0) for x in xs]),
                                     axis_name, mesh_axes)
        got = torch.stack([y.to(dev0) for y in k])
        records.append(dict(shape=(len(xs),) + tuple(xs[0].shape),
                            cards=len({x.device for x in xs}),
                            equal=torch.equal(got, p),
                            err=float((got - p).abs().max())))
        return k

    rr.ring_all_reduce_ranks = held
    try:
        yield
    finally:
        rr.ring_all_reduce_ranks = kernel


def per_rank_phase(ba: dict, pgo: dict, counters, dev):
    """Phase 22: the per-rank route, a mesh of one device per rank in one
    process (the reference's layout over the chips of one host), with
    every rank on cuda:0 (`make_ba_mesh(devices=["cuda:0"] * 4)`): the
    sharded BA at (dp 2, mp 2) on phase 11's window, "ring" (every kernel
    D launch held to its plain version bit for bit) and "xla", each within
    SHARD_RING_TOL of phase 11's tensor-axis route at the same split and
    within SHARD_SINGLE_TOL of the single-card BA; the sharded PGO over
    the 4 ranks on phase 12's graph within PGO_SHARD_TOL of the single
    solve. Returns (the ring run's launches, kernel D's timing on the
    route, the gates missed)."""
    import torch
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
    from stereovision_slam_torch.slam.backend import optimize_window_plain

    t_phase = time.perf_counter()
    missed = []
    m, cl, cr, K, F, L, kw = (ba[k] for k in ("m", "cl", "cr", "K", "F",
                                              "L", "kw"))
    mesh = make_ba_mesh(devices=[f"{dev}:0"] * PER_RANK_RANKS, dp=2, mp=2)
    tensor_mesh = make_ba_mesh(PER_RANK_RANKS, dp=2, mp=2, device=dev)
    ms1, _ = optimize_window_plain(
        m, cl, cr, chi2_th=kw["chi2_th"], iters=kw["iters"],
        outlier_rounds=0, max_active_landmarks=kw["max_active_landmarks"])
    launches, ms, records = None, {}, []
    for impl in ("ring", "xla"):
        run = build_sharded_ba(mesh, K, F, L, reduce_impl=impl, **kw)
        k_t, l_t = build_sharded_ba(tensor_mesh, K, F, L, reduce_impl=impl,
                                    **kw)(m, cl, cr)
        for mod in counters.values():
            mod.launch_count = 0
        with ranks_held(records):
            (k_r, l_r), _ = timed(lambda: run(m, cl, cr))
        if impl == "ring":
            launches = {k: mod.launch_count for k, mod in counters.items()}
        _, t = timed(lambda: run(m, cl, cr))
        ms[impl] = 1e3 * t
        for name, k_b, l_b, tol in (
                ("phase 11's route at (2, 2)", k_t, l_t, SHARD_RING_TOL),
                ("the single-card BA", ms1.kf_pose, ms1.lm_pos,
                 SHARD_SINGLE_TOL)):
            ok, msg = ba["compare"](f"per-rank {impl} vs {name}", k_r, l_r,
                                    k_b, l_b, tol)
            if not ok:
                missed.append(f"phase 22: {msg}")
        if not (k_r.device == mesh.device and bool(torch.isfinite(k_r).all())
                and bool(torch.isfinite(l_r).all())):
            missed.append(f"phase 22: per-rank {impl} gave non-finite "
                          f"values or left {mesh.device}")
    held = all(r["equal"] for r in records)
    n_d = launches["ring_all_reduce"]
    print(f"phase 22: per-rank sharded BA, {PER_RANK_RANKS} ranks on "
          f"{dev}:0 at (2, 2): launches on the ring run {launches}; "
          f"{len(records)} kernel D calls on payloads "
          f"{records[0]['shape'] if records else None}, bit-equal to the "
          f"plain version: {held}; wall per call ring {ms['ring']:.1f} ms, "
          f"xla {ms['xla']:.1f} ms (phase 11, (4, 2) as tensor axes: ring "
          f"{ba['ms_ring']:.1f} ms, xla {ba['ms_xla']:.1f} ms)")
    if n_d != kw["iters"]:
        missed.append(f"phase 22: kernel D launched {n_d} times on one "
                      f"card, not {kw['iters']}")
    if not held or not records:
        missed.append("phase 22: a kernel D launch of the per-rank route "
                      "differs from its plain version")
    g = pgo["g"]
    pgo_mesh = make_ba_mesh(devices=[f"{dev}:0"] * PER_RANK_RANKS)
    out, t_pgo = timed(lambda: build_sharded_pgo(pgo_mesh)(g))
    d = float((out - pgo["out1"]).abs().max())
    c2 = pgo["chi2"](out)
    print(f"phase 22: per-rank sharded PGO over {PER_RANK_RANKS} ranks "
          f"{d:.3e} from the single solve (tolerance {PGO_SHARD_TOL}), chi2 "
          f"{c2:.4e} (single {pgo['c1']:.4e}); {t_pgo:.2f} s a solve "
          f"(phase 12's first solves: single {pgo['s_single_first']:.2f} s, "
          f"8 ranks as tensor axes {pgo['s_sharded_first']:.2f} s); phase "
          f"22 {time.perf_counter() - t_phase:.1f} s")
    if not (d <= PGO_SHARD_TOL and c2 <= pgo["c1"] * 1.05 + 1e-8):
        missed.append(f"phase 22: per-rank PGO {d}, chi2 {c2}")
    return launches, dict(ms_ring=ms["ring"], ms_xla=ms["xla"],
                          pgo_s=t_pgo), missed


def shared_cfg(**overrides):
    """The reference scenarios' one operating point
    (tests/test_loop_scenes.py:41-56): 250 features, LK 12, pose 3 x 6, BA
    6 and `PLACENET_LOOP_GATES`, with the keys the reference's
    per-sequence configs vary as `overrides`."""
    from stereovision_slam_torch.slam.config import (PLACENET_LOOP_GATES,
                                                     SlamConfig)

    cfg = SlamConfig(num_features=250, lk_max_iters=12, pose_rounds=3,
                     pose_iters_per_round=6, ba_lm_iters=6, **overrides)
    for k, v in PLACENET_LOOP_GATES.items():
        setattr(cfg, k, v)
    return cfg


def scenario_run(label: str, scene, cfg, counters, dev, params,
                 totals: dict, chunked: bool = True, records=None,
                 pgo: bool = False) -> dict:
    """Phase 20: one scenario, (lefts, rights, gt) rendered on the card,
    through the loop path on "cuda": `ScanLoopVisualOdometry` (chunk 8),
    or with `chunked` False `FusedLoopVisualOdometry` with every kernel A
    and B launch recorded into `records`; the counters set to 0 before it,
    its launches added to `totals`; then PGO if `pgo`. Prints and returns
    fps, keyframes, loops, inliers and ATE (keyframes, and after PGO)."""
    import numpy as np
    import torch
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry, ScanLoopVisualOdometry)
    from stereovision_slam_torch.utils.evaluation import ate_rmse

    lefts, rights, gt = scene
    gt = dict(enumerate(gt))
    T = len(lefts)
    kw = {"chunk_size": SCEN_CHUNK} if chunked else {}
    vo = (ScanLoopVisualOdometry if chunked else FusedLoopVisualOdometry)(
        cfg, ArraySequenceDataset(lefts, rights,
                                  list(scenes.make_stereo_rig())),
        place_params=params, max_total_keyframes=SCEN_MAX_KF,
        max_total_landmarks=SCEN_MAX_LM, device=dev, **kw)
    vo.initialize()
    for mod in counters.values():
        mod.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (recorded(records) if records is not None
          else contextlib.nullcontext()):
        vo.run()
    dt = time.perf_counter() - t0
    launches = {k: m.launch_count for k, m in counters.items()}
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n
    keyframes, _, frames = vo.drain()
    info = dict(vo=vo, keyframes=keyframes, edges=vo.loop_edges(),
                n_in=np.array([int(f.n_inliers) for _, f in frames]),
                ate=ate_rmse(dict(keyframes.values()), gt, align=False),
                ate_pgo=None)
    if pgo:
        info["ate_pgo"] = ate_rmse(vo.run_pgo(), gt, align=False)
    edges = info["edges"]
    print(f"phase 20 {label}: {T} frames in {dt:.3f} s = {T / dt:.2f} fps "
          f"({type(vo).__name__}, host clock, ends in synchronize), "
          f"{len(keyframes)} keyframes, {len(edges)} loops "
          f"{[(e.kf_id, e.loop_kf_id) for e in edges]}, inliers >= "
          f"{info['n_in'][1:].min()}, keyframe ATE {info['ate']:.4f} m"
          + (f", after PGO {info['ate_pgo']:.4f} m" if pgo else "")
          + f"; launches {launches}")
    info["fps"] = T / dt
    return info


def scenario_phase(counters, dev, params) -> tuple[dict, float, float, list]:
    """Phase 20: the reference's loop-scene scenarios on the card, each
    with the reference's settings and its own assertions: (a) the
    figure-eight closes >= 2 loops, one spanning >= 40 keyframes, and PGO
    does not degrade it; (b) the 4-fold aliased arena over 3/4 of a circle
    and (c) the straight self-similar corridor accept no loop; (d)
    PlaceNet's candidate precision and recall on the 96-frame circuit at
    the strong gate >= 0.7; (e) a seeded MobileNet-V2 at the reference's
    gates tracks the 40-frame circle with no loop; (f) the hard scene's
    renderer, then 100 hard frames with inliers > 10 on > 90% of frames
    and ATE after PGO < 3% of the path, chunked and eager (every kernel A
    and B launch of the eager run held to its plain version after it); (g) the 150-frame corridor with
    `SlamConfig()` through `ScanVisualOdometry`: inliers > 30, > 10
    keyframes, drift < 2% (through `trajectory()`). Returns (kernel A and
    B launches, their largest errors on the hard scene, the gates
    missed)."""
    import numpy as np
    import torch
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.apps.train_place_net import candidate_pr
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.models import mobilenet_v2, place_net
    from stereovision_slam_torch.slam.config import (PLACENET_LOOP_GATES,
                                                     SlamConfig)
    from stereovision_slam_torch.slam.fused import ScanVisualOdometry
    from stereovision_slam_torch.utils.evaluation import ate_rmse

    t_phase = time.perf_counter()
    arena = dict(center=(0.0, 6.0), radius=25.0, device=dev)

    def render(fn, poses, **kw):
        lefts, rights = fn(poses, **kw)
        return (lefts.cpu().numpy(), rights.cpu().numpy(),
                np.asarray(poses.numpy()))

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    totals, missed = {}, []

    def gate(ok: bool, msg: str) -> None:
        if not ok:
            missed.append(f"phase 20 {msg}")

    every_frame = shared_cfg(num_features_needed_for_keyframe=1000)
    # (a) the figure-eight: two same-heading revisits of the crossing
    scene = render(scenes.render_arena_stereo_sequence,
                   scenes.figure_eight_poses(112, step=0.5), **arena)
    r = scenario_run("(a) figure-eight", scene, every_frame, counters, dev,
                     params, totals, pgo=True)
    spans = sorted(e.kf_id - e.loop_kf_id for e in r["edges"])
    gate(len(spans) >= 2 and spans[-1] >= 40,
         f"(a): loops spanning {spans} keyframes (>= 2, one >= 40)")
    gate(bool(np.isfinite(r["ate_pgo"])) and r["ate_pgo"] <= r["ate"] + 1e-6,
         f"(a): PGO degraded the trajectory: {r['ate']} -> {r['ate_pgo']}")
    # (b) perceptual aliasing: 3/4 of a circle, every candidate false
    scene = render(scenes.render_arena_stereo_sequence,
                   scenes.forward_motion_poses(72, step=0.5,
                                               yaw_rate=2 * np.pi / 96),
                   wall_symmetry=4, **arena)
    r = scenario_run("(b) aliased arena", scene, every_frame, counters, dev,
                     params, totals)
    for e in r["edges"]:
        d = np.linalg.norm(center(scene[2][r["keyframes"][e.kf_id][0]])
                           - center(scene[2][r["keyframes"][e.loop_kf_id][0]]))
        gate(d < 2.0, f"(b): false fusion {e.kf_id}->{e.loop_kf_id}, "
                      f"{d:.1f} m apart")
    gate(not r["edges"], f"(b): {len(r['edges'])} aliased loops accepted")
    # (c) the straight self-similar corridor: no revisit
    scene = render(scenes.render_textured_stereo_sequence,
                   scenes.forward_motion_poses(80, step=0.5), device=dev)
    r = scenario_run("(c) corridor", scene, every_frame, counters, dev,
                     params, totals)
    gate(not r["edges"], f"(c): {len(r['edges'])} loops on the corridor")
    # (d) PlaceNet's candidates on the 96-frame circuit at the strong gate
    poses = scenes.forward_motion_poses(96, step=0.35,
                                        yaw_rate=2 * np.pi / 88)
    lefts, _, gt = render(scenes.render_arena_stereo_sequence, poses,
                          **arena)
    embs = torch.stack([place_net.embed_image(params, torch.from_numpy(
        l).to(dev)) for l in lefts]).cpu().numpy()
    cen = np.stack([center(p) for p in gt])[:, [0, 2]]
    yaws = np.array([np.arctan2(-p[2, 0], p[2, 2]) for p in gt])
    prec, rec, fired, have = candidate_pr(
        embs, cen, yaws, PLACENET_LOOP_GATES["potential_loop_strong_threshold"],
        PLACENET_LOOP_GATES["keyframes_to_skip_in_candidate_search"])
    print(f"phase 20 (d) PlaceNet on the 96-frame circuit at the strong "
          f"gate: precision {prec:.3f}, recall {rec:.3f} ({fired} fired, "
          f"{have} frames with a true revisit)")
    gate(have > 0 and prec >= 0.7 and rec >= 0.7,
         f"(d): precision {prec:.3f}, recall {rec:.3f} (>= 0.7 each)")
    # (e) MobileNet-V2 (seeded) at the reference's own gates
    cfg = SlamConfig(num_features=250, num_features_needed_for_keyframe=1000,
                     keyframes_to_skip_in_candidate_search=15,
                     potential_loop_strong_threshold=0.95,
                     potential_loop_weak_threshold=0.92,
                     max_num_weak_threshold=3,
                     min_num_acceptable_keypoint_match=10, lk_max_iters=12,
                     pose_rounds=3, pose_iters_per_round=6, ba_lm_iters=6)
    scene = render(scenes.render_arena_stereo_sequence,
                   scenes.forward_motion_poses(40, step=0.5,
                                               yaw_rate=2 * np.pi / 40),
                   **arena)
    r = scenario_run("(e) MobileNet-V2", scene, cfg, counters, dev,
                     mobilenet_v2.init_params(seed=0, device=dev), totals)
    finite = all(np.isfinite(p).all() for _, p in r["keyframes"].values())
    gate(len(r["keyframes"]) >= 40 - 5 and finite and not r["edges"],
         f"(e): {len(r['keyframes'])} keyframes, finite {finite}, "
         f"{len(r['edges'])} loops")
    # (f) the hard scene: the renderer, then the loop path, held
    poses = scenes.forward_motion_poses(3, step=0.35,
                                        yaw_rate=2 * np.pi / 112)
    hard = scenes.render_hard_arena_stereo_sequence(poses, **arena)[0]
    clean = scenes.render_arena_stereo_sequence(poses, **arena)[0]
    l0, l1, c0 = (x.cpu().numpy() for x in (hard[0], hard[1], clean[0]))
    d_clean = float(np.mean(np.abs(l0 - c0)))
    moved = float(np.mean(np.abs(l1 - l0) > 25))
    print(f"phase 20 (f) hard renderer: mean |hard - clean| {d_clean:.2f}, "
          f"{100 * moved:.2f}% of pixels change > 25 between frames 0 and "
          f"1, values in [{l0.min():.2f}, {l0.max():.2f}]")
    gate(d_clean > 5.0 and moved > 0.01 and bool(np.isfinite(l0).all())
         and l0.min() >= 0.0 and l0.max() <= 255.0,
         f"(f): the hard renderer: {d_clean}, {moved}")
    T = 100
    scene = render(scenes.render_hard_arena_stereo_sequence,
                   scenes.forward_motion_poses(
                       T, step=0.35, yaw_rate=2 * np.pi / (T - 8)), **arena)
    # chunked, then eager with every kernel A and B launch recorded (a
    # graph replay launches without Python, so only the eager run can
    # record them); the reference's gates on both
    records, dist = [], 0.35 * T
    for chunked in (True, False):
        how = "chunked" if chunked else "eager"
        r = scenario_run(f"(f) hard scene, {how}", scene, loop_config(),
                         counters, dev, params, totals, chunked=chunked,
                         records=None if chunked else records, pgo=True)
        ok_share = float((r["n_in"][1:] > 10).mean())
        gate(ok_share > 0.9,
             f"(f) {how}: inliers > 10 on {ok_share:.3f} of frames")
        gate(bool(np.isfinite(r["ate_pgo"])) and r["ate_pgo"] < 0.03 * dist,
             f"(f) {how}: ATE after PGO {r['ate_pgo']} over {dist} m")
    a_err, b_err, failed = hold_recorded(records, "phase 20 (f) hard scene",
                                         r["vo"].cfg.num_features_tracking_bad)
    missed += failed
    # (g) the long corridor with the default config, chunked odometry
    T = 150
    lefts, rights, gt = render(scenes.render_textured_stereo_sequence,
                               scenes.forward_motion_poses(T, step=0.4),
                               device=dev)
    vo = ScanVisualOdometry(SlamConfig(), ArraySequenceDataset(
        lefts, rights, list(scenes.make_stereo_rig())), device=dev)
    vo.initialize()
    for mod in counters.values():
        mod.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vo.run()
    dt = time.perf_counter() - t0
    launches = {k: m.launch_count for k, m in counters.items()}
    for k, n in launches.items():
        totals[k] = totals.get(k, 0) + n
    traj = vo.trajectory()
    n_in = np.array([int(f.n_inliers) for _, f in vo.outputs])
    err = ate_rmse(traj, dict(enumerate(gt)), align=False)
    dist = 0.4 * T
    print(f"phase 20 (g) long corridor: {T} frames in {dt:.3f} s = "
          f"{T / dt:.2f} fps (ScanVisualOdometry, SlamConfig()), "
          f"{len(traj)} keyframes, inliers >= {n_in[1:].min()}, drift "
          f"{err:.4f} m over {dist:.0f} m ({100 * err / dist:.3f}%); "
          f"launches {launches}")
    gate(n_in[1:].min() > 30 and len(traj) > 10 and err / dist < 0.02,
         f"(g): inliers >= {n_in[1:].min()}, {len(traj)} keyframes, drift "
         f"{err / dist:.4f}")
    gate(totals["lk_pyramid"] > 0 and totals["pose_lm"] > 0,
         f"kernels A and B launched {totals}")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s; kernel A and B "
          f"launches {totals['lk_pyramid']}, {totals['pose_lm']}; "
          + ("every gate met" if not missed else "MISSED: "
             + "; ".join(missed)))
    return totals, a_err, b_err, missed


def training_phase(tmp: str, dev, shipped) -> list:
    """Phase 21: `apps.train_place_net` at its defaults on the card into a
    temporary --out: the loss finite and its last LOSS_WINDOW steps' mean
    under its first's; the new weights pass the reference's held-out
    world test (tests/test_place_net.py:49-85); the validation table beside
    the shipped weights' on the bench world; the shipped file unchanged.
    Returns the gates missed."""
    import hashlib

    import numpy as np
    from stereovision_slam_torch.apps import train_place_net as tp
    from stereovision_slam_torch.models import place_net

    def digest() -> str:
        with open(place_net.WEIGHTS_PATH, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    t_phase = time.perf_counter()
    before = digest()
    out = os.path.join(tmp, "place_net_trained.npz")
    s = tp.run(tp.parse_args(["--out", out, "--device", str(dev)]))
    losses = s["losses"]
    first = float(np.mean(losses[:LOSS_WINDOW]))
    last = float(np.mean(losses[-LOSS_WINDOW:]))
    print(f"phase 21: {len(losses)} steps in {s['train_s']:.2f} s = "
          f"{s['steps_per_s']:.1f} steps/s (batch 192 pairs, float32, TF32 "
          f"off), dataset rendered in {s['render_s']:.2f} s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first "
          f"{LOSS_WINDOW} steps {first:.4f}, of the last {last:.4f}")
    new = place_net.load_params(out, device=dev)
    missed = []
    heldout = {}
    for name, params in (("trained", new), ("shipped", shipped)):
        pos, neg = tp.heldout_discrimination(params, dev)
        heldout[name] = (pos, neg)
        print(f"phase 21: held-out world (phase 57.3), {name} weights: "
              f"positives {min(pos):.3f}-{max(pos):.3f} (mean "
              f"{np.mean(pos):.3f}), negatives up to {max(neg):.3f}")
    shipped_table = tp.validate(shipped, dev, phases=(0.0,))
    print("phase 21: the bench world (phase 0.0), shipped weights:")
    tp.print_table(shipped_table, print)
    print("phase 21: the held-out circuits, the new weights:")
    tp.print_table(s["table"], print)
    pos, neg = heldout["trained"]
    if not (np.isfinite(losses).all() and last < first):
        missed.append(f"phase 21: the loss {first} -> {last}, finite "
                      f"{bool(np.isfinite(losses).all())}")
    if not (min(pos) > max(neg) + 0.1 and np.mean(pos) > 0.8):
        missed.append(f"phase 21: the trained weights do not discriminate "
                      f"the held-out world: {pos}, {neg}")
    if digest() != before:
        missed.append("phase 21: the shipped weights file changed")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s; "
          + ("every gate met" if not missed else "MISSED: "
             + "; ".join(missed)))
    return missed


TRACE_T = 200    # phase 23: frames of the traced and untraced loop runs


def tracing_run(scene, dev, params, traced: bool, n: int | None = None):
    """`ScanLoopVisualOdometry` (chunks of 1) over the scene's first n
    (TRACE_T) frames, each frame handed over and synchronized on the host
    clock, the recorder on where `traced`. Returns (poses (n, 3, 4), per-frame ms,
    the pipeline, the recorder's records or None)."""
    import numpy as np
    import torch

    from stereovision_slam_torch.slam.fused_loop import (
        ScanLoopVisualOdometry)
    from stereovision_slam_torch.utils import profiling

    n = n or TRACE_T
    lefts, rights, _, _, rig = scene
    ld = torch.as_tensor(lefts[:n], device=dev)
    rd = torch.as_tensor(rights[:n], device=dev)
    vo = loop_vo(ScanLoopVisualOdometry, lefts[:n], rights[:n], rig, dev,
                 params, chunk_size=1, max_frames=n + 8)
    profiling.reset()
    if traced:
        profiling.enable()
    try:
        ms = []
        for t in range(n):
            torch.cuda.synchronize()
            a = time.perf_counter()
            vo.step_chunk(ld[t:t + 1], rd[t:t + 1], None, np.ones(1, bool),
                          host_fids=[t], n=1)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - a))
        records = profiling.read() if traced else None
    finally:
        profiling.disable()
        profiling.reset()
    return vo.out_buf.pose[:n].cpu().numpy(), ms, vo, records


def tracing_phase(scene, dev, params) -> list:
    """Phase 23: the recorder on the card. The loop path over TRACE_T
    frames untraced twice and traced once: the traced poses equal the
    untraced ones bit for bit; in each keyframe frame every device span
    reads a positive time and they sum to no more than the frame's
    host-to-synchronize window; with the recorder off each graph launches
    per replay the kernels of the same graph captured with every recorder
    call stubbed out (the program before the recorder). Returns the gates
    missed."""
    import numpy as np

    from tests.torch_tracing import graph_kernels, stubbed_recorder
    from stereovision_slam_torch.utils import profiling

    missed = []
    t0 = time.perf_counter()
    p_off, ms_off, vo_off, _ = tracing_run(scene, dev, params, False)
    p_off2, _, _, _ = tracing_run(scene, dev, params, False)
    p_on, ms_on, vo_on, rec = tracing_run(scene, dev, params, True)
    print(f"phase 23: three {TRACE_T}-frame loop runs in "
          f"{time.perf_counter() - t0:.1f} s; median frame ms untraced "
          f"{np.median(ms_off):.3f}, traced {np.median(ms_on):.3f}; "
          f"untraced runs bit-equal: {np.array_equal(p_off, p_off2)}")
    if not np.array_equal(p_on, p_off):
        gap = float(np.abs(p_on - p_off).max())
        missed.append(f"traced poses differ from untraced by {gap:.3e}")
    kf = {}
    for d in rec["device_spans"]:
        kf.setdefault(d["request"][1], []).append(d)
    worst, bad = 0.0, []
    for fid, ds in kf.items():
        tot = sum(d["ms"] for d in ds)
        worst = max(worst, tot / ms_on[fid])
        bad += [(fid, d["name"], d["ms"]) for d in ds if not d["ms"] > 0]
        if tot > ms_on[fid]:
            missed.append(f"frame {fid}: device spans {tot:.3f} ms over its "
                          f"window {ms_on[fid]:.3f} ms")
    print(f"phase 23: {len(kf)} frames with device spans, "
          f"{len(rec['device_spans'])} spans; the largest share of a "
          f"frame's window they cover {worst:.3f}")
    if bad or not kf:
        missed.append(f"device spans not positive: {bad[:5]}")
    off = graph_kernels(vo_off)
    on = graph_kernels(vo_on)
    with stubbed_recorder():
        _, _, vo_stub, _ = tracing_run(scene, dev, params, False)
    stub = graph_kernels(vo_stub)
    print(f"phase 23: device kernels per replay, recorder off {off}, on "
          f"{on}, recorder calls stubbed {stub}")
    for k in set(off) & set(stub):
        if off[k] != stub[k]:
            missed.append(f"graph {k}: {off[k]} kernels a replay with the "
                          f"recorder off, {stub[k]} without the recorder")
    print(profiling.report(rec))
    return missed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", type=int, default=0,
                    help="also profile this many frames of the slice and "
                         "of the serving streams, one call each of the "
                         "sharded BA, the single-card BA and PGO, and the "
                         "loop path over the whole circuit")
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
            _cuda, ba_kernel, gather, lk_iterate, lk_lanes, pose_kernel)
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
    kernels[1]["streams_4x3"] = check_pose_streams(dev)
    ba_row = check_ba(dev)

    # 4. the slice on the card, counters read around this run only
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce,
                "ring_all_reduce owner form": OwnedLaunches(ring_reduce),
                "ba_window": ba_kernel}
    T = len(lefts)
    for mod in counters.values():
        mod.launch_count = 0
    vo, dt = run_slice(lefts, rights, rig, dev)
    launches = {k: m.launch_count for k, m in counters.items()}
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])
    kf_counts = [int(f.kf_count) for _, f in frames]
    inserted = [bool(f.kf_inserted) for _, f in frames]
    slice_fps = T / dt
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
    want_lk = 2 * tracked + kf_steps     # one launch per LK call
    check(launches["lk_pyramid"] == want_lk,
          f"kernel A launched {launches['lk_pyramid']} times, not {want_lk}")
    check(launches["pose_lm"] == tracked,
          f"kernel B launched {launches['pose_lm']} times, not {tracked}")
    check(launches["lk_iterate"] == 0 and launches["gather_windows"] == 0,
          "the slice launched kernel C or the gather")
    # one BA pass, one launch, a keyframe step after the initialization
    check(launches["ba_window"] == kf_steps - 1,
          f"the BA kernel launched {launches['ba_window']} times, not "
          f"{kf_steps - 1}")
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
    ba_keep, pgo_keep, dense_keep = {}, {}, {}
    by_path["sharded_ba"], kernels[-1]["max_abs_err"] = sharded_ba_phase(
        vo, counters, dev, kernels[-1]["max_abs_err"], bool(args.profile),
        ba_keep)
    pgo_phase(keyframes, gt, dev, bool(args.profile), pgo_keep)

    # 13. the bench's main path: loop closure on the circuit and on the
    # 480-frame multi-lap circuit, every kernel A and B launch held
    from stereovision_slam_torch.models import place_net
    params = place_net.get_params(device=dev)
    check(params is not None, f"no PlaceNet weights at {place_net.WEIGHTS_PATH}")
    scenes_loop = {"circuit": (lefts, rights, gt, dist, rig)}
    t0 = time.perf_counter()
    scenes_loop["circuit_long"] = scenes.circuit_long(LONG_T, 188, 620,
                                                      device=dev)
    print(f"rendered the long circuit ({LONG_T} frames) in "
          f"{time.perf_counter() - t0:.1f} s")
    missed, eager_loop = [], {}
    for name, scene in scenes_loop.items():
        by_path[f"loop_{name}"], a_err, b_err, failed, eager_loop[name] = \
            loop_phase(name, scene, counters, dev, params)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], a_err)
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_err)
        missed += failed
    # 14. the command line on the circuit written as a KITTI sequence
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="svslam_kitti_")
    try:
        cli_paths, a_err, b_err, failed, outputs = cli_phase(
            scenes_loop["circuit"], counters, dev, tmp)
        by_path.update(cli_paths)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], a_err)
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_err)
        missed += failed
        # 16. the dense tool's command line on phase 14's fused run
        missed += dense_phase(outputs, tmp, dev, keep=dense_keep)
        # 17. MobileNet-V2: the fused loop path and the classic CLI
        mnv2_paths, failed = mobilenet_phase(scenes_loop["circuit"], outputs,
                                             tmp, counters, dev)
        by_path.update(mnv2_paths)
        missed += failed
        # 18. FAST corners (the ORB option) on the slice
        fast_paths, failed = fast_phase(scenes_loop["circuit"], counters, dev)
        by_path.update(fast_paths)
        missed += failed
        # 15. the chunked modes: CUDA-graph replays of the fused step's
        # branches and PGO's graph
        chunked_paths, failed = chunked_phase(
            scenes_loop, (lefts, rights, gt, dist, rig), counters, dev, params,
            eager_loop, slice_fps, args.profile)
        by_path.update(chunked_paths)
        missed += failed
        # 19. the distributed backend across two processes on the card,
        # serving over a mesh, the dense tool over mesh ranks
        by_path["sharded_ba_2proc"] = dict.fromkeys(counters, 0)
        n_d, kernels[-1]["cross_process"], failed = dist_phase(
            ba_keep, pgo_keep, kernels[-1], dev)
        by_path["sharded_ba_2proc"]["ring_all_reduce"] = n_d
        by_path["sharded_ba_2proc"]["ring_all_reduce owner form"] = \
            kernels[-1]["cross_process"].get("owned_launches", 0)
        missed += failed
        by_path["serving_mesh"], failed = serving_mesh_phase(
            streams, rig, counters, dev)
        missed += failed
        missed += dense_mesh_phase(dense_keep, tmp, dev)
        # 20. the reference's loop-scene scenarios, rendered on the card
        by_path["scenarios"], a_err, b_err, failed = scenario_phase(
            counters, dev, params)
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], a_err)
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], b_err)
        missed += failed
        # 21. PlaceNet's training on the card
        missed += training_phase(tmp, dev, params)
        # 22. the per-rank route (the reference's single-process layout
        # over chips) with its four ranks on the card
        by_path["per_rank_ba"], kernels[-1]["per_rank"], failed = \
            per_rank_phase(ba_keep, pgo_keep, counters, dev)
        missed += failed
        # 23. the recorder's spans and counters inside the loop path
        missed += tracing_phase(scenes_loop["circuit_long"], dev, params)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.profile:
        from stereovision_slam_torch.io.dataset import ArraySequenceDataset
        from stereovision_slam_torch.slam.fused_loop import (
            FusedLoopVisualOdometry)
        vo_l = FusedLoopVisualOdometry(
            loop_config(), ArraySequenceDataset(lefts, rights, list(rig)),
            place_params=params, max_total_keyframes=512,
            max_total_landmarks=1 << 16, device=dev)
        vo_l.initialize()
        profile_run("loop", vo_l.run, T - 1)

    # launches: kernels A and B on the loop path over both scenes (the
    # main path), on the command line's classic and fused runs and on this
    # MobileNet and FAST paths and on the scenarios, kernel
    # C and the gather on the serving run with the per-level LK, kernel D
    # on the sharded BA; every path's counts beside them
    ab_paths = ("loop_circuit", "loop_circuit_long", "cli_classic",
                "cli_fused", "mnv2_loop", "mnv2_cli_classic", "fast_slice",
                "fast_serving", "serving_mesh", "scenarios")
    main_path = {"lk_pyramid": ab_paths, "pose_lm": ab_paths,
                 "ba_window": ab_paths,
                 "lk_iterate": ("serving_pallas",),
                 "gather_windows": ("serving_pallas",),
                 "ring_all_reduce": ("sharded_ba", "sharded_ba_2proc",
                                     "per_rank_ba")}
    # the owner form, counted apart on kernel D's paths (on one card they
    # launch the table form)
    owned = kernels[-1]["owned"]
    owned["launches"] = sum(by_path[p][owned["name"]]
                            for p in main_path["ring_all_reduce"])
    owned["launches_by_path"] = {p: by_path[p][owned["name"]]
                                 for p in main_path["ring_all_reduce"]}
    kernels.append(ba_row)
    for k in kernels:
        k["launches"] = sum(by_path[p][k["name"]] for p in main_path[k["name"]])
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "cold_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "library_cold_ms",
            "streams_4x3", "wide", "cross_process", "per_rank", "owned",
            "cases", "launches_by_path")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys if k in kern}
                                  for kern in kernels]}))
    print(smi)
    # the bench's gates of phases 13 to 21, after everything else is
    # reported
    check(not missed, "; ".join(missed))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
