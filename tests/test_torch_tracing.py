"""The port's recorder (`utils/profiling.py`): spans, counters and the
graph runner's bookkeeping of them, a traced loop run against an untraced
one, and the benchmark's readers of the span stretch (`portbench/spans.py`,
`portbench/metrics/`) on a record made by hand.

Everything here runs on the CPU; what needs the card (device spans inside
replayed graphs, launches per replay with the recorder off, a traced run
bit for bit against an untraced one) is in tests/test_torch_cuda.py and
chip_smoke.py's phase 23.
"""

import contextlib
import json
import math
import sys
import types

import numpy as np
import pytest
import torch

from portbench import spans as bspans
from portbench.run import BENCH, FORBIDDEN, load_file
from stereovision_slam_torch import scenes
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import fused, fused_loop, graphs
from stereovision_slam_torch.slam.backend import optimize_window
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def test_recorder_off_records_nothing():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.NO_SPAN
    assert profiling.span("b", request=(0, 1)) is profiling.NO_SPAN
    assert profiling.device_span("c") is profiling.NO_SPAN
    with profiling.span("a"), profiling.device_span("c"):
        profiling.count("n", 3)
        profiling.device_count("d", torch.ones(()))
        profiling.kernel_launch("A", "t", [torch.ones(4)],
                                iterations=torch.ones(()))
    reads = {}
    assert profiling.host_read("inliers", torch.tensor(7), int, reads) == 7
    assert reads == {"inliers": 1}
    r = profiling.read()
    assert r["spans"] == [] and r["counts"] == {}
    assert r["device_counts"] == {} and r["device_spans"] == []
    assert profiling.counts() == {}


def test_spans_nest_with_parents_requests_and_self_time():
    profiling.enable()
    with profiling.span("frame", request=(3, 17)):
        with profiling.span("graph.replay", ("keyframe", True)):
            torch.ones(64, 64).sum()
        with profiling.device_span("kf.ba"):
            profiling.host_read("inliers", torch.tensor(5), int)
    with profiling.span("pgo", request=(3, None)):
        pass
    r = profiling.read()
    names = [s["name"] for s in r["spans"]]
    assert names == ["frame", "graph.replay", "kf.ba", "host_read.inliers",
                     "pgo"]
    parent = {s["name"]: s["parent"] for s in r["spans"]}
    assert parent == {"frame": -1, "graph.replay": 0, "kf.ba": 0,
                      "host_read.inliers": 2, "pgo": -1}
    req = {s["name"]: s["request"] for s in r["spans"]}
    assert req["graph.replay"] == req["host_read.inliers"] == (3, 17)
    assert req["pgo"] == (3, None)
    kinds = {s["name"]: s["kind"] for s in r["spans"]}
    assert kinds["kf.ba"] == "device@host" and kinds["frame"] == "host"
    assert r["spans"][1]["attr"] == "('keyframe', True)"
    own = profiling.self_ns(r["spans"])
    dur = [s["end_ns"] - s["start_ns"] for s in r["spans"]]
    assert own[0] == dur[0] - dur[1] - dur[2] and own[2] == dur[2] - dur[3]
    assert own[1] == dur[1] and all(x >= 0 for x in own)
    summ = profiling.summary(r)
    assert summ["frame"]["count"] == 1
    assert summ["frame"]["self_ms"] == pytest.approx(own[0] / 1e6)
    assert "graph.replay" in profiling.report(r)
    profiling.reset()
    assert profiling.read()["spans"] == []


def test_span_start_on_the_profiler_clock():
    """A span's start, moved by the recorder's clock pair, lies within
    0.5 ms of its record_function event in a torch.profiler session (after
    the session's first record_function, which takes ~1 ms to set up; the
    median of five spans, as a loaded machine may preempt one between the
    two clock readings)."""
    from torch.profiler import ProfilerActivity, profile
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("probe.first"):
            pass
        for _ in range(5):
            with profiling.span("probe.span"):
                torch.ones(32).sum()
    r = profiling.read()
    ours = sorted(s["start_ns"] + r["epoch_offset_ns"] for s in r["spans"]
                  if s["name"] == "probe.span")
    theirs = sorted(int(e.start_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe.span")
    assert len(ours) == len(theirs) == 5
    gaps = sorted(abs(a - b) for a, b in zip(ours, theirs))
    assert gaps[2] < 500_000


@contextlib.contextmanager
def _fake_cuda(monkeypatch):
    """What `GraphRunner._capture` calls of CUDA, as no-op stand-ins: a
    graph whose replay does nothing, streams and a pool."""
    class Graph:
        def capture_begin(self, pool=None):
            pass

        def capture_end(self):
            pass

        def replay(self):
            pass

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(graphs, "_linalg_on_cusolver",
                        contextlib.nullcontext)
    monkeypatch.setattr(profiling.RECORDER, "prepare", lambda dev: None)
    yield


def test_runner_adds_host_counters_again_on_every_replay(monkeypatch):
    """The runner's bookkeeping with CUDA stood in: the warm-up counts, the
    capture's counts are taken back, every replay adds them again (the
    recorder's counters as the kernel modules' launches); a graph captured
    with the recorder on is another graph than the one captured off."""
    mod = types.ModuleType("stand_in_kernel")    # a kernel module's counter
    mod.launch_count = 0
    out = torch.zeros(())

    def fn():
        mod.launch_count += 1
        profiling.count("kernel.X.bytes[t]", 40)
        return [(out, torch.ones(()))]
    with _fake_cuda(monkeypatch):
        runner = graphs.GraphRunner("cpu", modules=(mod,))
        runner.device = torch.device("cuda")
        profiling.enable()
        for _ in range(3):
            runner.run("k", fn)
        assert profiling.counts() == {"kernel.X.bytes[t]": 40 * 4}
        assert mod.launch_count == 4
        assert runner.warm_launches == {"stand_in_kernel": 1}
        assert set(runner.graphs) == {graphs.Traced("k")}
        profiling.disable()
        runner.run("k", fn)
        assert set(runner.graphs) == {graphs.Traced("k"), "k"}
        assert mod.launch_count == 6 and runner.replays == 4
        assert runner.per_replay["k"] == {mod: 1}
        kinds = [s["name"] for s in profiling.read()["spans"]]
    assert kinds.count("graph.replay") == 3
    assert kinds.count("graph.capture") == kinds.count("graph.record") == 1


def test_device_counters_accumulate_and_reset_in_place():
    profiling.enable()
    profiling.device_count("ba.lm_overflow", torch.tensor(5))
    profiling.device_count("ba.lm_overflow", torch.tensor([2.5]))
    profiling.device_count("ba.passes", 1, device="cpu")
    acc = profiling.RECORDER.acc[torch.device("cpu")]
    assert profiling.read()["device_counts"] == {"ba.lm_overflow": 7.5,
                                                 "ba.passes": 1.0}
    profiling.reset()
    assert profiling.RECORDER.acc[torch.device("cpu")] is acc
    assert profiling.device_counts() == {"ba.lm_overflow": 0.0,
                                         "ba.passes": 0.0}


# -- a traced loop run on the CPU ----------------------------------------- #

T = 32


def _config() -> SlamConfig:
    return SlamConfig(
        num_features=120, num_features_init=20, num_features_tracking=25,
        num_features_tracking_bad=10, num_features_needed_for_keyframe=70,
        max_features=128, max_landmarks=2048, max_keyframes_window=8,
        num_active_keyframes=5, lk_num_levels=3, gftt_min_distance=10,
        lk_max_iters=12, pose_rounds=3, pose_iters_per_round=6,
        ba_lm_iters=6, ba_max_active_landmarks=256, image_height=94,
        image_width=310, keyframes_to_skip_in_candidate_search=4)


@pytest.fixture(scope="module")
def loop_runs():
    """The circuit's arena at 94 x 310 (the rig halved), T frames through
    `ScanLoopVisualOdometry` (chunk 8), untraced and traced."""
    rig = scenes.make_stereo_rig(fx=175.0, fy=175.0, cx=155.0, cy=47.0)
    poses = scenes.forward_motion_poses(T, step=0.35,
                                        yaw_rate=2 * math.pi / 112)
    lefts, rights = scenes.render_arena_stereo_sequence(
        poses, H=94, W=310, rig=rig, center=(0.0, 6.0), radius=25.0)
    params = place_net.get_params(device="cpu")
    out = []
    for traced in (False, True):
        profiling.reset()
        if traced:
            profiling.enable()
        vo = fused_loop.ScanLoopVisualOdometry(
            _config(), ArraySequenceDataset(lefts.numpy(), rights.numpy(),
                                            list(rig)),
            place_params=params, chunk_size=8, max_total_keyframes=64,
            max_total_landmarks=1 << 13, max_frames=40, device="cpu")
        vo.initialize()
        vo.run()
        traj = vo.run_pgo()
        out.append((vo, traj, profiling.read() if traced else None))
        profiling.disable()
    profiling.reset()
    return out


def test_traced_loop_run_equals_untraced(loop_runs):
    """Bit for bit: outputs, states, loop database and the PGO'd
    trajectory; every frame has its span tree under one request."""
    (a, traj_a, _), (b, traj_b, rec) = loop_runs
    for name in ("fs", "ms", "arc", "ls"):
        for x, y in zip(graphs.leaves(getattr(a, name)),
                        graphs.leaves(getattr(b, name))):
            assert torch.equal(x, y), name
    oa, ob = a.outputs, b.outputs
    assert len(oa) == len(ob) == T
    for (fa, p), (fb, q) in zip(oa, ob):
        assert fa == fb
        for u, v in zip(p, q):
            assert np.array_equal(np.asarray(u), np.asarray(v))
    assert sorted(traj_a) == sorted(traj_b)
    for f in traj_a:
        assert np.array_equal(traj_a[f], traj_b[f])
    assert a.reads == b.reads and a.hook_reads == b.hook_reads > 0
    assert b.kf_count >= 3

    spans = rec["spans"]
    frames = [s for s in spans if s["name"] == "frame"]
    assert [s["request"] for s in frames] == [(b.trace_id, f)
                                              for f in range(T)]
    by_req = bspans.by_request(dict(records=rec, frames=T))
    kf_frames = [f for f, o in ob if bool(o.kf_inserted)][1:]
    for f in range(T):
        names = {s["name"] for s in by_req[(b.trace_id, f)]}
        if f == 0:
            assert {"drive.init", "host_read.new_landmarks"} <= names
            continue
        assert "host_read.inliers" in names
        if f in kf_frames:
            assert {"kf.frontend", "kf.ba", "kf.archive", "hook.embed",
                    "hook.orb", "hook.scan", "hook.insert",
                    "host_read.hook.candidate"} <= names
        for s in by_req[(b.trace_id, f)]:
            if s["name"] != "frame":
                assert spans[s["parent"]]["request"] == s["request"]
    assert {s["name"] for s in spans if s["request"] == (b.trace_id, None)
            } >= {"pgo", "pgo.drain", "pgo.assemble"}
    c = rec["device_counts"]
    assert c["ba.passes"] == len(kf_frames)
    assert sum(1 for s in spans if s["name"] == "kf.ba") == len(kf_frames)


def test_ba_overflow_counter_equals_optimize_window(loop_runs):
    """The keyframe branch's `ba.lm_overflow` counts what a direct
    `optimize_window` call on the same state returns as `lm_overflow`."""
    vo = loop_runs[0][0]
    s = vo._static
    ids = fused.keyframe_ids(999, vo.kf_count + 1, vo.Tmax, "cpu")
    profiling.enable()
    fused.keyframe_branch(vo.fs, vo.ms, vo.arc, vo._right_pyr, ids,
                          vo.cam_left, vo.cam_right, True, **s)
    counted = profiling.read()["device_counts"]
    profiling.disable()
    _, ms2, _, _, _ = fe.keyframe_step(
        vo.fs, vo.ms, vo._right_pyr, vo.cam_left, vo.cam_right,
        ids.frame_id, ids.kf_id, detect_all=False, **fused._kf_kw(s))
    _, stats = optimize_window(ms2, vo.cam_left, vo.cam_right,
                               chi2_th=s["chi2_th"], iters=s["ba_iters"],
                               max_active_landmarks=s["ba_max_active"])
    assert counted["ba.passes"] == 1.0
    assert counted["ba.lm_overflow"] == float(stats[3]) > 0


def test_keyframe_frames_count_one_ba_launch_per_pass(loop_runs):
    """`backend.optimize_window` counts each pass in the recorder, on the
    CPU's plain route as on the kernel: one `kernel.BA.launches[tag]` per
    `ba.passes`, one pass per keyframe frame after the first, with its
    observations and landmarks counted."""
    _, (b, _, rec) = loop_runs
    launches = {k: v for k, v in rec["counts"].items()
                if k.startswith("kernel.BA.launches[")}
    dc = rec["device_counts"]
    kf_frames = [f for f, o in b.outputs if bool(o.kf_inserted)][1:]
    assert sum(launches.values()) == dc["ba.passes"] == len(kf_frames) > 0
    for key in launches:
        tag = key[len("kernel.BA.launches["):-1]
        assert dc[f"kernel.BA.observations[{tag}]"] > 0
        assert dc[f"kernel.BA.landmarks[{tag}]"] > 0
        assert rec["counts"][f"kernel.BA.bytes[{tag}]"] > 0


# -- the benchmark's readers of the span stretch -------------------------- #

def _span(name, t0_ms, t1_ms, parent, request, attr=None, kind="host"):
    return dict(name=name, start_ns=int(t0_ms * 1e6), end_ns=int(t1_ms * 1e6),
                parent=parent, request=request, attr=attr, kind=kind)


def _stretch() -> dict:
    """Three frames of pipeline 0 (the start, a tracking frame, a keyframe
    frame) and a PGO, with device spans, counters and a profiled slice."""
    r0, r1, r2, rp = (0, 0), (0, 1), (0, 2), (0, None)
    sp = [
        _span("frame", 0, 10, -1, r0),
        _span("drive.init", 1, 4, 0, r0),
        _span("host_read.new_landmarks", 3, 4, 1, r0),
        _span("frame", 10, 12, -1, r1),
        _span("graph.replay", 10, 10.5, 3, r1, "track"),
        _span("host_read.inliers", 11, 11.2, 3, r1),
        _span("frame", 12, 20, -1, r2),
        _span("graph.replay", 12, 12.5, 6, r2, "track"),
        _span("host_read.inliers", 12.6, 12.8, 6, r2),
        _span("graph.replay", 13, 15, 6, r2,
              "Traced(key=('keyframe+scan', True))"),
        _span("host_read.hook.candidate", 15, 15.5, 6, r2),
        _span("graph.replay", 15.6, 16, 6, r2, "Traced(key='insert')"),
        _span("pgo", 30, 40, -1, rp),
        _span("pgo.drain", 30, 32, 12, rp),
        _span("pgo.assemble", 32, 33, 12, rp),
        _span("pgo.solve", 33, 38, 12, rp),
        _span("pgo.reanchor", 38, 39.5, 12, rp),
    ]
    dev = [dict(name=n, ms=ms, request=r2, parent=9) for n, ms in (
        ("kf.frontend", 1.0), ("kf.ba", 2.0), ("kf.archive", 0.1),
        ("hook.embed", 0.5), ("hook.orb", 0.2), ("hook.scan", 0.05))]
    dev.append(dict(name="hook.insert", ms=0.15, request=r2, parent=11))
    off = 1_000_000_000
    # the profiled slice: frames 1-2 on the profiler's clock; the device
    # busy 10.2-10.9 ms and 13.5-17 ms, idle elsewhere in [10, 20)
    sub = dict(
        wall_ns=10_000_000, lo_ns=off + 10_000_000, hi_ns=off + 20_000_000,
        busy=[[off + 10_200_000, off + 10_900_000],
              [off + 13_500_000, off + 17_000_000]],
        kernel_ns={"A": 40_000, "B": 80_000}, kernel_ops={"A": 2, "B": 1},
        replay_events=[],
        counts={"kernel.A.launches[L4.n512.win11]": 2,
                "kernel.A.bytes[L4.n512.win11]": 2_540_176,
                "kernel.B.launches[S3.r3.i6]": 1,
                "kernel.B.bytes[S3.r3.i6]": 30_000},
        device_counts={"kernel.A.iterations[L4.n512.win11]": 6144.0,
                       "kernel.B.observations[S3.r3.i6]": 350.0})
    # a profiled frame after the drive (frame 3), which the span readers
    # leave out
    r3 = (0, 3)
    sp += [_span("frame", 50, 70, -1, r3),
           _span("graph.replay", 50, 66, 17, r3,
                 "Traced(key=('keyframe+scan', True))"),
           _span("host_read.inliers", 66, 67, 17, r3)]
    dev.append(dict(name="kf.ba", ms=9.0, request=r3, parent=18))
    records = dict(spans=sp, epoch_offset_ns=off, device_spans=dev,
                   device_frames=[dict(request=r2, ms=4.5),
                                  dict(request=r3, ms=9.5)],
                   counts={}, device_counts={"ba.passes": 5.0,
                                             "ba.lm_overflow": 30.0})
    return dict(frames=3, frame_lat_s=[0.01, 0.002, 0.008],
                frame_kf=[False, False, True], pgo_s=0.0101, traced=True,
                records=records, sub=sub, kind="NVIDIA H100 80GB HBM3",
                drive_device_counts={"ba.passes": 4.0,
                                     "ba.lm_overflow": 10.0})


def _reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", name)


def test_stretch_readers_on_a_record_made_by_hand():
    from portbench import roofline
    got = bspans.read_all({bspans.KEY: _stretch()})
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    # kernel A: two launches of 4 x 512 point-levels, 6144 iterations in
    # all; kernel B: 3 starts x (3 x (6 + 1) + 1) passes over 350
    # observations
    _, base = roofline.lk_counts(([], []), torch.zeros(4, 512, 6), 11)
    a_ops = 2 * base + 6144 * 12 * 121
    want = {
        "host_wait_ms_per_frame": (1.0 + 0.2 + 0.2 + 0.5) / 3,
        "kf_launch_ms_p50": 0.5 + 2.0 + 0.4,
        "kf_device_ms_p50": 4.5,
        "ba_device_ms_p50": 2.0,
        "ba_overflow_per_pass": 2.5,
        "hook_device_ms_p50": 0.5 + 0.2 + 0.05 + 0.15,
        "init_ms": 3.0,
        "pgo_solve_ms": 5.0,
        "pgo_host_ms": 2.0 + 1.0 + 1.5,
        "lk_roofline_pct": 100 * roofline.bound_ms(
            2_540_176, a_ops, peak)[0] / 0.04,
        "pose_roofline_pct": 100 * roofline.bound_ms(
            30_000, 3 * 22 * 350 * 240.0, peak)[0] / 0.08,
    }
    assert sorted(want) == sorted(bspans.READERS)
    for name, v in want.items():
        assert got[name] == pytest.approx(v, rel=1e-6), name
    for name in bspans.READERS:
        assert 0 < got[name] < float("inf"), name


@pytest.mark.parametrize("name", bspans.READERS)
def test_stretch_reader_reads_nothing_without_a_stretch(name):
    """Where the stretch did not run (an older program, a run that is not a
    traced one on the card, the tests' own command line), the reader
    returns None, and a record already marked so is not run again."""
    rec = dict(frame_lat_s=[0.01], frames=1)
    assert _reader(name).read(rec) is None
    assert rec[bspans.KEY] is None
    assert _reader(name).read({bspans.KEY: None}) is None


def test_stretch_consistency_checks_on_a_record_made_by_hand():
    st = _stretch()
    c = bspans.consistency(st)
    assert c["pgo_parts_over_run_pgo"] == pytest.approx(9.5 / 10.1)
    # the device spans of frame 2 sum to 4.0 ms, within its 4.5 ms
    assert c["kf_device_spans_over_window_ms"] == pytest.approx(-0.5)
    # idle 0.2 + 2.6 + 3.0 ms; the program's spans cover all of it
    assert c["idle_in_spans_pct"] == pytest.approx(100.0)


@pytest.mark.parametrize("rc,stdout,want", [
    (0, '{"frames": 3, "sub": {"frames": 1}, "checks": {}}', "record"),
    (1, "", None),
    (3, "", SystemExit)])
def test_stretch_process_result(rc, stdout, want, monkeypatch):
    """The run takes the stretch's record from its process's last line,
    goes on without it where that process failed, and exits 3, as the run
    itself does, where that process loaded a module the run may not
    load."""
    import subprocess
    monkeypatch.setattr(
        bspans.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, rc, stdout, ""))
    if want is SystemExit:
        with pytest.raises(SystemExit) as e:
            bspans.stretch_in_process("loop.circuit", 2**31 + 3)
        assert e.value.code == 3
    else:
        got = bspans.stretch_in_process("loop.circuit", 2**31 + 3)
        assert (got["frames"] if want else got) == (3 if want else None)


@pytest.mark.parametrize("loaded", [(), ("jax",), ("stereovision_slam_tpu",)])
def test_stretch_process_refuses_forbidden_modules(loaded, monkeypatch,
                                                   capsys):
    """`python -m portbench.spans --stretch` prints its record only where
    it has loaded no module of JAX or of the JAX package; else it exits 3
    and prints nothing on standard output."""
    class Stub:
        def __init__(self, *a):
            pass

        def warm(self):
            pass

        def drive(self, traced):
            return dict(frames=1, traced=traced, checks={})
    monkeypatch.setattr(bspans, "Stretch", Stub)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # this process's own imports (the parity tests' JAX) stay out of view
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc = bspans.main(["--stretch", "--seed", str(2**31 + 9)])
    out = capsys.readouterr().out
    if loaded:
        assert rc == 3 and out == ""
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["frames"] == 1
