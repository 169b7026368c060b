"""The loop path's driver: `ScanLoopVisualOdometry` over drives of the arena
lap, one frame handed over at a time, drives back to back.

A drive is `drive_frames` frames of one lap (`scenes.render_lap`), served
by index from the rendered lap on the device, starting at a lap position
drawn from the seed; the texture phase is drawn from the seed too. Each
drive runs on a freshly initialized pipeline (its stereo initialization
and graph captures are paid in the drive), every frame's pose is read to
the host before the next frame is handed over, and the drive's last frame
carries the shutdown PGO (`run_pgo`).

Set-up renders the lap, loads PlaceNet and runs the first `warm_frames`
frames of drive 0 with the PGO graph warmed (`warm_pgo`); the window then
goes on with drive 0 and the drives after it. At frames drawn from the
seed, and past the last of them at every frame until one of the sampled
frames is a keyframe, the pipeline's state is copied before and after the
frame, and after
the stereo initialization of the first drive that starts in the window,
so that the reference can follow the program from its own state (and
check the start from the empty state) after the window
(`reference/loop_check.py`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench import scenes
from portbench.program import LapDataset, program_config, program_rig
from portbench.reference import loop_check

KERNELS = {"A": "lk_pyramid_kernel", "B": "pose_lm_kernel"}


class Driver:
    def __init__(self, spec: dict, seed: int, device: str):
        self.seed = seed
        self.cfg_file, self.wl = spec["config"], spec["workload"]
        self.dev = torch.device(device)
        self.drive_frames = int(self.wl.get("drive_frames",
                                            self.cfg_file["drive_frames"]))
        self.scene = dict(self.cfg_file["camera"], **self.wl["arena"])
        self.vo = None
        self.windowing = self.checked_start = False
        self.drives = []        # per drive: what the check and metrics read
        self.samples = []       # state copies around the sampled frames

    # -- set-up ----------------------------------------------------------- #

    def setup(self) -> None:
        from stereovision_slam_torch.models import place_net
        from stereovision_slam_torch.ops import lk_lanes, pose_kernel

        self.counters = {"A": lk_lanes, "B": pose_kernel}
        self.lap_l, self.lap_r = scenes.render_lap(
            self.scene, harness.tex_phase(self.seed, self.wl["tex_phase"]),
            self.dev)
        lap = self.scene["lap_frames"]
        self.start = int(harness.rng(self.seed, 1).integers(lap))
        self.params = place_net.get_params(device=self.dev)
        self.rig = [c.to(self.dev) for c in program_rig(self.cfg_file[
            "camera"])]
        self.cfg = program_config(self.cfg_file["slam"])
        self.drive_no = 0
        self._new_drive()
        hint = self.wl["pgo_kf_hint"]
        self.vo.warm_pgo(kf_hint=hint, iters=self.cfg_file["pgo_iters"])
        for _ in range(self.wl["warm_frames"]):
            self._frame()
        harness.synchronize(self.dev)

    def _new_drive(self) -> None:
        from stereovision_slam_torch.slam.fused_loop import (
            ScanLoopVisualOdometry)
        caps = self.cfg_file["capacities"]
        self.vo = ScanLoopVisualOdometry(
            self.cfg, LapDataset(self.rig), place_params=self.params,
            chunk_size=1, max_total_keyframes=caps["max_total_keyframes"],
            max_total_landmarks=caps["max_total_landmarks"],
            max_frames=caps["max_frames"],
            max_loop_edges=caps["max_loop_edges"],
            num_hypotheses=self.cfg_file["pnp_hypotheses"], device=self.dev)
        self.vo.initialize()
        self.t = 0
        self.drives.append(dict(
            no=self.drive_no, start=(self.start + 7 * self.drive_no)
            % self.scene["lap_frames"], frames=0, kf=0, pgo_s=None,
            replays0=0, hook0=0, in_window=self.windowing))
        self.drive_no += 1

    def lap_index(self, drive: dict, t: int) -> int:
        return (drive["start"] + t) % self.scene["lap_frames"]

    def _frame(self, sample: bool = False):
        """Hand over the drive's next frame and read its pose; the drive's
        last frame runs the shutdown PGO. Returns (kf inserted, n_inliers,
        pose)."""
        vo, d, t = self.vo, self.drives[-1], self.t
        i = self.lap_index(d, t)
        pre, pre_kf = None, vo.kf_count
        if sample and t > 0:
            pre = harness.clone((vo.fs, vo.ms, vo.arc, vo.ls))
        # the first drive started in the window: its stereo initialization
        # is checked from the empty state
        start = t == 0 and self.windowing and not self.checked_start
        self.checked_start |= start
        vo.step_chunk(self.lap_l[i:i + 1], self.lap_r[i:i + 1], None,
                      np.ones(1, bool), host_fids=[t], n=1)
        row = len(vo._fids) - 1
        pose = vo.out_buf.pose[row].cpu()
        n_in = int(vo.out_buf.n_inliers[row])
        kf = vo.kf_count > pre_kf
        if pre is not None or start:
            self.samples.append(dict(
                drive=d["no"], t=t, lap=i, pre=pre, pre_kf=pre_kf, kf=kf,
                n_in=n_in, pose=pose.numpy(),
                post=harness.clone((vo.fs, vo.ms))))
        self.t += 1
        d["frames"] += 1
        d["kf"] += int(kf)
        if self.t == self.drive_frames:
            t0 = time.perf_counter()
            d["traj"] = vo.run_pgo(iters=self.cfg_file["pgo_iters"])
            harness.synchronize(self.dev)
            d["pgo_s"] = time.perf_counter() - t0
            self._close_drive()
            self._new_drive()
        return kf, n_in, pose

    def _close_drive(self) -> None:
        """Keep what the check and the metrics read of the finished drive
        (its state tensors, not the pipeline)."""
        vo, d = self.vo, self.drives[-1]
        d.update(state=(vo.arc, vo.ms, vo.ls), kf_count=vo.kf_count,
                 replays=vo.runner.replays, capture_s=vo.runner.capture_s,
                 hook_reads=vo.hook_reads)
        self.vo = None

    # -- the window ------------------------------------------------------- #

    def _mark_window(self) -> None:
        d = self.drives[-1]
        d.update(in_window=True, replays0=self.vo.runner.replays,
                 hook0=self.vo.hook_reads)

    def window(self, seconds: float) -> dict:
        rng = harness.rng(self.seed, 2)
        guess = int(seconds * self.wl["sample_fps_guess"])
        picks = set(rng.choice(max(guess, 1), size=min(
            self.wl["samples"], max(guess, 1)), replace=False).tolist())
        last_pick = max(picks, default=0)
        lat, kfs = [], []
        failed = 0
        have_kf = False
        self._mark_window()
        self.windowing = True
        for m in self.counters.values():
            m.launch_count = 0
        c0 = time.process_time()
        t0_wall, t0 = time.time(), time.perf_counter()
        end = t0 + seconds
        k = 0
        while True:
            a = time.perf_counter()
            # past the last pick, frames are sampled until one of the
            # samples is a keyframe (about one frame in four is)
            kf, n_in, pose = self._frame(sample=k in picks or (
                k > last_pick and not have_kf))
            b = time.perf_counter()
            have_kf |= bool(self.samples) and self.samples[-1]["kf"] \
                and self.samples[-1]["pre"] is not None
            lat.append(b - a)
            kfs.append(kf)
            if n_in < 0 or not bool(torch.isfinite(pose).all()):
                failed += 1
            k += 1
            if b >= end:
                break
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        self.windowing = False
        if self.vo is not None:
            self.drives[-1].update(replays=self.vo.runner.replays,
                                   capture_s=self.vo.runner.capture_s,
                                   hook_reads=self.vo.hook_reads)
        self.launches = {k: m.launch_count for k, m in self.counters.items()}
        return self._record(lat, kfs, wall, cpu, t0_wall, failed)

    def _record(self, lat, kfs, wall, cpu, t0_wall, failed) -> dict:
        ds = [d for d in self.drives if d["in_window"]]
        first = ds[0]
        replays = sum(d["replays"] - (d["replays0"] if d is first else 0)
                      for d in ds)
        hook = sum(d["hook_reads"] - (d["hook0"] if d is first else 0)
                   for d in ds)
        kf_win = int(sum(kfs))
        started = [d for d in ds if d is not first]
        return dict(
            t0_wall=t0_wall, window_s=wall, frames=len(lat),
            attempted=len(lat), failed=failed, frame_lat_s=lat,
            frame_kf=kfs, cpu_s=cpu, graph_replays=replays,
            keyframes=kf_win, hook_reads=hook,
            capture_s_drives=[d["capture_s"] for d in started],
            pgo_s=[d["pgo_s"] for d in ds if d["pgo_s"] is not None],
            drives_in_window=len(ds))

    # -- the traced slice ----------------------------------------------- #

    def trace(self) -> dict:
        from portbench import trace
        for m in self.counters.values():
            m.launch_count = 0
        out = trace.profile(
            lambda: [self._frame() for _ in range(self.wl["trace_frames"])],
            self.dev, KERNELS)
        out["kernel_launches"] = {k: m.launch_count
                                  for k, m in self.counters.items()}
        print(f"portbench trace: kernel launches counted "
              f"{out['kernel_launches']}, device operations of those "
              f"kernels in the trace {out['kernels_seen']} over "
              f"{self.wl['trace_frames']} frames (graph replays)",
              file=sys.stderr)
        return out

    # -- after the window ------------------------------------------------ #

    def release(self) -> None:
        """Free the program's pipeline; the state copies move to the host."""
        if self.vo is not None:
            self._close_drive()
        for s in self.samples:
            s["pre"], s["post"] = harness.to_cpu(s["pre"]), harness.to_cpu(
                s["post"])
        for d in self.drives:
            if "state" in d:
                d["state"] = harness.to_cpu(d["state"])
        self.lap_l, self.lap_r = self.lap_l.cpu(), self.lap_r.cpu()
        self.params = self.rig = None

    def numbers(self, control: bool = False) -> dict:
        return loop_check.numbers(self, control)

    def check(self) -> list:
        return loop_check.check(self)
