"""Multi-stream serving: B independent stereo streams advanced in lockstep
(counterpart of `slam/batched.py`).

Every state carries a leading stream axis: `FrontendState`, `MapState` and
`ArchiveState` hold (B, ...) tensors (pyramid levels (B, H, W)); keyframe
counts and frame ids are host integers, one per stream. The cameras are
shared.

`batched_staggered_step` is the serving step (`kf_stagger` > 1): tracking for
all streams in one `frontend.track_step_serving` call, whose LK solves fold
every stream into one call per level and whose pose solve covers every
stream in one launch; then the keyframe branch for the streams of the
rotating m-stream sub-batch that want one. The reference selects that
sub-batch on the device; here it is a host slice, because the phase is a
host integer. `batched_fused_step` is the exact per-frame step
(`kf_stagger` 0 or 1): `fused.fused_step` stream by stream, without LOST
recovery, as the reference's vmapped step runs it.

`BatchedFusedVisualOdometry(mesh=)` shards the streams over a mesh's ranks
(the reference shards its stream axis over devices): each rank's
sub-batch state lives on the rank's device and is stepped in turn.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereovision_slam_torch.device import on_device, resolve_device
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.ops.pose_kernel import camera_block
from stereovision_slam_torch.parallel.mesh import Mesh
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.backend import optimize_window
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.fused import (
    FrameOutputs, _archive_eviction, _record_keyframe, empty_archive,
    fused_step)


def _map(fn, *trees):
    """fn over the tensors of NamedTuples / tuples of tensors."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    vals = [_map(fn, *xs) for xs in zip(*trees)]
    return type(trees[0])(*vals) if hasattr(trees[0], "_fields") \
        else tuple(vals)


def lane(tree, b: int):
    """Stream b of a (B, ...) state."""
    return _map(lambda x: x[b], tree)


def stack(trees):
    """(B, ...) state from B single-stream states."""
    return _map(lambda *xs: torch.stack(xs), *trees)


def _set_lane(tree, b: int, sub):
    """A copy of the (B, ...) state with stream b replaced by `sub`."""
    def put(x, s):
        idx = torch.tensor([b], device=x.device)
        return x.index_copy(0, idx, s.to(x.dtype)[None])
    return _map(put, tree, sub)


def _split_pyramids(left_img, right_img, num_levels: int):
    """Left and right pyramids of B streams, built in one pass per level."""
    B = left_img.shape[0]
    both = imops.build_pyramid_batched(torch.cat([left_img, right_img]),
                                       num_levels)
    return tuple(lv[:B] for lv in both), tuple(lv[B:] for lv in both)


def batched_staggered_step(fs, ms, arc, kf_count, left_img, right_img,
                           frame_id, phase: int, cam_left, cam_right, *,
                           num_levels=4, num_features=150, min_distance=20,
                           quality_level=0.01, max_depth=300.0, num_active=10,
                           kf_threshold=80, bad_threshold=20, chi2_th=5.991,
                           backend_on=True, ba_iters=10, ba_max_active=None,
                           m=1, lk_iters=30, pose_rounds=4, pose_iters=10,
                           fold_tracks=True, pallas_mode="lanes",
                           camp=None, detector="gftt"):
    """Advance B streams one frame, with the keyframe branch on the m
    streams [phase * m % B, + m).

    fs / ms / arc: (B, ...) states; kf_count, frame_id: B host ints;
    left_img / right_img (B, H, W). fold_tracks=False tracks stream by
    stream with `frontend.track_step` (the reference's vmapped topology);
    pallas_mode and camp are `track_step_serving`'s. Returns (fs, ms, arc,
    kf_count, FrameOutputs) with (B, ...) outputs."""
    B = left_img.shape[0]
    pyrs, right_pyrs = _split_pyramids(left_img, right_img, num_levels)
    track_kw = dict(chi2_th=chi2_th, rounds=pose_rounds, iters=pose_iters,
                    lk_iters=lk_iters, camp=camp)
    if fold_tracks:
        fs, n_in, n_tracked = fe.track_step_serving(
            fs, ms, pyrs, cam_left, right_pyrs, cam_right,
            pallas_mode=pallas_mode, **track_kw)
    else:
        per = [fe.track_step(lane(fs, b), lane(ms, b), lane(pyrs, b),
                             cam_left, lane(right_pyrs, b), cam_right,
                             **track_kw) for b in range(B)]
        fs = stack([p[0] for p in per])
        n_in = torch.stack([p[1] for p in per])
        n_tracked = torch.stack([p[2] for p in per])
    n_in_host = n_in.cpu().numpy()
    want_kf = (n_in_host < kf_threshold) & (n_in_host > bad_threshold)

    start = (phase * m) % B
    scheduled = (np.arange(B) - start) % B < m
    kf_count = list(kf_count)
    Tmax = arc.kf_pose.shape[1]
    for b in range(start, start + m):
        if not want_kf[b]:
            continue
        kf_id = kf_count[b] + 1
        fs2, ms2, ev, _, _ = fe.keyframe_step(
            lane(fs, b), lane(ms, b), lane(right_pyrs, b), cam_left,
            cam_right, frame_id[b], kf_id, num_features=num_features,
            min_distance=min_distance, quality_level=quality_level,
            max_depth=max_depth, num_active=num_active, detect_all=False,
            lk_iters=lk_iters, detector=detector)
        if backend_on:
            ms2, _ = optimize_window(ms2, cam_left, cam_right,
                                     chi2_th=chi2_th, iters=ba_iters,
                                     max_active_landmarks=ba_max_active)
            newest = torch.argmax(torch.where(ms2.kf_valid, ms2.kf_id,
                                              torch.full_like(ms2.kf_id, -1)))
            fs2 = fs2._replace(T_cur=ms2.kf_pose[newest])
        # the reference's serving branch records pose and frame id only:
        # no odometry edge to the previous keyframe
        arc2 = _record_keyframe(_archive_eviction(lane(arc, b), ev),
                                min(max(kf_id, 0), Tmax - 1), fs2.T_cur,
                                frame_id[b])
        fs = _set_lane(fs, b, fs2)
        ms = _set_lane(ms, b, ms2)
        arc = _set_lane(arc, b, arc2)
        kf_count[b] = kf_id

    out = FrameOutputs(n_inliers=n_in, n_tracked=n_tracked,
                       kf_inserted=want_kf & scheduled,
                       kf_count=np.asarray(kf_count, np.int32),
                       pose=fs.T_cur)
    return fs, ms, arc, kf_count, out


def batched_fused_step(fs, ms, arc, kf_count, left_img, right_img, frame_id,
                       cam_left, cam_right, **statics):
    """Advance B streams one frame each through `fused.fused_step`, with
    LOST recovery off. The streams are initialized (kf_count >= 0), so the
    init branch never runs. Same arguments and returns as
    `batched_staggered_step`, without the schedule."""
    per = [fused_step(lane(fs, b), lane(ms, b), lane(arc, b), kf_count[b],
                      left_img[b], right_img[b], frame_id[b], cam_left,
                      cam_right, lost_recovery=False, **statics)
           for b in range(left_img.shape[0])]
    outs = [p[4] for p in per]
    out = FrameOutputs(
        n_inliers=torch.stack([o.n_inliers for o in outs]),
        n_tracked=torch.stack([o.n_tracked for o in outs]),
        kf_inserted=np.array([o.kf_inserted for o in outs]),
        kf_count=np.array([o.kf_count for o in outs], np.int32),
        pose=torch.stack([o.pose for o in outs]))
    return (stack([p[0] for p in per]), stack([p[1] for p in per]),
            stack([p[2] for p in per]), [p[3] for p in per], out)


class _Step(NamedTuple):
    fids: list
    alive: list
    outs: list          # one FrameOutputs per shard, in stream order


class _Shard:
    """The streams of one mesh rank and their (b, ...) state on the rank's
    device (one shard of every stream without a mesh)."""

    def __init__(self, streams: range, device: torch.device):
        self.streams, self.device = streams, device
        self.fs = self.ms = self.arc = None
        self.kf_count: list[int] = []
        self.cam_left = self.cam_right = self.camp = None


def _cat(trees, device):
    """The shards' (b, ...) states as one (B, ...) state on `device`."""
    return _map(lambda *xs: torch.cat([x.to(device) for x in xs]), *trees)


class BatchedFusedVisualOdometry:
    """Host loop driving B datasets in lockstep, one batched step per frame
    index, on `device`.

    Streams that end early keep feeding their last frame (every stream
    carries data each step); their outputs stop being recorded.

    `mesh` (a `parallel.mesh.Mesh` in this process) shards the streams:
    stream b belongs to rank b // (B / mesh.size), and each rank's
    sub-batch state lives on the rank's device and is stepped in turn each
    frame, with that device current (`device.on_device`: kernel launches
    and anything else that names no device go to the shard's card).
    Streams never interact, so a shard's step is the unsharded one on its
    streams; `fs`, `ms`, `arc` and `kf_count` gather the shards."""

    def __init__(self, cfg: SlamConfig, datasets,
                 max_total_keyframes: int = 4096,
                 max_total_landmarks: int = 1 << 15, mesh=None,
                 kf_stagger: int = 0, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.datasets = list(datasets)
        self.B = len(self.datasets)
        self.Tmax = max_total_keyframes
        self.Lmax = max_total_landmarks
        self.kf_stagger = int(kf_stagger)
        if self.kf_stagger > 1:
            if mesh is not None:
                raise ValueError("kf_stagger is a single-device lane "
                                 "schedule; use mesh sharding without it")
            if self.B % self.kf_stagger != 0:
                raise ValueError(f"B={self.B} must be a multiple of "
                                 f"kf_stagger={self.kf_stagger}")
        self.device = resolve_device(device)
        if mesh is None:
            self.shards = [_Shard(range(self.B), self.device)]
        else:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh= takes a parallel.mesh.Mesh, not "
                                f"{type(mesh).__name__}")
            if mesh.group is not None:
                raise ValueError(
                    "mesh= shards the streams over the ranks of this "
                    "process; streams never interact, so a mesh over "
                    "processes is one server per process")
            if self.B % mesh.size != 0:
                raise ValueError(
                    f"B={self.B} streams must divide the mesh size "
                    f"{mesh.size} evenly (static per-device lane count)")
            per = self.B // mesh.size
            self.shards = [_Shard(range(r * per, (r + 1) * per), d)
                           for r, d in enumerate(mesh.devices)]
        self._step_idx = 0
        self._steps: list[_Step] = []
        self._alive = [True] * self.B
        self._last = [None] * self.B

    # the gathered state, read-only: code that changes state changes a
    # shard's
    def _gathered(self, name):
        if len(self.shards) == 1:
            return getattr(self.shards[0], name)
        return _cat([getattr(sh, name) for sh in self.shards],
                    self.shards[0].device)

    fs = property(lambda self: self._gathered("fs"))
    ms = property(lambda self: self._gathered("ms"))
    arc = property(lambda self: self._gathered("arc"))
    kf_count = property(
        lambda self: [k for sh in self.shards for k in sh.kf_count])

    def initialize(self):
        """Stereo initialization of every stream, one by one, then stack
        each shard's."""
        for ds in self.datasets:
            ds.initialize()
        ds0 = self.datasets[0]
        for sh in self.shards:
            with on_device(sh.device):
                self._initialize_shard(sh, ds0)
        first = self.shards[0]
        self.cam_left, self.cam_right = first.cam_left, first.cam_right
        self.camp = first.camp

    def _initialize_shard(self, sh, ds0):
        """Stereo initialization of the shard's streams on its device."""
        cfg = self.cfg
        dev = sh.device
        sh.cam_left = ds0.get_camera(ds0.left_cam_index).to(dev)
        sh.cam_right = ds0.get_camera(ds0.right_cam_index).to(dev)
        sh.camp = camera_block(sh.cam_left, sh.cam_right)
        fs_list, ms_list, fids = [], [], []
        for b in sh.streams:
            frame = self.datasets[b].next_frame()
            ms = mapmod.empty_map(cfg.max_keyframes_window,
                                  cfg.max_features, cfg.max_landmarks,
                                  device=dev)
            pyr, right_pyr = _split_pyramids(
                *(torch.as_tensor(np.asarray(im, np.float32))[None].to(
                    dev) for im in (frame.left, frame.right)),
                cfg.lk_num_levels)
            fs = fe.init_state(cfg.max_features, lane(pyr, 0))
            # the library's default LK budget, not cfg.lk_max_iters, as
            # in the reference's initializer
            fs, ms, _, _, _ = fe.keyframe_step(
                fs, ms, lane(right_pyr, 0), sh.cam_left, sh.cam_right,
                frame.frame_id, 0, num_features=cfg.num_features,
                min_distance=cfg.gftt_min_distance,
                quality_level=cfg.gftt_quality_level,
                max_depth=cfg.max_triangulation_depth,
                num_active=cfg.num_active_keyframes, detect_all=True,
                detector=cfg.keypoint_feature_detector.lower())
            fs_list.append(fs)
            ms_list.append(ms)
            fids.append(frame.frame_id)
            self._last[b] = frame
        sh.fs, sh.ms = stack(fs_list), stack(ms_list)
        arc = empty_archive(self.Tmax, self.Lmax, device=dev)
        sh.arc = stack([_record_keyframe(arc, 0, fs.T_cur, fid)
                        for fs, fid in zip(fs_list, fids)])
        sh.kf_count = [0] * len(sh.streams)

    def _statics(self) -> dict:
        cfg = self.cfg
        kw = dict(num_levels=cfg.lk_num_levels, num_features=cfg.num_features,
                  min_distance=cfg.gftt_min_distance,
                  quality_level=cfg.gftt_quality_level,
                  max_depth=cfg.max_triangulation_depth,
                  num_active=cfg.num_active_keyframes,
                  kf_threshold=cfg.num_features_needed_for_keyframe,
                  bad_threshold=cfg.num_features_tracking_bad,
                  chi2_th=cfg.chi2_th, backend_on=bool(cfg.backend_on),
                  ba_iters=cfg.ba_lm_iters,
                  ba_max_active=cfg.ba_max_active_landmarks or None,
                  detector=cfg.keypoint_feature_detector.lower())
        if self.kf_stagger > 1:
            kw.update(m=self.B // self.kf_stagger, lk_iters=cfg.lk_max_iters,
                      pose_rounds=cfg.pose_rounds,
                      pose_iters=cfg.pose_iters_per_round)
        # the per-frame step keeps fused_step's defaults for the LK and pose
        # budgets, as the reference's batched step does
        return kw

    def step(self) -> bool:
        """One batched frame; False when every stream is exhausted."""
        lefts, rights, fids = [], [], []
        any_alive = False
        for b, ds in enumerate(self.datasets):
            frame = ds.next_frame() if self._alive[b] else None
            if frame is None:
                self._alive[b] = False
                frame = self._last[b]
            else:
                any_alive = True
                self._last[b] = frame
            lefts.append(np.asarray(frame.left, np.float32))
            rights.append(np.asarray(frame.right, np.float32))
            fids.append(int(frame.frame_id))
        if not any_alive:
            return False
        outs = []
        for sh in self.shards:
            sl = slice(sh.streams.start, sh.streams.stop)
            left = torch.from_numpy(np.stack(lefts[sl])).to(sh.device)
            right = torch.from_numpy(np.stack(rights[sl])).to(sh.device)
            state = (sh.fs, sh.ms, sh.arc, sh.kf_count, left, right,
                     fids[sl])
            with on_device(sh.device):
                if self.kf_stagger > 1:
                    res = batched_staggered_step(
                        *state, self._step_idx % self.kf_stagger,
                        sh.cam_left, sh.cam_right, camp=sh.camp,
                        **self._statics())
                else:
                    res = batched_fused_step(*state, sh.cam_left,
                                             sh.cam_right, camp=sh.camp,
                                             **self._statics())
            sh.fs, sh.ms, sh.arc, sh.kf_count, out = res
            outs.append(out)
        self._step_idx += 1
        self._steps.append(_Step(fids, list(self._alive), outs))
        return True

    def run(self):
        while self.step():
            pass
        for dev in {sh.device for sh in self.shards}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @property
    def outputs(self) -> list[list[tuple[int, FrameOutputs]]]:
        """Per stream, (frame_id, FrameOutputs) of every frame it fed."""
        outs = [[] for _ in range(self.B)]
        for st in self._steps:
            n_in = np.concatenate([o.n_inliers.cpu().numpy()
                                   for o in st.outs])
            n_tr = np.concatenate([o.n_tracked.cpu().numpy()
                                   for o in st.outs])
            pose = np.concatenate([o.pose.cpu().numpy() for o in st.outs])
            kf_in = np.concatenate([np.asarray(o.kf_inserted)
                                    for o in st.outs])
            kf_c = np.concatenate([np.asarray(o.kf_count) for o in st.outs])
            for b in range(self.B):
                if st.alive[b]:
                    outs[b].append((st.fids[b], FrameOutputs(
                        n_inliers=np.int32(n_in[b]),
                        n_tracked=np.int32(n_tr[b]),
                        kf_inserted=np.bool_(kf_in[b]),
                        kf_count=np.int32(kf_c[b]),
                        pose=pose[b])))
        return outs

    def trajectories(self) -> list[dict[int, np.ndarray]]:
        """Per stream, frame_id -> (3, 4) keyframe pose; window values
        override the archive."""
        out = []
        for sh in self.shards:
            arc = type(sh.arc)(*(t.cpu().numpy() for t in sh.arc))
            ms = type(sh.ms)(*(t.cpu().numpy() for t in sh.ms))
            for b in range(len(sh.streams)):
                keyframes = {int(k): (int(arc.kf_frame_id[b, k]),
                                      arc.kf_pose[b, k])
                             for k in np.nonzero(arc.kf_set[b])[0]}
                for s in np.nonzero(ms.kf_valid[b])[0]:
                    keyframes[int(ms.kf_id[b, s])] = (
                        int(ms.kf_frame_id[b, s]), ms.kf_pose[b, s])
                out.append({fid: pose for fid, pose in keyframes.values()})
        return out
