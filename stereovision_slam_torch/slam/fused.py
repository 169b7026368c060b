"""The fused per-frame SLAM step and its streaming host loop (counterpart of
`slam/fused.py`: the path of `FusedVisualOdometry`).

Per frame: stereo pyramids, `frontend.track_step` (frame-to-frame LK, one
batched LK for the anchored refinement and the left->right track, the
multi-start stereo pose solve), then on a keyframe `frontend.keyframe_step`
and `backend.optimize_window`, then the optional keyframe hook (the loop
closure of `slam/fused_loop.py`), with the all-time archives kept on the
device.

The reference's `lax.cond` branches (init, track, keyframe+BA, LOST
re-init) are host-side branches here, each a function of tensors
(`init_branch`, `track_branch`, `keyframe_branch` + `finish_keyframe`,
`lost_branch`). They read the inlier count of the frame, and on the init
and re-init branches the count of new landmarks, so each frame has one
device->host read (two on a re-init). The keyframe count lives on the
host. Init and re-init failure revert the map wholesale, as in the
reference. The reference packs its drain into one word buffer for the
TPU's readback cost; a plain `.cpu()` drain is enough here. The chunked
modes (`ScanVisualOdometry`, `UnrolledVisualOdometry`) replay the track
and keyframe branches as CUDA graphs (`slam/graphs.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.ops.pose_kernel import camera_block
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.backend import optimize_window
from stereovision_slam_torch.slam.config import SlamConfig
from stereovision_slam_torch.slam.graphs import GraphRunner, write
from stereovision_slam_torch.utils import profiling


class ArchiveState(NamedTuple):
    kf_pose: torch.Tensor      # (Tmax, 3, 4) final pose per keyframe id
    kf_frame_id: torch.Tensor  # (Tmax,) int32
    kf_set: torch.Tensor       # (Tmax,) bool
    kf_rel: torch.Tensor       # (Tmax, 3, 4) odometry T_k * T_{k-1}^-1
    lm_pos: torch.Tensor       # (Lmax, 3) archived landmarks by global id
    lm_first_kf: torch.Tensor  # (Lmax,) int32
    lm_set: torch.Tensor       # (Lmax,) bool


class FrameOutputs(NamedTuple):
    n_inliers: object   # () int32
    n_tracked: object   # () int32
    kf_inserted: object  # () bool
    kf_count: object    # () int32
    pose: object        # (3, 4)


def empty_archive(Tmax: int, Lmax: int, dtype=torch.float32,
                  device="cpu") -> ArchiveState:
    return ArchiveState(
        kf_pose=torch.zeros((Tmax, 3, 4), dtype=dtype, device=device),
        kf_frame_id=torch.full((Tmax,), -1, dtype=torch.int32, device=device),
        kf_set=torch.zeros((Tmax,), dtype=torch.bool, device=device),
        kf_rel=se3.se3_identity(dtype, device)[None].repeat(Tmax, 1, 1),
        lm_pos=torch.zeros((Lmax, 3), dtype=dtype, device=device),
        lm_first_kf=torch.full((Lmax,), -1, dtype=torch.int32, device=device),
        lm_set=torch.zeros((Lmax,), dtype=torch.bool, device=device),
    )


def empty_outputs(max_frames: int, dtype=torch.float32,
                  device="cpu") -> FrameOutputs:
    """The per-frame output buffer that the chunked modes write row by row:
    n_inliers and n_tracked -1 (also the sentinel of a chunk's padded
    tail), kf_inserted False, kf_count -1, pose 0."""
    return FrameOutputs(
        n_inliers=torch.full((max_frames,), -1, dtype=torch.int32,
                             device=device),
        n_tracked=torch.full((max_frames,), -1, dtype=torch.int32,
                             device=device),
        kf_inserted=torch.zeros((max_frames,), dtype=torch.bool,
                                device=device),
        kf_count=torch.full((max_frames,), -1, dtype=torch.int32,
                            device=device),
        pose=torch.zeros((max_frames, 3, 4), dtype=dtype, device=device))


def _archive_eviction(arc: ArchiveState,
                      ev: mapmod.EvictedKeyframe) -> ArchiveState:
    """Fold an eviction event into the archive."""
    Tmax, Lmax = arc.kf_pose.shape[0], arc.lm_pos.shape[0]
    kf_idx = torch.where(ev.happened, torch.clamp(ev.kf_id, 0, Tmax - 1),
                         torch.full_like(ev.kf_id, Tmax)).reshape(1)
    lm_idx = torch.where(ev.lm_archived & ev.happened,
                         torch.clamp(ev.lm_id, 0, Lmax - 1),
                         torch.full_like(ev.lm_id, Lmax))
    sd = mapmod.scatter_drop
    return arc._replace(
        kf_pose=sd(arc.kf_pose, kf_idx, ev.pose[None]),
        kf_frame_id=sd(arc.kf_frame_id, kf_idx, ev.frame_id.reshape(1)),
        kf_set=sd(arc.kf_set, kf_idx, True),
        lm_pos=sd(arc.lm_pos, lm_idx, ev.lm_pos),
        lm_first_kf=sd(arc.lm_first_kf, lm_idx, ev.lm_first_kf),
        lm_set=sd(arc.lm_set, lm_idx, True),
    )


def _rel_to_prev(T_new, kf_id, ms_post: mapmod.MapState,
                 ev: mapmod.EvictedKeyframe, arc: ArchiveState):
    """Odometry measurement T_new * T_{kf_id-1}^-1 for a new keyframe: the
    predecessor from the window, else the keyframe evicted this step, else
    the archive row. `kf_id` a 0-d integer tensor."""
    Tmax = arc.kf_pose.shape[0]
    prev_id = kf_id - 1
    in_win = ms_post.kf_valid & (ms_post.kf_id == prev_id)
    prev_win = torch.einsum("k,kab->ab", in_win.to(T_new.dtype),
                            ms_post.kf_pose)
    prev_pose = torch.where(
        in_win.any(), prev_win,
        torch.where(ev.happened & (ev.kf_id == prev_id), ev.pose,
                    mapmod.row(arc.kf_pose,
                               torch.clamp(prev_id, 0, Tmax - 1))))
    return se3.se3_compose(T_new, se3.se3_inverse(prev_pose))


def _refresh_relative_poses(arc: ArchiveState,
                            ms: mapmod.MapState) -> ArchiveState:
    """Re-derive rel = T_k * T_{k-1}^-1 from the window poses for every
    window keyframe whose predecessor is also in the window."""
    Tmax = arc.kf_pose.shape[0]
    ids, valid = ms.kf_id, ms.kf_valid
    pred = valid[None, :] & valid[:, None] & (ids[None, :] == ids[:, None] - 1)
    has_prev = pred.any(dim=1)
    prev_slot = torch.argmax(pred.to(torch.int32), dim=1)
    rel = se3.se3_compose(ms.kf_pose, se3.se3_inverse(ms.kf_pose[prev_slot]))
    idx = torch.where(valid & has_prev, torch.clamp(ids, 0, Tmax - 1),
                      torch.full_like(ids, Tmax))
    return arc._replace(kf_rel=mapmod.scatter_drop(arc.kf_rel, idx, rel))


def _record_keyframe(arc: ArchiveState, slot, pose, frame_id,
                     rel=None) -> ArchiveState:
    """The archive row `slot` (an int or a 0-d tensor) takes the keyframe's
    pose and frame id (and its odometry measurement)."""
    sr = mapmod.set_row
    arc = arc._replace(kf_pose=sr(arc.kf_pose, slot, pose),
                       kf_frame_id=sr(arc.kf_frame_id, slot, frame_id),
                       kf_set=sr(arc.kf_set, slot, True))
    if rel is not None:
        arc = arc._replace(kf_rel=sr(arc.kf_rel, slot, rel))
    return arc


class KeyframeIds(NamedTuple):
    """What a keyframe branch writes, as 0-d int32 tensors on the state's
    device: a captured graph reads them from static buffers at each replay,
    where a Python int would be frozen into it."""
    frame_id: torch.Tensor
    kf_id: torch.Tensor
    slot: torch.Tensor      # archive row: min(max(kf_id, 0), Tmax - 1)


def keyframe_ids(frame_id: int, kf_id: int, Tmax: int, device) -> KeyframeIds:
    ids = torch.tensor([frame_id, kf_id, min(max(kf_id, 0), Tmax - 1)],
                       dtype=torch.int32).to(device)
    return KeyframeIds(*ids)


def frame_pyramids(left_img, right_img, num_levels: int):
    """The frame's left and right pyramids, built in one batched pass."""
    both = imops.build_pyramid_batched(torch.stack([left_img, right_img]),
                                       num_levels)
    return tuple(lv[0] for lv in both), tuple(lv[1] for lv in both)


def fresh_state(fs: fe.FrontendState, pyr, T_cur, T_rel) -> fe.FrontendState:
    """A frontend state with no features at the pose, anchored on `pyr`."""
    return fe.FrontendState(
        T_cur=T_cur, T_rel=T_rel, feat_uv=torch.zeros_like(fs.feat_uv),
        feat_lm=torch.full_like(fs.feat_lm, -1),
        feat_valid=torch.zeros_like(fs.feat_valid), pyr=pyr,
        ref_uv=torch.zeros_like(fs.ref_uv), ref_pyr=pyr)


def _kf_kw(s: dict) -> dict:
    return {k: s[k] for k in ("num_features", "min_distance", "quality_level",
                              "max_depth", "num_active", "lk_iters",
                              "detector")}


# The branches of `fused_step`. Each reads and writes tensors only; the ids
# come in as `KeyframeIds`. The host decision between them stays in the
# caller: one read a frame (the inlier count), and one more on the rare
# init and re-init branches (the new landmarks).

def init_branch(fs, ms, arc, pyr, right_pyr, ids: KeyframeIds, cam_left,
                cam_right, **s):
    """Stereo initialization as keyframe 0; too few landmarks revert the
    map. Reads the new landmarks on the host. Returns (fs, ms, arc,
    kf_count, FrameOutputs)."""
    ident = se3.se3_identity(fs.T_cur.dtype, fs.T_cur.device)
    fs2, ms2, _, n_new, n_r = fe.keyframe_step(
        fresh_state(fs, pyr, ident, ident), ms, right_pyr, cam_left,
        cam_right, ids.frame_id, ids.kf_id, detect_all=True, **_kf_kw(s))
    ok = profiling.host_read("new_landmarks", n_new, int) \
        >= s["num_features_init"]
    if ok:
        ms, arc = ms2, _record_keyframe(arc, ids.slot, fs2.T_cur,
                                        ids.frame_id)
    kfc = 0 if ok else -1
    return fs2, ms, arc, kfc, FrameOutputs(
        n_inliers=n_new, n_tracked=n_r, kf_inserted=ok, kf_count=kfc,
        pose=fs2.T_cur)


def track_branch(fs, ms, pyr, right_pyr, cam_left, cam_right, camp=None,
                 **s):
    """Tracking: (fs', n_inliers, n_tracked), the counts 0-d int32."""
    return fe.track_step(fs, ms, pyr, cam_left, right_pyr, cam_right,
                         chi2_th=s["chi2_th"], rounds=s["pose_rounds"],
                         iters=s["pose_iters"], lk_iters=s["lk_iters"],
                         camp=camp)


def keyframe_branch(fs1, ms, arc, right_pyr, ids: KeyframeIds, cam_left,
                    cam_right, run_ba: bool, **s):
    """A new keyframe from the tracked state `fs1` and, with `run_ba`, one
    BA pass over the window (the current pose then taken from it). Returns
    (fs, ms, arc with the eviction folded in, the keyframe's odometry
    measurement); `finish_keyframe` completes the archive after the
    keyframe hook. The recorder's device spans: `kf.frontend`, `kf.ba`,
    `kf.archive`; its device counters `ba.passes` and `ba.lm_overflow`
    (the landmarks BA's compaction left out)."""
    with profiling.device_span("kf.frontend"):
        fs2, ms2, ev, _, _ = fe.keyframe_step(
            fs1, ms, right_pyr, cam_left, cam_right, ids.frame_id, ids.kf_id,
            detect_all=False, **_kf_kw(s))
    if run_ba:
        with profiling.device_span("kf.ba"):
            ms2, stats = optimize_window(
                ms2, cam_left, cam_right, chi2_th=s["chi2_th"],
                iters=s["ba_iters"], max_active_landmarks=s["ba_max_active"])
            newest = torch.argmax(torch.where(ms2.kf_valid, ms2.kf_id,
                                              torch.full_like(ms2.kf_id, -1)))
            fs2 = fs2._replace(T_cur=mapmod.row(ms2.kf_pose, newest))
        profiling.device_count("ba.passes", 1, device=stats[3].device)
        profiling.device_count("ba.lm_overflow", stats[3])
    with profiling.device_span("kf.archive"):
        rel_new = _rel_to_prev(fs2.T_cur, ids.kf_id, ms2, ev, arc)
        arc = _archive_eviction(arc, ev)
    return fs2, ms2, arc, rel_new


def finish_keyframe(arc, fs, ms, ids: KeyframeIds, rel_new) -> ArchiveState:
    """The archive records the keyframe's (post-hook) pose and odometry
    measurement, and refreshes the window's relative poses."""
    arc = _record_keyframe(arc, ids.slot, fs.T_cur, ids.frame_id, rel_new)
    return _refresh_relative_poses(arc, ms)


def lost_branch(fs, ms, arc, pyr, right_pyr, ids: KeyframeIds, cam_left,
                cam_right, **s):
    """LOST: extrapolate the pose of `fs` (the state before this frame's
    tracking), drop the features and try a fresh stereo initialization as
    a new keyframe into the existing map; a failure keeps the map. Reads
    the new landmarks on the host. Returns (fs, ms, arc, ok)."""
    fs_r = fresh_state(fs, pyr, se3.se3_compose(fs.T_rel, fs.T_cur), fs.T_rel)
    fs2, ms2, ev, n_new, _ = fe.keyframe_step(
        fs_r, ms, right_pyr, cam_left, cam_right, ids.frame_id, ids.kf_id,
        detect_all=True, **_kf_kw(s))
    ok = profiling.host_read("new_landmarks", n_new, int) \
        >= s["num_features_init"]
    if ok:
        fs_out, ms_out = fs2, ms2
        arc2 = _archive_eviction(arc, ev)
        arc2 = _record_keyframe(arc2, ids.slot, fs2.T_cur, ids.frame_id,
                                _rel_to_prev(fs2.T_cur, ids.kf_id, ms2, ev,
                                             arc))
    else:
        fs_out, ms_out, arc2 = fs_r, ms, arc
    return fs_out, ms_out, _refresh_relative_poses(arc2, ms_out), ok


def runs_ba(kf_id: int, backend_on: bool, ba_every: int) -> bool:
    return backend_on and (ba_every <= 1 or kf_id % ba_every == 0)


def fused_step(fs: fe.FrontendState, ms: mapmod.MapState, arc: ArchiveState,
               kf_count: int, left_img, right_img, frame_id: int, cam_left,
               cam_right, *, num_levels: int = 4, num_features: int = 150,
               min_distance: int = 20, quality_level: float = 0.01,
               max_depth: float = 300.0, num_active: int = 10,
               kf_threshold: int = 80, bad_threshold: int = 20,
               chi2_th: float = 5.991, backend_on: bool = True,
               ba_iters: int = 10, num_features_init: int = 50,
               ba_max_active: int | None = 1024,
               lk_iters: int = 30, pose_rounds: int = 4, pose_iters: int = 10,
               ba_every: int = 1, lost_recovery: bool = True, camp=None,
               detector: str = "gftt", kf_hook=None, hook_state=None):
    """One SLAM frame. `kf_count` < 0 marks an uninitialized map (the frame
    then runs stereo initialization). `lost_recovery=False` leaves a LOST
    frame on the tracking branch (no keyframe) instead of re-initializing,
    as `batched.batched_fused_step` asks. `camp`: the rig's
    `pose_kernel.camera_block`, as `frontend.track_step` takes it.
    `detector`: "gftt", or "orb" / "fast" for FAST corners.

    `kf_hook(hook_state, fs, ms, pyr, frame_id, kf_id, arc) -> (fs, ms,
    hook_state)` runs on the keyframe branch only (not on the stereo
    initialization nor the LOST re-initialization), after BA, the new
    keyframe's odometry measurement and the eviction's archiving, and
    before the archive records the keyframe, so the archive records the
    post-hook pose and the window's relative poses are refreshed from the
    post-hook poses (the reference's order).

    Returns (fs, ms, arc, kf_count, FrameOutputs), with hook_state before
    the outputs when a hook is given."""
    s = dict(num_features=num_features, min_distance=min_distance,
             quality_level=quality_level, max_depth=max_depth,
             num_active=num_active, lk_iters=lk_iters, chi2_th=chi2_th,
             ba_iters=ba_iters, ba_max_active=ba_max_active,
             num_features_init=num_features_init, pose_rounds=pose_rounds,
             pose_iters=pose_iters, detector=detector)
    pyr, right_pyr = frame_pyramids(left_img, right_img, num_levels)
    Tmax = arc.kf_pose.shape[0]
    dev = fs.T_cur.device

    def result(fs_, ms_, arc_, kfc_, out_):
        if kf_hook is None:
            return fs_, ms_, arc_, kfc_, out_
        return fs_, ms_, arc_, kfc_, hook_state, out_

    if kf_count < 0:
        # stereo initialization; too few landmarks -> revert and retry
        return result(*init_branch(fs, ms, arc, pyr, right_pyr,
                                   keyframe_ids(frame_id, 0, Tmax, dev),
                                   cam_left, cam_right, **s))

    fs1, n_in, n_tracked = track_branch(fs, ms, pyr, right_pyr, cam_left,
                                        cam_right, camp=camp, **s)
    n_in_host = profiling.host_read("inliers", n_in, int)
    lost = n_in_host <= bad_threshold
    want_kf = n_in_host < kf_threshold and not lost
    kf_id = kf_count + 1

    if lost and lost_recovery:
        fs_out, ms_out, arc2, ok = lost_branch(
            fs, ms, arc, pyr, right_pyr,
            keyframe_ids(frame_id, kf_id, Tmax, dev), cam_left, cam_right,
            **s)
        kf_count2 = kf_id if ok else kf_count
    elif want_kf:
        ids = keyframe_ids(frame_id, kf_id, Tmax, dev)
        fs2, ms2, arc2, rel_new = keyframe_branch(
            fs1, ms, arc, right_pyr, ids, cam_left, cam_right,
            runs_ba(kf_id, backend_on, ba_every), **s)
        if kf_hook is not None:
            fs2, ms2, hook_state = kf_hook(hook_state, fs2, ms2, pyr,
                                           frame_id, kf_id, arc2)
        arc2 = finish_keyframe(arc2, fs2, ms2, ids, rel_new)
        fs_out, ms_out, kf_count2 = fs2, ms2, kf_id
    else:
        fs_out, ms_out, arc2, kf_count2 = fs1, ms, arc, kf_count

    out = FrameOutputs(n_inliers=n_in, n_tracked=n_tracked,
                       kf_inserted=want_kf or kf_count2 > kf_count,
                       kf_count=kf_count2, pose=fs_out.T_cur)
    return result(fs_out, ms_out, arc2, kf_count2, out)


class FusedVisualOdometry:
    """Streaming host loop: one `fused_step` per frame on `device`."""

    def __init__(self, cfg: SlamConfig, dataset,
                 max_total_keyframes: int = 4096,
                 max_total_landmarks: int = 1 << 17,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.dataset = dataset
        self.Tmax = max_total_keyframes
        self.Lmax = max_total_landmarks
        self.device = resolve_device(device)
        self._fids: list[int] = []
        self._outs: list[FrameOutputs] = []
        self.fs = self.ms = self.arc = None
        self.kf_count = -1
        self.trace_id = profiling.pipeline_id()   # the recorder's requests

    def initialize(self):
        self.dataset.initialize()
        dev = self.device
        self.cam_left = self.dataset.get_camera(
            self.dataset.left_cam_index).to(dev)
        self.cam_right = self.dataset.get_camera(
            self.dataset.right_cam_index).to(dev)
        self.camp = camera_block(self.cam_left, self.cam_right)
        cfg = self.cfg
        self.ms = mapmod.empty_map(cfg.max_keyframes_window, cfg.max_features,
                                   cfg.max_landmarks, device=dev)
        self.arc = empty_archive(self.Tmax, self.Lmax, device=dev)
        self.kf_count = -1
        self._fids, self._outs = [], []

    def _statics(self) -> dict:
        cfg = self.cfg
        return dict(
            num_levels=cfg.lk_num_levels, num_features=cfg.num_features,
            min_distance=cfg.gftt_min_distance,
            quality_level=cfg.gftt_quality_level,
            max_depth=cfg.max_triangulation_depth,
            num_active=cfg.num_active_keyframes,
            kf_threshold=cfg.num_features_needed_for_keyframe,
            bad_threshold=cfg.num_features_tracking_bad, chi2_th=cfg.chi2_th,
            backend_on=bool(cfg.backend_on), ba_iters=cfg.ba_lm_iters,
            num_features_init=cfg.num_features_init,
            ba_max_active=cfg.ba_max_active_landmarks or None,
            lk_iters=cfg.lk_max_iters, pose_rounds=cfg.pose_rounds,
            pose_iters=cfg.pose_iters_per_round,
            ba_every=cfg.ba_every_kth_keyframe,
            detector=cfg.keypoint_feature_detector.lower())

    def step(self) -> bool:
        frame = self.dataset.next_frame()
        if frame is None:
            return False
        dev = self.device
        left = torch.as_tensor(np.asarray(frame.left, np.float32)).to(dev)
        right = torch.as_tensor(np.asarray(frame.right, np.float32)).to(dev)
        if self.fs is None:
            self.fs = fe.init_state(
                self.cfg.max_features,
                imops.build_pyramid(torch.zeros_like(left),
                                    self.cfg.lk_num_levels))
        fid = int(frame.frame_id)
        with profiling.span("frame", request=(self.trace_id, fid)):
            out = self._advance(left, right, fid)
        self._fids.append(fid)
        self._outs.append(out)
        return True

    def _advance(self, left, right, frame_id: int) -> FrameOutputs:
        """One `fused_step` on the state; returns the frame's outputs."""
        self.fs, self.ms, self.arc, self.kf_count, out = fused_step(
            self.fs, self.ms, self.arc, self.kf_count, left, right, frame_id,
            self.cam_left, self.cam_right, camp=self.camp, **self._statics())
        return out

    def run(self):
        while self.step():
            pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def outputs(self) -> list[tuple[int, FrameOutputs]]:
        if not self._outs:
            return []
        n_in = torch.stack([torch.as_tensor(o.n_inliers, device=self.device)
                            for o in self._outs]).cpu().numpy()
        n_tr = torch.stack([torch.as_tensor(o.n_tracked, device=self.device)
                            for o in self._outs]).cpu().numpy()
        poses = torch.stack([o.pose for o in self._outs]).cpu().numpy()
        return [(fid, FrameOutputs(n_inliers=np.int32(n_in[i]),
                                   n_tracked=np.int32(n_tr[i]),
                                   kf_inserted=np.bool_(o.kf_inserted),
                                   kf_count=np.int32(o.kf_count),
                                   pose=poses[i]))
                for i, (fid, o) in enumerate(zip(self._fids, self._outs))]

    def state_dict(self) -> tuple[dict, dict]:
        """(arrays, meta) of the complete streaming state, in the
        reference's checkpoint layout (`slam/checkpoint.py`); a
        device->host read of every state tensor."""
        from stereovision_slam_torch.slam.checkpoint import (
            frontend_arrays, host)
        arrays = frontend_arrays(self.fs)
        for prefix, state in (("ms", self.ms), ("arc", self.arc)):
            for name, val in state._asdict().items():
                arrays[f"{prefix}.{name}"] = host(val)
        arrays["kf_count"] = np.asarray(self.kf_count, np.int32)
        outs = self.outputs
        if outs:
            arrays["out.fids"] = np.asarray(self._fids, np.int64)
            for f, dt in zip(FrameOutputs._fields, (
                    np.int32, np.int32, np.bool_, np.int32, np.float32)):
                arrays[f"out.{f}"] = np.stack(
                    [np.asarray(getattr(o, f), dt) for _, o in outs])
        meta = {"mode": type(self).__name__, "num_pyr_levels": len(self.fs.pyr),
                "num_outputs": len(outs),
                "dataset_index": getattr(self.dataset, "current_index", 0)}
        return arrays, meta

    def load_state_dict(self, arrays: dict, meta: dict) -> None:
        """Restore a `state_dict` into an initialized instance (the
        dataset and config must match); the next step() continues the
        sequence."""
        from stereovision_slam_torch.slam.checkpoint import (
            load_frontend, load_tuple)
        dev = self.device
        self.fs = load_frontend(arrays, meta["num_pyr_levels"], dev)
        self.ms = load_tuple(mapmod.MapState, arrays, "ms", dev)
        self.arc = load_tuple(ArchiveState, arrays, "arc", dev)
        self.kf_count = int(arrays["kf_count"])
        self._fids, self._outs = [], []
        if meta["num_outputs"]:
            self._fids = [int(f) for f in arrays["out.fids"]]
            n_in, n_tr, pose = (torch.as_tensor(arrays[f"out.{f}"]).to(dev)
                                for f in ("n_inliers", "n_tracked", "pose"))
            self._outs = [FrameOutputs(
                n_inliers=n_in[i], n_tracked=n_tr[i],
                kf_inserted=bool(arrays["out.kf_inserted"][i]),
                kf_count=int(arrays["out.kf_count"][i]), pose=pose[i])
                for i in range(len(self._fids))]
        if hasattr(self.dataset, "current_index"):
            self.dataset.current_index = meta["dataset_index"]

    def drain(self):
        """(keyframes {kf_id: (frame_id, pose)}, landmarks {global id: xyz},
        outputs) on the host; window values override the archive."""
        arc = ArchiveState(*(t.cpu().numpy() for t in self.arc))
        ms = mapmod.MapState(*(t.cpu().numpy() for t in self.ms))
        keyframes = {int(k): (int(arc.kf_frame_id[k]), arc.kf_pose[k])
                     for k in np.nonzero(arc.kf_set)[0]}
        for s in np.nonzero(ms.kf_valid)[0]:
            keyframes[int(ms.kf_id[s])] = (int(ms.kf_frame_id[s]),
                                           ms.kf_pose[s])
        landmarks = {int(g): arc.lm_pos[g] for g in np.nonzero(arc.lm_set)[0]}
        for s in np.nonzero(ms.lm_valid)[0]:
            gid = int(ms.lm_id[s])
            if 0 <= gid < self.Lmax:
                landmarks[gid] = ms.lm_pos[s]
        return keyframes, landmarks, self.outputs

    def trajectory(self) -> dict[int, np.ndarray]:
        """{frame_id: pose} of the drained keyframes."""
        keyframes, _, _ = self.drain()
        return {fid: pose for fid, pose in keyframes.values()}



def build_scan_chunk(unroll=False, **static) -> dict:
    """The counterpart of the reference's `build_scan_chunk`: there a jitted
    `lax.scan` (or, with `unroll`, an unrolled loop) over a chunk of
    frames; here the statics of `fused_step` that the chunked modes' branch
    graphs close over. XLA's `unroll` has no counterpart in a graph replay
    and is accepted and ignored."""
    del unroll
    return dict(static)


class ScanVisualOdometry(FusedVisualOdometry):
    """Chunked mode: frames are consumed in chunks of `chunk_size` (the
    reference's `ScanVisualOdometry`, one `lax.scan` program a chunk), and
    each frame of a chunk is a replay of CUDA graphs of `fused_step`'s
    branches on the pipeline's static state: the track graph (pyramids,
    tracking, the frame's output row), one host read of the inlier count,
    then the keyframe graph (keyframe, BA, archive, output row) when the
    host decision asks for it. Produces the same archives and outputs as
    `FusedVisualOdometry`, bit for bit on the CPU, where the runner calls
    the branch functions directly.

    The stereo initialization and the LOST re-initialization run eagerly:
    each reads its new-landmark count on the host, and they run once and
    rarely (on the 120-frame circuit once and never). The output buffer
    (`empty_outputs(max_frames)`) takes a chunk's rows at once; a padded
    tail (`valid` False) gets the sentinel row (n_inliers -1) and leaves
    the state as it was."""

    def __init__(self, cfg: SlamConfig, dataset, chunk_size: int = 32,
                 unroll=False, max_frames: int = 4096, **kw):
        super().__init__(cfg, dataset, **kw)
        self.chunk_size = chunk_size
        self.unroll = unroll
        self.Fmax = max_frames
        self.out_buf: FrameOutputs | None = None
        self.runner: GraphRunner | None = None

    def initialize(self):
        super().initialize()
        self.out_buf = empty_outputs(self.Fmax, device=self.device)
        self.runner = GraphRunner(self.device)
        self.fs = None
        self._static = build_scan_chunk(unroll=self.unroll, **self._statics())

    def _alloc(self, shape) -> None:
        """The static tensors: the frontend state (every leaf its own
        buffer), the frame pair, the right pyramid, the pose and motion
        before the frame's tracking, the inlier count, and the ids
        [frame_id, kf_id, slot, output row] with their pinned host copy."""
        dev = self.device
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        fs = fe.init_state(self.cfg.max_features, imops.build_pyramid(
            zeros, self.cfg.lk_num_levels))
        self.fs = fe.FrontendState(*(tuple(t.clone() for t in v)
                                     if isinstance(v, tuple) else v.clone()
                                     for v in fs))
        self._left, self._right = zeros, zeros.clone()
        self._right_pyr = tuple(t.clone() for t in self.fs.pyr)
        self._prev = (self.fs.T_cur.clone(), self.fs.T_rel.clone())
        self._n_in = torch.zeros((), dtype=torch.int32, device=dev)
        self._ids = torch.zeros(4, dtype=torch.int32, device=dev)
        self._ids_host = torch.zeros(4, dtype=torch.int32,
                                     pin_memory=dev.type == "cuda")

    # -- chunk assembly, as the reference's ------------------------------ #

    def _next_chunk(self):
        """Read up to chunk_size frames; returns stacked host arrays or None."""
        lefts, rights, fids = [], [], []
        while len(lefts) < self.chunk_size:
            frame = self.dataset.next_frame()
            if frame is None:
                break
            lefts.append(np.asarray(frame.left, np.float32))
            rights.append(np.asarray(frame.right, np.float32))
            fids.append(frame.frame_id)
        if not lefts:
            return None
        n = len(lefts)
        pad = self.chunk_size - n
        if pad:  # tail: repeat the last frame, masked invalid
            lefts += [lefts[-1]] * pad
            rights += [rights[-1]] * pad
            fids += [fids[-1]] * pad
        valid = np.arange(self.chunk_size) < n
        return (np.stack(lefts), np.stack(rights),
                np.asarray(fids, np.int32), valid, n)

    def step(self) -> bool:
        """One chunk."""
        chunk = self._next_chunk()
        if chunk is None:
            return False
        lefts, rights, fids, valid, n = chunk
        self.step_chunk(lefts, rights, fids, valid, host_fids=fids[:n], n=n)
        return True

    def step_chunk(self, lefts, rights, fids, valid, host_fids=None,
                   n=None) -> None:
        """Advance one pre-assembled chunk of (chunk_size, H, W) frames
        (numpy arrays, or tensors that may already lie on the device).
        `host_fids`/`n` carry the host-side frame ids and the true
        (unpadded) length, so that nothing is read back for them."""
        if host_fids is None:
            host_fids = np.asarray(torch.as_tensor(fids).cpu())
            n = len(host_fids) if n is None else n
        C = int(lefts.shape[0])
        if len(self._fids) + C > self.Fmax:
            raise RuntimeError(
                f"output buffer full ({self.Fmax} frames); construct with a "
                "larger max_frames= for longer sequences")
        ok = np.asarray(torch.as_tensor(valid).cpu(), dtype=bool)
        dev = self.device
        lefts = torch.as_tensor(lefts, dtype=torch.float32).to(dev)
        rights = torch.as_tensor(rights, dtype=torch.float32).to(dev)
        if self.fs is None:
            self._alloc(lefts.shape[1:])
        base = len(self._fids)
        for i in range(C):
            row = base + i
            if not ok[i]:
                self._pad_row(row)
                continue
            fid = int(host_fids[i])
            with profiling.span("frame", request=(self.trace_id, fid)):
                self._left.copy_(lefts[i])
                self._right.copy_(rights[i])
                self._frame(fid, row)
        self._fids.extend(int(f) for f in host_fids[:n])

    def _set_ids(self, frame_id: int, kf_id: int, row: int) -> None:
        """One copy of the frame's ids into their static buffer. The host
        copy is rewritten only after the frame's inlier read, by which time
        the previous copy has run."""
        self._ids_host.copy_(torch.tensor(
            [frame_id, kf_id, min(max(kf_id, 0), self.Tmax - 1), row],
            dtype=torch.int32))
        self._ids.copy_(self._ids_host, non_blocking=True)

    def _kf_ids(self) -> KeyframeIds:
        return KeyframeIds(self._ids[0], self._ids[1], self._ids[2])

    def _frame(self, frame_id: int, row: int) -> None:
        s = self._static
        kf_id = self.kf_count + 1
        self._set_ids(frame_id, max(kf_id, 0), row)
        if self.kf_count < 0:
            self._init_frame()
            return
        self.runner.run("track", self._track_graph)
        # the frame's one host read
        n_in = profiling.host_read("inliers", self._n_in, int)
        lost = n_in <= s["bad_threshold"]
        if lost:
            self._lost_frame()
        elif n_in < s["kf_threshold"]:
            self._keyframe(runs_ba(kf_id, s["backend_on"], s["ba_every"]))
            self.kf_count = kf_id

    def _out_row(self, **vals) -> list:
        """Writes of the frame's output row (the row index is a static
        buffer)."""
        return [(getattr(self.out_buf, k), self._ids[3], v)
                for k, v in vals.items()]

    def _init_frame(self) -> None:
        """The eager stereo initialization (a `drive.init` span)."""
        s = self._static
        with profiling.span("drive.init"):
            pyr, right_pyr = frame_pyramids(self._left, self._right,
                                            s["num_levels"])
            fs, ms, arc, kfc, out = init_branch(
                self.fs, self.ms, self.arc, pyr, right_pyr, self._kf_ids(),
                self.cam_left, self.cam_right, **s)
            write([(self.fs, fs), (self.ms, ms), (self.arc, arc)]
                  + self._out_row(n_inliers=out.n_inliers,
                                  n_tracked=out.n_tracked,
                                  kf_inserted=out.kf_inserted, kf_count=kfc,
                                  pose=out.pose))
        self.kf_count = kfc

    def _track_graph(self) -> list:
        s = self._static
        pyr, right_pyr = frame_pyramids(self._left, self._right,
                                        s["num_levels"])
        fs1, n_in, n_tr = track_branch(self.fs, self.ms, pyr, right_pyr,
                                       self.cam_left, self.cam_right,
                                       camp=self.camp, **s)
        return [(self._prev, (self.fs.T_cur, self.fs.T_rel)),
                (self.fs, fs1), (self._right_pyr, right_pyr),
                (self._n_in, n_in)] + self._out_row(
                    n_inliers=n_in, n_tracked=n_tr, kf_inserted=False,
                    kf_count=self._ids[1] - 1, pose=fs1.T_cur)

    def _keyframe_graph(self, run_ba: bool) -> list:
        ids = self._kf_ids()
        fs, ms, arc, rel_new = keyframe_branch(
            self.fs, self.ms, self.arc, self._right_pyr, ids, self.cam_left,
            self.cam_right, run_ba, **self._static)
        arc = finish_keyframe(arc, fs, ms, ids, rel_new)
        return [(self.fs, fs), (self.ms, ms), (self.arc, arc)] + \
            self._out_row(kf_inserted=True, kf_count=ids.kf_id,
                          pose=fs.T_cur)

    def _keyframe(self, run_ba: bool) -> None:
        self.runner.run(("keyframe", run_ba),
                        lambda: self._keyframe_graph(run_ba))

    def _lost_frame(self) -> None:
        fs_prev = self.fs._replace(T_cur=self._prev[0], T_rel=self._prev[1])
        fs, ms, arc, ok = lost_branch(
            fs_prev, self.ms, self.arc, self.fs.pyr, self._right_pyr,
            self._kf_ids(), self.cam_left, self.cam_right, **self._static)
        if ok:
            self.kf_count += 1
        write([(self.fs, fs), (self.ms, ms), (self.arc, arc)]
              + self._out_row(kf_inserted=ok, kf_count=self.kf_count,
                              pose=fs.T_cur))

    def _pad_row(self, row: int) -> None:
        """The sentinel row of a padded frame: the state is untouched."""
        ob = self.out_buf
        ob.n_inliers[row] = -1
        ob.n_tracked[row] = -1
        ob.kf_inserted[row] = False
        ob.kf_count[row] = self.kf_count
        if self.fs is not None:
            ob.pose[row] = self.fs.T_cur

    # -- outputs, checkpoints -------------------------------------------- #

    @property
    def outputs(self) -> list[tuple[int, FrameOutputs]]:
        n = len(self._fids)
        if not n:
            return []
        cols = [t[:n].cpu().numpy() for t in self.out_buf]
        return [(fid, FrameOutputs(*(c[i] for c in cols)))
                for i, fid in enumerate(self._fids)]

    def load_state_dict(self, arrays: dict, meta: dict) -> None:
        """As `FusedVisualOdometry.load_state_dict`; the restored tensors
        become the static state, so the graphs are captured anew."""
        super().load_state_dict(arrays, meta)
        outs, self._outs = self._outs, []
        self.out_buf = empty_outputs(self.Fmax, device=self.device)
        for i, o in enumerate(outs):
            for k, v in o._asdict().items():
                getattr(self.out_buf, k)[i] = v
        fs = self.fs
        self._alloc(fs.pyr[0].shape)
        write([(self.fs, fs)])
        self.runner = GraphRunner(self.device)


class UnrolledVisualOdometry(ScanVisualOdometry):
    """The reference's `UnrolledVisualOdometry` (the chunk body unrolled
    into one XLA executable) with its default chunk of 8. XLA's `unroll`
    has no counterpart in a graph replay: it runs the same branch graphs
    as `ScanVisualOdometry`, frame by frame."""

    def __init__(self, cfg: SlamConfig, dataset, chunk_size: int = 8, **kw):
        kw.pop("unroll", None)
        super().__init__(cfg, dataset, chunk_size=chunk_size, unroll=True,
                         **kw)
