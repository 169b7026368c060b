"""The fused per-frame SLAM step and its streaming host loop (counterpart of
`slam/fused.py` without the loop hook: the path of `FusedVisualOdometry`).

Per frame: stereo pyramids, `frontend.track_step` (frame-to-frame LK, one
batched LK for the anchored refinement and the left->right track, the
multi-start stereo pose solve), then on a keyframe `frontend.keyframe_step`
and `backend.optimize_window`, with the all-time archives kept on the
device.

The reference's `lax.cond` branches (init, track, keyframe+BA, LOST
re-init) are host-side branches here. They read the inlier count of the
frame, and on the init and re-init branches the count of new landmarks, so
each frame has one device->host read (two on a re-init). The keyframe count
lives on the host. Init and re-init failure revert the map wholesale, as in
the reference. The reference packs its drain into one word buffer for the
TPU's readback cost; a plain `.cpu()` drain is enough here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereovision_slam_torch.device import resolve_device
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.ops import image as imops
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.backend import optimize_window
from stereovision_slam_torch.slam.config import SlamConfig


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


def _rel_to_prev(T_new, kf_id: int, ms_post: mapmod.MapState,
                 ev: mapmod.EvictedKeyframe, arc: ArchiveState):
    """Odometry measurement T_new * T_{kf_id-1}^-1 for a new keyframe: the
    predecessor from the window, else the keyframe evicted this step, else
    the archive row."""
    Tmax = arc.kf_pose.shape[0]
    prev_id = kf_id - 1
    in_win = ms_post.kf_valid & (ms_post.kf_id == prev_id)
    prev_win = torch.einsum("k,kab->ab", in_win.to(T_new.dtype),
                            ms_post.kf_pose)
    prev_pose = torch.where(
        in_win.any(), prev_win,
        torch.where(ev.happened & (ev.kf_id == prev_id), ev.pose,
                    arc.kf_pose[min(max(prev_id, 0), Tmax - 1)]))
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


def _record_keyframe(arc: ArchiveState, slot: int, pose, frame_id: int,
                     rel=None) -> ArchiveState:
    arc = arc._replace(
        kf_pose=arc.kf_pose.index_copy(
            0, torch.tensor([slot], device=pose.device), pose[None]),
        kf_frame_id=arc.kf_frame_id.index_fill(
            0, torch.tensor([slot], device=pose.device), frame_id),
        kf_set=arc.kf_set.index_fill(
            0, torch.tensor([slot], device=pose.device), True))
    if rel is not None:
        arc = arc._replace(kf_rel=arc.kf_rel.index_copy(
            0, torch.tensor([slot], device=pose.device), rel[None]))
    return arc


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
               ba_every: int = 1):
    """One SLAM frame. `kf_count` < 0 marks an uninitialized map (the frame
    then runs stereo initialization). Returns (fs, ms, arc, kf_count,
    FrameOutputs)."""
    both = imops.build_pyramid_batched(torch.stack([left_img, right_img]),
                                       num_levels)
    pyr = tuple(lv[0] for lv in both)
    right_pyr = tuple(lv[1] for lv in both)
    Tmax = arc.kf_pose.shape[0]
    kf_kw = dict(num_features=num_features, min_distance=min_distance,
                 quality_level=quality_level, max_depth=max_depth,
                 num_active=num_active, lk_iters=lk_iters)

    def fresh_state(T_cur, T_rel):
        return fe.FrontendState(
            T_cur=T_cur, T_rel=T_rel, feat_uv=torch.zeros_like(fs.feat_uv),
            feat_lm=torch.full_like(fs.feat_lm, -1),
            feat_valid=torch.zeros_like(fs.feat_valid), pyr=pyr,
            ref_uv=torch.zeros_like(fs.ref_uv), ref_pyr=pyr)

    if kf_count < 0:
        # stereo initialization; too few landmarks -> revert and retry
        ident = se3.se3_identity(fs.T_cur.dtype, fs.T_cur.device)
        fs2, ms2, _, n_new, n_r = fe.keyframe_step(
            fresh_state(ident, ident), ms, right_pyr, cam_left, cam_right,
            frame_id, 0, detect_all=True, **kf_kw)
        ok = int(n_new) >= num_features_init
        if ok:
            ms, arc = ms2, _record_keyframe(arc, 0, fs2.T_cur, frame_id)
        kfc = 0 if ok else -1
        return fs2, ms, arc, kfc, FrameOutputs(
            n_inliers=n_new, n_tracked=n_r, kf_inserted=ok, kf_count=kfc,
            pose=fs2.T_cur)

    fs1, n_in, n_tracked = fe.track_step(
        fs, ms, pyr, cam_left, right_pyr, cam_right, chi2_th=chi2_th,
        rounds=pose_rounds, iters=pose_iters, lk_iters=lk_iters)
    n_in_host = int(n_in)
    lost = n_in_host <= bad_threshold
    want_kf = n_in_host < kf_threshold and not lost
    kf_id = kf_count + 1
    slot = min(max(kf_id, 0), Tmax - 1)

    if lost:
        # LOST: extrapolate the pose, drop the features, and try a fresh
        # stereo initialization as a new keyframe into the existing map
        fs_r = fresh_state(se3.se3_compose(fs.T_rel, fs.T_cur), fs.T_rel)
        fs2, ms2, ev, n_new, _ = fe.keyframe_step(
            fs_r, ms, right_pyr, cam_left, cam_right, frame_id, kf_id,
            detect_all=True, **kf_kw)
        ok = int(n_new) >= num_features_init
        if ok:
            fs_out, ms_out = fs2, ms2
            arc2 = _archive_eviction(arc, ev)
            arc2 = _record_keyframe(arc2, slot, fs2.T_cur, frame_id,
                                    _rel_to_prev(fs2.T_cur, kf_id, ms2, ev,
                                                 arc))
        else:
            fs_out, ms_out, arc2 = fs_r, ms, arc
        arc2 = _refresh_relative_poses(arc2, ms_out)
        kf_count2 = kf_id if ok else kf_count
    elif want_kf:
        fs2, ms2, ev, _, _ = fe.keyframe_step(
            fs1, ms, right_pyr, cam_left, cam_right, frame_id, kf_id,
            detect_all=False, **kf_kw)
        if backend_on and (ba_every <= 1 or kf_id % ba_every == 0):
            ms2, _ = optimize_window(ms2, cam_left, cam_right,
                                     chi2_th=chi2_th, iters=ba_iters,
                                     max_active_landmarks=ba_max_active)
            newest = torch.argmax(torch.where(ms2.kf_valid, ms2.kf_id,
                                              torch.full_like(ms2.kf_id, -1)))
            fs2 = fs2._replace(T_cur=ms2.kf_pose[newest])
        rel_new = _rel_to_prev(fs2.T_cur, kf_id, ms2, ev, arc)
        arc2 = _archive_eviction(arc, ev)
        arc2 = _record_keyframe(arc2, slot, fs2.T_cur, frame_id, rel_new)
        arc2 = _refresh_relative_poses(arc2, ms2)
        fs_out, ms_out, kf_count2 = fs2, ms2, kf_id
    else:
        fs_out, ms_out, arc2, kf_count2 = fs1, ms, arc, kf_count

    out = FrameOutputs(n_inliers=n_in, n_tracked=n_tracked,
                       kf_inserted=want_kf or kf_count2 > kf_count,
                       kf_count=kf_count2, pose=fs_out.T_cur)
    return fs_out, ms_out, arc2, kf_count2, out


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

    def initialize(self):
        self.dataset.initialize()
        dev = self.device
        self.cam_left = self.dataset.get_camera(
            self.dataset.left_cam_index).to(dev)
        self.cam_right = self.dataset.get_camera(
            self.dataset.right_cam_index).to(dev)
        cfg = self.cfg
        self.ms = mapmod.empty_map(cfg.max_keyframes_window, cfg.max_features,
                                   cfg.max_landmarks, device=dev)
        self.arc = empty_archive(self.Tmax, self.Lmax, device=dev)
        self.kf_count = -1
        self._fids, self._outs = [], []

    def _statics(self) -> dict:
        cfg = self.cfg
        if cfg.keypoint_feature_detector.lower() != "gftt":
            raise ValueError("only the GFTT detector is ported")
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
            ba_every=cfg.ba_every_kth_keyframe)

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
        self.fs, self.ms, self.arc, self.kf_count, out = fused_step(
            self.fs, self.ms, self.arc, self.kf_count, left, right,
            int(frame.frame_id), self.cam_left, self.cam_right,
            **self._statics())
        self._fids.append(int(frame.frame_id))
        self._outs.append(out)
        return True

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

