"""Loop closure for the classic pipeline (counterpart of
`slam/loop_closure.py`): place embedding, candidate scan, ORB descriptors
and Hamming matching, PnP RANSAC with the pose gates, a rigid LocalFusion
with the duplicate-landmark merge, and the global pose-graph optimization
at shutdown.

Keyframes are processed synchronously at insertion. The database lives on
the host (numpy, the reference's `ProcessedKeyframe` layout: descriptors
as uint32 words), the scan is one matvec over a cached embedding matrix,
and the geometric stages run on the device of the pipeline's cameras.
Semantics as in the reference: candidate = argmax similarity skipping the
most recent keyframes, gated by the strong threshold and the weak count;
match gate d <= max(2 d_min, 30) and at least `min_num_acceptable_keypoint_
match` matches and PnP inliers; the pose-difference gates; a cooldown after
a closed loop that suppresses the attempt but still stores the keyframe.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from stereovision_slam_torch.convert import tensor
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.models import mobilenet_v2 as mnv2
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.ops import descriptors, matching, prng
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.fused_loop import embed, loop_information
from stereovision_slam_torch.slam.pnp import pnp_ransac
from stereovision_slam_torch.slam.pose_graph import (
    PoseGraph, optimize_pose_graph, reanchor_landmarks)

NUM_HYPOTHESES = 256


@dataclass
class ProcessedKeyframe:
    kf_id: int
    frame_id: int
    embedding: np.ndarray        # (1280,)
    desc: np.ndarray             # (F, W) uint32
    desc_ok: np.ndarray          # (F,)
    feat_uv: np.ndarray          # (F, 2)
    lm_pos: np.ndarray           # (F, 3) landmark snapshot per feature
    lm_has: np.ndarray           # (F,)
    lm_id: np.ndarray            # (F,) global landmark id per feature
    lm_first_kf: np.ndarray      # (F,) first-observer keyframe id
    pose: np.ndarray             # (3, 4) pose at processing time


@dataclass
class LoopEdge:
    kf_id: int
    loop_kf_id: int
    relative_pose: np.ndarray    # (3, 4) T_cur_corrected * T_loop^-1
    info: np.ndarray | None = None  # (6, 6) normalized PnP information


def resolve_embedder(embedder: str, mnv2_weights_path: str | None, device):
    """(name, parameters) of the place embedder. 'auto' takes MobileNet-V2
    when its weights file exists, else PlaceNet when its shipped weights
    exist, else the weight-free thumbnail, as the reference does. An
    explicit 'mobilenet' without a weights file is the seeded random
    network (`mobilenet_v2.get_params`)."""
    if embedder == "auto":
        have_weights = bool(mnv2_weights_path) and os.path.exists(
            mnv2_weights_path)
        embedder = ("mobilenet" if have_weights else
                    "placenet" if os.path.exists(place_net.WEIGHTS_PATH)
                    else "thumbnail")
    if embedder == "mobilenet":
        return embedder, mnv2.get_params(mnv2_weights_path, device=device)
    if embedder == "placenet":
        params = place_net.get_params(device=device)
        if params is None:
            raise FileNotFoundError(
                f"embedder='placenet' but the weights artifact is missing "
                f"({place_net.WEIGHTS_PATH})")
        return embedder, params
    if embedder == "thumbnail":
        return embedder, None
    raise ValueError(f"unknown embedder {embedder!r}")


def _apply_rigid_correction(ms: mapmod.MapState, T_cur_old, T_corr,
                            fs_T_cur):
    """LocalFusion as one rigid world transform D = T_old^-1 * T_corr:
    T_i' = T_i * D for active keyframes, p' = D^-1 p for active landmarks,
    and the frontend pose likewise."""
    D = se3.se3_compose(se3.se3_inverse(T_cur_old), T_corr)
    Dinv = se3.se3_inverse(D)
    ms = ms._replace(
        kf_pose=torch.where(ms.kf_valid[:, None, None],
                            se3.se3_compose(ms.kf_pose, D[None]), ms.kf_pose),
        lm_pos=torch.where(ms.lm_valid[:, None],
                           se3.se3_apply(Dinv[None], ms.lm_pos), ms.lm_pos))
    return ms, se3.se3_compose(fs_T_cur, D)


def _match_and_count(cand_desc, cand_ok, cur_desc, cur_ok, cand_lm_has):
    idx, _, good = matching.match(cand_desc, cand_ok, cur_desc, cur_ok)
    usable = good & cand_lm_has
    return idx, usable, torch.sum(usable)


def keyframe_snapshot(img, fs, ms) -> dict:
    """A keyframe's ORB descriptors on `img` and, per feature, the linked
    landmark's position, id and first observer (`lm_has` marks the
    links): what relocalization and the loop database keep of it."""
    desc, ok = descriptors.compute(img, fs.feat_uv, fs.feat_valid)
    safe = torch.clamp(fs.feat_lm, 0, ms.lm_pos.shape[0] - 1).to(torch.int64)
    return {"desc": desc, "ok": ok, "lm_pos": ms.lm_pos[safe],
            "lm_has": fs.feat_valid & (fs.feat_lm >= 0) & ms.lm_valid[safe],
            "lm_id": ms.lm_id[safe], "lm_first_kf": ms.lm_first_kf[safe]}


def _rel(pose: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """pose * prev^-1 of two (3, 4) numpy poses, in float32."""
    a, b = (torch.from_numpy(np.asarray(p, np.float32)) for p in (pose, prev))
    return se3.se3_compose(a, se3.se3_inverse(b)).numpy()


class LoopClosure:
    """Host orchestrator of the loop-closure pipeline.

    embedder: 'mobilenet' (MobileNet-V2: the weights file, else the seeded
    network), 'placenet' (the shipped weights), 'thumbnail' (weight-free)
    or 'auto' (see `resolve_embedder`)."""

    def __init__(self, cfg, cam_left, mnv2_weights_path: str | None = None,
                 embedder: str = "auto"):
        self.cfg = cfg
        self.cam_left = cam_left
        self.device = cam_left.fx.device
        self.embedder, self.params = resolve_embedder(
            embedder, mnv2_weights_path, self.device)
        self.db: dict[int, ProcessedKeyframe] = {}
        # similarity-scan cache: a capacity-doubling (cap, 1280) matrix and
        # its id vector, appended on insert
        self._emb_matrix: np.ndarray | None = None
        self._emb_ids: np.ndarray | None = None
        self._emb_n = 0
        self.loop_edges: list[LoopEdge] = []
        self.last_closed_kf_id: int | None = None
        self.last_deep_score: float = 0.0
        self.pgo_ran = False

    def _t(self, a) -> torch.Tensor:
        return tensor(a, self.device)

    # ------------------------------------------------------------------ #

    def add_keyframe(self, vo, frame) -> None:
        """Process a newly inserted keyframe. The cooldown after a closed
        loop suppresses the closure attempt only; the keyframe still joins
        the database (the reference's deviation from the C++ system)."""
        cfg = self.cfg
        kf_id = vo.kf_count
        in_cooldown = (self.last_closed_kf_id is not None and
                       kf_id - self.last_closed_kf_id <=
                       cfg.keyframes_to_ignore_after_loop)
        entry = self._process(vo, frame, kf_id)
        if not in_cooldown:
            candidate = self._find_candidate(entry)
            viewer = getattr(vo, "viewer", None)
            if viewer is not None:
                viewer.plot("plots/loop_deep_score", self.last_deep_score,
                            kf_id)
            if candidate is not None:
                before = len(self.loop_edges)
                self._attempt_closure(vo, entry, candidate)
                if viewer is not None and len(self.loop_edges) > before:
                    viewer.log_info_mkf(
                        f"LoopClosure: closed loop keyframe {kf_id} -> "
                        f"{candidate.kf_id} "
                        f"(deep score {self.last_deep_score:.3f})",
                        kf_id, "loopclosure")
        self.db[kf_id] = entry
        self._scan_cache_append(kf_id, entry.embedding)

    # ------------------------------------------------------------------ #

    def _scan_cache_append(self, kf_id: int, embedding: np.ndarray) -> None:
        if self._emb_matrix is None:
            cap = 256
            self._emb_matrix = np.zeros((cap, embedding.shape[0]), np.float32)
            self._emb_ids = np.full((cap,), -1, np.int64)
        if self._emb_n == self._emb_matrix.shape[0]:
            self._emb_matrix = np.concatenate(
                [self._emb_matrix, np.zeros_like(self._emb_matrix)])
            self._emb_ids = np.concatenate(
                [self._emb_ids, np.full_like(self._emb_ids, -1)])
        self._emb_matrix[self._emb_n] = embedding
        self._emb_ids[self._emb_n] = kf_id
        self._emb_n += 1

    def invalidate_scan_cache(self) -> None:
        """Rebuild the similarity cache from `db` (after replacing the
        database wholesale, as a checkpoint restore does)."""
        self._emb_matrix = None
        self._emb_ids = None
        self._emb_n = 0
        for kf_id, p in self.db.items():
            self._scan_cache_append(kf_id, p.embedding)

    def _process(self, vo, frame, kf_id) -> ProcessedKeyframe:
        left = torch.as_tensor(np.asarray(frame.left, np.float32)).to(
            self.device)
        embedding = embed(self.params, left).cpu().numpy()
        snap = getattr(vo, "_reloc", None)
        if snap is None or snap.get("kf_id") != kf_id:
            # else the pipeline's relocalization snapshot of this keyframe
            snap = keyframe_snapshot(left, vo.fs, vo.ms)

        def host(t):
            return t.cpu().numpy()
        return ProcessedKeyframe(
            kf_id=kf_id, frame_id=frame.frame_id, embedding=embedding,
            desc=host(snap["desc"]).view(np.uint32), desc_ok=host(snap["ok"]),
            feat_uv=host(vo.fs.feat_uv), lm_pos=host(snap["lm_pos"]),
            lm_has=host(snap["lm_has"]), lm_id=host(snap["lm_id"]),
            lm_first_kf=host(snap["lm_first_kf"]), pose=host(vo.fs.T_cur))

    def _find_candidate(self, entry) -> ProcessedKeyframe | None:
        """Similarity scan with strong/weak gating: one (N, 1280) x (1280,)
        matvec over the cached embedding matrix."""
        cfg = self.cfg
        skip = getattr(cfg, "keyframes_to_skip_in_candidate_search", 20)
        if self._emb_n != len(self.db):  # db replaced behind our back
            self.invalidate_scan_cache()
        if self._emb_n == 0:
            self.last_deep_score = 0.0
            return None
        emb, ids = self._emb_matrix[:self._emb_n], self._emb_ids[:self._emb_n]
        mask = entry.kf_id - ids >= skip
        if not mask.any():
            self.last_deep_score = 0.0
            return None
        sims = emb @ entry.embedding
        sims = np.where(mask, sims, -np.inf)
        best = int(np.argmax(sims))
        best_sim = float(sims[best])
        weak = int(np.sum(sims > cfg.potential_loop_weak_threshold))
        self.last_deep_score = max(best_sim, 0.0)
        if (best_sim < cfg.potential_loop_strong_threshold
                or weak > cfg.max_num_weak_threshold):
            return None
        return self.db[int(ids[best])]

    def _attempt_closure(self, vo, entry, cand) -> None:
        cfg = self.cfg
        t = self._t
        idx, usable, n_match = _match_and_count(
            t(cand.desc), t(cand.desc_ok), t(entry.desc), t(entry.desc_ok),
            t(cand.lm_has))
        if int(n_match) < cfg.min_num_acceptable_keypoint_match:
            return

        # 2D-3D correspondences: candidate landmarks -> current pixels; the
        # draws are the reference's PRNGKey(kf_id) uniforms
        pts3d = t(cand.lm_pos)
        uv2d = t(entry.feat_uv)[idx]
        uniform = prng.uniform(entry.kf_id, (NUM_HYPOTHESES, pts3d.shape[0]),
                               1e-9, 1.0, device=self.device)
        T_corr, inliers, n_in = pnp_ransac(self.cam_left, pts3d, uv2d, usable,
                                           uniform, reproj_threshold=5.991)
        if int(n_in) < cfg.min_num_acceptable_keypoint_match:
            return

        # the pose gates
        loop_rel = se3.se3_compose(T_corr, se3.se3_inverse(t(cand.pose)))
        if (float(torch.linalg.vector_norm(se3.se3_log(loop_rel)))
                > cfg.max_pose_distance_between_loop_keyframes):
            return
        T_old = t(entry.pose)
        pose_diff = float(se3.se3_distance(T_old, T_corr))
        if pose_diff > cfg.max_pose_differnece_between_old_new:
            return
        need_correction = pose_diff > cfg.min_pose_differnece_between_old_new

        # the loop edge for PGO (its measurement uses the corrected pose),
        # weighted by the PnP information as the fused path's edges are
        info = loop_information(self.cam_left, T_corr, pts3d, uv2d, inliers,
                                loop_rel)
        self.loop_edges.append(LoopEdge(
            kf_id=entry.kf_id, loop_kf_id=cand.kf_id,
            relative_pose=loop_rel.cpu().numpy(), info=info.cpu().numpy()))
        self.last_closed_kf_id = entry.kf_id

        if need_correction:
            vo.ms, new_T_cur = _apply_rigid_correction(vo.ms, T_old, T_corr,
                                                       vo.fs.T_cur)
            vo.fs = vo.fs._replace(T_cur=new_T_cur)
            if entry.kf_id in vo.archived_keyframes:
                vo.archived_keyframes[entry.kf_id].pose = \
                    new_T_cur.cpu().numpy()
            entry.pose = new_T_cur.cpu().numpy()
            # merge duplicate landmarks against the loop keyframe's, over
            # the RANSAC-verified matches only
            kf_slot = torch.argmax(torch.where(
                vo.ms.kf_valid, vo.ms.kf_id, torch.full_like(vo.ms.kf_id, -1)))
            vo.ms, new_feat_lm = mapmod.merge_loop_landmarks(
                vo.ms, vo.fs.feat_lm, vo.fs.feat_valid, kf_slot, idx,
                usable & inliers, t(cand.lm_pos), t(cand.lm_id),
                t(cand.lm_first_kf))
            vo.fs = vo.fs._replace(feat_lm=new_feat_lm)

    # ------------------------------------------------------------------ #

    def stop(self, vo) -> None:
        """Shutdown: global pose-graph optimization over every keyframe,
        consecutive edges with unit information and loop edges with their
        PnP information (unit where an edge has none, as in a checkpoint
        the JAX package wrote); keyframe poses written back, also into the
        active window, and landmarks re-anchored through their first
        observing keyframe."""
        if not self.loop_edges:
            return
        if int(self.cfg.global_pose_graph_optimization) == 0:
            return
        vo._sync_active_to_archive()
        recs = sorted(vo.archived_keyframes.values(), key=lambda r: r.kf_id)
        T = len(recs)
        if T < 3:
            return
        slot_of = {r.kf_id: i for i, r in enumerate(recs)}

        poses = np.stack([r.pose for r in recs]).astype(np.float32)
        eye6 = np.eye(6, dtype=np.float32)
        edge_i, edge_j, meas, infos = [], [], [], []
        # consecutive edges from the relative poses refreshed after BA,
        # with unit information
        for a, b in zip(recs[:-1], recs[1:]):
            rel = (_rel(b.pose, a.pose) if b.rel_to_prev is None
                   else b.rel_to_prev)
            edge_i.append(slot_of[b.kf_id])
            edge_j.append(slot_of[a.kf_id])
            meas.append(rel)
            infos.append(eye6)
        weighted = False
        for e in self.loop_edges:
            if e.kf_id in slot_of and e.loop_kf_id in slot_of:
                edge_i.append(slot_of[e.kf_id])
                edge_j.append(slot_of[e.loop_kf_id])
                meas.append(e.relative_pose)
                infos.append(eye6 if e.info is None else e.info)
                weighted = weighted or e.info is not None
        t = self._t
        ones = torch.ones((T,), dtype=torch.bool, device=self.device)
        g = PoseGraph(
            poses=t(poses), pose_valid=ones,
            edge_i=t(np.asarray(edge_i, np.int64)),
            edge_j=t(np.asarray(edge_j, np.int64)),
            edge_meas=t(np.stack(meas).astype(np.float32)),
            edge_valid=torch.ones((len(edge_i),), dtype=torch.bool,
                                  device=self.device),
            edge_info=(t(np.stack(infos).astype(np.float32)) if weighted
                       else None))
        new_poses = optimize_pose_graph(g, iters=22)
        for rec, pose in zip(recs, new_poses.cpu().numpy()):
            rec.pose = pose

        if vo.archived_landmarks:
            lm_ids = list(vo.archived_landmarks.keys())
            lm_pos = np.stack([vo.archived_landmarks[i] for i in lm_ids])
            first = np.array([slot_of.get(
                vo.archived_landmark_first_kf.get(i, -1), -1)
                for i in lm_ids], np.int64)
            new_lm = reanchor_landmarks(t(lm_pos.astype(np.float32)),
                                        t(first), g.poses, new_poses,
                                        ones).cpu().numpy()
            for i, p in zip(lm_ids, new_lm):
                vo.archived_landmarks[i] = p
        if getattr(vo, "ms", None) is not None:
            _write_back_window(vo)
        self.pgo_ran = True


def _write_back_window(vo) -> None:
    """The active window takes the optimized keyframe poses and landmarks
    from the archives, as the C++ system writes every keyframe of its map
    back. The reference leaves the window at its odometry values, so the
    pipeline's next fold of the window into the archives (`finish`,
    `save_output`, `trajectory`) undid PGO for the newest keyframes."""
    ms = vo.ms
    kf_pose, lm_pos = (t.cpu().numpy().copy() for t in (ms.kf_pose, ms.lm_pos))
    kf_id, lm_id = ms.kf_id.cpu().numpy(), ms.lm_id.cpu().numpy()
    for s in np.nonzero(ms.kf_valid.cpu().numpy())[0]:
        rec = vo.archived_keyframes.get(int(kf_id[s]))
        if rec is not None:
            kf_pose[s] = rec.pose
    for s in np.nonzero(ms.lm_valid.cpu().numpy())[0]:
        p = vo.archived_landmarks.get(int(lm_id[s]))
        if p is not None:
            lm_pos[s] = p
    dev = ms.kf_pose.device
    vo.ms = ms._replace(kf_pose=torch.from_numpy(kf_pose).to(dev),
                        lm_pos=torch.from_numpy(lm_pos).to(dev))
