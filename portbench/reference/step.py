"""The reference's SLAM frame, from a configuration file and the
program's state before the frame.

A frame is tracked (`track`), then by the reference's own inlier count n
it is LOST (n <= the bad threshold: a fresh stereo start from the
extrapolated pose), a new keyframe (n < the keyframe threshold: new
corners, the right image, triangulation, the window, bundle adjustment,
then the loop hook), or a tracked frame. The first frame of a drive is the
stereo start from the empty window.

State comes in as dicts under the program's state names: the frontend
(T_cur, T_rel, feat_uv, feat_lm, feat_valid, ref_uv), the window
(`window.py`) and the loop database (db_*, last_closed). Images and
pyramids are the benchmark's: the previous frame's, the anchor
keyframe's, the frame's own.
"""

from __future__ import annotations

import torch

from portbench.reference import features, lk, loop, pose, window
from portbench.reference import geometry as geo
from portbench.reference.image import pyramid


class Reference:
    def __init__(self, cfg_file: dict):
        c = cfg_file["slam"]
        self.cams = geo.rig(cfg_file["camera"])
        self.levels = c["lk_num_levels"]
        self.lk = dict(win=c["lk_win_size"], iters=c["lk_max_iters"])
        self.kf_threshold = c["num_features_needed_for_keyframe"]
        self.bad_threshold = c["num_features_tracking_bad"]
        self.n_init = c["num_features_init"]
        self.chi2 = c["chi2_th"]
        self.pose = dict(chi2_th=c["chi2_th"], rounds=c["pose_rounds"],
                         iters=c["pose_iters_per_round"])
        self.kf = dict(n=c["num_features"], min_distance=c[
            "gftt_min_distance"], quality=c["gftt_quality_level"],
            max_depth=c["max_triangulation_depth"],
            num_active=c["num_active_keyframes"])
        self.ba = bool(c["backend_on"])
        self.ba_every = c["ba_every_kth_keyframe"]
        self.ba_kw = dict(chi2_th=c["chi2_th"], iters=c["ba_lm_iters"],
                          max_active=c["ba_max_active_landmarks"] or None)
        self.gates = dict(
            skip=c["keyframes_to_skip_in_candidate_search"],
            cooldown=c["keyframes_to_ignore_after_loop"],
            strong=c["potential_loop_strong_threshold"],
            weak=c["potential_loop_weak_threshold"],
            max_weak=c["max_num_weak_threshold"],
            min_match=c["min_num_acceptable_keypoint_match"],
            min_diff=c["min_pose_differnece_between_old_new"],
            max_diff=c["max_pose_differnece_between_old_new"],
            max_dist=c["max_pose_distance_between_loop_keyframes"])
        self.hypotheses = cfg_file["pnp_hypotheses"]
        self.sizes = (c["max_keyframes_window"], c["max_features"],
                      c["max_landmarks"])
        self.place = loop.place_weights()
        self.pattern = loop.orb_pattern()

    def pyramid(self, img):
        return pyramid(img, self.levels)

    # -- tracking ---------------------------------------------------------- #

    def _linked(self, fs, w):
        L = w["lm_valid"].shape[0]
        lm = fs["feat_lm"].long()
        safe = torch.clamp(lm, 0, L - 1)
        return (w["lm_pos"][safe],
                fs["feat_valid"] & (lm >= 0) & w["lm_valid"][safe])

    def _guess(self, cam, T, pos, linked, uv):
        """Pixels of the linked landmarks seen from T (in front), else uv."""
        proj, q = geo.project(cam, T, pos)
        return torch.where((linked & (q[:, 2] > 1e-3))[:, None], proj, uv)

    def track(self, fs, w, prev, anchor, pyr, rpyr):
        """The frame's pose from the features of the previous frame: each
        tracked from the previous frame (guessed where its landmark
        projects under constant velocity), refined against the anchor
        keyframe where that converges, and tracked into the right image;
        the pose solved from three starts (constant velocity, no motion,
        half the motion) on the linked features in both cameras. Returns
        (frontend, inliers)."""
        camL, camR = self.cams
        T0, Trel = fs["T_cur"], fs["T_rel"]
        T_guess = geo.compose(Trel, T0)
        starts = torch.stack([T_guess, T0, geo.compose(
            geo.exp(0.5 * geo.log(Trel)), T0)])
        pos, linked = self._linked(fs, w)
        uv, valid = fs["feat_uv"], fs["feat_valid"]
        uv_a, st_a = lk.track(prev, pyr, uv, self._guess(
            camL, T_guess, pos, linked, uv), valid, **self.lk)
        uv_g, st_g = lk.track(anchor, pyr, fs["ref_uv"], uv_a, valid,
                              **self.lk)
        uv_r, st_r = lk.track(pyr, rpyr, uv_a, self._guess(
            camR, T_guess, pos, linked, uv_a), valid & st_a & linked,
            **self.lk)
        cur = torch.where(st_g[:, None], uv_g, uv_a)
        tracked = valid & st_a
        use = tracked & linked
        T, inl = pose.solve([camL, camR], [pos, pos], [cur, uv_r],
                            torch.cat([use, use & st_r]), starts,
                            **self.pose)
        T = geo.orthonormalize(T)
        inl = inl[:len(uv)]
        keep = tracked & ~(use & ~inl)
        return dict(fs, T_cur=T, T_rel=geo.compose(T, geo.inverse(T0)),
                    feat_uv=cur, feat_valid=tracked,
                    feat_lm=torch.where(keep, fs["feat_lm"], torch.full_like(
                        fs["feat_lm"], -1))), int(inl.sum())

    # -- keyframes --------------------------------------------------------- #

    def keyframe(self, fs, w, pyr, rpyr, frame_id, kf_id, detect_all):
        """The frame becomes a keyframe: links to landmarks no longer in
        the window expire; corners away from the tracked features (all
        over the image with `detect_all`) fill the free feature slots in
        order; every feature is tracked into the right image and the
        unlinked ones triangulated into new landmarks; the keyframe joins
        the window. Returns (frontend, window, new landmarks)."""
        camL, camR = self.cams
        k = self.kf
        L = w["lm_valid"].shape[0]
        lm = fs["feat_lm"]
        lm = torch.where((lm >= 0) & w["lm_valid"][torch.clamp(
            lm, 0, L - 1).long()], lm, torch.full_like(lm, -1))
        uv, valid = fs["feat_uv"].clone(), fs["feat_valid"].clone()
        F = len(uv)
        H, W = pyr[0].shape
        mask = None if detect_all else features.free_area(
            H, W, uv, valid, k["min_distance"] // 2)
        pts, ok = features.corners(pyr[0], F, k["quality"],
                                   k["min_distance"], mask)
        ok = ok & (torch.arange(F) < k["n"])
        order = torch.cumsum(ok.long(), 0) - 1
        dst = torch.where(ok, window.first_free(valid, F)[torch.clamp(
            order, 0, F - 1)], torch.full_like(order, -1))
        put = ok & (dst >= 0)
        uv[dst[put]] = pts[put]
        valid[dst[put]] = True
        T = fs["T_cur"]
        pos, linked = self._linked(dict(fs, feat_lm=lm, feat_valid=valid), w)
        uv_r, st_r = lk.track(pyr, rpyr, uv, self._guess(
            camR, T, pos, linked, uv), valid, **self.lk)
        has_r = valid & st_r
        xyz, tri = features.triangulate(camL.ext, camR.ext,
                                        geo.normalized(camL, uv),
                                        geo.normalized(camR, uv_r))
        create = valid & has_r & (lm < 0) & tri & (xyz[:, 2] > 0) \
            & (xyz[:, 2] <= k["max_depth"])
        w, slots = window.add_landmarks(
            w, geo.apply(geo.inverse(T), xyz), create, kf_id)
        made = create & (slots >= 0)
        lm = torch.where(made, slots.int(), lm)
        w = window.insert_keyframe(w, T, frame_id, kf_id, uv, uv_r, lm,
                                   has_r & (lm >= 0), valid, k["num_active"])
        return dict(fs, feat_uv=uv, feat_lm=lm, feat_valid=valid,
                    ref_uv=uv), w, int(made.sum())

    def hook(self, ls, fs, w, left, kf_id: int):
        """The loop hook of a new keyframe: its place embedding against the
        database's keyframes at least `skip` older; with a strong enough
        best match that is not drowned in weak ones, outside the cooldown
        after the last closure, its ORB descriptors matched to the
        candidate's, PnP on the candidate's landmarks, and where the
        corrected pose passes the gates and moved enough, the local
        fusion. Returns (frontend, window)."""
        g = self.gates
        emb = loop.embed(self.place, left)
        ids = torch.arange(ls["db_valid"].shape[0])
        mask = ls["db_valid"] & (kf_id - ids >= g["skip"])
        if not bool(mask.any()):
            return fs, w
        sims = torch.where(mask, ls["db_embed"] @ emb,
                           torch.full((), float("-inf")))
        best = int(torch.argmax(sims))
        last = int(ls["last_closed"])
        if (last >= 0 and kf_id - last <= g["cooldown"]) \
                or float(sims[best]) < g["strong"] \
                or int((sims > g["weak"]).sum()) > g["max_weak"]:
            return fs, w
        desc, ok = loop.orb(left, fs["feat_uv"], fs["feat_valid"],
                            self.pattern)
        T_corr, rel, usable, idx, inl = self.attempt(
            ls, best, desc, ok, fs["feat_uv"], kf_id)
        diff = float(geo.distance(fs["T_cur"], T_corr))
        if not (int(usable.sum()) >= g["min_match"]
                and int(inl.sum()) >= g["min_match"]
                and float(torch.linalg.vector_norm(geo.log(rel)))
                <= g["max_dist"] and diff <= g["max_diff"]
                and bool(torch.isfinite(T_corr).all())) \
                or diff <= g["min_diff"]:
            return fs, w
        w, T, lm = loop.fuse(
            w, fs["T_cur"], fs["feat_lm"], fs["feat_valid"], window.newest(w),
            idx, usable & inl, ls["db_lm_pos"][best], ls["db_lm_id"][best],
            ls["db_lm_first"][best], T_corr)
        return dict(fs, T_cur=T, feat_lm=lm), w

    def attempt(self, ls, j: int, desc, ok, uv, key: int):
        """Keyframe `key`'s features (descriptors, pixels) against database
        keyframe j: matches, PnP on j's landmarks with the draws keyed by
        `key`. Returns (T, T * T_j^-1, usable matches, match index, PnP
        inliers)."""
        idx, good = loop.match(ls["db_desc"][j], ls["db_desc_ok"][j], desc,
                               ok)
        usable = good & ls["db_lm_has"][j]
        X = ls["db_lm_pos"][j]
        u = loop.threefry_uniform(key, (self.hypotheses, X.shape[0]), 1e-9,
                                  1.0)
        T, inl = loop.pnp(self.cams[0], X, uv[torch.clamp(idx, min=0)],
                          usable, u)
        return T, geo.compose(T, geo.inverse(ls["db_pose"][j])), usable, \
            idx, inl

    # -- frames ------------------------------------------------------------ #

    def empty_window(self) -> dict:
        K, F, L = self.sizes
        i32, b = torch.int32, torch.bool
        return dict(
            kf_pose=torch.zeros(K, 3, 4), kf_frame_id=torch.full((K,), -1,
                                                                 dtype=i32),
            kf_id=torch.full((K,), -1, dtype=i32),
            kf_valid=torch.zeros(K, dtype=b), lm_pos=torch.zeros(L, 3),
            lm_valid=torch.zeros(L, dtype=b),
            lm_obs_count=torch.zeros(L, dtype=i32),
            lm_first_kf=torch.full((L,), -1, dtype=i32),
            lm_id=torch.full((L,), -1, dtype=i32),
            obs_uv_l=torch.zeros(K, F, 2), obs_uv_r=torch.zeros(K, F, 2),
            obs_lm=torch.full((K, F), -1, dtype=i32),
            obs_has_r=torch.zeros(K, F, dtype=b),
            obs_valid=torch.zeros(K, F, dtype=b),
            next_lm_id=torch.zeros((), dtype=i32))

    def fresh(self, T, Trel) -> dict:
        F = self.sizes[1]
        return dict(T_cur=T, T_rel=Trel, feat_uv=torch.zeros(F, 2),
                    feat_lm=torch.full((F,), -1, dtype=torch.int32),
                    feat_valid=torch.zeros(F, dtype=torch.bool),
                    ref_uv=torch.zeros(F, 2))

    def start(self, pyr, rpyr, frame_id: int):
        """A drive's stereo start: (pose, new landmarks, window)."""
        I = geo.identity()
        fs, w, n = self.keyframe(self.fresh(I, I), self.empty_window(), pyr,
                                 rpyr, frame_id, 0, True)
        return fs["T_cur"], n, w

    def frame(self, fs, w, ls, prev, anchor, pyr, rpyr, frame_id: int,
              kf_id: int):
        """One frame from the state before it. Returns (pose, inliers,
        branch "lost" / "keyframe" / "track", window or None)."""
        fs1, n = self.track(fs, w, prev, anchor, pyr, rpyr)
        if n <= self.bad_threshold:
            fr = self.fresh(geo.compose(fs["T_rel"], fs["T_cur"]),
                            fs["T_rel"])
            fs2, w2, made = self.keyframe(fr, w, pyr, rpyr, frame_id, kf_id,
                                          True)
            if made >= self.n_init:
                return fs2["T_cur"], n, "lost", w2
            return fr["T_cur"], n, "lost", None
        if n >= self.kf_threshold:
            return fs1["T_cur"], n, "track", None
        fs2, w2, _ = self.keyframe(fs1, w, pyr, rpyr, frame_id, kf_id, False)
        if self.ba and (self.ba_every <= 1 or kf_id % self.ba_every == 0):
            w2 = window.bundle_adjust(w2, self.cams, **self.ba_kw)
            fs2 = dict(fs2, T_cur=w2["kf_pose"][window.newest(w2)])
        fs2, w2 = self.hook(ls, fs2, w2, pyr[0], kf_id)
        return fs2["T_cur"], n, "keyframe", w2

    def branch_range(self, branch: str) -> tuple:
        """The inlier counts that lead to a branch."""
        return {"lost": (0, self.bad_threshold),
                "keyframe": (self.bad_threshold + 1, self.kf_threshold - 1),
                "track": (self.kf_threshold, 10 ** 9)}[branch]
