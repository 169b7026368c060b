"""Tracking frontend: LK tracking, pose solve, keyframing (counterpart of
`slam/frontend.py`).

`track_step_serving` is the reference's default tracking topology over a
leading axis of B streams: frame-to-frame LK with landmark-reprojection
guesses, then ONE batched LK call (kernel A, 2B groups) for the anchored
refinement and the left->right track, then the multi-start stereo pose
solve (kernel B, all streams in one launch). `track_step` is the
single-stream step: in the default topology its B = 1 case, otherwise the
reference's sequential topology (`anchored=False`, `fused_tracks=False` or
mono: one LK call, kernel A, per solve; the mono pose solve is the plain
`pose_solver` path, as the reference solves it on every backend). Every
solved pose is projected back onto SO(3). `keyframe_step` is the keyframe
path: GFTT (or FAST, the ORB option) detection away from tracked features,
left->right LK,
triangulation, landmark creation and keyframe insertion. The reference's
static-size `nonzero` and dropped scatters become explicit masks
(`map_state.nonzero_static`, `map_state.scatter_drop`).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import jacobians, se3, triangulation
from stereovision_slam_torch.geometry.camera import Camera, pixel2camera
from stereovision_slam_torch.ops import fast, gftt, lk
from stereovision_slam_torch.ops.pose_kernel import (camera_block,
                                                      solve_pose_multi_lr)
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.pose_solver import solve_pose_multi


class FrontendStatus(enum.Enum):
    """The classic pipeline's tracking status machine."""
    INITING = 0
    TRACKING_GOOD = 1
    TRACKING_BAD = 2
    LOST = 3


class FrontendState(NamedTuple):
    T_cur: torch.Tensor       # (3, 4) current frame pose T_c_w
    T_rel: torch.Tensor       # (3, 4) constant-velocity relative motion
    feat_uv: torch.Tensor     # (F, 2) left-image feature positions
    feat_lm: torch.Tensor     # (F,) landmark slot per feature, -1 = none
    feat_valid: torch.Tensor  # (F,) slot in use
    pyr: tuple                # last frame's left-image pyramid
    ref_uv: torch.Tensor      # (F, 2) feature positions at the anchor keyframe
    ref_pyr: tuple            # anchor keyframe's left-image pyramid


def init_state(F: int, pyramid, dtype=torch.float32) -> FrontendState:
    dev = pyramid[0].device
    return FrontendState(
        T_cur=se3.se3_identity(dtype, dev),
        T_rel=se3.se3_identity(dtype, dev),
        feat_uv=torch.zeros((F, 2), dtype=dtype, device=dev),
        feat_lm=torch.full((F,), -1, dtype=torch.int32, device=dev),
        feat_valid=torch.zeros((F,), dtype=torch.bool, device=dev),
        pyr=tuple(pyramid),
        ref_uv=torch.zeros((F, 2), dtype=dtype, device=dev),
        ref_pyr=tuple(pyramid),
    )


def _landmark_guesses(cam: Camera, T_guess, lm_pos, lm_valid, feat_uv,
                      feat_lm, feat_valid):
    """Initial LK guesses over a leading stream axis: project linked
    landmarks, else keep the position. T_guess (B, 3, 4); the map's
    lm_pos (B, L, 3) and lm_valid (B, L); the features (B, F, ...).
    Returns (guess (B, F, 2), lm_pos (B, F, 3), linked (B, F))."""
    safe = torch.clamp(feat_lm, 0, lm_pos.shape[1] - 1).to(torch.int64)
    pos = torch.take_along_dim(lm_pos, safe[..., None], dim=1)
    linked = (feat_valid & (feat_lm >= 0)
              & torch.take_along_dim(lm_valid, safe, dim=1))
    proj, p_cam = jacobians.project_points(cam, T_guess[:, None], pos)
    use_proj = linked & (p_cam[..., 2] > 1e-3)
    return torch.where(use_proj[..., None], proj, feat_uv), pos, linked


def _blend_obs_cameras(cam_left: Camera, cam_right: Camera, n_left: int,
                       n_right: int) -> Camera:
    """Per-observation camera: the first n_left rows left, the rest right."""
    def blend(a, b):
        return torch.cat([a.expand((n_left,) + a.shape),
                          b.expand((n_right,) + b.shape)])
    return Camera(*(blend(a, b) for a, b in zip(cam_left, cam_right)))


def _pose_inits(T_rel, T_cur, multi_start: bool):
    """The pose solve's starts (..., S, 3, 4): the constant-velocity
    prediction, then with `multi_start` zero motion and a half step."""
    T_guess = se3.se3_compose(T_rel, T_cur)
    if not multi_start:
        return T_guess[..., None, :, :]
    half_rel = se3.se3_exp(0.5 * se3.se3_log(T_rel))
    return torch.stack([T_guess, T_cur, se3.se3_compose(half_rel, T_cur)],
                       dim=-3)


def track_step_serving(fs: FrontendState, m: mapmod.MapState, cur_pyr,
                       cam_left: Camera, cur_right_pyr, cam_right: Camera, *,
                       chi2_th: float = 5.991, rounds: int = 4,
                       iters: int = 10, lk_iters: int = 30,
                       pallas_mode: str = "lanes", camp=None,
                       multi_start: bool = True):
    """The tracking step over B streams at once: state and map with a
    leading (B, ...) axis, pyramid levels (B, H, W), shared cameras.
    `camp` is the rig's `camera_block` for kernel B (built from the cameras
    when None; the VO loops build it once). `multi_start=False` solves from
    the constant-velocity prediction alone (kernel B with S = 1).

    The two LK solves fold every stream into one call per level (G = B
    groups, then G = 2B for the anchored refinement and the right-image
    track); the pose solve runs all streams together. pallas_mode "lanes"
    (the default on every device) runs kernel A and kernel B; "pallas" the
    per-level LK with kernel C on windowed levels, and kernel B; "xla" the
    per-level LK with its PyTorch loop and the LU pose solver, stream by
    stream. Where a level is too small for the lanes windows, `lk` falls
    back to the per-level route (the reference's serving path does not).
    Returns (fs', num_inliers (B,), num_tracked (B,))."""
    B, F = fs.feat_uv.shape[:2]
    T_inits = _pose_inits(fs.T_rel, fs.T_cur, multi_start)
    T_guess = T_inits[:, 0]
    guess, lm_pos, linked = _landmark_guesses(
        cam_left, T_guess, m.lm_pos, m.lm_valid, fs.feat_uv, fs.feat_lm,
        fs.feat_valid)
    lk_kw = dict(max_iters=lk_iters, pallas_mode=pallas_mode)

    # frame-to-frame LK, all B streams folded (G = B)
    uv_a, st_a = lk.track_batched(list(fs.pyr), list(cur_pyr), fs.feat_uv,
                                  guess, fs.feat_valid, **lk_kw)
    status = st_a
    mask_c = fs.feat_valid & st_a & linked
    guess_r, _, _ = _landmark_guesses(
        cam_right, T_guess, m.lm_pos, m.lm_valid, uv_a, fs.feat_lm,
        fs.feat_valid)
    # anchored refinement + right-image track, folded as G = 2B
    uv_g, st_g = lk.track_batched(
        [torch.cat([r, c]) for r, c in zip(fs.ref_pyr, cur_pyr)],
        [torch.cat([c, rr]) for c, rr in zip(cur_pyr, cur_right_pyr)],
        torch.cat([fs.ref_uv, uv_a]), torch.cat([uv_a, guess_r]),
        torch.cat([fs.feat_valid, mask_c]), **lk_kw)
    cur_uv = torch.where(st_g[:B, :, None], uv_g[:B], uv_a)
    uv_r, status_r = uv_g[B:], st_g[B:]

    tracked = fs.feat_valid & status
    num_tracked = tracked.sum(dim=1).to(torch.int32)
    use = tracked & linked
    use_r = use & status_r
    if pallas_mode in ("lanes", "pallas"):
        if camp is None:
            camp = camera_block(cam_left, cam_right)
        T_new, inlier2, num_inliers = solve_pose_multi_lr(
            camp, T_inits, lm_pos, cur_uv, uv_r, use, use_r,
            chi2_th=chi2_th, rounds=rounds, iters=iters)
    else:
        cam_obs = _blend_obs_cameras(cam_left, cam_right, F, F)
        solved = [solve_pose_multi(
            cam_obs, T_inits[b], torch.cat([lm_pos[b], lm_pos[b]]),
            torch.cat([cur_uv[b], uv_r[b]]), torch.cat([use[b], use_r[b]]),
            chi2_th=chi2_th, rounds=rounds, iters=iters) for b in range(B)]
        T_new = torch.stack([s[0] for s in solved])
        inlier2 = torch.stack([s[1] for s in solved])
        num_inliers = inlier2[:, :F].sum(dim=1).to(torch.int32)
    # keep the pose on SO(3): the motion model below inverts by transposing
    T_new = se3.se3_orthonormalize(T_new)
    inlier = inlier2[:, :F]
    feat_lm = torch.where(tracked & ~(use & ~inlier), fs.feat_lm,
                          torch.full_like(fs.feat_lm, -1))
    fs_new = FrontendState(
        T_cur=T_new,
        T_rel=se3.se3_compose(T_new, se3.se3_inverse(fs.T_cur)),
        feat_uv=cur_uv, feat_lm=feat_lm, feat_valid=tracked,
        pyr=tuple(cur_pyr), ref_uv=fs.ref_uv, ref_pyr=fs.ref_pyr)
    return fs_new, num_inliers, num_tracked


def track_step(fs: FrontendState, m: mapmod.MapState, cur_pyr,
               cam_left: Camera, cur_right_pyr=None, cam_right: Camera = None,
               chi2_th: float = 5.991, rounds: int = 4, iters: int = 10,
               anchored: bool = True, multi_start: bool = True,
               fused_tracks: bool = True, lk_iters: int = 30, camp=None):
    """Track last-frame features into the current frame and solve the pose.

    The default topology (anchored, stereo, fused tracks) is
    `track_step_serving` on the lanes route for one stream (the same
    kernel launches). `anchored=False`, `fused_tracks=False` or a missing
    right pyramid (mono) take the reference's sequential topology:
    frame-to-frame LK, then the anchored refinement when asked for, then
    the right-image LK, each its own kernel A launch; a stereo pose solve
    is kernel B, a mono one the plain multi-start solver. `multi_start=
    False` solves from the constant-velocity prediction alone. Returns
    (new_state, num_inliers, num_tracked) as 0-d int32 tensors; inliers
    are counted on the left camera."""
    stereo = cur_right_pyr is not None and cam_right is not None
    if fused_tracks and anchored and stereo:
        def one(x):
            return (tuple(lv[None] for lv in x) if isinstance(x, tuple)
                    else x[None])
        fs1, n_in, n_tr = track_step_serving(
            FrontendState(*map(one, fs)), mapmod.MapState(*map(one, m)),
            one(tuple(cur_pyr)), cam_left, one(tuple(cur_right_pyr)),
            cam_right, chi2_th=chi2_th, rounds=rounds, iters=iters,
            lk_iters=lk_iters, camp=camp, multi_start=multi_start)
        fs_new = FrontendState(*(tuple(lv[0] for lv in x)
                                 if isinstance(x, tuple) else x[0]
                                 for x in fs1))
        return fs_new, n_in[0], n_tr[0]

    F = fs.feat_uv.shape[0]
    T_inits = _pose_inits(fs.T_rel, fs.T_cur, multi_start)
    T_guess = T_inits[0]

    def guesses(cam, uv):
        g, pos, linked = _landmark_guesses(
            cam, T_guess[None], m.lm_pos[None], m.lm_valid[None], uv[None],
            fs.feat_lm[None], fs.feat_valid[None])
        return g[0], pos[0], linked[0]

    guess, lm_pos, linked = guesses(cam_left, fs.feat_uv)
    cur_uv, status = lk.track(list(fs.pyr), list(cur_pyr), fs.feat_uv,
                              initial_pts=guess, mask=fs.feat_valid,
                              max_iters=lk_iters)
    if anchored:
        # the drift-free refinement against the anchor keyframe's
        # templates, trusted wherever its LK converged
        ref_uv, ref_status = lk.track(list(fs.ref_pyr), list(cur_pyr),
                                      fs.ref_uv, initial_pts=cur_uv,
                                      mask=fs.feat_valid, max_iters=lk_iters)
        cur_uv = torch.where(ref_status[:, None], ref_uv, cur_uv)
    tracked = fs.feat_valid & status
    use = tracked & linked
    if stereo:
        guess_r = guesses(cam_right, cur_uv)[0]
        uv_r, status_r = lk.track(list(cur_pyr), list(cur_right_pyr), cur_uv,
                                  initial_pts=guess_r,
                                  mask=fs.feat_valid & status & linked,
                                  max_iters=lk_iters)
        if camp is None:
            camp = camera_block(cam_left, cam_right)
        T_new, inlier2, num_inliers = solve_pose_multi_lr(
            camp, T_inits, lm_pos, cur_uv, uv_r, use, use & status_r,
            chi2_th=chi2_th, rounds=rounds, iters=iters)
        inlier = inlier2[:F]
    else:
        T_new, inlier, num_inliers = solve_pose_multi(
            cam_left, T_inits, lm_pos, cur_uv, use, chi2_th=chi2_th,
            rounds=rounds, iters=iters)
    # keep the pose on SO(3): the motion model below inverts by transposing
    T_new = se3.se3_orthonormalize(T_new)
    feat_lm = torch.where(tracked & ~(use & ~inlier), fs.feat_lm,
                          torch.full_like(fs.feat_lm, -1))
    fs_new = FrontendState(
        T_cur=T_new,
        T_rel=se3.se3_compose(T_new, se3.se3_inverse(fs.T_cur)),
        feat_uv=cur_uv, feat_lm=feat_lm, feat_valid=tracked,
        pyr=tuple(cur_pyr), ref_uv=fs.ref_uv, ref_pyr=fs.ref_pyr)
    return fs_new, num_inliers, tracked.sum().to(torch.int32)


def keyframe_step(fs: FrontendState, m: mapmod.MapState, right_pyr,
                  cam_left: Camera, cam_right: Camera, frame_id, kf_id,
                  num_features: int = 150, min_distance: int = 20,
                  quality_level: float = 0.01, max_depth: float = 300.0,
                  num_active: int = 10, detect_all: bool = False,
                  lk_iters: int = 30, detector: str = "gftt"):
    """Make the current frame a keyframe: detect corners away from the
    tracked features (GFTT, or FAST for `detector` "orb" / "fast", the
    config's ORB option), track them into the right image, triangulate.

    `detect_all=True` is the stereo-initialization path (no masking).
    `frame_id` and `kf_id` are ints or 0-d integer tensors (the chunked
    modes' static ids), passed through to the map. Returns (fs', m',
    evicted, num_new_landmarks, num_right_tracks)."""
    F = fs.feat_uv.shape[0]
    left_img = fs.pyr[0]
    H, W = left_img.shape
    dev = left_img.device
    L = m.lm_valid.shape[0]

    # links to archived landmarks expire (the feature re-triangulates)
    safe_lm = torch.clamp(fs.feat_lm, 0, L - 1).to(torch.int64)
    fs = fs._replace(feat_lm=torch.where(
        (fs.feat_lm >= 0) & m.lm_valid[safe_lm], fs.feat_lm,
        torch.full_like(fs.feat_lm, -1)))

    mask = None if detect_all else gftt.occupancy_mask(
        (H, W), fs.feat_uv, fs.feat_valid, min_distance // 2)
    if detector.lower() in ("orb", "fast"):
        new_pts, new_valid, _ = fast.detect(
            left_img, max_corners=F, min_distance=min_distance, mask=mask)
    else:
        new_pts, new_valid, _ = gftt.detect(
            left_img, max_corners=F, quality_level=quality_level,
            min_distance=min_distance, mask=mask)
    new_valid = new_valid & (torch.arange(F, device=dev) < num_features)

    # merge detections into free feature slots
    free_slots = mapmod.nonzero_static(~fs.feat_valid, F)
    order = torch.cumsum(new_valid.to(torch.int64), 0) - 1
    dst = torch.where(new_valid, free_slots[torch.clamp(order, 0, F - 1)],
                      torch.full_like(order, -1))
    ok = new_valid & (dst >= 0)
    safe_dst = torch.where(ok, dst, torch.full_like(dst, F))
    feat_uv = mapmod.scatter_drop(fs.feat_uv, safe_dst, new_pts)
    feat_valid = mapmod.scatter_drop(fs.feat_valid, safe_dst, True)
    feat_lm = fs.feat_lm

    # LK left -> right with reprojection guesses
    guess_r = _landmark_guesses(
        cam_right, fs.T_cur[None], m.lm_pos[None], m.lm_valid[None],
        feat_uv[None], feat_lm[None], feat_valid[None])[0][0]
    uv_r, status_r = lk.track(list(fs.pyr), list(right_pyr), feat_uv,
                              initial_pts=guess_r, mask=feat_valid,
                              max_iters=lk_iters)
    has_r = feat_valid & status_r
    num_right = has_r.sum().to(torch.int32)

    # triangulate unlinked features in the rig frame, then to world
    pl = pixel2camera(cam_left, feat_uv)[:, :2]
    pr = pixel2camera(cam_right, uv_r)[:, :2]
    xyz_rig, tri_ok = triangulation.triangulate(
        torch.stack([cam_left.pose, cam_right.pose]),
        torch.stack([pl, pr], dim=1))
    depth_ok = (xyz_rig[:, 2] > 0.0) & (xyz_rig[:, 2] <= max_depth)
    world = se3.se3_apply(se3.se3_inverse(fs.T_cur), xyz_rig)
    create = feat_valid & has_r & (feat_lm < 0) & tri_ok & depth_ok
    m, slots = mapmod.add_landmarks(m, world, create, kf_id)
    made = (slots >= 0) & create
    feat_lm = torch.where(made, slots, feat_lm)
    num_new = made.sum().to(torch.int32)

    m, ev = mapmod.insert_keyframe(
        m, fs.T_cur, frame_id, kf_id, feat_uv, uv_r, feat_lm,
        has_r & (feat_lm >= 0), feat_valid, num_active=num_active)
    fs_new = fs._replace(feat_uv=feat_uv, feat_lm=feat_lm,
                         feat_valid=feat_valid, ref_uv=feat_uv,
                         ref_pyr=fs.pyr)
    return fs_new, m, ev, num_new, num_right
