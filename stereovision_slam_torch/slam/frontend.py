"""Tracking frontend: LK tracking, pose solve, keyframing (counterpart of
`slam/frontend.py`).

`track_step` is the reference's default topology only: frame-to-frame LK
with landmark-reprojection guesses, then ONE batched LK call (kernel A, two
groups) for the anchored refinement and the left->right track, then the
multi-start stereo pose solve (kernel B). `keyframe_step` is the GFTT
keyframe path: detection away from tracked features, left->right LK,
triangulation, landmark creation and keyframe insertion. The reference's
static-size `nonzero` and dropped scatters become explicit masks
(`map_state.nonzero_static`, `map_state.scatter_drop`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import jacobians, se3, triangulation
from stereovision_slam_torch.geometry.camera import Camera, pixel2camera
from stereovision_slam_torch.ops import gftt, lk
from stereovision_slam_torch.ops.pose_kernel import solve_pose_multi_lr
from stereovision_slam_torch.slam import map_state as mapmod


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


def _landmark_guesses(cam: Camera, T_guess, m: mapmod.MapState, feat_uv,
                      feat_lm, feat_valid):
    """Initial LK guesses: project linked landmarks, else keep the position.
    Returns (guess (F, 2), lm_pos (F, 3), linked (F,))."""
    safe = torch.clamp(feat_lm, 0, m.lm_pos.shape[0] - 1).to(torch.int64)
    lm_pos = m.lm_pos[safe]
    linked = feat_valid & (feat_lm >= 0) & m.lm_valid[safe]
    proj, p_cam = jacobians.project_points(cam, T_guess, lm_pos)
    use_proj = linked & (p_cam[..., 2] > 1e-3)
    return torch.where(use_proj[:, None], proj, feat_uv), lm_pos, linked


def _stack_levels(*pyramids):
    return [torch.stack(levels) for levels in zip(*pyramids)]


def track_step(fs: FrontendState, m: mapmod.MapState, cur_pyr,
               cam_left: Camera, cur_right_pyr, cam_right: Camera,
               chi2_th: float = 5.991, rounds: int = 4, iters: int = 10,
               lk_iters: int = 30):
    """Track last-frame features into the current frame and solve the pose.
    Returns (new_state, num_inliers, num_tracked) as 0-d int32 tensors."""
    F = fs.feat_uv.shape[0]
    T_guess = se3.se3_compose(fs.T_rel, fs.T_cur)
    half_rel = se3.se3_exp(0.5 * se3.se3_log(fs.T_rel))
    T_inits = torch.stack([T_guess, fs.T_cur,
                           se3.se3_compose(half_rel, fs.T_cur)])
    guess, lm_pos, linked = _landmark_guesses(
        cam_left, T_guess, m, fs.feat_uv, fs.feat_lm, fs.feat_valid)

    # frame-to-frame first: its result seeds everything downstream ...
    uv_a, st_a = lk.track(list(fs.pyr), list(cur_pyr), fs.feat_uv,
                          initial_pts=guess, mask=fs.feat_valid,
                          max_iters=lk_iters)
    status = st_a
    mask_c = fs.feat_valid & st_a & linked
    guess_r, _, _ = _landmark_guesses(cam_right, T_guess, m, uv_a, fs.feat_lm,
                                      fs.feat_valid)
    # ... then the anchored refinement and the right-image track as one call
    uv_g, st_g = lk.track_batched(
        _stack_levels(fs.ref_pyr, cur_pyr),
        _stack_levels(cur_pyr, cur_right_pyr),
        torch.stack([fs.ref_uv, uv_a]), torch.stack([uv_a, guess_r]),
        torch.stack([fs.feat_valid, mask_c]), max_iters=lk_iters)
    cur_uv = torch.where(st_g[0][:, None], uv_g[0], uv_a)
    uv_r, status_r = uv_g[1], st_g[1]

    tracked = fs.feat_valid & status
    num_tracked = tracked.sum().to(torch.int32)
    use = tracked & linked
    T_new, inlier2, _ = solve_pose_multi_lr(
        cam_left, cam_right, T_inits, lm_pos, cur_uv, uv_r, use,
        use & status_r, chi2_th=chi2_th, rounds=rounds, iters=iters)
    inlier = inlier2[:F]
    num_inliers = inlier.sum().to(torch.int32)
    # unlink outliers from their landmarks; failed tracks are dead slots
    feat_lm = torch.where(tracked & ~(use & ~inlier), fs.feat_lm,
                          torch.full_like(fs.feat_lm, -1))
    fs_new = FrontendState(
        T_cur=T_new,
        T_rel=se3.se3_compose(T_new, se3.se3_inverse(fs.T_cur)),
        feat_uv=cur_uv, feat_lm=feat_lm, feat_valid=tracked,
        pyr=tuple(cur_pyr), ref_uv=fs.ref_uv, ref_pyr=fs.ref_pyr)
    return fs_new, num_inliers, num_tracked


def keyframe_step(fs: FrontendState, m: mapmod.MapState, right_pyr,
                  cam_left: Camera, cam_right: Camera, frame_id, kf_id,
                  num_features: int = 150, min_distance: int = 20,
                  quality_level: float = 0.01, max_depth: float = 300.0,
                  num_active: int = 10, detect_all: bool = False,
                  lk_iters: int = 30):
    """Make the current frame a keyframe (GFTT detector).

    `detect_all=True` is the stereo-initialization path (no masking).
    Returns (fs', m', evicted, num_new_landmarks, num_right_tracks)."""
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
    guess_r, _, _ = _landmark_guesses(cam_right, fs.T_cur, m, feat_uv,
                                      feat_lm, feat_valid)
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
