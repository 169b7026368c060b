"""Sliding-window bundle adjustment with a Schur-complement solver
(counterpart of `slam/backend.py:optimize_window`).

One pose per active keyframe (the oldest held fixed as the gauge), one
marginalized point per landmark, one reprojection edge per camera per
observation, Huber with delta = chi2_th, `iters` LM steps, then the adaptive
outlier threshold (doubled until more than half the observations are
inliers) and unlinking of the outlier observations.

The reference assembles the normal equations with one-hot matmuls, a layout
chosen for the TPU's matrix unit; here they are `index_add_` scatters of the
per-observation blocks. The port is held to the reference's values, not to
its formulation: the sums are taken in another order. With
`max_active_landmarks` the landmark axis is compacted to the landmarks that
hold observations before assembly, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.slam import map_state as mapmod


class BAObservations(NamedTuple):
    kf: torch.Tensor        # (M,) keyframe slot
    lm: torch.Tensor        # (M,) landmark slot
    uv: torch.Tensor        # (M, 2) measured pixels
    is_right: torch.Tensor  # (M,) bool
    valid: torch.Tensor     # (M,) bool


def flatten_observations(m: mapmod.MapState) -> BAObservations:
    """(K, F) observation block -> flat (M = 2 K F,) arrays, left camera
    rows first, then right."""
    K, F = m.obs_lm.shape
    kf_idx = torch.arange(K, device=m.obs_lm.device)[:, None].expand(K, F)
    kf_idx = kf_idx.reshape(-1)
    lm_idx = m.obs_lm.reshape(-1).to(torch.int64)
    base = m.obs_valid & (m.obs_lm >= 0) & m.kf_valid[:, None]
    has_r = (m.obs_has_r & base).reshape(-1)
    base = base.reshape(-1)
    return BAObservations(
        kf=torch.cat([kf_idx, kf_idx]), lm=torch.cat([lm_idx, lm_idx]),
        uv=torch.cat([m.obs_uv_l.reshape(-1, 2), m.obs_uv_r.reshape(-1, 2)]),
        is_right=torch.cat([torch.zeros_like(base), torch.ones_like(has_r)]),
        valid=torch.cat([base, has_r]))


def _blend_cameras(cam_left: Camera, cam_right: Camera,
                   is_right: torch.Tensor) -> Camera:
    """Per-observation camera parameters chosen by the left/right flag (M,),
    for the observation-sharded BA (`parallel/sharded_ba.py`)."""
    s = is_right
    sf = s.to(cam_left.pose.dtype)[:, None, None]

    def pick(a, b):
        return torch.where(s, b, a)
    return Camera(fx=pick(cam_left.fx, cam_right.fx),
                  fy=pick(cam_left.fy, cam_right.fy),
                  cx=pick(cam_left.cx, cam_right.cx),
                  cy=pick(cam_left.cy, cam_right.cy),
                  baseline=pick(cam_left.baseline, cam_right.baseline),
                  pose=(1.0 - sf) * cam_left.pose + sf * cam_right.pose,
                  pose_inv=(1.0 - sf) * cam_left.pose_inv
                  + sf * cam_right.pose_inv)


def _residuals(cam_obs: Camera, kf_pose, lm_pos, obs: BAObservations):
    """Residuals and Jacobians of every observation with its own camera
    (`_blend_cameras`). Returns (r, J_pose, J_point, in_front)."""
    r, Jp, Jl, p_cam = jacobians.reprojection_residual_jac(
        cam_obs, kf_pose[obs.kf], lm_pos[torch.clamp(obs.lm, min=0)], obs.uv)
    return r, Jp, Jl, p_cam[..., 2] > 1e-6


def _residuals_lr(cam_left: Camera, cam_right: Camera, kf_pose, lm_pos,
                  obs: BAObservations):
    """Residuals and Jacobians, left half with the left camera, right half
    with the right one. Returns (r, J_pose, J_point, in_front)."""
    h = obs.kf.shape[0] // 2
    T_all = kf_pose[obs.kf]
    P_all = lm_pos[torch.clamp(obs.lm, min=0)]
    halves = [jacobians.reprojection_residual_jac(cam, T_all[sl], P_all[sl],
                                                  obs.uv[sl])
              for cam, sl in ((cam_left, slice(0, h)),
                              (cam_right, slice(h, None)))]
    r, Jp, Jl, p_cam = (torch.cat(parts) for parts in zip(*halves))
    return r, Jp, Jl, p_cam[..., 2] > 1e-6


def _assemble(r, J_pose, J_point, w, obs: BAObservations, K: int, L: int,
              rank: torch.Tensor | int = 0, n_ranks: int = 1):
    """Scatter-add the weighted normal-equation blocks (rows with w = 0 add
    nothing), per rank: observation m goes into the blocks of rank[m], and
    every block has a leading (n_ranks,) axis (the sharded BA's dp ranks;
    one rank for the single-card BA). The scatters accumulate in float64:
    on the card `index_add_` adds with atomics in an order that changes
    from run to run, and float32 sums in changing orders made whole
    trajectories differ between two runs of the same input; float64 sums
    rounded once to float32 do not."""
    on = w != 0
    wJp = torch.where(on[:, None, None], J_pose * w[:, None, None], 0.0)
    wJl = torch.where(on[:, None, None], J_point * w[:, None, None], 0.0)
    J_pose = torch.where(on[:, None, None], J_pose, 0.0)
    J_point = torch.where(on[:, None, None], J_point, 0.0)
    r = torch.where(on[:, None], r, 0.0)
    lm = torch.where(on, obs.lm, torch.zeros_like(obs.lm))
    kf_i, lm_i = rank * K + obs.kf, rank * L + lm
    dt, dev = r.dtype, r.device

    def scatter(n, idx, blocks):
        acc = torch.zeros((n_ranks * n,) + blocks.shape[1:],
                          dtype=torch.float64, device=dev)
        acc.index_add_(0, idx, blocks.to(torch.float64))
        return acc.to(dt).reshape((n_ranks, n) + blocks.shape[1:])

    H_pp = scatter(K, kf_i, torch.einsum("nab,nac->nbc", wJp, J_pose))
    b_p = scatter(K, kf_i, torch.einsum("nab,na->nb", wJp, r))
    H_ll = scatter(L, lm_i, torch.einsum("nab,nac->nbc", wJl, J_point))
    b_l = scatter(L, lm_i, torch.einsum("nab,na->nb", wJl, r))
    G = scatter(L * K, lm_i * K + obs.kf,
                torch.einsum("nab,nac->nbc", wJp, J_point))
    return H_pp, b_p, H_ll, b_l, G.reshape(n_ranks, L, K, 6, 3)


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched adjugate 3x3 inverse; singular blocks give 0."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A21 = f * g - d * i
    A31 = d * h - e * g
    det = a * A11 + b * A21 + c * A31
    ok = torch.abs(det) > 1e-30
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    adj = torch.stack([
        torch.stack([A11, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([A21, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([A31, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def schur_solve(H_pp, b_p, H_ll, b_l, G, lam, kf_active, lm_active):
    """Marginalize the landmarks, solve the reduced camera system and
    back-substitute. Returns (dx_pose (K, 6), dx_point (L, 3))."""
    K = H_pp.shape[0]
    dt, dev = H_pp.dtype, H_pp.device
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hll_d = H_ll + lam * eye3 * torch.clamp(
        torch.diagonal(H_ll, dim1=-2, dim2=-1), min=1e-6)[..., None] * eye3
    Hll_d = torch.where(lm_active[:, None, None], Hll_d, eye3)
    Hll_inv = torch.where(lm_active[:, None, None], _inv3x3(Hll_d), 0.0)

    GH = torch.einsum("lkac,lcd->lkad", G, Hll_inv)
    S = -torch.einsum("lkad,ljbd->kjab", GH, G)
    diag_damp = H_pp + lam * eye6 * torch.clamp(
        torch.diagonal(H_pp, dim1=-2, dim2=-1), min=1e-6)[..., None] * eye6
    idx = torch.arange(K, device=dev)
    S[idx, idx] += diag_damp
    act2 = kf_active[:, None] & kf_active[None, :]
    S = torch.where(act2[:, :, None, None], S, 0.0)
    S[idx, idx] += (~kf_active).to(dt)[:, None, None] * eye6
    b_s = b_p - torch.einsum("lkad,ld->ka", GH, b_l)
    b_s = torch.where(kf_active[:, None], b_s, 0.0)
    S_mat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dx_p = torch.linalg.solve_ex(S_mat, -b_s.reshape(-1))[0].reshape(K, 6)
    Gt_dx = torch.einsum("lkab,ka->lb", G, dx_p)
    dx_l = torch.einsum("lab,lb->la", Hll_inv, -b_l - Gt_dx)
    dx_p = torch.where(kf_active[:, None], dx_p, 0.0)
    dx_l = torch.where(lm_active[:, None], dx_l, 0.0)
    return dx_p, dx_l


def optimize_window(m: mapmod.MapState, cam_left: Camera, cam_right: Camera,
                    chi2_th: float = 5.991, iters: int = 10,
                    outlier_rounds: int = 5,
                    max_active_landmarks: int | None = None):
    """One BA pass over the active window: refined poses and landmarks are
    written back and outlier observations unlinked.

    Returns (new_map, stats) with stats = (num_obs, num_outliers,
    final_chi2_th, lm_overflow), all tensors."""
    K, F = m.obs_lm.shape
    L = m.lm_valid.shape[0]
    dt, dev = m.kf_pose.dtype, m.kf_pose.device
    obs = flatten_observations(m)
    huber_d2 = float(torch.tensor(chi2_th * chi2_th, dtype=dt))

    oldest_id = torch.min(torch.where(m.kf_valid, m.kf_id,
                                      torch.full_like(m.kf_id, 2 ** 31 - 1)))
    kf_free = m.kf_valid & (m.kf_id != oldest_id)
    lm_active = m.lm_valid & (m.lm_obs_count > 0)

    compact = max_active_landmarks is not None and max_active_landmarks < L
    if compact:
        La = max_active_landmarks
        sel = mapmod.nonzero_static(lm_active, La, fill=L)
        sel_on = sel < L
        inv = mapmod.scatter_drop(
            torch.full((L + 1,), -1, dtype=torch.int64, device=dev),
            torch.where(sel_on, sel, torch.full_like(sel, L + 1)),
            torch.arange(La, device=dev))
        lm_overflow = lm_active.sum() - sel_on.sum()
        lm_pos0 = torch.where(sel_on[:, None],
                              m.lm_pos[torch.clamp(sel, 0, L - 1)], 0.0)
        lm_active_c = sel_on
        obs_lm_c = inv[torch.where(obs.lm >= 0, obs.lm,
                                   torch.full_like(obs.lm, L))]
        obs_c = obs._replace(lm=obs_lm_c, valid=obs.valid & (obs_lm_c >= 0))
        L_solve = La
    else:
        lm_overflow = torch.zeros((), dtype=torch.int64, device=dev)
        lm_pos0, lm_active_c, obs_c, L_solve = m.lm_pos, lm_active, obs, L

    def rho(c):
        return torch.where(c <= huber_d2, c,
                           2.0 * torch.sqrt(huber_d2 * c) - huber_d2)

    def robust_total(kf_pose, lm_pos):
        r, _, _, in_front = _residuals_lr(cam_left, cam_right, kf_pose,
                                          lm_pos, obs_c)
        c = torch.sum(r * r, dim=-1)
        return torch.where(obs_c.valid & in_front, rho(c), 0.0).sum()

    kf_pose, lm_pos_c = m.kf_pose, lm_pos0
    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    for _ in range(iters):
        r, Jp, Jl, in_front = _residuals_lr(cam_left, cam_right, kf_pose,
                                            lm_pos_c, obs_c)
        c = torch.sum(r * r, dim=-1)
        use = obs_c.valid & in_front
        w = torch.where(use, jacobians.huber_weight(c, huber_d2), 0.0)
        H_pp, b_p, H_ll, b_l, G = (b[0] for b in _assemble(
            r, Jp, Jl, w, obs_c, K, L_solve))
        dx_p, dx_l = schur_solve(H_pp, b_p, H_ll, b_l, G, lam, kf_free,
                                 lm_active_c)
        kf_new = se3.se3_compose(se3.se3_exp(dx_p), kf_pose)
        lm_new = lm_pos_c + dx_l
        cost_inc = torch.where(use, rho(c), 0.0).sum()
        better = robust_total(kf_new, lm_new) < cost_inc
        kf_pose = torch.where(better, kf_new, kf_pose)
        lm_pos_c = torch.where(better, lm_new, lm_pos_c)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e4))

    if compact:
        lm_pos = mapmod.scatter_drop(
            m.lm_pos, torch.where(lm_active_c, sel, torch.full_like(sel, L)),
            lm_pos_c)
    else:
        lm_pos = lm_pos_c

    # adaptive outlier threshold: double until the inlier ratio > 0.5
    r, _, _, in_front = _residuals_lr(cam_left, cam_right, kf_pose, lm_pos_c,
                                      obs_c)
    c_final = torch.where(obs_c.valid & in_front, torch.sum(r * r, dim=-1),
                          0.0)
    total = torch.clamp(obs_c.valid.sum(), min=1)
    th = torch.tensor(chi2_th, dtype=dt, device=dev)

    def ratio_at(th):
        return (obs_c.valid & (c_final <= th) & in_front).sum() / total

    ratio = ratio_at(th)
    for _ in range(outlier_rounds):
        th = torch.where(ratio <= 0.5, th * 2.0, th)
        ratio = ratio_at(th)
    outlier = obs_c.valid & ((c_final > th) | ~in_front)

    # an outlier in either camera severs the feature->landmark link
    sever = outlier[:K * F].reshape(K, F) | outlier[K * F:].reshape(K, F)
    linked = m.obs_valid & (m.obs_lm >= 0)
    dec_flat = torch.cat([(sever & linked).reshape(-1),
                          (sever & linked & m.obs_has_r).reshape(-1)])
    dec_flat = (dec_flat & obs_c.valid).to(torch.int32)
    lm_dec = torch.where(obs_c.valid, obs_c.lm, torch.zeros_like(obs_c.lm))
    dec_c = torch.zeros(L_solve, dtype=torch.int32, device=dev).index_add_(
        0, lm_dec, dec_flat)
    if compact:
        dst = torch.where(lm_active_c, sel, torch.full_like(sel, L))
        ext = torch.cat([m.lm_obs_count, m.lm_obs_count[:1]])
        new_count = ext.index_add(0, dst, -dec_c)[:L]
    else:
        new_count = m.lm_obs_count - dec_c
    new_count = torch.clamp(new_count, min=0)

    m = m._replace(
        kf_pose=kf_pose, lm_pos=lm_pos,
        obs_lm=torch.where(sever, torch.full_like(m.obs_lm, -1), m.obs_lm),
        obs_has_r=m.obs_has_r & ~sever, lm_obs_count=new_count)
    return m, (obs.valid.sum(), outlier.sum(), th, lm_overflow)
