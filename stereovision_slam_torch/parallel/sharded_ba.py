"""Distributed sliding-window bundle adjustment over a (dp, mp) rank mesh
(counterpart of `parallel/sharded_ba.py`).

  dp - the observations are split into n_dp contiguous chunks; each rank
       linearizes its chunk and scatter-adds partial normal-equation blocks
       (H_pp, b_p, H_ll, b_l, G), which a `psum` over dp completes;
  mp - each rank inverts its slice of the landmark Hessians and forms its
       partial Schur complement; a `psum` over mp completes it, the reduced
       camera system is solved replicated, the landmark updates are
       back-substituted per slice and gathered.

The ranks are tensor axes (`parallel/mesh.py`): the local blocks have
shape (n_dp, n_mp, ...), rank (i, j) holding those of observation chunk i.
The dp reduction is `"xla"`, a sum over the dp axis (the counterpart of
`lax.psum`), or `"ring"`, one launch of kernel D for the five blocks
(`ring_reduce.ring_psum`). The small mp-axis Schur sum, the chi2 sums and
the gather of the landmark updates stay plain tensor ops, as the reference
leaves them to XLA. Values replicated over an axis are kept once.

On a mesh over processes each process computes the blocks of its own
ranks (its dp rows and mp columns); "xla" is the local sum over its dp rows
followed by `all_reduce` over the processes of its dp ring, "ring" is
kernel D across the processes; the mp-axis Schur sum, the chi2 sums and
the gather of the landmark updates `all_reduce` where their axis crosses
processes, and the replicated camera solve runs in every process, as
`shard_map` runs it on every device. A mesh whose ranks sit on several
devices of one process is refused: one process per card.

LM damping, Huber weights and the accept test are those of the
single-card solver (`slam/backend.py`), and so is the scatter of the
per-rank partial blocks (`backend._assemble`, float64 sums rounded once).
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.parallel import ring_reduce
from stereovision_slam_torch.parallel.mesh import Mesh
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.backend import (
    _assemble, _blend_cameras, _residuals, flatten_observations)


def _local_blocks(cam_obs, kf_pose, lm_pos, obs, huber_d2, n_dp, K, L):
    """Per-dp-rank normal-equation blocks (n_dp, ...) of the observation
    chunks given (observation m belongs to rank m // (M / n_dp))."""
    r, J_pose, J_point, in_front = _residuals(cam_obs, kf_pose, lm_pos, obs)
    c = torch.sum(r * r, dim=-1)
    w = torch.where(obs.valid & in_front,
                    jacobians.huber_weight(c, huber_d2), 0.0)
    M = r.shape[0]
    rank = torch.arange(M, device=r.device) // (M // n_dp)
    return _assemble(r, J_pose, J_point, w, obs, K, L, rank, n_dp)


def _robust_chi2(cam_obs, kf_pose, lm_pos, obs, huber_d2, n_dp):
    """Per-dp-rank robust cost (n_dp,), then its sum over dp."""
    r, _, _, in_front = _residuals(cam_obs, kf_pose, lm_pos, obs)
    c = torch.sum(r * r, dim=-1)
    rho = torch.where(c <= huber_d2, c,
                      2.0 * torch.sqrt(huber_d2 * c) - huber_d2)
    rho = torch.where(obs.valid & in_front, rho, 0.0)
    return rho.reshape(n_dp, -1).sum(1).sum(0)


def build_sharded_ba(mesh: Mesh, K: int, F: int, L: int,
                     chi2_th: float = 5.991, iters: int = 10,
                     reduce_impl: str = "xla",
                     max_active_landmarks: int | None = None):
    """A distributed BA for the mesh and capacities: returns
    run(map_state, cam_left, cam_right) -> (kf_pose, lm_pos), the refined
    poses and landmarks (the map and cameras on `mesh.device`).

    M = 2 K F observations must divide by dp, and the solved landmark axis
    (L, or `max_active_landmarks` La with the reference's compaction) by mp.
    `reduce_impl` picks the dp reduction: "xla" or "ring". The port has no
    XLA: "xla" keeps the reference's name for its `lax.psum` and is the
    plain `sum` over the dp axis. "ring" is kernel D on the card and its
    plain version on the CPU, one launch per LM iteration for all five
    blocks."""
    if reduce_impl not in ("xla", "ring"):
        raise ValueError(f"reduce_impl {reduce_impl!r}: 'xla' or 'ring'")
    if len(set(mesh.local_devices)) > 1:
        raise NotImplementedError(
            "the sharded BA runs one process per card: start one process per "
            "device with `parallel.mesh.initialize_multihost` and build the "
            "mesh in each (the PyTorch idiom for the reference's "
            "single-host multi-device mesh)")
    n_dp, n_mp = mesh.shape["dp"], mesh.shape["mp"]
    rows, cols = mesh.local_rows, mesh.local_cols
    n_rows, n_cols = mesh.local_shape
    M = 2 * K * F
    compact = max_active_landmarks is not None and max_active_landmarks < L
    L_solve = max_active_landmarks if compact else L
    if M % n_dp:
        raise ValueError(f"observation count {M} does not divide by dp "
                         f"= {n_dp}")
    if L_solve % n_mp:
        raise ValueError(f"landmark solve axis {L_solve} does not divide by "
                         f"mp = {n_mp}")
    Ls = L_solve // n_mp
    Mc = M // n_dp                 # observations per dp rank
    huber_d2 = chi2_th * chi2_th

    def mine(tree):
        """The observations of this process's dp rows."""
        if n_rows == n_dp:
            return tree
        return type(tree)(*(f[rows.start * Mc:rows.stop * Mc] for f in tree))

    def reduce_dp(blocks):
        """psum over dp of per-dp blocks (n_rows, ...): the copies of this
        process's mp ranks, (n_cols, ...) after the reduction (every dp
        rank holds the same)."""
        if reduce_impl == "xla":
            return tuple(mesh.all_reduce(b.sum(0), "dp")[None].expand(
                (n_cols,) + b.shape[1:]) for b in blocks)
        ranks = tuple(b[:, None].expand((n_rows, n_cols) + b.shape[1:])
                      for b in blocks)
        out = ring_reduce.ring_psum(ranks, "dp", mesh.mesh_axes, mesh)
        return tuple(b[0] for b in out)

    def chi2(cam_obs, kf_pose, lm_pos, obs):
        return mesh.all_reduce(_robust_chi2(
            cam_obs, kf_pose, lm_pos, obs, huber_d2, n_rows), "dp")

    def ba_step(obs, cam_obs, kf_pose, lm_pos, kf_free):
        dt, dev = kf_pose.dtype, kf_pose.device
        eye3 = torch.eye(3, dtype=dt, device=dev)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        mi = mesh.axis_index("mp")
        ci = torch.arange(n_cols, device=dev)
        obs_r, cam_r = mine(obs), mine(cam_obs)
        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        for _ in range(iters):
            H_pp, b_p, H_ll, b_l, G = reduce_dp(_local_blocks(
                cam_r, kf_pose, lm_pos, obs_r, huber_d2, n_rows, K, L_solve))
            # replicated over mp: the copy of mp rank 0
            H_pp, b_p = H_pp[0], b_p[0]
            kf_active = (torch.diagonal(H_pp, dim1=-2, dim2=-1).sum(-1) > 0) \
                & kf_free
            lm_diag_all = torch.diagonal(H_ll[0], dim1=-2, dim2=-1)
            lm_active = lm_diag_all.sum(-1) > 0

            # landmark marginalization, mp rank j on its slice j
            Hll_s = H_ll.reshape(n_cols, n_mp, Ls, 3, 3)[ci, mi]
            bl_s = b_l.reshape(n_cols, n_mp, Ls, 3)[ci, mi]
            G_s = G.reshape(n_cols, n_mp, Ls, K, 6, 3)[ci, mi]
            act_s = lm_active.reshape(n_mp, Ls)[mi]
            diag_s = lm_diag_all.reshape(n_mp, Ls, 3)[mi]
            Hll_d = Hll_s + lam * eye3 * torch.clamp(diag_s, min=1e-6)[
                ..., None] * eye3
            Hll_d = torch.where(act_s[..., None, None], Hll_d, eye3)
            Hll_inv_s = torch.where(act_s[..., None, None],
                                    torch.linalg.inv_ex(Hll_d)[0], 0.0)
            GH_s = torch.einsum("mlkac,mlcd->mlkad", G_s, Hll_inv_s)
            S = -mesh.all_reduce(
                torch.einsum("mlkad,mljbd->mkjab", GH_s, G_s).sum(0), "mp")
            b_s = b_p - mesh.all_reduce(
                torch.einsum("mlkad,mld->mka", GH_s, bl_s).sum(0), "mp")

            diag_damp = H_pp + lam * eye6 * torch.clamp(
                torch.diagonal(H_pp, dim1=-2, dim2=-1), min=1e-6)[
                ..., None] * eye6
            idx = torch.arange(K, device=dev)
            S[idx, idx] += diag_damp
            act2 = kf_active[:, None] & kf_active[None, :]
            S = torch.where(act2[:, :, None, None], S, 0.0)
            S[idx, idx] += (~kf_active).to(dt)[:, None, None] * eye6
            b_s = torch.where(kf_active[:, None], b_s, 0.0)

            # replicated reduced solve
            S_mat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
            dx_p = torch.linalg.solve_ex(S_mat, -b_s.reshape(-1))[0]
            dx_p = torch.where(kf_active[:, None], dx_p.reshape(K, 6), 0.0)

            # back-substitution per mp slice, then the all-gather
            Gt_dx = torch.einsum("mlkab,ka->mlb", G_s, dx_p)
            dx_l_s = torch.einsum("mlab,mlb->mla", Hll_inv_s, -bl_s - Gt_dx)
            dx_l = mesh.all_reduce_gather(
                torch.where(act_s[..., None], dx_l_s, 0.0), "mp").reshape(
                L_solve, 3)

            kf_new = se3.se3_compose(se3.se3_exp(dx_p), kf_pose)
            lm_new = lm_pos + dx_l
            chi_new = chi2(cam_r, kf_new, lm_new, obs_r)
            chi_old = chi2(cam_r, kf_pose, lm_pos, obs_r)
            better = chi_new < chi_old
            kf_pose = torch.where(better, kf_new, kf_pose)
            lm_pos = torch.where(better, lm_new, lm_pos)
            lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e4))
        return kf_pose, lm_pos

    def run(m: mapmod.MapState, cam_left: Camera, cam_right: Camera):
        if m.kf_pose.device != mesh.device:
            raise ValueError(f"the map is on {m.kf_pose.device}, the mesh on "
                             f"{mesh.device}")
        if m.obs_lm.shape != (K, F) or m.lm_pos.shape[0] != L:
            raise ValueError(f"map capacities {tuple(m.obs_lm.shape)}, "
                             f"{m.lm_pos.shape[0]} are not (K, F) = "
                             f"({K}, {F}), L = {L}")
        dev = mesh.device
        obs = flatten_observations(m)
        is_right = torch.arange(M, device=dev) >= K * F
        obs = obs._replace(is_right=is_right)
        cam_obs = _blend_cameras(cam_left, cam_right, is_right)
        oldest = torch.min(torch.where(m.kf_valid, m.kf_id,
                                       torch.full_like(m.kf_id, 2 ** 31 - 1)))
        kf_free = m.kf_valid & (m.kf_id != oldest)
        if not compact:
            return ba_step(obs, cam_obs, m.kf_pose, m.lm_pos, kf_free)
        # gather the observed landmarks into the compact (La,) solve table
        lm_active = m.lm_valid & (m.lm_obs_count > 0)
        sel = mapmod.nonzero_static(lm_active, L_solve, fill=L)
        sel_on = sel < L
        inv = mapmod.scatter_drop(
            torch.full((L + 1,), -1, dtype=torch.int64, device=dev),
            torch.where(sel_on, sel, torch.full_like(sel, L + 1)),
            torch.arange(L_solve, device=dev))
        lm_pos0 = torch.where(sel_on[:, None],
                              m.lm_pos[torch.clamp(sel, 0, L - 1)], 0.0)
        lm_c = inv[torch.where(obs.lm >= 0, obs.lm,
                               torch.full_like(obs.lm, L))]
        obs_c = obs._replace(lm=lm_c, valid=obs.valid & (lm_c >= 0))
        kf_pose, lm_pos_c = ba_step(obs_c, cam_obs, m.kf_pose, lm_pos0,
                                    kf_free)
        lm_pos = mapmod.scatter_drop(
            m.lm_pos, torch.where(sel_on, sel, torch.full_like(sel, L)),
            lm_pos_c)
        return kf_pose, lm_pos

    return run
