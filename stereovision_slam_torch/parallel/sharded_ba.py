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
leaves them to XLA. Values replicated over an axis are kept once. Each dp
rank's blocks and cost, and each mp rank's slice, are computed on their
own, with the shapes one rank has, and sums over ranks add in rank order
(`mesh.fold`): a batch of ranks rounds otherwise on the card (its GEMMs
contract in another order), so every layout below gives the same bits.

On a mesh over processes each process computes the blocks of its own
ranks (its dp rows and mp columns); "xla" is the local sum over its dp rows
followed by `all_reduce` over the processes of its dp ring, "ring" is
kernel D across the processes; the mp-axis Schur sum, the chi2 sums and
the gather of the landmark updates `all_reduce` where their axis crosses
processes, and the replicated camera solve runs in every process, as
`shard_map` runs it on every device.

On a per-rank mesh (`make_ba_mesh(devices=...)`, one device per rank in
this process: the reference's own single-process layout over several
chips) every rank runs the body on its own device, as `shard_map` does:
its observation chunk, its copy of the replicated state, its mp slice.
"xla" is the sum over the dp ranks in rank order with a copy on each
rank's device (`Mesh.psum_ranks`), "ring" is kernel D across the cards
(`ring_reduce.ring_psum_ranks`); the mp sums and the gather go through
the same per-rank collectives. The result is rank 0's, on `mesh.device`.
The body is one code for the three layouts: it runs once per unit, the
ranks one device serves, and the collectives join the units.

LM damping, Huber weights and the accept test are those of the
single-card solver (`slam/backend.py`), and so is the scatter of the
per-rank partial blocks (`backend._assemble`, float64 sums rounded once).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.geometry.camera import Camera
from stereovision_slam_torch.parallel import ring_reduce
from stereovision_slam_torch.parallel.mesh import Mesh, fold
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.backend import (
    _assemble, _blend_cameras, _residuals, flatten_observations)


def _local_blocks(cam_obs, kf_pose, lm_pos, obs, huber_d2, K, L):
    """One dp rank's normal-equation blocks, (1, ...), from its chunk of
    the observations."""
    r, J_pose, J_point, in_front = _residuals(cam_obs, kf_pose, lm_pos, obs)
    c = torch.sum(r * r, dim=-1)
    w = torch.where(obs.valid & in_front,
                    jacobians.huber_weight(c, huber_d2), 0.0)
    return _assemble(r, J_pose, J_point, w, obs, K, L)


def _robust_chi2(cam_obs, kf_pose, lm_pos, obs, huber_d2):
    """One dp rank's robust cost, in float64 throughout. The LM accept test
    compares two sums of these, and near the minimum a step along a barely
    observed direction changes the cost by less than float32 rounds:
    evaluated in float32, the test took such a step on one device and
    refused it on another (the CPU and the card, or two layouts of the
    ranks), and the results parted by a whole step."""
    f64 = torch.float64
    uv, p_cam = jacobians.project_points(
        Camera(*(t.to(f64) for t in cam_obs)), kf_pose.to(f64)[obs.kf],
        lm_pos.to(f64)[torch.clamp(obs.lm, min=0)])
    r = uv - obs.uv.to(f64)
    in_front = p_cam[..., 2] > 1e-6
    c = torch.sum(r * r, dim=-1)
    rho = torch.where(c <= huber_d2, c,
                      2.0 * torch.sqrt(huber_d2 * c) - huber_d2)
    return torch.where(obs.valid & in_front, rho, 0.0).sum()


def build_sharded_ba(mesh: Mesh, K: int, F: int, L: int,
                     chi2_th: float = 5.991, iters: int = 10,
                     reduce_impl: str = "xla",
                     max_active_landmarks: int | None = None):
    """A distributed BA for the mesh and capacities: returns
    run(map_state, cam_left, cam_right) -> (kf_pose, lm_pos), the refined
    poses and landmarks (the map and cameras on `mesh.device`, and so are
    the results).

    M = 2 K F observations must divide by dp, and the solved landmark axis
    (L, or `max_active_landmarks` La with the reference's compaction) by mp.
    `reduce_impl` picks the dp reduction: "xla" or "ring". The port has no
    XLA: "xla" keeps the reference's name for its `lax.psum` and is the
    plain sum over the dp ranks. "ring" is kernel D on the card and its
    plain version on the CPU, for all five blocks at once: one launch per
    LM iteration, or on a per-rank mesh over several cards one launch per
    card."""
    if reduce_impl not in ("xla", "ring"):
        raise ValueError(f"reduce_impl {reduce_impl!r}: 'xla' or 'ring'")
    if mesh.per_rank:
        mesh.check_rank_devices()
    n_dp, n_mp = mesh.shape["dp"], mesh.shape["mp"]
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
    # the units the body runs for: one rank each on a per-rank mesh, else
    # every rank this process holds, on its one device
    if mesh.per_rank:
        units = [(range(r // n_mp, r // n_mp + 1), range(r % n_mp,
                                                       r % n_mp + 1), d)
                 for r, d in enumerate(mesh.devices)]
    else:
        units = [(mesh.local_rows, mesh.local_cols, mesh.device)]

    def psum(parts, axis):
        """Each unit's partial, its own ranks already summed -> the sum
        over `axis`, one per unit."""
        if mesh.per_rank:
            return mesh.psum_ranks(parts, axis)
        return [mesh.all_reduce(parts[0], axis)]

    def gather(parts, axis):
        if mesh.per_rank:
            return mesh.gather_ranks(parts, axis)
        return [mesh.all_reduce_gather(parts[0], axis)]

    def reduce_dp(us, blocks):
        """psum over dp of each unit's per-dp blocks (n_rows, ...): the
        copies of the unit's mp ranks, (n_cols, ...) after the reduction
        (every dp rank holds the same)."""
        if reduce_impl == "xla":
            sums = [psum([fold(b[k]) for b in blocks], "dp")
                    for k in range(len(blocks[0]))]
            return [tuple(s[i][None].expand((len(u.cols),) + s[i].shape)
                          for s in sums) for i, u in enumerate(us)]
        if mesh.per_rank:
            out = ring_reduce.ring_psum_ranks(
                [tuple(b[0] for b in bl) for bl in blocks], "dp",
                mesh.mesh_axes)
            return [tuple(b[None] for b in t) for t in out]
        n_rows, n_cols = mesh.local_shape
        ranks = tuple(b[:, None].expand((n_rows, n_cols) + b.shape[1:])
                      for b in blocks[0])
        out = ring_reduce.ring_psum(ranks, "dp", mesh.mesh_axes, mesh)
        return [tuple(b[0] for b in out)]

    def unit_state(rows, cols, dev, obs, cam_obs, kf_pose, lm_pos,
                   kf_free):
        """A unit's observation chunks, one per dp row, and its copy of
        the replicated state on its device."""
        def chunk(tree, i):
            return type(tree)(*(f[i * Mc:(i + 1) * Mc].to(dev) for f in tree))
        return SimpleNamespace(
            rows=rows, cols=cols, dev=dev,
            chunks=[(chunk(obs, i), chunk(cam_obs, i)) for i in rows],
            kf=kf_pose.to(dev), lm=lm_pos.to(dev), free=kf_free.to(dev),
            lam=torch.tensor(1e-4, dtype=kf_pose.dtype, device=dev))

    def blocks_of(u):
        """The unit's normal-equation blocks, (n_rows, ...), one dp rank's
        chunk at a time."""
        return tuple(torch.cat(b) for b in zip(*[
            _local_blocks(cam, u.kf, u.lm, obs, huber_d2, K, L_solve)
            for obs, cam in u.chunks]))

    def marginalize(u, blocks):
        """Each of the unit's mp ranks on its slice of the landmark blocks:
        the inverses, then the partial Schur complement and right-hand
        side, summed over the unit's mp ranks in rank order."""
        H_pp, b_p, H_ll, b_l, G = blocks
        eye3 = torch.eye(3, dtype=u.kf.dtype, device=u.dev)
        # replicated over mp: the copy of mp rank 0
        u.H_pp, u.b_p = H_pp[0], b_p[0]
        u.kf_active = (torch.diagonal(u.H_pp, dim1=-2, dim2=-1).sum(-1)
                       > 0) & u.free
        lm_diag_all = torch.diagonal(H_ll[0], dim1=-2, dim2=-1)
        lm_active = lm_diag_all.sum(-1) > 0
        u.slices, S_parts, bs_parts = [], [], []
        for c, j in enumerate(u.cols):
            sl = slice(j * Ls, (j + 1) * Ls)
            act = lm_active[sl]
            Hll_d = H_ll[c, sl] + u.lam * eye3 * torch.clamp(
                lm_diag_all[sl], min=1e-6)[..., None] * eye3
            Hll_d = torch.where(act[:, None, None], Hll_d, eye3)
            Hll_inv = torch.where(act[:, None, None],
                                  torch.linalg.inv_ex(Hll_d)[0], 0.0)
            G_s, bl_s = G[c, sl], b_l[c, sl]
            GH = torch.einsum("lkac,lcd->lkad", G_s, Hll_inv)
            S_parts.append(torch.einsum("lkad,ljbd->kjab", GH, G_s))
            bs_parts.append(torch.einsum("lkad,ld->ka", GH, bl_s))
            u.slices.append((G_s, bl_s, act, Hll_inv))
        return fold(S_parts), fold(bs_parts)

    def solve(u, S_sum, bs_sum):
        """The replicated reduced camera solve, then the unit's landmark
        slices back-substituted, (n_cols, Ls, 3)."""
        dt, dev, H_pp = u.kf.dtype, u.dev, u.H_pp
        eye6 = torch.eye(6, dtype=dt, device=dev)
        S = -S_sum
        b_s = u.b_p - bs_sum
        diag_damp = H_pp + u.lam * eye6 * torch.clamp(
            torch.diagonal(H_pp, dim1=-2, dim2=-1), min=1e-6)[
            ..., None] * eye6
        idx = torch.arange(K, device=dev)
        S[idx, idx] += diag_damp
        act2 = u.kf_active[:, None] & u.kf_active[None, :]
        S = torch.where(act2[:, :, None, None], S, 0.0)
        S[idx, idx] += (~u.kf_active).to(dt)[:, None, None] * eye6
        b_s = torch.where(u.kf_active[:, None], b_s, 0.0)

        S_mat = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        dx_p = torch.linalg.solve_ex(S_mat, -b_s.reshape(-1))[0]
        u.dx_p = torch.where(u.kf_active[:, None], dx_p.reshape(K, 6), 0.0)
        out = []
        for G_s, bl_s, act, Hll_inv in u.slices:
            Gt_dx = torch.einsum("lkab,ka->lb", G_s, u.dx_p)
            dx_l = torch.einsum("lab,lb->la", Hll_inv, -bl_s - Gt_dx)
            out.append(torch.where(act[:, None], dx_l, 0.0))
        return torch.stack(out)

    def chi2_part(u, kf_pose, lm_pos):
        return fold([_robust_chi2(cam, kf_pose, lm_pos, obs, huber_d2)
                     for obs, cam in u.chunks])

    def ba_step(obs, cam_obs, kf_pose, lm_pos, kf_free):
        us = [unit_state(*unit, obs, cam_obs, kf_pose, lm_pos, kf_free)
              for unit in units]
        for _ in range(iters):
            blocks = reduce_dp(us, [blocks_of(u) for u in us])
            parts = [marginalize(u, b) for u, b in zip(us, blocks)]
            S = psum([p[0] for p in parts], "mp")
            bs = psum([p[1] for p in parts], "mp")
            dx_l = gather([solve(u, s, b) for u, s, b in zip(us, S, bs)],
                          "mp")
            new = [(se3.se3_compose(se3.se3_exp(u.dx_p), u.kf),
                    u.lm + d.reshape(L_solve, 3)) for u, d in zip(us, dx_l)]
            chi_new = psum([chi2_part(u, *n) for u, n in zip(us, new)], "dp")
            chi_old = psum([chi2_part(u, u.kf, u.lm) for u in us], "dp")
            for u, (kf_new, lm_new), c_new, c_old in zip(us, new, chi_new,
                                                         chi_old):
                better = c_new < c_old
                u.kf = torch.where(better, kf_new, u.kf)
                u.lm = torch.where(better, lm_new, u.lm)
                u.lam = torch.where(better, torch.clamp(u.lam * 0.5,
                                                        min=1e-9),
                                    torch.clamp(u.lam * 4.0, max=1e4))
        # every unit holds the same result; the first is on mesh.device
        return us[0].kf, us[0].lm

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
