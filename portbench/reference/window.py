"""The sliding window of keyframes and landmarks, and its bundle
adjustment, as the reference keeps them.

The window is a dict of tensors under the program's state names (K
keyframe slots, F features a keyframe, L landmark slots):
kf_pose (K, 3, 4), kf_frame_id, kf_id (K,) (-1 empty), kf_valid (K,);
lm_pos (L, 3), lm_valid, lm_obs_count, lm_first_kf, lm_id (L,);
obs_uv_l, obs_uv_r (K, F, 2), obs_lm (K, F) (-1 none), obs_has_r,
obs_valid (K, F); next_lm_id (). A landmark's count is the number of
camera observations of it in the window (left, and right where the
feature has one).
"""

from __future__ import annotations

import torch

from portbench.reference import geometry as geo


def first_free(used: torch.Tensor, n: int) -> torch.Tensor:
    """The first n slots with used False, in order, then -1s."""
    free = torch.nonzero(~used).flatten()[:n]
    return torch.cat([free, torch.full((n - len(free),), -1,
                                       dtype=torch.long)])


def _counts(lm: torch.Tensor, on: torch.Tensor, has_r: torch.Tensor,
            L: int) -> torch.Tensor:
    """Per landmark slot, the camera observations of the rows `on`."""
    out = torch.zeros(L, dtype=torch.int32)
    w = (1 + has_r.int()) * on.int()
    return out.index_add(0, torch.clamp(lm, min=0).long(), w)


def add_landmarks(w: dict, pos: torch.Tensor, create: torch.Tensor,
                  kf_id: int):
    """New landmarks at `pos` (F, 3) where `create`: the k-th created one
    takes the k-th free slot and the id next_lm_id + k. Returns (window,
    slots (F,) -1 where none)."""
    F = pos.shape[0]
    w = dict(w)
    k = torch.cumsum(create.long(), 0) - 1
    free = first_free(w["lm_valid"], F)
    slots = torch.where(create, free[torch.clamp(k, 0, F - 1)],
                        torch.full_like(k, -1))
    ok = create & (slots >= 0)
    s = slots[ok]
    for name, val in (("lm_pos", pos[ok]), ("lm_valid", True),
                      ("lm_obs_count", 0), ("lm_first_kf", kf_id),
                      ("lm_id", (w["next_lm_id"] + k[ok]).int())):
        w[name] = w[name].clone()
        w[name][s] = val
    w["next_lm_id"] = w["next_lm_id"] + int(ok.sum())
    return w, slots


def insert_keyframe(w: dict, pose, frame_id: int, kf_id: int, uv_l, uv_r,
                    feat_lm, has_r, feat_valid, num_active: int) -> dict:
    """The keyframe joins the first empty slot. A window of `num_active`
    keyframes first drops one: the nearest to the new pose where it lies
    within 0.2 (|log|), else the farthest. A dropped keyframe's
    observations leave the counts, and a landmark left with none leaves
    the window."""
    w = {k: v.clone() for k, v in w.items()}
    L = w["lm_valid"].shape[0]
    if int(w["kf_valid"].sum()) >= num_active:
        d = geo.distance(w["kf_pose"], pose[None])
        live = w["kf_valid"]
        near = torch.argmin(torch.where(live, d, torch.full_like(d, float(
            "inf"))))
        far = torch.argmax(torch.where(live, d, torch.full_like(d, -float(
            "inf"))))
        s = int(near if d[near] < 0.2 else far)
        on = w["obs_valid"][s] & (w["obs_lm"][s] >= 0)
        count = torch.clamp(w["lm_obs_count"] - _counts(
            w["obs_lm"][s], on, w["obs_has_r"][s], L), min=0)
        gone = w["lm_valid"] & (count == 0) & (w["lm_obs_count"] > 0)
        w["lm_obs_count"], w["lm_valid"] = count, w["lm_valid"] & ~gone
        w["kf_valid"][s], w["kf_frame_id"][s], w["kf_id"][s] = False, -1, -1
        w["obs_valid"][s], w["obs_lm"][s], w["obs_has_r"][s] = False, -1, \
            False
    s = int(torch.argmax((~w["kf_valid"]).int()))
    on = feat_valid & (feat_lm >= 0) & w["lm_valid"][torch.clamp(
        feat_lm, min=0).long()]
    w["lm_obs_count"] = w["lm_obs_count"] + _counts(feat_lm, on, has_r, L)
    w["kf_pose"][s], w["kf_frame_id"][s], w["kf_id"][s] = pose, frame_id, \
        kf_id
    w["kf_valid"][s] = True
    w["obs_uv_l"][s], w["obs_uv_r"][s] = uv_l, uv_r
    w["obs_lm"][s] = torch.where(on, feat_lm, torch.full_like(feat_lm, -1))
    w["obs_has_r"][s] = has_r & on
    w["obs_valid"][s] = feat_valid
    return w


def newest(w: dict) -> int:
    return int(torch.argmax(torch.where(w["kf_valid"], w["kf_id"],
                                        torch.full_like(w["kf_id"], -1))))


# -- bundle adjustment ------------------------------------------------------ #

def bundle_adjust(w: dict, cams, *, chi2_th: float, iters: int,
                  max_active: int | None, outlier_rounds: int = 5) -> dict:
    """One pass over the window: every keyframe pose but the oldest and
    the landmarks with observations (the first `max_active` of them by
    slot) move by `iters` LM steps on the stereo reprojection errors,
    Huber above chi2_th^2 on the squared error; a step (H + lam diag H,
    diagonal at least 1e-6; lam from 1e-4, x0.5 on a kept step, x4
    otherwise, in [1e-9, 1e4]) is kept when the robust cost drops. The
    normal equations are solved in float64 with the landmarks eliminated.
    Then the outlier threshold doubles from chi2_th, up to
    `outlier_rounds` times, while at most half the observations are
    within it, and an observation beyond it (or behind its camera) cuts
    its feature's link in both cameras."""
    K, F = w["obs_lm"].shape
    L = w["lm_valid"].shape[0]
    dt = w["kf_pose"].dtype
    d2 = float(torch.tensor(chi2_th * chi2_th, dtype=dt))

    active = w["lm_valid"] & (w["lm_obs_count"] > 0)
    sel = torch.nonzero(active).flatten()
    if max_active is not None and max_active < L:
        sel = sel[:max_active]
    La = len(sel)
    cidx = torch.full((L,), -1, dtype=torch.long)
    cidx[sel] = torch.arange(La)

    base = w["obs_valid"] & (w["obs_lm"] >= 0) & w["kf_valid"][:, None]
    kk = torch.arange(K)[:, None].expand(K, F)
    rows = []   # (kf slot, compact landmark, uv, camera) per observation
    for side, on in ((0, base), (1, base & w["obs_has_r"])):
        uv = w["obs_uv_l"] if side == 0 else w["obs_uv_r"]
        lmc = cidx[torch.clamp(w["obs_lm"], min=0).long()]
        on = on & (lmc >= 0)
        rows.append((kk[on], lmc[on], uv[on], side, on))
    oldest = int(torch.min(torch.where(w["kf_valid"], w["kf_id"],
                                       torch.full_like(w["kf_id"],
                                                       2 ** 31 - 1))))
    free = w["kf_valid"] & (w["kf_id"] != oldest)

    def residuals(poses, pts):
        out = []
        for k, l, uv, side, _ in rows:
            r, Jp, Jl, z = geo.reprojection(cams[side], poses[k], pts[l], uv)
            out.append((r, Jp, Jl, z > 1e-6))
        return out

    def rho(c):
        return torch.where(c <= d2, c, 2.0 * torch.sqrt(d2 * c) - d2)

    def cost(res):
        return sum(torch.where(f, rho((r * r).sum(-1)), 0.0).sum()
                   for r, _, _, f in res)

    poses, pts = w["kf_pose"].clone(), w["lm_pos"][sel].clone()
    lam = 1e-4
    for _ in range(iters):
        res = residuals(poses, pts)
        Hpp = torch.zeros(K, 6, 6, dtype=torch.float64)
        bp = torch.zeros(K, 6, dtype=torch.float64)
        Hll = torch.zeros(La, 3, 3, dtype=torch.float64)
        bl = torch.zeros(La, 3, dtype=torch.float64)
        G = torch.zeros(La, K, 6, 3, dtype=torch.float64)
        for (k, l, _, _, _), (r, Jp, Jl, front) in zip(rows, res):
            c = (r * r).sum(-1)
            wt = torch.where(front, torch.where(
                c <= d2, torch.ones_like(c),
                torch.sqrt(d2 / torch.clamp(c, min=1e-20))), 0.0).double()
            r, Jp, Jl = r.double(), Jp.double(), Jl.double()
            Hpp.index_put_((k,), torch.einsum("n,nai,naj->nij", wt, Jp, Jp),
                           accumulate=True)
            bp.index_put_((k,), torch.einsum("n,nai,na->ni", wt, Jp, r),
                          accumulate=True)
            Hll.index_put_((l,), torch.einsum("n,nai,naj->nij", wt, Jl, Jl),
                           accumulate=True)
            bl.index_put_((l,), torch.einsum("n,nai,na->ni", wt, Jl, r),
                          accumulate=True)
            G.index_put_((l, k), torch.einsum("n,nai,naj->nij", wt, Jp, Jl),
                         accumulate=True)
        dxp, dxl = _schur(Hpp, bp, Hll, bl, G, lam, free)
        new_poses = geo.compose(geo.exp(dxp.to(dt)), poses)
        new_pts = pts + dxl.to(dt)
        if cost(residuals(new_poses, new_pts)) < cost(res):
            poses, pts = new_poses, new_pts
            lam = max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e4)

    out = {k: v.clone() for k, v in w.items()}
    out["kf_pose"] = poses
    out["lm_pos"][sel] = pts
    # outliers at the final estimate
    res = residuals(poses, pts)
    chi = [torch.where(f, (r * r).sum(-1), 0.0) for r, _, _, f in res]
    total = max(sum(len(c) for c in chi), 1)
    th = float(torch.tensor(chi2_th, dtype=dt))

    def share(th):
        return sum(int(((c <= th) & f).sum())
                   for c, (*_, f) in zip(chi, res)) / total
    ratio = share(th)
    for _ in range(outlier_rounds):
        if ratio <= 0.5:
            th *= 2.0
        ratio = share(th)
    cut = torch.zeros(K, F, dtype=torch.bool)
    for c, (*_, f), (*_, on) in zip(chi, res, rows):
        cut[on] |= (c > th) | ~f
    dec = torch.zeros(La, dtype=torch.int32)
    for *_, on in rows:
        lm = cidx[torch.clamp(w["obs_lm"], min=0).long()][cut & on]
        dec.index_add_(0, lm, torch.ones_like(lm, dtype=torch.int32))
    count = w["lm_obs_count"].clone()
    count[sel] = count[sel] - dec
    out["lm_obs_count"] = torch.clamp(count, min=0)
    out["obs_lm"] = torch.where(cut, torch.full_like(w["obs_lm"], -1),
                                w["obs_lm"])
    out["obs_has_r"] = w["obs_has_r"] & ~cut
    return out


def _schur(Hpp, bp, Hll, bl, G, lam, free):
    """Solve the damped normal equations with the landmark blocks
    eliminated; fixed keyframes do not move."""
    K, La = Hpp.shape[0], Hll.shape[0]
    e3 = torch.eye(3, dtype=torch.float64)
    e6 = torch.eye(6, dtype=torch.float64)
    Hll = Hll + lam * torch.diag_embed(torch.clamp(torch.diagonal(
        Hll, dim1=-2, dim2=-1), min=1e-6))
    det = torch.linalg.det(Hll)
    Hinv = torch.where((det.abs() > 1e-30)[:, None, None],
                       torch.linalg.inv(torch.where(
                           (det.abs() > 1e-30)[:, None, None], Hll, e3)), 0.0)
    GH = torch.einsum("lkad,lde->lkae", G, Hinv)
    S = torch.zeros(K, K, 6, 6, dtype=torch.float64)
    S -= torch.einsum("lkae,ljbe->kjab", GH, G)
    S[range(K), range(K)] += Hpp + lam * torch.diag_embed(torch.clamp(
        torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6))
    both = free[:, None] & free[None, :]
    S = torch.where(both[:, :, None, None], S, 0.0)
    S[range(K), range(K)] += (~free).double()[:, None, None] * e6
    rhs = torch.where(free[:, None], bp - torch.einsum("lkae,le->ka", GH, bl),
                      0.0)
    dxp = torch.linalg.solve(S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K),
                             -rhs.reshape(-1)).reshape(K, 6)
    dxp = torch.where(free[:, None], dxp, 0.0)
    dxl = torch.einsum("lab,lb->la", Hinv,
                       -bl - torch.einsum("lkab,ka->lb", G, dxp))
    return dxp, dxl
