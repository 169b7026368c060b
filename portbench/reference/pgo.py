"""The shutdown pose graph of a drive, built from its final state, its
cost, and its solve, in float64.

Vertices are the drive's keyframes in id order (the archive's poses, the
window's where a keyframe is still in it). Edges: each keyframe to its
predecessor, measured by the odometry the archive recorded (unit
information), and each loop edge between keyframes of the graph, measured
by its relative pose with its information. An edge (i, j) with
measurement M has the residual log(M^-1 T_i T_j^-1) and the cost
r^T info r, info's negative rounding in its spectrum dropped.
"""

from __future__ import annotations

import torch

from portbench.reference import geometry as geo


def graph(arc: dict, ms: dict, ls: dict):
    """(graph dict, {kf id: slot}, {kf id: (frame id, pose)}), or None
    with fewer than three keyframes or no loop edge."""
    kfs = {int(k): (int(arc["kf_frame_id"][k]), arc["kf_pose"][k])
           for k in torch.nonzero(arc["kf_set"]).flatten().tolist()}
    for s in torch.nonzero(ms["kf_valid"]).flatten().tolist():
        kfs[int(ms["kf_id"][s])] = (int(ms["kf_frame_id"][s]),
                                    ms["kf_pose"][s])
    n = int(ls["n_loops"])
    ids = sorted(kfs)
    if len(ids) < 3 or n == 0:
        return None
    slot = {k: s for s, k in enumerate(ids)}
    ei, ej, meas, info = [], [], [], []
    eye = torch.eye(6, dtype=torch.float64)
    for a, b in zip(ids, ids[1:]):
        ei.append(slot[b])
        ej.append(slot[a])
        meas.append(arc["kf_rel"][b].double())
        info.append(eye)
    for e in range(n):
        i, j = int(ls["loop_i"][e]), int(ls["loop_j"][e])
        if i in slot and j in slot:
            ei.append(slot[i])
            ej.append(slot[j])
            meas.append(ls["loop_rel"][e].double())
            A = ls["loop_info"][e].double()
            ev, U = torch.linalg.eigh(0.5 * (A + A.T))
            info.append(U @ torch.diag(torch.clamp(ev, min=0.0)) @ U.T)
    g = dict(poses=torch.stack([kfs[k][1] for k in ids]).double(),
             i=torch.tensor(ei), j=torch.tensor(ej),
             meas=torch.stack(meas), info=torch.stack(info))
    return g, slot, kfs


def _residual(Ti, Tj, M):
    return geo.log(geo.compose(geo.inverse(M),
                               geo.compose(Ti, geo.inverse(Tj))))


def cost(g: dict, poses: torch.Tensor) -> float:
    r = _residual(poses[g["i"]], poses[g["j"]], g["meas"])
    return float(torch.einsum("ea,eab,eb->", r, g["info"], r))


def solve(g: dict, iters: int, cg_iters: int = 100) -> torch.Tensor:
    """`iters` Levenberg-Marquardt steps with the first keyframe held: the
    damped normal equations (H + lam diag H) dx = -g solved by `cg_iters`
    steps of conjugate gradients preconditioned by the inverses of H's
    damped 6 x 6 diagonal blocks (+1e-8), stopping where r.z < 1e-8; a
    step taken on the left by exp and kept when the cost drops (lam from
    1e-6, x0.5 on a kept step, x4 otherwise, in [1e-9, 1e6])."""
    poses = g["poses"].clone()
    T = poses.shape[0]
    n = 6 * (T - 1)

    def r_of(xi, xj, Ti, Tj, M):
        return _residual(geo.compose(geo.exp(xi), Ti),
                         geo.compose(geo.exp(xj), Tj), M)

    jac = torch.func.vmap(torch.func.jacfwd(r_of, argnums=(0, 1)))
    six = torch.arange(6)
    lam = 1e-6
    c = cost(g, poses)
    for _ in range(iters):
        Ti, Tj = poses[g["i"]], poses[g["j"]]
        z = torch.zeros(len(g["i"]), 6, dtype=torch.float64)
        Ji, Jj = jac(z, z, Ti, Tj, g["meas"])
        r = _residual(Ti, Tj, g["meas"])
        H = torch.zeros(T, 6, T, 6, dtype=torch.float64)
        b = torch.zeros(T, 6, dtype=torch.float64)
        for A, ia in ((Ji, g["i"]), (Jj, g["j"])):
            b.index_add_(0, ia, torch.einsum("eba,ebc,ec->ea", A, g["info"],
                                             r))
            for B, ib in ((Ji, g["i"]), (Jj, g["j"])):
                H.index_put_((ia[:, None, None], six[None, :, None],
                              ib[:, None, None], six[None, None]),
                             A.transpose(1, 2) @ g["info"] @ B,
                             accumulate=True)
        H = H.reshape(6 * T, 6 * T)[6:, 6:]
        A = H + lam * torch.diag(torch.diagonal(H))
        blocks = torch.stack([H[6 * k:6 * k + 6, 6 * k:6 * k + 6]
                              for k in range(T - 1)])
        Minv = torch.linalg.inv(blocks + torch.diag_embed(
            lam * torch.diagonal(blocks, dim1=-2, dim2=-1) + 1e-8))
        rhs = -b.reshape(-1)[6:]
        x = torch.zeros(n, dtype=torch.float64)
        res = rhs.clone()
        zz = (Minv @ res.reshape(-1, 6, 1)).reshape(-1)
        p, rz = zz.clone(), float(res @ zz)
        for _ in range(cg_iters):
            Ap = A @ p
            pAp = float(p @ Ap)
            alpha = 0.0 if rz < 1e-8 else rz / (pAp if abs(pAp) >= 1e-20
                                                 else 1e-20)
            x = x + alpha * p
            res = res - alpha * Ap
            zz = (Minv @ res.reshape(-1, 6, 1)).reshape(-1)
            rz_new = float(res @ zz)
            p = zz + rz_new / (rz if abs(rz) >= 1e-20 else 1e-20) * p
            rz = rz_new
        new = poses.clone()
        new[1:] = geo.compose(geo.exp(x.reshape(T - 1, 6)), poses[1:])
        cn = cost(g, new)
        if cn < c:
            poses, c, lam = new, cn, max(lam * 0.5, 1e-9)
        else:
            lam = min(lam * 4.0, 1e6)
    return poses
