"""The rig pose from 3-D points and their pixels, by Levenberg-Marquardt
from one or several starts, as the tracker and the loop check solve it.

Each observation is a world point seen by one camera of the rig. From each
start, `rounds` rounds of `iters` LM steps on the summed squared
reprojection error of the round's inliers; every round but the last
weighs an error c above th = chi2_th * 2^(rounds - 1 - round) by Huber
(cost 2 sqrt(th c) - th, weight sqrt(th / c)). A step solves
(H + lam diag H + 1e-10 I) dx = -b, moves the pose by exp(dx) on the
left, and is kept when the round's cost drops (lam * 0.3, else lam * 5,
lam from 1e-6 each round, kept in [1e-9, 1e5]). Between rounds, and after
the last, the inliers are the observations in front of the camera whose
error is within chi2_th * 2^(rounds - 2 - round) (chi2_th after the last).
Of several starts the one with the least capped cost, sum of
min(c, chi2_th) over the valid observations (chi2_th for each other one),
wins, the first on a tie.
"""

from __future__ import annotations

import torch

from portbench.reference import geometry as geo


def _chi2(cams, T, pts, uv):
    """Squared error per observation (S, M); 1e12 behind the camera."""
    out = []
    for cam, (p, q) in zip(cams, zip(pts, uv)):
        r, _, _, z = geo.reprojection(cam, T[:, None], p, q)
        c = (r * r).sum(-1)
        out.append(torch.where(z > 1e-6, c, torch.full_like(c, 1e12)))
    return torch.cat(out, -1)


def _normal(cams, T, pts, uv, inlier, th):
    """H (S, 6, 6), b (S, 6) and the cost (S,) over the inliers in front,
    Huber above th where th is not None."""
    H = b = cost = 0.0
    at = 0
    for cam, p, q in zip(cams, pts, uv):
        n = p.shape[0]
        r, J, _, z = geo.reprojection(cam, T[:, None], p, q)
        use = inlier[:, at:at + n] & (z > 1e-6)
        at += n
        c = (r * r).sum(-1)
        w = use.to(r.dtype)
        if th is not None:
            w = w * torch.where(c <= th, torch.ones_like(c),
                                torch.sqrt(th / torch.clamp(c, min=1e-20)))
            c = torch.where(c <= th, c, 2.0 * torch.sqrt(th * c) - th)
        H = H + torch.einsum("smai,smaj,sm->sij", J, J, w)
        b = b + torch.einsum("smai,sma,sm->si", J, r, w)
        cost = cost + torch.where(use, c, torch.zeros_like(c)).sum(-1)
    return H, b, cost


def solve(cams, pts, uv, valid, T0, *, chi2_th: float, rounds: int,
          iters: int):
    """cams: one camera per observation group; pts, uv: per group (Mg, 3)
    and (Mg, 2); valid (M,) over the groups in order; T0 (S, 3, 4) the
    starts. Returns (T (3, 4), inlier (M,)) of the winning start."""
    S = T0.shape[0]
    T = T0.clone()
    valid = valid[None].expand(S, -1)
    inlier = valid
    dt = T.dtype
    eye = torch.eye(6, dtype=dt)
    for rnd in range(rounds):
        if rnd > 0:
            lev = float(2 ** max(rounds - 1 - rnd, 0))
            inlier = valid & (_chi2(cams, T, pts, uv) <= chi2_th * lev)
        th = float(torch.tensor(chi2_th * 2.0 ** (rounds - 1 - rnd),
                                dtype=dt)) if rnd < rounds - 1 else None
        H, b, cost = _normal(cams, T, pts, uv, inlier, th)
        lam = torch.full((S,), 1e-6, dtype=dt)
        for _ in range(iters):
            A = H + torch.diag_embed(lam[:, None] * torch.diagonal(
                H, dim1=-2, dim2=-1)) + 1e-10 * eye
            dx = torch.linalg.solve_ex(A, -b)[0]
            Tn = geo.compose(geo.exp(dx), T)
            Hn, bn, cn = _normal(cams, Tn, pts, uv, inlier, th)
            ok = cn < cost
            T = torch.where(ok[:, None, None], Tn, T)
            H = torch.where(ok[:, None, None], Hn, H)
            b = torch.where(ok[:, None], bn, b)
            cost = torch.where(ok, cn, cost)
            lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e5))
    c = _chi2(cams, T, pts, uv)
    inlier = valid & (c <= chi2_th)
    capped = torch.where(valid, torch.clamp(c, max=chi2_th),
                         torch.full_like(c, chi2_th)).sum(-1)
    best = int(torch.argmin(capped))
    return T[best], inlier[best]
