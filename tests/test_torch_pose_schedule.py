"""Kernel B's one-pass LM schedule (ops/pose_kernel.py `pose_lm_plain`).

The plain version forms the normal equations and the robust cost together
at each candidate pose and keeps the incumbent's sums when a step is
rejected. That is exact, not an approximation: a second pass would compute
the same values from the same inputs. `two_pass_plain` below is the
schedule it replaced (two passes per step: the incumbent's normal equations
and cost, then the candidate's cost), kept here as the reference; the two
are held bit for bit on every start of every stream, including a start
whose points all lie behind the cameras and a stream with no valid
observation.
"""

import numpy as np
import pytest
import torch

from stereovision_slam_torch.geometry import jacobians, se3
from stereovision_slam_torch.ops import pose_kernel as pk
from stereovision_slam_torch.scenes import make_stereo_rig

torch.set_num_threads(1)   # parallel workers: see tests/test_torch_serving.py


def two_pass_plain(camp, pts, uv, valid, T0, *, chi2_th: float, rounds: int,
                   iters: int):
    """Kernel B's plain version before the one-pass schedule: two passes
    over the observations per LM step.

    camp (2, 16); pts ([B,] F, 3); uv ([B,] F, 4) [ul, vl, ur, vr]; valid
    ([B,] F, 2) float; T0 ([B,] S, 3, 4). Returns (T ([B,] S, 3, 4), inlier
    ([B,] S, 2, F) float, cost ([B,] S), n_inliers ([B,] S))."""
    single = pts.dim() == 2
    if single:
        pts, uv, valid, T0 = pts[None], uv[None], valid[None], T0[None]
    B, S = T0.shape[:2]
    f32 = torch.float32
    col = [camp[:, i][None, :, None] for i in range(16)]     # (1, 2, 1)
    fx, fy, cx, cy = col[:4]
    Re = [[col[4 + 3 * r + c] for c in range(3)] for r in range(3)]
    te = col[13:16]

    def per_start(x):          # (B, ...) -> (B * S, ...), start-major
        return x.repeat_interleave(S, dim=0)

    px, py, pz = (per_start(pts[:, None, :, i]) for i in range(3))
    u_obs = per_start(torch.stack([uv[..., 0], uv[..., 2]], dim=1))
    v_obs = per_start(torch.stack([uv[..., 1], uv[..., 3]], dim=1))
    valid = per_start(valid.transpose(1, 2) > 0.5)           # (BS, 2, F)

    def project(T):
        t = [[T[:, i, j][:, None, None] for j in range(4)] for i in range(3)]
        qx = t[0][0] * px + t[0][1] * py + t[0][2] * pz + t[0][3]
        qy = t[1][0] * px + t[1][1] * py + t[1][2] * pz + t[1][3]
        qz = t[2][0] * px + t[2][1] * py + t[2][2] * pz + t[2][3]
        X = Re[0][0] * qx + Re[0][1] * qy + Re[0][2] * qz + te[0]
        Y = Re[1][0] * qx + Re[1][1] * qy + Re[1][2] * qz + te[1]
        Z = Re[2][0] * qx + Re[2][1] * qy + Re[2][2] * qz + te[2]
        Zs = torch.where(torch.abs(Z) < 1e-8, torch.full_like(Z, 1e-8), Z)
        iz = 1.0 / Zs
        ru = fx * X * iz + cx - u_obs
        rv = fy * Y * iz + cy - v_obs
        return qx, qy, qz, X, Y, iz, Z, ru, rv

    def chi2_at(T):
        _, _, _, _, _, _, Z, ru, rv = project(T)
        return torch.where(Z > 1e-6, ru * ru + rv * rv,
                           torch.full_like(Z, 1e12))

    def jac_cols(qx, qy, qz, X, Y, iz):
        iz2 = iz * iz
        jrow = [(fx * iz, None, -fx * X * iz2), (None, fy * iz, -fy * Y * iz2)]
        rdq = [[Re[r][i] for r in range(3)] for i in range(3)]
        for cc in ((None, -qz, qy), (qz, None, -qx), (-qy, qx, None)):
            rdq.append([sum(Re[r][k] * cc[k] for k in range(3)
                            if cc[k] is not None) for r in range(3)])
        cols = []
        for a in range(2):
            for i in range(6):
                acc = None
                for k in range(3):
                    if jrow[a][k] is None:
                        continue
                    t = jrow[a][k] * rdq[i][k]
                    acc = t if acc is None else acc + t
                cols.append(acc)
        return cols

    def s11(x):
        return x.sum(dim=(1, 2))

    T = T0.reshape(B * S, 3, 4)
    inlier = valid
    for rnd in range(rounds):
        use_huber = rnd < rounds - 1
        round_th = float(torch.tensor(chi2_th * float(2 ** (rounds - 1 - rnd)),
                                      dtype=f32))
        inl_f = inlier.to(f32)
        lam = torch.full((B * S,), 1e-6, dtype=f32, device=T.device)

        def robust(cq, mask):
            if use_huber:
                cq = torch.where(cq <= round_th, cq,
                                 2.0 * torch.sqrt(round_th * cq) - round_th)
            return s11(torch.where(mask, cq, torch.zeros_like(cq)))

        for _ in range(iters):
            qx, qy, qz, X, Y, iz, Z, ru, rv = project(T)
            w = inl_f * (Z > 1e-6).to(f32)
            c = ru * ru + rv * rv
            if use_huber:
                w = w * torch.where(
                    c <= round_th, torch.ones_like(c),
                    torch.sqrt(round_th / torch.clamp(c, min=1e-20)))
            J = jac_cols(qx, qy, qz, X, Y, iz)
            wJ = [w * cj for cj in J]
            H = torch.stack([torch.stack([
                s11(wJ[i] * J[j] + wJ[6 + i] * J[6 + j]) for j in range(6)],
                dim=-1) for i in range(6)], dim=-2)          # (S, 6, 6)
            b = torch.stack([s11(wJ[i] * ru + wJ[6 + i] * rv)
                             for i in range(6)], dim=-1)     # (S, 6)
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            Hd = H + torch.diag_embed(lam[:, None] * diag + 1e-10)
            L, _ = torch.linalg.cholesky_ex(Hd)
            dx = torch.cholesky_solve(-b[..., None], L)[..., 0]
            T_new = se3.se3_compose(se3.se3_exp(dx), T)
            cost_T = robust(c, inlier & (Z > 1e-6))
            _, _, _, _, _, _, Zn, run, rvn = project(T_new)
            cost_N = robust(run * run + rvn * rvn, inlier & (Zn > 1e-6))
            better = cost_N < cost_T
            T = torch.where(better[:, None, None], T_new, T)
            lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e5))
        next_scale = float(2 ** max(rounds - 2 - rnd, 0))
        inlier = valid & (chi2_at(T) <= chi2_th * next_scale)
    c_fin = chi2_at(T)
    cost = s11(torch.where(valid, torch.clamp(c_fin, max=chi2_th),
                           torch.full_like(c_fin, chi2_th)))
    inl = inlier.to(f32)
    out = (T.reshape(B, -1, 3, 4), inl.reshape(B, -1, 2, inl.shape[-1]),
           cost.reshape(B, -1), s11(inl).reshape(B, -1))
    return tuple(o[0] for o in out) if single else out


def _streams(seed, B, S, F=96):
    """B streams of F points seen by both cameras with pixel noise and a few
    gross outliers, S starts around each stream's pose. Start 1 of every
    stream is turned half a turn about y, so all its points lie behind the
    cameras; with B > 1 stream 1 has no valid observation at all."""
    rng = np.random.default_rng(seed)
    left, right = make_stereo_rig()
    pts, uv_l, uv_r, vl, vr, T0 = [], [], [], [], [], []
    for b in range(B):
        T_gt = se3.se3_exp(torch.tensor(rng.normal(0, [0.3, 0.1, 0.3, 0.02,
                                                       0.03, 0.02]),
                                        dtype=torch.float32))
        p = torch.tensor(np.stack([rng.uniform(-8, 8, F), rng.uniform(-3, 3, F),
                                   rng.uniform(6, 40, F)], 1),
                         dtype=torch.float32)
        noise = rng.normal(0, 0.3, (2, F, 2)).astype(np.float32)
        ul = jacobians.project_points(left, T_gt, p)[0] + torch.tensor(noise[0])
        ur = jacobians.project_points(right, T_gt, p)[0] + torch.tensor(noise[1])
        ul[:5] += 30.0
        v_l = torch.tensor(rng.uniform(size=F) > 0.1)
        v_r = v_l & torch.tensor(rng.uniform(size=F) > 0.1)
        if B > 1 and b == 1:
            v_l[:] = False
            v_r[:] = False
        d = torch.tensor(rng.normal(0, 0.05, (S, 6)), dtype=torch.float32)
        d[1] = torch.tensor([0.0, 0.0, 0.0, 0.0, np.pi, 0.0])
        starts = se3.se3_compose(se3.se3_exp(d), T_gt)
        for lst, x in zip((pts, uv_l, uv_r, vl, vr, T0),
                          (p, ul, ur, v_l, v_r, starts)):
            lst.append(x)
    camp = pk.camera_block(left, right)
    return camp, *(torch.stack(x) for x in (pts, uv_l, uv_r, vl, vr, T0))


@pytest.mark.parametrize("B,S", [(1, 3), (4, 3), (1, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_pass_schedule_equals_two_pass(seed, B, S):
    camp, pts, uv_l, uv_r, vl, vr, T0 = _streams(seed, B, S)
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    got = pk.pose_lm_plain(camp, pts, uv_l, uv_r, vl, vr, T0, **kw)
    T, inl, cost, _ = two_pass_plain(
        camp, pts, torch.cat([uv_l, uv_r], -1),
        torch.stack([vl, vr], -1).float(), T0, **kw)
    assert torch.equal(got.T_all, T)
    assert torch.equal(got.inl_all, inl > 0.5)
    assert torch.equal(got.cost, cost)
    assert bool(torch.isfinite(got.T_all).all())
    # the chosen start: the first of least cost
    best = torch.argmin(cost, dim=-1)
    rows = torch.arange(B)
    assert torch.equal(got.T, T[rows, best])
    assert torch.equal(got.inlier, (inl[rows, best] > 0.5).reshape(B, -1))
    assert torch.equal(got.n_inliers,
                       (inl[rows, best, 0] > 0.5).sum(-1).to(torch.int32))
    # the half-turned start keeps no inlier; the empty stream none at all
    assert not bool(got.inl_all[:, 1].any())
    if B > 1:
        assert not bool(got.inl_all[1].any()) and int(got.n_inliers[1]) == 0


@pytest.mark.parametrize("B,S", [(1, 3), (4, 3)])
def test_plain_trace_and_follow(B, S):
    """The plain version writes its decisions into `trace` (each step's
    acceptance, each round's inliers); following its own trace gives its
    own bits with no decision differing; following a trace with one
    acceptance turned gives another pose, and reports the turned decision
    with its distance from a tie (the two costs of that step)."""
    camp, pts, uv_l, uv_r, vl, vr, T0 = _streams(3, B, S)
    args = (camp, pts, uv_l, uv_r, vl, vr, T0)
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    tr = {}
    got = pk.pose_lm_plain(*args, **kw, trace=tr)
    F = pts.shape[1]
    assert tr["acc"].shape == (B, S, 3, 6) and tr["acc"].dtype == torch.bool
    assert tr["lev"].shape == (B, S, 3, 2, F)
    assert torch.equal(tr["lev"][:, :, 0], torch.stack(
        [vl, vr], 1)[:, None].expand(B, S, 2, F))
    # the first step from a start near the pose lowers the cost
    assert bool(tr["acc"][0, 0, 0, 0])
    again = {}
    same = pk.pose_lm_plain(*args, **kw, trace=again, follow=tr)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    assert again["acc_flips"] == 0 and again["lev_flips"] == 0
    assert again["acc_tie"] == 0.0 and again["lev_tie"] == 0.0
    # reject the first step of start 0 of stream 0 (a clear decrease)
    turned = {k: v.clone() for k, v in tr.items()}
    turned["acc"][0, 0, 0, 0] = False
    rep = {}
    moved = pk.pose_lm_plain(*args, **kw, trace=rep, follow=turned)
    assert rep["acc_flips"] >= 1 and rep["acc_tie"] > 1e-3
    assert torch.equal(rep["acc"], turned["acc"])
    assert not torch.equal(moved.T_all[0, 0], got.T_all[0, 0])
    if B > 1:
        assert torch.equal(moved.T_all[1:], got.T_all[1:])
    # the single-stream form has no leading axis
    one = {}
    pk.pose_lm_plain(*(x[0] if i else x for i, x in enumerate(args)), **kw,
                     trace=one)
    assert one["acc"].shape == (S, 3, 6) and one["lev"].shape == (S, 3, 2, F)
    assert torch.equal(one["acc"], tr["acc"][0])
