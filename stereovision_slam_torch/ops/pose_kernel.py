"""Kernel B: the whole multi-start stereo LM pose solve (counterpart of
`ops/pose_pallas.py`, whose `_pose_kernel` the CUDA kernel in
`csrc/pose_lm.cu` replaces).

Per start: `rounds x iters` LM steps over the 2F observations (left and
right camera, each with its own intrinsics and rig->camera extrinsic), a
graduated Huber threshold chi2_th * 2^(rounds-1-rnd), the damped 6x6 normal
equations solved by Cholesky, `se3_exp(dx) @ T`, incumbent-cost acceptance
with the 0.3 / 5 damping schedule, and inlier re-levelling between rounds.
The caller keeps the start with the lowest robust cost, first index on ties.

`pose_lm` launches the kernel on a CUDA tensor and runs `pose_lm_plain` on a
CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.ops import _cuda

MAX_POINTS = 1024
launch_count = 0
# pose_lm_launch(camp, pts, uv, valid, T0, T_out, inl_out, cost_out, nin_out,
#                F, S, rounds, iters, chi2_th, stream)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_void_p])


def cam_params(cam) -> torch.Tensor:
    """(16,) [fx, fy, cx, cy, R (9), t (3)] of a camera's extrinsic."""
    return torch.cat([torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]),
                      cam.pose[:3, :3].reshape(9), cam.pose[:3, 3]]
                     ).to(torch.float32)


def pose_lm_plain(camp, pts, uv, valid, T0, *, chi2_th: float, rounds: int,
                  iters: int):
    """Plain PyTorch version of the kernel, all starts at once.

    camp (2, 16); pts (F, 3); uv (F, 4) [ul, vl, ur, vr]; valid (F, 2)
    float; T0 (S, 3, 4). Returns (T (S, 3, 4), inlier (S, 2, F) float,
    cost (S,), n_inliers (S,))."""
    f32 = torch.float32
    col = [camp[:, i][None, :, None] for i in range(16)]     # (1, 2, 1)
    fx, fy, cx, cy = col[:4]
    Re = [[col[4 + 3 * r + c] for c in range(3)] for r in range(3)]
    te = col[13:16]
    px, py, pz = (pts[:, i][None, None, :] for i in range(3))
    u_obs = torch.stack([uv[:, 0], uv[:, 2]])[None]          # (1, 2, F)
    v_obs = torch.stack([uv[:, 1], uv[:, 3]])[None]
    valid = (valid.T > 0.5)[None]                            # (1, 2, F)

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

    T = T0
    S = T.shape[0]
    inlier = valid.expand(S, -1, -1)
    for rnd in range(rounds):
        use_huber = rnd < rounds - 1
        round_th = float(torch.tensor(chi2_th * float(2 ** (rounds - 1 - rnd)),
                                      dtype=f32))
        inl_f = inlier.to(f32)
        lam = torch.full((S,), 1e-6, dtype=f32, device=T.device)

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
    return T, inl, cost, s11(inl)


def pose_lm(camp, pts, uv, valid, T0, *, chi2_th: float, rounds: int,
            iters: int):
    """All S starts of the LM schedule: the CUDA kernel (one block per start)
    on a CUDA tensor, `pose_lm_plain` on a CPU tensor. Same signature and
    outputs as `pose_lm_plain`."""
    kw = dict(chi2_th=chi2_th, rounds=rounds, iters=iters)
    if pts.device.type == "cpu":
        return pose_lm_plain(camp, pts, uv, valid, T0, **kw)
    if pts.device.type != "cuda":
        raise ValueError(f"pose_lm: unsupported device {pts.device}")
    F, S = pts.shape[0], T0.shape[0]
    shapes = {"camp": (2, 16), "pts": (F, 3), "uv": (F, 4), "valid": (F, 2),
              "T0": (S, 3, 4)}
    for name, t in zip(shapes, (camp, pts, uv, valid, T0)):
        if (t.shape != shapes[name] or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != pts.device):
            raise ValueError(f"pose_lm: {name} must be a contiguous float32 "
                             f"{shapes[name]} tensor on {pts.device}")
    if F > MAX_POINTS:
        raise ValueError(f"pose_lm: at most {MAX_POINTS} points, got {F}")
    dev = pts.device
    T_out = torch.empty((S, 3, 4), dtype=torch.float32, device=dev)
    inl_out = torch.empty((S, 2, F), dtype=torch.float32, device=dev)
    cost_out = torch.empty((S,), dtype=torch.float32, device=dev)
    nin_out = torch.empty((S,), dtype=torch.float32, device=dev)
    fn = _cuda.function("pose_lm", "pose_lm_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    code = fn(camp.data_ptr(), pts.data_ptr(), uv.data_ptr(),
              valid.data_ptr(), T0.data_ptr(), T_out.data_ptr(),
              inl_out.data_ptr(), cost_out.data_ptr(), nin_out.data_ptr(),
              F, S, rounds, iters, float(chi2_th), _cuda.stream_handle(pts))
    _cuda.check(code, "pose_lm")
    return T_out, inl_out, cost_out, nin_out


def solve_pose_multi_lr(cam_left, cam_right, T_inits, points, uv_l, uv_r,
                        valid_l, valid_r, *, chi2_th: float = 5.991,
                        rounds: int = 4, iters: int = 10):
    """Fused multi-start stereo pose solve.

    T_inits (S, 3, 4); points (F, 3); uv_l / uv_r (F, 2); valid_l / valid_r
    (F,) bool. Returns (T (3, 4), inlier (2F,) bool [left; right],
    num_inliers () int32 counting the left half)."""
    F = points.shape[0]
    f32 = torch.float32
    camp = torch.stack([cam_params(cam_left), cam_params(cam_right)])
    uv = torch.cat([uv_l, uv_r], dim=1).to(f32).contiguous()
    valid = torch.stack([valid_l, valid_r], dim=1).to(f32).contiguous()
    T_all, inl_all, cost, _ = pose_lm(
        camp.contiguous(), points.to(f32).contiguous(), uv, valid,
        T_inits.to(f32).contiguous(), chi2_th=chi2_th, rounds=rounds,
        iters=iters)
    best = torch.argmin(cost)
    inl = inl_all[best] > 0.5
    inlier = torch.cat([inl[0], inl[1]])
    return T_all[best], inlier, inl[0].sum().to(torch.int32)
