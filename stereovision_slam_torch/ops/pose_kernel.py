"""Kernel B: the whole multi-start stereo LM pose solve and the choice of
the best start (counterpart of `ops/pose_pallas.py`, whose `_pose_kernel`
and `solve_pose_multi_lr` the CUDA kernel in `csrc/pose_lm.cu` replaces).

Per start: `rounds x iters` LM steps over the 2F observations (left and
right camera, each with its own intrinsics and rig->camera extrinsic), a
graduated Huber threshold chi2_th * 2^(rounds-1-rnd), the damped 6x6 normal
equations solved by Cholesky, `se3_exp(dx) @ T`, incumbent-cost acceptance
with the 0.3 / 5 damping schedule, and inlier re-levelling between rounds.
Then the start with the lowest robust cost, first index on ties.

One pass over the observations per LM step: the normal equations and the
robust cost are formed together at the candidate pose. Accepted, they are
the next step's incumbent sums; rejected, the incumbent's saved sums serve
again, which are the values a second pass would compute from the same
inputs. The plain version runs that schedule too (a test holds it bit for
bit to the two-pass schedule).

Both can write their decisions into a `trace` dict: "acc" ([B,] S, rounds,
iters) bool, each step's acceptance, and "lev" ([B,] S, rounds, 2, F) bool,
each round's inlier set after its re-levelling. The plain version can also
`follow` such a trace, taking those decisions where its own would differ,
and then reports how close each of its own differing decisions was to a
tie. An accepted step compares two float32 sums of some hundred terms,
and re-levelling compares each chi2 with its threshold: where the two
sides are a few ulps apart, the kernel and the plain version may decide
differently, and a decision taken differently moves every later step.

`pose_lm` launches the kernel on a CUDA tensor and runs `pose_lm_plain` on a
CPU tensor. Both take an optional leading stream axis B (multi-stream
serving, where the reference vmaps the solve): one launch covers every
(stream, start), with the cameras shared.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.ops import _cuda
from stereovision_slam_torch.utils import profiling

MAX_STARTS = 8     # csrc/pose_lm.cu kMaxStarts; any number of points
launch_count = 0
# pose_lm_launch(camp, pts, uv_l, uv_r, valid_l, valid_r, T0, T_all, inl_all,
#                cost_all, T_best, inl_best, n_best, tr_acc, tr_lev, B, F, S,
#                rounds, iters, chi2_th, stream)
_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])


class PoseSolve(NamedTuple):
    T_all: torch.Tensor      # ([B,] S, 3, 4) each start's pose
    inl_all: torch.Tensor    # ([B,] S, 2, F) bool, each start's inliers
    cost: torch.Tensor       # ([B,] S) each start's final robust cost
    T: torch.Tensor          # ([B,] 3, 4) the chosen start's pose
    inlier: torch.Tensor     # ([B,] 2F) bool, its [left; right] inliers
    n_inliers: torch.Tensor  # ([B,]) int32, its left inliers


def _cam_params(cam) -> torch.Tensor:
    """(16,) [fx, fy, cx, cy, R (9), t (3)] of a camera's extrinsic."""
    return torch.cat([torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]),
                      cam.pose[:3, :3].reshape(9), cam.pose[:3, 3]]
                     ).to(torch.float32)


def camera_block(cam_left, cam_right) -> torch.Tensor:
    """The rig's (2, 16) contiguous float32 camera parameters, kernel B's
    `camp` input: built once per rig, not per frame."""
    return torch.stack([_cam_params(cam_left),
                        _cam_params(cam_right)]).contiguous()


def pose_lm_plain(camp, pts, uv_l, uv_r, valid_l, valid_r, T0, *,
                  chi2_th: float, rounds: int, iters: int,
                  trace: dict | None = None,
                  follow: dict | None = None) -> PoseSolve:
    """Plain PyTorch version of the kernel, all streams and starts at once.

    camp (2, 16); pts ([B,] F, 3); uv_l, uv_r ([B,] F, 2); valid_l, valid_r
    ([B,] F) bool; T0 ([B,] S, 3, 4). Returns a `PoseSolve`. With `trace`,
    writes the decisions taken into it ("acc", "lev", as the kernel does);
    with `follow` (such a trace), takes its decisions, and `trace` also
    gets, over the decisions where its own differ, their number
    ("acc_flips", "lev_flips") and their largest distance from a tie
    ("acc_tie": |cost_N - cost_T| / max(|cost_T|, 1); "lev_tie": |chi2 /
    threshold - 1|), 0 where none differ."""
    single = pts.dim() == 2
    if single:
        pts, uv_l, uv_r, valid_l, valid_r, T0 = (
            x[None] for x in (pts, uv_l, uv_r, valid_l, valid_r, T0))
    B, S = T0.shape[:2]
    f32 = torch.float32
    col = [camp[:, i][None, :, None] for i in range(16)]     # (1, 2, 1)
    fx, fy, cx, cy = col[:4]
    Re = [[col[4 + 3 * r + c] for c in range(3)] for r in range(3)]
    te = col[13:16]

    def per_start(x):          # (B, ...) -> (B * S, ...), start-major
        return x.repeat_interleave(S, dim=0)

    px, py, pz = (per_start(pts[:, None, :, i]) for i in range(3))
    u_obs = per_start(torch.stack([uv_l[..., 0], uv_r[..., 0]], dim=1))
    v_obs = per_start(torch.stack([uv_l[..., 1], uv_r[..., 1]], dim=1))
    valid = per_start(torch.stack([valid_l, valid_r], dim=1))  # (BS, 2, F)

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

    def normal_eq(T, inlier, robust_th):
        """H (BS, 6, 6), b (BS, 6) and the robust cost (BS,) over the
        inliers in front of the camera at T."""
        qx, qy, qz, X, Y, iz, Z, ru, rv = project(T)
        front = Z > 1e-6
        w = inlier.to(f32) * front.to(f32)
        c = ru * ru + rv * rv
        if robust_th is not None:
            w = w * torch.where(
                c <= robust_th, torch.ones_like(c),
                torch.sqrt(robust_th / torch.clamp(c, min=1e-20)))
            c = torch.where(c <= robust_th, c,
                            2.0 * torch.sqrt(robust_th * c) - robust_th)
        J = jac_cols(qx, qy, qz, X, Y, iz)
        wJ = [w * cj for cj in J]
        H = torch.stack([torch.stack([
            s11(wJ[i] * J[j] + wJ[6 + i] * J[6 + j]) for j in range(6)],
            dim=-1) for i in range(6)], dim=-2)
        b = torch.stack([s11(wJ[i] * ru + wJ[6 + i] * rv)
                         for i in range(6)], dim=-1)
        cost = s11(torch.where(inlier & front, c, torch.zeros_like(c)))
        return H, b, cost

    T = T0.reshape(B * S, 3, 4)
    inlier = valid
    if trace is not None:
        acc_t = torch.zeros((B * S, rounds, iters), dtype=torch.bool,
                            device=T.device)
        lev_t = torch.zeros((B * S, rounds) + valid.shape[1:],
                            dtype=torch.bool, device=T.device)
        lev_t[:, 0] = valid
    ties = {"acc_flips": 0, "acc_tie": 0.0, "lev_flips": 0, "lev_tie": 0.0}

    def take(kind, own, rnd, it, gap):
        """The followed decision where there is one, and the tie count
        (`gap()`: each decision's distance from a tie)."""
        if follow is None:
            return own
        want = follow[kind].to(own.device).reshape(
            (B * S, rounds) + own.shape[1:] + ((iters,) if kind == "acc"
                                               else ()))
        want = want[:, rnd, ..., it] if kind == "acc" else want[:, rnd]
        differ = want != own
        if bool(differ.any()):
            ties[f"{kind}_flips"] += int(differ.sum())
            ties[f"{kind}_tie"] = max(ties[f"{kind}_tie"],
                                      float(gap()[differ].max()))
        return want

    for rnd in range(rounds):
        if rnd > 0:       # re-level on the previous round's threshold
            lev = float(2 ** max(rounds - 1 - rnd, 0))
            c_lev = chi2_at(T)
            inlier = take("lev", valid & (c_lev <= chi2_th * lev), rnd, None,
                          lambda: (c_lev / (chi2_th * lev) - 1.0).abs())
            if trace is not None:
                lev_t[:, rnd] = inlier
        round_th = float(torch.tensor(chi2_th * float(2 ** (rounds - 1 - rnd)),
                                      dtype=f32))
        robust_th = round_th if rnd < rounds - 1 else None
        H, b, cost_T = normal_eq(T, inlier, robust_th)
        lam = torch.full((B * S,), 1e-6, dtype=f32, device=T.device)
        for it in range(iters):
            diag = torch.diagonal(H, dim1=-2, dim2=-1)
            Hd = H + torch.diag_embed(lam[:, None] * diag + 1e-10)
            L, _ = torch.linalg.cholesky_ex(Hd)
            dx = torch.cholesky_solve(-b[..., None], L)[..., 0]
            T_new = se3.se3_compose(se3.se3_exp(dx), T)
            H_new, b_new, cost_N = normal_eq(T_new, inlier, robust_th)
            better = take("acc", cost_N < cost_T, rnd, it,
                          lambda: ((cost_N - cost_T).abs()
                                   / cost_T.abs().clamp(min=1.0)))
            if trace is not None:
                acc_t[:, rnd, it] = better
            T = torch.where(better[:, None, None], T_new, T)
            H = torch.where(better[:, None, None], H_new, H)
            b = torch.where(better[:, None], b_new, b)
            cost_T = torch.where(better, cost_N, cost_T)
            lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9),
                              torch.clamp(lam * 5.0, max=1e5))
    inlier = valid & (chi2_at(T) <= chi2_th)
    c_fin = chi2_at(T)
    cost = s11(torch.where(valid, torch.clamp(c_fin, max=chi2_th),
                           torch.full_like(c_fin, chi2_th)))
    T_all = T.reshape(B, S, 3, 4)
    inl_all = inlier.reshape(B, S, 2, -1)
    cost = cost.reshape(B, S)
    best = torch.argmin(cost, dim=-1)                         # (B,)
    rows = torch.arange(B, device=T.device)
    inl = inl_all[rows, best]                                 # (B, 2, F)
    out = PoseSolve(T_all, inl_all, cost, T_all[rows, best],
                    inl.reshape(B, -1),
                    inl[:, 0].sum(dim=-1).to(torch.int32))
    if trace is not None:
        lead = () if single else (B,)
        trace["acc"] = acc_t.reshape(lead + (S, rounds, iters))
        trace["lev"] = lev_t.reshape(lead + (S,) + lev_t.shape[1:])
        if follow is not None:
            trace.update(ties)
    return PoseSolve(*(o[0] for o in out)) if single else out


def pose_lm(camp, pts, uv_l, uv_r, valid_l, valid_r, T0, *, chi2_th: float,
            rounds: int, iters: int, trace: dict | None = None) -> PoseSolve:
    """All S starts of the LM schedule and the best of them, for one stream
    or a leading axis of B streams: the CUDA kernel (one block per stream)
    on a CUDA tensor, `pose_lm_plain` on a CPU tensor. Same signature and
    outputs as `pose_lm_plain`. The kernel takes S <= MAX_STARTS starts,
    any number F of points (staged in shared memory up to 1024) and
    rounds >= 1. With `trace`, the kernel also writes its decisions there,
    as `pose_lm_plain` does."""
    kw = dict(chi2_th=chi2_th, rounds=rounds, iters=iters)
    args = (camp, pts, uv_l, uv_r, valid_l, valid_r, T0)
    if pts.device.type == "cpu":
        return pose_lm_plain(*args, **kw, trace=trace)
    if pts.device.type != "cuda":
        raise ValueError(f"pose_lm: unsupported device {pts.device}")
    with profiling.span("kernel.B"):
        return _pose_lm_cuda(args, trace, **kw)


def _pose_lm_cuda(args, trace, *, chi2_th, rounds, iters) -> PoseSolve:
    """`pose_lm` on CUDA tensors: checks, outputs, one launch, and the
    recorder's counters of the launch (`profiling.kernel_launch`: its valid
    observations, which every start's passes read, are the
    data-dependent work)."""
    camp, pts, uv_l, uv_r, valid_l, valid_r, T0 = args
    lead = pts.shape[:-2]
    F, S = pts.shape[-2], T0.shape[-3]
    B = int(lead.numel())
    f32, b8 = torch.float32, torch.bool
    want = {"camp": ((2, 16), f32), "pts": ((*lead, F, 3), f32),
            "uv_l": ((*lead, F, 2), f32), "uv_r": ((*lead, F, 2), f32),
            "valid_l": ((*lead, F), b8), "valid_r": ((*lead, F), b8),
            "T0": ((*lead, S, 3, 4), f32)}
    for (name, (shape, dtype)), t in zip(want.items(), args):
        if (t.shape != shape or t.dtype != dtype or not t.is_contiguous()
                or t.device != pts.device or t.data_ptr() % 8):
            raise ValueError(f"pose_lm: {name} must be a contiguous, 8-byte "
                             f"aligned {dtype} {shape} tensor on {pts.device}")
    if len(lead) > 1:
        raise ValueError("pose_lm: at most one stream axis")
    if not 1 <= S <= MAX_STARTS:
        raise ValueError(f"pose_lm: the kernel takes 1 to {MAX_STARTS} "
                         f"starts (MAX_STARTS), got {S}")
    if rounds < 1:
        raise ValueError(f"pose_lm: at least one round, got {rounds}")
    dev = pts.device
    out = PoseSolve(
        T_all=torch.empty((*lead, S, 3, 4), dtype=f32, device=dev),
        inl_all=torch.empty((*lead, S, 2, F), dtype=b8, device=dev),
        cost=torch.empty((*lead, S), dtype=f32, device=dev),
        T=torch.empty((*lead, 3, 4), dtype=f32, device=dev),
        inlier=torch.empty((*lead, 2 * F), dtype=b8, device=dev),
        n_inliers=torch.empty(lead, dtype=torch.int32, device=dev))
    tr = (None, None)
    if trace is not None:
        trace["acc"] = torch.zeros((*lead, S, rounds, iters), dtype=b8,
                                   device=dev)
        trace["lev"] = torch.zeros((*lead, S, rounds, 2, F), dtype=b8,
                                   device=dev)
        tr = (trace["acc"].data_ptr(), trace["lev"].data_ptr())
    fn = _cuda.function("pose_lm", "pose_lm_launch", _ARGTYPES)
    global launch_count
    launch_count += 1
    _cuda.launch(fn, "pose_lm", pts, *(t.data_ptr() for t in args),
                 *(t.data_ptr() for t in out), *tr, B, F, S, rounds, iters,
                 float(chi2_th))
    if profiling.enabled():
        profiling.kernel_launch(
            "B", f"S{S}.r{rounds}.i{iters}", list(args) + list(out),
            observations=valid_l.sum() + valid_r.sum())
    return out


def solve_pose_multi_lr(camp, T_inits, points, uv_l, uv_r, valid_l, valid_r,
                        *, chi2_th: float = 5.991, rounds: int = 4,
                        iters: int = 10):
    """Fused multi-start stereo pose solve, for one stream or a leading axis
    of B streams (one launch either way).

    camp: the rig's `camera_block`. T_inits ([B,] S, 3, 4); points ([B,] F,
    3); uv_l / uv_r ([B,] F, 2); valid_l / valid_r ([B,] F) bool; float32
    and contiguous on the card. Returns (T ([B,] 3, 4), inlier ([B,] 2F)
    bool [left; right], num_inliers ([B,]) int32 counting the left
    half)."""
    out = pose_lm(camp, points, uv_l, uv_r, valid_l, valid_r, T_inits,
                  chi2_th=chi2_th, rounds=rounds, iters=iters)
    return out.T, out.inlier, out.n_inliers
