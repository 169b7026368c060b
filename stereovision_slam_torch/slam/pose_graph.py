"""Global SE(3) pose-graph optimization (counterpart of
`slam/pose_graph.py`).

Keyframe poses are the vertices (the first valid slot held fixed), SE(3)
relative-pose edges carry an optional information matrix, and
Levenberg-Marquardt solves each step matrix-free: a block-Jacobi
preconditioned conjugate gradient whose Hessian-vector product is an
edge-wise gather and scatter. Edge Jacobians are forward-mode derivatives
(`torch.func.jacfwd` under `vmap`) of the exact residual, as the
reference's `jax.jacfwd`.

The reference scatters with one-hot matmuls, a layout for the TPU's matrix
unit; here they are `index_add_` accumulated in float64 and rounded once,
so a sum does not change between runs with the order of the card's
atomics. The edges carry a leading rank axis (n, E / n): each rank
scatters its own edges into a partial (n, T, ...), and `reduce_fn` turns
the partials into the total. One rank with `_no_reduce` is the
single-device solver; `parallel/sharded_pgo.py` splits the edges over the
mesh's ranks and sums the partials, as the reference's `psum`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovision_slam_torch.geometry import jacobians, se3


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # (T, 3, 4) initial T_c_w per keyframe slot
    pose_valid: torch.Tensor  # (T,) bool
    edge_i: torch.Tensor      # (E,) first vertex
    edge_j: torch.Tensor      # (E,) second vertex
    edge_meas: torch.Tensor   # (E, 3, 4) measured T_i * T_j^-1
    edge_valid: torch.Tensor  # (E,) bool
    edge_info: torch.Tensor | None = None  # (E, 6, 6); None = identity.
    #   Loop edges carry the PnP solve's normalized Hessian, in the residual
    #   tangent frame (`se3_adjoint` transports it there), so directions the
    #   PnP pose cannot see get ~0 weight.


def _edge_residual(Ti, Tj, meas):
    return jacobians.relative_pose_residual(Ti, Tj, meas)


def _edge_jacobians(Ti, Tj, meas):
    """(J_i, J_j) (..., 6, 6): forward-mode derivatives of the residual
    with respect to left-multiplicative perturbations of each endpoint,
    taken at 0 edge by edge.

    They are taken in float64 and rounded to the poses' type: PyTorch's
    forward mode gives a float32 tensor divided by a Python float a float64
    tangent, which the next einsum refuses; in float64 the types agree."""
    def ri(xi, Ti, Tj, meas):
        return _edge_residual(se3.se3_compose(se3.se3_exp(xi), Ti), Tj, meas)

    def rj(xj, Ti, Tj, meas):
        return _edge_residual(Ti, se3.se3_compose(se3.se3_exp(xj), Tj), meas)

    lead = Ti.shape[:-2]
    args = [t.reshape((-1,) + t.shape[-2:]).to(torch.float64)
            for t in (Ti, Tj, meas)]
    z = torch.zeros((args[0].shape[0], 6), dtype=torch.float64,
                    device=Ti.device)
    Ji = torch.func.vmap(torch.func.jacfwd(ri))(z, *args)
    Jj = torch.func.vmap(torch.func.jacfwd(rj))(z, *args)
    return (Ji.to(Ti.dtype).reshape(lead + (6, 6)),
            Jj.to(Ti.dtype).reshape(lead + (6, 6)))


def _info_sqrt(edge_info: torch.Tensor) -> torch.Tensor:
    """Per-edge whitening W (..., 6, 6) with W^T W = info, by eigh and not
    Cholesky: loop edges carry exactly rank-deficient information, and a
    float32 Cholesky of it (plus jitter) gives NaN pivots, which poisoned
    chi2 in the reference until it moved to eigh. Negative rounding noise
    in the spectrum is clamped to 0."""
    info = 0.5 * (edge_info + edge_info.transpose(-1, -2))
    S, U = torch.linalg.eigh(info)
    return torch.sqrt(torch.clamp(S, min=0.0))[..., :, None] \
        * U.transpose(-1, -2)


def _linearize(g: PoseGraph, info_sqrt: torch.Tensor | None = None,
               jacobians_too: bool = True):
    """Whitened residuals and Jacobians of every edge, zero on invalid
    edges: (r (..., 6), J_i, J_j (..., 6, 6)); the Jacobians are None
    without `jacobians_too` (the reference's compiler drops them where only
    the residuals are read; eager PyTorch must be told)."""
    Ti, Tj = g.poses[g.edge_i], g.poses[g.edge_j]
    r = _edge_residual(Ti, Tj, g.edge_meas)
    Ji = Jj = None
    if jacobians_too:
        Ji, Jj = _edge_jacobians(Ti, Tj, g.edge_meas)
    if info_sqrt is None and g.edge_info is not None:
        info_sqrt = _info_sqrt(g.edge_info)
    on = g.edge_valid
    if info_sqrt is not None:
        r = torch.einsum("...ab,...b->...a", info_sqrt, r)
    r = torch.where(on[..., None], r, 0.0)
    if not jacobians_too:
        return r, None, None
    if info_sqrt is not None:
        Ji = torch.matmul(info_sqrt, Ji)
        Jj = torch.matmul(info_sqrt, Jj)
    return (r, torch.where(on[..., None, None], Ji, 0.0),
            torch.where(on[..., None, None], Jj, 0.0))


def _no_reduce(partials: torch.Tensor) -> torch.Tensor:
    """The total of one rank's partial (single-device PGO)."""
    return partials[0]


def _edge_ranks(g: PoseGraph, n: int = 1) -> PoseGraph:
    """The graph with its edges split over n ranks: (n, E / n, ...)."""
    return g._replace(**{
        f: getattr(g, f).reshape((n, -1) + getattr(g, f).shape[1:])
        for f in g._fields[2:] if getattr(g, f) is not None})


def _scatter(T: int, ei, ej, vi, vj) -> torch.Tensor:
    """Per-rank vertex sums (n, T, ...) of edge values vi at ei and vj at ej
    (n, Er, ...), accumulated in float64 and rounded once."""
    n = ei.shape[0]
    off = (torch.arange(n, device=ei.device) * T)[:, None]
    idx = torch.cat([(ei + off).reshape(-1), (ej + off).reshape(-1)])
    vals = torch.cat([vi.reshape((-1,) + vi.shape[2:]),
                      vj.reshape((-1,) + vj.shape[2:])])
    acc = torch.zeros((n * T,) + vals.shape[1:], dtype=torch.float64,
                      device=vals.device)
    acc.index_add_(0, idx, vals.to(torch.float64))
    return acc.to(vi.dtype).reshape((n, T) + vals.shape[1:])


def _hvp(g: PoseGraph, Ji, Jj, lam, diag_blocks, free, x,
         reduce_fn=_no_reduce):
    """(H + lam diag) @ x, edge-wise and matrix-free; x (T, 6)."""
    y = torch.einsum("...ab,...b->...a", Ji, x[g.edge_i]) \
        + torch.einsum("...ab,...b->...a", Jj, x[g.edge_j])
    ci = torch.einsum("...ab,...a->...b", Ji, y)
    cj = torch.einsum("...ab,...a->...b", Jj, y)
    out = reduce_fn(_scatter(x.shape[0], g.edge_i, g.edge_j, ci, cj))
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    out = out + lam * torch.einsum("tab,tb->ta", diag_blocks * eye, x)
    return torch.where(free[:, None], out, x)   # fixed rows: identity


def _diag_blocks(g: PoseGraph, Ji, Jj, T: int, reduce_fn=_no_reduce):
    Hi = torch.einsum("...ab,...ac->...bc", Ji, Ji)
    Hj = torch.einsum("...ab,...ac->...bc", Jj, Jj)
    return reduce_fn(_scatter(T, g.edge_i, g.edge_j, Hi, Hj))


def _pcg(g, Ji, Jj, b, lam, diag_blocks, free, iters: int = 100,
         tol: float = 1e-8, reduce_fn=_no_reduce):
    """Block-Jacobi preconditioned CG for (H + lam diag) dx = b; runs all
    `iters` steps (a converged step has alpha = 0), so nothing is read
    back to the host."""
    eye = torch.eye(6, dtype=b.dtype, device=b.device)
    Minv = torch.linalg.inv_ex(
        diag_blocks + (lam * torch.diagonal(diag_blocks, dim1=-2, dim2=-1)
                       [..., None] + 1e-8) * eye)[0]
    Minv = torch.where(free[:, None, None], Minv, eye)

    def apply_M(v):
        return torch.einsum("tab,tb->ta", Minv, v)

    b = torch.where(free[:, None], b, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    tiny = torch.tensor(1e-20, dtype=b.dtype, device=b.device)
    for _ in range(iters):
        Ap = _hvp(g, Ji, Jj, lam, diag_blocks, free, p, reduce_fn)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20, tiny, pAp)
        alpha = torch.where(rz < tol, torch.zeros_like(alpha), alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, tiny, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _optimize(g: PoseGraph, iters: int, cg_iters: int,
              reduce_fn=_no_reduce) -> torch.Tensor:
    """The LM loop shared by the single-device and the sharded PGO. The
    edge fields of `g` have a leading rank axis; every edge sum below is a
    per-rank partial that `reduce_fn` completes, and the vertex state
    (poses, CG vectors) is kept once."""
    T = g.poses.shape[0]
    dt, dev = g.poses.dtype, g.poses.device
    first = torch.argmax(g.pose_valid.to(torch.int32))
    free = g.pose_valid & (torch.arange(T, device=dev) != first)
    # the whitening does not depend on the poses: factor the infos once
    W = _info_sqrt(g.edge_info) if g.edge_info is not None else None

    def total_chi2(poses):
        r, _, _ = _linearize(g._replace(poses=poses), W,
                             jacobians_too=False)
        return reduce_fn(torch.sum(r * r, dim=tuple(range(1, r.dim()))))

    poses = g.poses
    lam = torch.tensor(1e-6, dtype=dt, device=dev)
    for _ in range(iters):
        gg = g._replace(poses=poses)
        r, Ji, Jj = _linearize(gg, W)
        b = -reduce_fn(_scatter(
            T, g.edge_i, g.edge_j, torch.einsum("...ab,...a->...b", Ji, r),
            torch.einsum("...ab,...a->...b", Jj, r)))
        D = _diag_blocks(gg, Ji, Jj, T, reduce_fn)
        dx = _pcg(gg, Ji, Jj, b, lam, D, free, iters=cg_iters,
                  reduce_fn=reduce_fn)
        poses_new = se3.se3_compose(se3.se3_exp(dx), poses)
        better = total_chi2(poses_new) < total_chi2(poses)
        poses = torch.where(better, poses_new, poses)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
    return poses


def optimize_pose_graph(g: PoseGraph, iters: int = 22,
                        cg_iters: int = 100) -> torch.Tensor:
    """LM on the pose graph, on the graph's device; returns the refined
    (T, 3, 4) poses. The valid slot with the smallest index is held fixed
    (the reference fixes keyframe 0)."""
    return _optimize(_edge_ranks(g), iters, cg_iters)


def reanchor_landmarks(lm_pos, lm_first_kf, old_poses, new_poses,
                       pose_valid) -> torch.Tensor:
    """Move each landmark with its first observing keyframe:
    p_new = T_new^-1 (T_old p_old). lm_first_kf (L,) indexes the pose
    slots; -1 or an invalid slot leaves the landmark where it is."""
    safe = torch.clamp(lm_first_kf, 0, old_poses.shape[0] - 1).to(torch.int64)
    ok = (lm_first_kf >= 0) & pose_valid[safe]
    p_w = se3.se3_apply(se3.se3_inverse(new_poses[safe]),
                        se3.se3_apply(old_poses[safe], lm_pos))
    return torch.where(ok[:, None], p_w, lm_pos)
