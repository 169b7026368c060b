"""Port parity, geometry: se3, camera, jacobians, symeig, triangulation.

Inputs are made with numpy from a seed and given to both packages. Both
compute in float32 with the same formulas; they differ only in the order
of a few sums and in libm's sin/cos/acos, so unit-scale results agree to
1e-5 (a few float32 ulps times the chains' lengths) unless stated.
"""

import numpy as np
import jax.numpy as jnp
import torch

from stereovision_slam_tpu.geometry import camera as jcam
from stereovision_slam_tpu.geometry import jacobians as jjac
from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.geometry import symeig as jsym
from stereovision_slam_tpu.geometry import triangulation as jtri
from stereovision_slam_torch import convert
from stereovision_slam_torch.geometry import camera as tcam
from stereovision_slam_torch.geometry import jacobians as tjac
from stereovision_slam_torch.geometry import se3 as tse3
from stereovision_slam_torch.geometry import symeig as tsym
from stereovision_slam_torch.geometry import triangulation as ttri


def _both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(j, t, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _tangents(seed=0):
    """Moderate, small-angle (below the 1e-8 t^2 branch) and near-pi
    tangents."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.5, (32, 6))
    xi[8:16, 3:] *= 1e-5
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi[16:24, 3:] = axis * (np.pi - 1e-4)
    return xi.astype(np.float32)


def test_se3_exp_log_compose_inverse_apply():
    xj, xt = _both(_tangents())
    Tj, Tt = jse3.se3_exp(xj), tse3.se3_exp(xt)
    _close(Tj, Tt)
    # log: near pi the axis comes from sqrt of (R + I) / 2, where float32
    # rounding of R costs ~sqrt(eps): 1e-3 there, 1e-5 elsewhere
    lj, lt = jse3.se3_log(Tj), tse3.se3_log(Tt)
    far = np.r_[0:16, 24:32]
    _close(lj[far], lt[far])
    _close(lj[16:24], lt[16:24], atol=1e-3)
    _close(jse3.se3_compose(Tj[:16], Tj[16:]),
           tse3.se3_compose(Tt[:16], Tt[16:]))
    _close(jse3.se3_inverse(Tj), tse3.se3_inverse(Tt))
    pj, pt = _both(np.random.default_rng(1).normal(0, 5, (32, 3)))
    _close(jse3.se3_apply(Tj, pj), tse3.se3_apply(Tt, pt), atol=5e-5)
    _close(jse3.se3_distance(Tj[:16], Tj[16:]),
           tse3.se3_distance(Tt[:16], Tt[16:]), atol=1e-4)


def _rig():
    left = jcam.Camera.create(350.0, 350.0, 310.0, 94.0)
    right = jcam.Camera.create(
        350.0, 350.0, 310.0, 94.0, baseline=0.54,
        pose=jse3.se3_from_Rt(jnp.eye(3), jnp.array([-0.54, 0.0, 0.0])))
    return (left, right), (convert.camera(left), convert.camera(right))


def test_camera_maps():
    (jl, jr), (tl, tr) = _rig()
    rng = np.random.default_rng(2)
    pj, pt = _both(np.c_[rng.uniform(-5, 5, (64, 2)), rng.uniform(4, 40, 64)])
    Tj, Tt = _both(np.asarray(jse3.se3_exp(jnp.asarray(
        [0.1, -0.2, 0.3, 0.01, 0.02, -0.03]))))
    for jc, tc in ((jl, tl), (jr, tr)):
        _close(jcam.world2camera(jc, pj, Tj), tcam.world2camera(tc, pt, Tt),
               atol=1e-4)
        _close(jcam.world2pixel(jc, pj, Tj), tcam.world2pixel(tc, pt, Tt),
               atol=1e-3)
        uj, ut = _both(rng.uniform(0, 600, (64, 2)))
        _close(jcam.pixel2camera(jc, uj, 7.5), tcam.pixel2camera(tc, ut, 7.5),
               atol=1e-5)
        _close(jcam.pixel2world(jc, uj, Tj, 7.5),
               tcam.pixel2world(tc, ut, Tt, 7.5), atol=1e-4)
        _close(jcam.camera2world(jc, pj, Tj), tcam.camera2world(tc, pt, Tt),
               atol=1e-4)
    _close(jl.K(), tl.K())


def test_jacobians():
    (jl, jr), (tl, tr) = _rig()
    rng = np.random.default_rng(3)
    pj, pt = _both(np.c_[rng.uniform(-5, 5, (128, 2)), rng.uniform(4, 40, 128)])
    uj, ut = _both(rng.uniform(0, 600, (128, 2)))
    Tj, Tt = _both(np.asarray(jse3.se3_exp(jnp.asarray(
        [0.1, -0.2, 0.3, 0.01, 0.02, -0.03]))))
    for jc, tc in ((jl, tl), (jr, tr)):
        uvj, pcj = jjac.project_points(jc, Tj, pj)
        uvt, pct = tjac.project_points(tc, Tt, pt)
        _close(uvj, uvt, atol=1e-3)     # pixels of order 1e3: ~3 ulps
        _close(pcj, pct, atol=1e-4)
        for a, b in zip(jjac.reprojection_residual_jac(jc, Tj, pj, uj),
                        tjac.reprojection_residual_jac(tc, Tt, pt, ut)):
            _close(a, b, atol=1e-3, rtol=1e-4)
    cj, ct = _both(rng.uniform(0, 60, 256))
    _close(jjac.huber_weight(cj, jnp.float32(5.991 ** 2)),
           tjac.huber_weight(ct, float(np.float32(5.991 ** 2))))


def test_symeig_small_and_triangulate():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 6, 4)).astype(np.float32)
    Bj, Bt = _both(np.einsum("nri,nrj->nij", A, A))
    (lj, Vj), (lt, Vt) = jsym.symeig_small(Bj, sweeps=8), tsym.symeig_small(Bt, 8)
    _close(lj, lt, atol=1e-4, rtol=1e-5)
    # the same rotations pick the same eigenvectors, signs included
    _close(Vj, Vt, atol=1e-4)

    (jl, jr), (tl, tr) = _rig()
    X = np.c_[rng.uniform(-5, 5, (96, 2)), rng.uniform(3, 60, 96)]
    X[:4, 2] = 1e4                       # no parallax: rejected
    pl = X[:, :2] / X[:, 2:]
    pr = np.c_[X[:, 0] - 0.54, X[:, 1]] / X[:, 2:]
    obs = np.stack([pl, pr], 1) + rng.normal(0, 1e-4, (96, 2, 2))
    oj, ot = _both(obs)
    xj, okj = jtri.triangulate(jnp.stack([jl.pose, jr.pose]), oj)
    xt, okt = ttri.triangulate(torch.stack([tl.pose, tr.pose]), ot)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() > 80
    # depth from a 4x4 null vector: relative 1e-4 of the depth
    _close(np.asarray(xj)[ok], xt[torch.from_numpy(ok.copy())], atol=1e-3, rtol=1e-4)


def test_se3_adjoint_and_relative_pose_residual():
    """Adj(T) on moderate, small-angle and near-pi poses; the pose-graph
    residual log(meas^-1 Ti Tj^-1) on near-consistent edges (residuals
    ~1e-2, the PGO regime) and on far ones (1e-4 near pi, as se3_log)."""
    xj, xt = _both(_tangents(5))
    Tj, Tt = jse3.se3_exp(xj), tse3.se3_exp(xt)
    _close(jse3.se3_adjoint(Tj), tse3.se3_adjoint(Tt))
    # the adjoint identity T exp(v) T^-1 = exp(Adj(T) v) holds in the port
    v = torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.1, (32, 6)).astype(np.float32))
    lhs = tse3.se3_compose(tse3.se3_compose(Tt, tse3.se3_exp(v)),
                           tse3.se3_inverse(Tt))
    rhs = tse3.se3_exp(torch.einsum("nab,nb->na", tse3.se3_adjoint(Tt), v))
    torch.testing.assert_close(lhs, rhs, rtol=0, atol=1e-4)

    rng = np.random.default_rng(7)
    dj, dt = _both(rng.normal(0, 0.01, (32, 6)))
    mj = jse3.se3_compose(Tj[:16], jse3.se3_inverse(Tj[16:]))
    mt = tse3.se3_compose(Tt[:16], tse3.se3_inverse(Tt[16:]))
    near_j = jse3.se3_compose(jse3.se3_exp(dj[:16]), mj)
    near_t = tse3.se3_compose(tse3.se3_exp(dt[:16]), mt)
    _close(jjac.relative_pose_residual(Tj[:16], Tj[16:], near_j),
           tjac.relative_pose_residual(Tt[:16], Tt[16:], near_t), atol=2e-5)
    _close(jjac.relative_pose_residual(Tj[:16], Tj[16:], Tj[8:24]),
           tjac.relative_pose_residual(Tt[:16], Tt[16:], Tt[8:24]),
           atol=1e-3)


def _so3_gap(T: torch.Tensor) -> float:
    R = T[..., :3, :3].double()
    return float((R @ R.transpose(-1, -2) - torch.eye(3, dtype=R.dtype))
                 .abs().amax())


def test_se3_orthonormalize_projects_onto_so3():
    """Port only (the reference keeps its poses as solved): the rotation
    goes to its polar factor, the nearest rotation, computed here in
    float64 by SVD; t is kept; a rotation moves by rounding only. Each
    step squares the deviation: the default two take 1e-4 to rounding, a
    deviation of 1e-2 needs a third."""
    T = tse3.se3_exp(torch.from_numpy(_tangents()))
    rng = np.random.default_rng(2)
    for scale, steps in ((1e-2, 3), (1e-4, 2), (1e-7, 2)):
        E = rng.normal(0, scale, (32, 3, 3)).astype(np.float32)
        Tp = T.clone()
        Tp[..., :3, :3] += torch.from_numpy(E)
        out = tse3.se3_orthonormalize(Tp, steps)
        assert _so3_gap(out) < 1e-6
        U, _, Vt = np.linalg.svd(Tp[..., :3, :3].double().numpy())
        np.testing.assert_allclose(out[..., :3, :3].numpy(), U @ Vt,
                                   atol=2e-6)
        assert torch.equal(out[..., :3, 3], Tp[..., :3, 3])
    _close(T, tse3.se3_orthonormalize(T), atol=1e-6, rtol=0)


def test_motion_model_stays_on_so3():
    """The constant-velocity model T_next = (T_cur T_prev^-1) T_cur, with
    the inverse a transpose, multiplies a pose's deviation from SO(3) by
    about 2.4 each step: from float32 rounding it reaches 1e-3 in some
    twenty steps. Projecting each new pose, as the frontend does after
    the pose solve, holds it at rounding."""
    T0 = tse3.se3_exp(torch.tensor([0.1, 0.0, 0.35, 0.0, 0.056, 0.0]))
    T1 = tse3.se3_compose(tse3.se3_exp(torch.tensor(
        [0.0, 0.01, 0.35, 0.001, 0.056, 0.002])), T0)
    gaps = {}
    for project in (False, True):
        prev, cur = T0, T1
        for _ in range(40):
            rel = tse3.se3_compose(cur, tse3.se3_inverse(prev))
            nxt = tse3.se3_compose(rel, cur)
            prev, cur = cur, (tse3.se3_orthonormalize(nxt) if project
                              else nxt)
        gaps[project] = _so3_gap(cur)
    assert gaps[False] > 1e-3
    assert gaps[True] < 1e-6
