"""Port parity, the pose graph and the distributed PGO.

The graphs of tests/test_pose_graph.py (a drifted circle with one loop
edge, and the corrupted loop edges with rank-deficient information) are
carried into the port with `convert`.

Tolerances. One LM iteration with 20 CG steps agrees with the reference
within 1e-4: the same algorithm, sums in another order (the port
scatters in float64, the reference with one-hot float32 matmuls), edge
Jacobians by forward-mode derivatives in both. Longer runs part further,
for two reasons of the algorithm, not of the port: CG stops moving once
its residual r.z falls below 1e-8, and whether that happens at step k or
k + 1 changes with rounding (on the 21-pose circle one LM iteration of 100
CG steps parts by 1.8e-2, of 50 steps by 7e-6); and near the minimum the
LM accept test flips with rounding (tests/test_sharded_pgo.py:21-24).
Measured after the full 22 x 100 iterations: 1.9e-2 on the 40-pose circle,
5.9e-2 on the 21-pose one after 10, each time with chi2 equal or lower in
the port. Held there to 1e-1 on the poses and chi2 within 5%.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.parallel.mesh import make_ba_mesh as jmake_mesh
from stereovision_slam_tpu.parallel.sharded_pgo import (
    build_sharded_pgo as jbuild_sharded_pgo)
from stereovision_slam_tpu.slam import pose_graph as jpg
from stereovision_slam_torch import convert
from stereovision_slam_torch.parallel.mesh import make_ba_mesh
from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
from stereovision_slam_torch.slam import pose_graph as tpg
from tests.test_pose_graph import (
    _corrupted_loop_graph, _with_loop_info, build_graph, centers)

torch.set_num_threads(1)


def chi2(g, poses):
    r, _, _ = jpg._linearize(g._replace(poses=jnp.asarray(poses)))
    return float(jnp.sum(r * r))


def _dense_blind_graph():
    """The loop edge's information: a PnP-style Hessian blind along a mixed
    direction, carried into the residual frame by Adj(meas)
    (tests/test_pose_graph.py, dense rank-deficient case)."""
    delta = np.array([0.0, 0.45, 0.0, 0.2, 0.0, 0.0], np.float32)
    u = delta / np.linalg.norm(delta)
    g_bad, _, gt, _ = _corrupted_loop_graph(
        meas_override=lambda m: jse3.se3_compose(
            jse3.se3_exp(jnp.asarray(delta)), m))
    A = np.asarray(jse3.se3_adjoint(jnp.asarray(
        np.asarray(g_bad.edge_meas)[-1])))
    H = A.T @ (np.eye(6, dtype=np.float32) - np.outer(u, u)) @ A
    H = (H / np.linalg.eigvalsh(H).max()).astype(np.float32)
    return _with_loop_info(g_bad, H), gt


def _axis_blind_graph():
    bad = np.zeros(6, np.float32)
    bad[1] = 0.8
    g_bad, _, gt, _ = _corrupted_loop_graph(bad)
    info = np.eye(6, dtype=np.float32)
    info[1, 1] = 0.0
    return _with_loop_info(g_bad, info), gt


@functools.lru_cache(maxsize=None)
def _graph(name):
    return {"circle": lambda: build_graph(n=40),
            "axis_blind": _axis_blind_graph,
            "dense_blind": _dense_blind_graph}[name]()[0]


@pytest.mark.parametrize("name", ["circle", "axis_blind", "dense_blind"])
def test_optimize_pose_graph_matches_reference(name):
    g = _graph(name)
    tg = convert.pose_graph(g)
    assert (tg.edge_info is None) == (name == "circle")
    one_j = np.asarray(jpg.optimize_pose_graph(g, iters=1, cg_iters=20))
    one_t = tpg.optimize_pose_graph(tg, iters=1, cg_iters=20).numpy()
    np.testing.assert_allclose(one_t, one_j, atol=1e-4)
    out_j = np.asarray(jpg.optimize_pose_graph(g, iters=22))
    out_t = tpg.optimize_pose_graph(tg, iters=22).numpy()
    assert np.all(np.isfinite(out_t))
    np.testing.assert_allclose(out_t, out_j, atol=1e-1)
    cj, ct = chi2(g, out_j), chi2(g, out_t)
    assert ct <= cj * 1.05 + 1e-8 and cj <= ct * 1.05 + 1e-8, (ct, cj)
    # the loop correction moved the poses
    assert np.abs(out_t - np.asarray(g.poses)).max() > 1e-3


def test_edge_linearization_and_whitening_match_reference():
    g = _graph("dense_blind")
    tg = convert.pose_graph(g)
    W = tpg._info_sqrt(tg.edge_info)
    torch.testing.assert_close(W.transpose(-1, -2) @ W,
                               0.5 * (tg.edge_info + tg.edge_info.mT),
                               rtol=0, atol=1e-5)
    rj, Jij, Jjj = jpg._linearize(g)
    rt, Jit, Jjt = tpg._linearize(tpg._edge_ranks(tg))
    # eigenvectors are unique up to sign (and basis within a repeated
    # eigenvalue): the normal-equation terms are not. The blind
    # direction's eigenvalue comes out of eigh as +-1e-8 by rounding, so
    # its whitening weight sqrt(max(s, 0)) is 0 or up to 1e-4: atol 1e-4
    for a, b in ((jnp.sum(rj * rj), rt.square().sum()),
                 (jnp.einsum("eab,ea->eb", Jij, rj),
                  torch.einsum("...ab,...a->...b", Jit, rt)[0]),
                 (jnp.einsum("eab,eac->ebc", Jjj, Jjj),
                  torch.einsum("...ab,...ac->...bc", Jjt, Jjt)[0])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=1e-4)


def test_pgo_closes_the_loop_and_fixes_the_first_pose():
    g, gt, drifted = build_graph()
    tg = convert.pose_graph(g)
    out = tpg.optimize_pose_graph(tg, iters=22).numpy()
    err_before = np.linalg.norm(centers(drifted) - centers(gt), axis=1)
    err_after = np.linalg.norm(centers(out) - centers(gt), axis=1)
    assert err_after.max() < err_before.max() * 0.7
    assert err_after[-1] < 0.05
    np.testing.assert_allclose(out[0], np.asarray(g.poses[0]), atol=1e-6)


def test_reanchor_landmarks_matches_reference():
    rng = np.random.default_rng(0)
    T = 6
    old = jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, (T, 6)), jnp.float32))
    new = jse3.se3_exp(jnp.asarray(rng.normal(0, 0.3, (T, 6)), jnp.float32))
    lm = jnp.asarray(rng.normal(0, 5, (50, 3)), jnp.float32)
    first = jnp.asarray(rng.integers(-1, T + 2, 50), jnp.int32)
    valid = jnp.asarray(rng.uniform(size=T) > 0.3)
    ref = np.asarray(jpg.reanchor_landmarks(lm, first, old, new, valid))
    got = tpg.reanchor_landmarks(*(convert.tensor(x) for x in
                                   (lm, first, old, new, valid)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    keep = ~(np.asarray(first) >= 0)
    np.testing.assert_array_equal(got.numpy()[keep], np.asarray(lm)[keep])


def test_sharded_pgo_odd_edge_count_matches_reference():
    """21 edges over 8 ranks (padded to 24): the port's sharded PGO against
    the reference's sharded PGO and against the port's single PGO."""
    g, gt, drifted = build_graph(n=21)
    assert g.edge_i.shape[0] % 8 != 0
    out_j = np.asarray(jbuild_sharded_pgo(jmake_mesh(8), iters=10)(g))
    tg = convert.pose_graph(g)
    out_s = build_sharded_pgo(make_ba_mesh(8, device="cpu"), iters=10)(tg)
    out_1 = tpg.optimize_pose_graph(tg, iters=10)
    np.testing.assert_allclose(out_s.numpy(), out_j, atol=1e-1)
    np.testing.assert_allclose(out_s.numpy(), out_1.numpy(), atol=5e-2)
    assert chi2(g, out_s.numpy()) <= chi2(g, out_j) * 1.05 + 1e-8


@pytest.mark.parametrize("name", ["circle", "dense_blind"])
def test_sharded_pgo_matches_single(name):
    """Edges over the 8 ranks of a (4, 2) mesh, with and without
    information matrices (the port pads them with identities)."""
    g = _graph(name)
    tg = convert.pose_graph(g)
    out_s = build_sharded_pgo(make_ba_mesh(8, device="cpu"))(tg).numpy()
    out_1 = tpg.optimize_pose_graph(tg).numpy()
    np.testing.assert_allclose(out_s, out_1, atol=5e-2)
    assert chi2(g, out_s) <= chi2(g, out_1) * 1.05 + 1e-8
