"""Port parity, the per-rank route: a mesh of one device per rank in one
process (`make_ba_mesh(devices=...)`), the reference's own layout over
the chips of one host. On the CPU every rank is a "cpu" entry, so the
code that runs each rank's share on its device and joins the ranks
(`Mesh.psum_ranks`, `gather_ranks`, `ring_reduce.ring_psum_ranks`) runs
here as it runs over four cards.

Held against the JAX package on 4 of tests/conftest.py's 8 virtual CPU
devices, inputs made with numpy from a seed:
  * the sharded BA on the window of tests/test_backend_ba.py
    (`build_window(seed=5, ...)`), splits (2, 2) and (4, 1), "xla" and
    "ring", at tests/test_torch_sharded_ba.py's tolerances (poses 1e-4,
    landmarks 1e-3 m after 2 LM iterations and 1e-2 m after 10: sums in
    another order, and at the minimum an accept test flips);
  * the sharded PGO at tests/test_torch_pose_graph.py's sharded
    tolerances (1e-1 on the poses and chi2 within 5% of the reference's,
    5e-2 of the port's single solve);
  * `ring_psum` over the per-rank route against the reference's
    `ring_psum(..., interpret=True)` under `shard_map`, bit for bit (one
    fused ring on both sides, as tests/test_torch_ring_reduce.py runs it);
  * `LoopClosure(pgo_mesh=<per-rank mesh>)` against the unsharded
    shutdown, 5e-2 (the sharded PGO's tolerance against the single one).
And four gloo processes on the CPU, one rank each at (dp 2, mp 2)
(tests/torch_dist_worker.py), against the per-rank run in this process:
kernel D's plain route bit for bit; the BA within 1e-5 on poses and 1e-4
on landmarks (tests/test_torch_sharded_ba.py's ring against sum: both
add the same two-term sums, measured equal); PGO within 5e-2.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from stereovision_slam_tpu.parallel.mesh import make_ba_mesh as jmake_mesh
from stereovision_slam_tpu.parallel.ring_reduce import ring_psum as jring_psum
from stereovision_slam_tpu.parallel.sharded_ba import (
    build_sharded_ba as jbuild_sharded_ba)
from stereovision_slam_tpu.parallel.sharded_pgo import (
    build_sharded_pgo as jbuild_sharded_pgo)
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_torch import convert
from stereovision_slam_torch.parallel import ring_reduce as rr
from stereovision_slam_torch.parallel.mesh import make_ba_mesh
from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
from stereovision_slam_torch.slam import loop_closure as tlc
from stereovision_slam_torch.slam import pose_graph as tpg
from stereovision_slam_torch.slam.pipeline import KeyframeRecord
from tests import synthetic, torch_dist_worker
from tests.test_backend_ba import F, K, L, build_window
from tests.test_loop_closure import FakeVO
from tests.test_pose_graph import build_graph
from tests.test_torch_loop_closure import _drifted_line, _fill
from tests.test_torch_pose_graph import chi2
from tests.test_torch_ring_reduce import _TREE, _ranked

torch.set_num_threads(1)

RANKS = 4


def _cpu_ranks(dp, mp):
    return make_ba_mesh(devices=["cpu"] * RANKS, dp=dp, mp=mp)


@pytest.fixture(scope="module")
def window():
    m, _, _, _, cams = build_window(seed=5, pose_noise=0.03, lm_noise=0.2,
                                    px_noise=0.2)
    return m, cams, convert.map_state(m), tuple(convert.camera(c)
                                                for c in cams)


def test_per_rank_mesh_layout():
    mesh = _cpu_ranks(2, 2)
    assert mesh.per_rank and mesh.device == torch.device("cpu")
    assert mesh.ring_of(3, "dp") == [1, 3] and mesh.ring_of(3, "mp") == [2, 3]
    parts = [torch.full((2,), float(r)) for r in range(RANKS)]
    sums = mesh.psum_ranks(parts, "dp")
    assert [float(s[0]) for s in sums] == [2.0, 4.0, 2.0, 4.0]
    # every rank holds a tensor of its own
    assert len({s.data_ptr() for s in sums}) == RANKS
    got = mesh.gather_ranks(parts, "mp")
    assert got[2].tolist() == [2.0, 2.0, 3.0, 3.0]
    assert not make_ba_mesh(RANKS, dp=2, mp=2, device="cpu").per_rank


@pytest.mark.parametrize("iters,lm_tol", [(2, 1e-3), (10, 1e-2)])
@pytest.mark.parametrize("impl", ["xla", "ring"])
@pytest.mark.parametrize("dp,mp", [(2, 2), (4, 1)])
def test_per_rank_ba_matches_reference(window, dp, mp, impl, iters, lm_tol):
    m, cams, tm, (tl, tr) = window
    kj, lj = jbuild_sharded_ba(
        jmake_mesh(RANKS, dp=dp, mp=mp), K, F, L, iters=iters,
        reduce_impl=impl, max_active_landmarks=128)(m, cams[0], cams[1])
    kt, lt = build_sharded_ba(_cpu_ranks(dp, mp), K, F, L, iters=iters,
                              reduce_impl=impl,
                              max_active_landmarks=128)(tm, tl, tr)
    assert kt.device == torch.device("cpu")
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=lm_tol)


def test_per_rank_pgo_matches_reference():
    """21 edges over 4 ranks (padded to 24)."""
    g = build_graph(n=21)[0]
    out_j = np.asarray(jbuild_sharded_pgo(jmake_mesh(RANKS), iters=10)(g))
    tg = convert.pose_graph(g)
    out_t = build_sharded_pgo(_cpu_ranks(None, None), iters=10)(tg).numpy()
    out_1 = tpg.optimize_pose_graph(tg, iters=10).numpy()
    assert np.all(np.isfinite(out_t))
    np.testing.assert_allclose(out_t, out_j, atol=1e-1)
    np.testing.assert_allclose(out_t, out_1, atol=5e-2)
    assert chi2(g, out_t) <= chi2(g, out_j) * 1.05 + 1e-8


def _jax_ring(tree, axis, dp, mp):
    """The reference's interpreted ring under `shard_map` on the first
    dp * mp virtual devices."""
    mesh = JMesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                 ("dp", "mp"))
    mesh_axes = tuple((n, mesh.shape[n]) for n in mesh.axis_names)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P("dp", "mp"),
                       out_specs=P("dp", "mp"), check_vma=False)
    def f(t):
        local = jax.tree.map(lambda x: x[0, 0], t)
        red = jring_psum(local, axis, mesh_axes, interpret=True)
        return jax.tree.map(lambda x: x[None, None], red)

    return {k: np.asarray(v) for k, v in f(tree).items()}


@pytest.mark.parametrize("axis,dp,mp", [("dp", 4, 1), ("dp", 2, 2),
                                        ("mp", 2, 2)])
def test_ring_psum_ranks_matches_reference_bit_for_bit(axis, dp, mp):
    tree = _ranked(_TREE, dp, mp)
    ref = _jax_ring(tree, axis, dp, mp)
    trees = [{k: torch.from_numpy(v[r // mp, r % mp]) for k, v in tree.items()}
             for r in range(dp * mp)]
    got = rr.ring_psum_ranks(trees, axis, (("dp", dp), ("mp", mp)))
    for r, t in enumerate(got):
        for k in tree:
            assert t[k].shape == tree[k].shape[2:]
            np.testing.assert_array_equal(t[k].numpy(), ref[k][r // mp,
                                                               r % mp])


def test_loop_closure_per_rank_pgo_matches_unsharded(monkeypatch):
    """The shutdown PGO over a per-rank mesh (the port's counterpart of
    the reference's `pgo_mesh` over the chips) against `pgo_mesh=None`."""
    gt, est, true_rel = _drifted_line()
    cfg = convert.slam_config(JConfig())
    left, _ = synthetic.make_stereo_rig()
    built = []
    build = tlc.build_sharded_pgo
    monkeypatch.setattr(tlc, "build_sharded_pgo",
                        lambda mesh, **kw: built.append(mesh) or build(
                            mesh, **kw))
    runs = []
    for mesh in (_cpu_ranks(None, None), None):
        lc = tlc.LoopClosure(cfg, convert.camera(left), embedder="thumbnail",
                             pgo_mesh=mesh)
        vo = FakeVO()
        _fill(vo, lc, est, true_rel, KeyframeRecord, tlc.LoopEdge)
        lc.stop(vo)
        assert lc.pgo_ran
        runs.append(vo)
    assert len(built) == 1 and built[0].per_rank
    sharded, single = runs
    for k, rec in single.archived_keyframes.items():
        np.testing.assert_allclose(sharded.archived_keyframes[k].pose,
                                   rec.pose, atol=5e-2)
    np.testing.assert_allclose(sharded.archived_landmarks[7],
                               single.archived_landmarks[7], atol=5e-2)
    n = len(est)
    before = np.linalg.norm(est[-1][:, 3] - gt[-1][:, 3])
    after = np.linalg.norm(sharded.archived_keyframes[n - 1].pose[:, 3]
                           - gt[-1][:, 3])
    assert after < 0.5 * before


@pytest.fixture(scope="module")
def graph():
    return build_graph(n=40)[0]


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(3)
    return rng.standard_normal((RANKS, 64, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def four_processes(window, graph, payload, tmp_path_factory):
    """Each of the four workers' results (one rank a process)."""
    _, _, tm, (tl, tr) = window
    tmp = tmp_path_factory.mktemp("dist4")
    arrays = {"payload": payload}
    for prefix, tup in (("m_", tm), ("cl_", tl), ("cr_", tr),
                        ("g_", convert.pose_graph(graph))):
        arrays.update({prefix + f: v.numpy() for f, v in
                       zip(tup._fields, tup) if v is not None})
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    return torch_dist_worker.spawn(inputs, str(tmp), nproc=RANKS)


@pytest.mark.parametrize("impl", ["xla", "ring"])
def test_four_processes_ba_matches_per_rank_run(window, four_processes,
                                                impl):
    _, _, tm, (tl, tr) = window
    kf, lm = build_sharded_ba(_cpu_ranks(2, 2), K, F, L,
                              iters=torch_dist_worker.ITERS,
                              reduce_impl=impl)(tm, tl, tr)
    for res in four_processes:
        np.testing.assert_allclose(res[f"kf_{impl}"], kf.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(res[f"lm_{impl}"], lm.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("axis", ["dp", "mp"])
def test_four_processes_ring_is_bit_equal(four_processes, payload, axis):
    ma = (("dp", 2), ("mp", 2))
    want = rr.ring_all_reduce_ranks(list(torch.from_numpy(payload)), axis, ma)
    for r, res in enumerate(four_processes):
        np.testing.assert_array_equal(res[f"ring_{axis}"][0],
                                      want[r].numpy())


def test_four_processes_pgo_matches_per_rank_run(graph, four_processes):
    want = build_sharded_pgo(_cpu_ranks(2, 2))(
        convert.pose_graph(graph)).numpy()
    for res in four_processes:
        np.testing.assert_allclose(res["pgo"], want, atol=5e-2)
        np.testing.assert_array_equal(res["pgo"], four_processes[0]["pgo"])
