"""Port parity, the distributed backend across processes.

Two OS processes (tests/torch_dist_worker.py) join a gloo group on
127.0.0.1 and run the sharded BA on the window of tests/test_backend_ba.py
(`build_window(seed=5, pose_noise=0.03, lm_noise=0.2, px_noise=0.2)`),
carried into the port and handed over as an .npz, with 4 CPU ranks a
process (mesh dp 4 x mp 2: the dp reduction crosses the processes) and
with one (dp 1 x mp 2: the mp Schur sum and the landmark gather cross
them); kernel D's plain route across the processes; and the sharded PGO.

Tolerances, each with its reason:
  * against the reference's `optimize_window(iters=8, outlier_rounds=0)`:
    tests/test_distributed_ba.py's 5e-3 on poses and 5e-2 on landmarks;
  * the "ring" and "xla" runs of the (4, 2) mesh against the port's
    one-process runs: 1e-5 on poses and 1e-4 on landmarks
    (tests/test_torch_sharded_ba.py's ring against sum): the reduction is
    bit for bit the one-process one, the chi2 sums add two process partials
    in another order (measured: equal bits);
  * the (1, 2) mesh against its one-process run: 1e-4 on poses and 1e-2 on
    landmarks, the port's sharded-BA tolerances after 10 iterations
    (tests/test_torch_sharded_ba.py): each process's Schur product is an
    einsum over one mp column instead of a batch of two, which contracts
    in another order (3.8e-5 apart on random blocks), and at the cost
    minimum an accept test flips and a deep landmark moves by millimetres
    (measured 5.4e-5 on poses, 4.0e-3 m on landmarks);
  * the reduction itself: bit for bit `ring_all_reduce_plain` over the
    whole payload in one process;
  * every process holds the same replicated result, bit for bit;
  * the sharded PGO against the reference's `optimize_pose_graph`: the
    tolerances of tests/test_torch_pose_graph.py (1e-1 on the poses, chi2
    within 5%).
"""

import numpy as np
import pytest
import torch

from stereovision_slam_tpu.slam import pose_graph as jpg
from stereovision_slam_tpu.slam.backend import optimize_window
from stereovision_slam_torch import convert
from stereovision_slam_torch.parallel import ring_reduce
from stereovision_slam_torch.parallel.mesh import (
    initialize_multihost, make_ba_mesh)
from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
from tests.test_backend_ba import K, F, L, build_window
from tests.test_pose_graph import build_graph
from tests import torch_dist_worker
from tests.test_torch_pose_graph import chi2

torch.set_num_threads(1)

ITERS = torch_dist_worker.ITERS


@pytest.fixture(scope="module")
def window():
    m, _, _, _, cams = build_window(seed=5, pose_noise=0.03, lm_noise=0.2,
                                    px_noise=0.2)
    return m, cams, convert.map_state(m), tuple(convert.camera(c)
                                                for c in cams)


@pytest.fixture(scope="module")
def graph():
    return build_graph(n=40)[0]


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(3)
    return rng.standard_normal((8, 64, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def two_processes(window, graph, payload, tmp_path_factory):
    """Both workers' results (one dict each)."""
    _, _, tm, (tl, tr) = window
    tmp = tmp_path_factory.mktemp("dist")
    arrays = {"payload": payload}
    for prefix, tup in (("m_", tm), ("cl_", tl), ("cr_", tr),
                        ("g_", convert.pose_graph(graph))):
        arrays.update({prefix + f: v.numpy() for f, v in
                       zip(tup._fields, tup) if v is not None})
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **arrays)
    return torch_dist_worker.spawn(inputs, str(tmp))


@pytest.fixture(scope="module")
def reference():
    """The reference's single-chip BA (it donates its inputs: a window of
    its own)."""
    m, _, _, _, cams = build_window(seed=5, pose_noise=0.03, lm_noise=0.2,
                                    px_noise=0.2)
    ms, _ = optimize_window(m, cams[0], cams[1], iters=ITERS,
                            outlier_rounds=0)
    return (np.asarray(ms.kf_pose), np.asarray(ms.lm_pos),
            np.asarray(ms.kf_valid), np.asarray(ms.lm_valid))


@pytest.mark.parametrize("run", ["xla", "ring", "mp"])
def test_two_process_ba_matches_reference(reference, two_processes, run):
    kf_ref, lm_ref, kv, lv = reference
    res = two_processes[0]
    np.testing.assert_allclose(res[f"kf_{run}"][kv], kf_ref[kv], atol=5e-3)
    np.testing.assert_allclose(res[f"lm_{run}"][lv], lm_ref[lv], atol=5e-2)


@pytest.mark.parametrize("key", ["kf_xla", "lm_xla", "kf_ring", "lm_ring",
                                 "kf_mp", "lm_mp", "pgo"])
def test_processes_hold_the_same_result(two_processes, key):
    np.testing.assert_array_equal(two_processes[0][key],
                                  two_processes[1][key])


@pytest.mark.parametrize("dp,mp,run,tol", [(4, 2, "ring", (1e-5, 1e-4)),
                                           (4, 2, "xla", (1e-5, 1e-4)),
                                           (1, 2, "mp", (1e-4, 1e-2))])
def test_two_process_ba_matches_one_process(window, two_processes, dp, mp,
                                            run, tol):
    _, _, tm, (tl, tr) = window
    impl = "ring" if run == "ring" else "xla"
    kf, lm = build_sharded_ba(make_ba_mesh(dp * mp, dp=dp, mp=mp,
                                           device="cpu"),
                              K, F, L, iters=ITERS, reduce_impl=impl)(
        tm, tl, tr)
    res = two_processes[0]
    np.testing.assert_allclose(res[f"kf_{run}"], kf.numpy(), rtol=0,
                               atol=tol[0])
    np.testing.assert_allclose(res[f"lm_{run}"], lm.numpy(), rtol=0,
                               atol=tol[1])


@pytest.mark.parametrize("axis", ["dp", "mp"])
def test_cross_process_ring_is_bit_equal(two_processes, payload, axis):
    mesh = make_ba_mesh(8, dp=4, mp=2, device="cpu")
    want = ring_reduce.ring_all_reduce_plain(torch.from_numpy(payload), axis,
                                             mesh.mesh_axes).numpy()
    got = np.concatenate([r[f"ring_{axis}"] for r in two_processes])
    np.testing.assert_array_equal(got, want)


def test_two_process_pgo_matches_reference(graph, two_processes):
    out_j = np.asarray(jpg.optimize_pose_graph(graph, iters=22))
    out_t = two_processes[0]["pgo"]
    assert np.all(np.isfinite(out_t))
    np.testing.assert_allclose(out_t, out_j, atol=1e-1)
    cj, ct = chi2(graph, out_j), chi2(graph, out_t)
    assert ct <= cj * 1.05 + 1e-8 and cj <= ct * 1.05 + 1e-8, (ct, cj)
    assert np.abs(out_t - np.asarray(graph.poses)).max() > 1e-3


def test_initialize_multihost_one_process_is_a_noop():
    initialize_multihost(num_processes=1)
    assert not torch.distributed.is_initialized()
    mesh = make_ba_mesh(8, dp=4, mp=2, device="cpu")
    assert mesh.group is None and mesh.ranks == range(8)
    assert mesh.local_shape == (4, 2)


def test_several_device_mesh_matches_one_device(window):
    """A mesh of one device per rank (the per-rank route, every rank a
    device entry of this process) against the same mesh as tensor axes
    on one device, bit for bit: both add the ranks' partials in rank order
    and form each mp rank's Schur products alone."""
    _, _, tm, (tl, tr) = window
    mesh = make_ba_mesh(devices=["cpu"] * 8, dp=4, mp=2)
    assert mesh.per_rank and mesh.devices == [torch.device("cpu")] * 8
    for impl in ("xla", "ring"):
        kf, lm = build_sharded_ba(mesh, K, F, L, iters=ITERS,
                                  reduce_impl=impl)(tm, tl, tr)
        kf1, lm1 = build_sharded_ba(make_ba_mesh(8, dp=4, mp=2,
                                                 device="cpu"),
                                    K, F, L, iters=ITERS,
                                    reduce_impl=impl)(tm, tl, tr)
        assert torch.equal(kf, kf1) and torch.equal(lm, lm1)
