"""Port parity, distributed BA on a rank mesh held on the CPU.

The window of tests/test_backend_ba.py (`build_window(seed=5, ...)`) is
carried into the port with `convert`; the port's `build_sharded_ba` is held
to the reference's (XLA collectives on the 8 virtual CPU devices).

Tolerances. After 2 LM iterations poses agree within 1e-4 and landmarks
within 1e-3 m, the tolerances of tests/test_torch_slam.py (sums in another
order: the port scatters in float64, the reference in float32). After 10
iterations poses still agree within 1e-4, but at the cost minimum an LM
step's accept test flips with rounding, and a landmark 44 m deep moves by a
few millimetres: the reference's own (4, 2) and (8, 1) meshes differ there
by 4.7e-3 m (landmark 13, from the fourth iteration on). Landmarks are held
to 1e-2 m after 10 iterations. Ring against sum (both the port's):
1e-5 / 1e-4; sharded against the port's single-card BA: 5e-3 / 5e-2
(tests/test_sharded_ba.py).
"""

import numpy as np
import pytest
import torch

from stereovision_slam_tpu.parallel.mesh import make_ba_mesh as jmake_mesh
from stereovision_slam_tpu.parallel.sharded_ba import (
    build_sharded_ba as jbuild_sharded_ba)
from stereovision_slam_torch import convert
from stereovision_slam_torch.parallel.mesh import make_ba_mesh
from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
from stereovision_slam_torch.slam import backend as tbe
from tests.test_backend_ba import build_window, K, F, L

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def window():
    m, poses_gt, lms_gt, lm_slots, cams = build_window(
        seed=5, pose_noise=0.03, lm_noise=0.2, px_noise=0.2)
    return m, cams, convert.map_state(m), tuple(convert.camera(c)
                                                for c in cams)


@pytest.mark.parametrize("dp,mp", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("max_active", [None, 128])
def test_sharded_ba_matches_reference(window, dp, mp, max_active):
    m, cams, tm, (tl, tr) = window
    for iters, lm_tol in ((2, 1e-3), (10, 1e-2)):
        kj, lj = jbuild_sharded_ba(
            jmake_mesh(8, dp=dp, mp=mp), K, F, L, iters=iters,
            max_active_landmarks=max_active)(m, cams[0], cams[1])
        mesh = make_ba_mesh(8, dp=dp, mp=mp, device="cpu")
        kt, lt = build_sharded_ba(mesh, K, F, L, iters=iters,
                                  max_active_landmarks=max_active)(tm, tl, tr)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=lm_tol)


@pytest.mark.parametrize("dp,mp,max_active", [(4, 2, None), (2, 4, 128),
                                              (8, 1, 128)])
def test_ring_matches_sum_and_single_card(window, dp, mp, max_active):
    """The dp reduction by the ring (kernel D's plain version) against the
    plain sum, and both against `optimize_window(outlier_rounds=0)`."""
    _, _, tm, (tl, tr) = window
    mesh = make_ba_mesh(8, dp=dp, mp=mp, device="cpu")
    kx, lx = build_sharded_ba(mesh, K, F, L, iters=10,
                              max_active_landmarks=max_active)(tm, tl, tr)
    kr, lr = build_sharded_ba(mesh, K, F, L, iters=10, reduce_impl="ring",
                              max_active_landmarks=max_active)(tm, tl, tr)
    torch.testing.assert_close(kr, kx, rtol=0, atol=1e-5)
    torch.testing.assert_close(lr, lx, rtol=0, atol=1e-4)
    ms, _ = tbe.optimize_window(tm, tl, tr, iters=10, outlier_rounds=0,
                                max_active_landmarks=max_active)
    kv, lv = ms.kf_valid, ms.lm_valid
    for kf, lm in ((kx, lx), (kr, lr)):
        torch.testing.assert_close(kf[kv], ms.kf_pose[kv], rtol=0, atol=5e-3)
        torch.testing.assert_close(lm[lv], ms.lm_pos[lv], rtol=0, atol=5e-2)


@pytest.mark.parametrize("n", [8, 6, 4, 2])
def test_make_ba_mesh_default_split(n):
    jm = jmake_mesh(n)
    tm = make_ba_mesh(n, device="cpu")
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.size == n and len(tm.devices) == n


def test_mesh_layout_and_errors(window):
    mesh = make_ba_mesh(devices=["cpu"] * 8, dp=4, mp=2)
    assert mesh.mesh_axes == (("dp", 4), ("mp", 2))
    assert mesh.axis_index("mp").tolist() == [0, 1]
    assert make_ba_mesh(dp=2, mp=3, device="cpu").size == 6
    with pytest.raises(ValueError):
        make_ba_mesh(8, dp=3, mp=2, device="cpu")
    with pytest.raises(NotImplementedError):
        make_ba_mesh(devices=["cpu", "meta"])
    _, _, tm, (tl, tr) = window
    with pytest.raises(ValueError):
        build_sharded_ba(make_ba_mesh(8, dp=8, mp=1, device="cpu"), K, F, L,
                         reduce_impl="nccl")
    with pytest.raises(ValueError):     # L = 256 does not divide by mp = 3
        build_sharded_ba(make_ba_mesh(dp=2, mp=3, device="cpu"), K, F, L)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_ba_mesh(8)               # the card by default
