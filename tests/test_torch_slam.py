"""Port parity, map state, frontend and backend, started from one state.

The JAX package runs the scene of tests/test_fused.py for a few frames; its
state is carried into the port (`convert`), and both packages then take the
same next step. On the CPU the reference's frontend would take its
full-image LK and LU pose solve, so the test routes it through its own
kernels' interpreters (lanes LK, Pallas pose solve): the same algorithms as
the port's plain versions. Integer and boolean state must be equal;
positions agree to 1e-3 px, poses to 1e-4, landmarks to 1e-3 m (sums in
another order, amplified by the solves).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.ops import lk as jlk
from stereovision_slam_tpu.slam import backend as jbe
from stereovision_slam_tpu.slam import frontend as jfe
from stereovision_slam_tpu.slam import map_state as jmap
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.slam import backend as tbe
from stereovision_slam_torch.slam import frontend as tfe
from stereovision_slam_torch.slam import map_state as tmap
from tests import synthetic
from tests.test_pipeline_frontend import small_config


def _eq_state(j, t, float_tol, skip=()):
    tn = convert.to_numpy(t)
    for f in t._fields:
        if f in skip:
            continue
        a, b = np.asarray(getattr(j, f)), tn[f]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=float_tol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_map_state_ops():
    """add_landmarks / insert_keyframe (with eviction) / active_counts from
    the same random operations, tensor by tensor."""
    rng = np.random.default_rng(0)
    K, F, L = 4, 16, 64
    jm = jmap.empty_map(K, F, L)
    tm = tmap.empty_map(K, F, L)
    _eq_state(jm, tm, 0.0)
    for kf in range(6):
        pose = np.c_[np.eye(3), rng.normal(0, 1.0 + kf, 3)].astype(np.float32)
        pos = rng.normal(0, 5, (F, 3)).astype(np.float32)
        create = rng.uniform(size=F) > 0.4
        jm, js = jmap.add_landmarks(jm, jnp.asarray(pos), jnp.asarray(create),
                                    jnp.int32(kf))
        tm, ts = tmap.add_landmarks(tm, torch.from_numpy(pos),
                                    torch.from_numpy(create), kf)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        feat_lm = np.where(rng.uniform(size=F) > 0.3, np.asarray(js), -1)
        feat_lm = feat_lm.astype(np.int32)
        uv = rng.uniform(0, 300, (2, F, 2)).astype(np.float32)
        has_r = rng.uniform(size=F) > 0.2
        valid = rng.uniform(size=F) > 0.1
        jm, jev = jmap.insert_keyframe(
            jm, jnp.asarray(pose), jnp.int32(10 * kf), jnp.int32(kf),
            jnp.asarray(uv[0]), jnp.asarray(uv[1]), jnp.asarray(feat_lm),
            jnp.asarray(has_r), jnp.asarray(valid), num_active=3)
        tm, tev = tmap.insert_keyframe(
            tm, torch.from_numpy(pose), 10 * kf, kf, torch.from_numpy(uv[0]),
            torch.from_numpy(uv[1]), torch.from_numpy(feat_lm),
            torch.from_numpy(has_r), torch.from_numpy(valid), num_active=3)
        _eq_state(jm, tm, 0.0)
        _eq_state(jev, tev, 0.0)
    assert bool(jev.happened)
    for a, b in zip(jmap.active_counts(jm), tmap.active_counts(tm)):
        assert int(a) == int(b)


@pytest.fixture(scope="module")
def mid():
    """The reference's state after 7 frames of the test_fused.py scene (two
    keyframes, one BA), and the frames."""
    H, W = 120, 320
    rig = synthetic.make_stereo_rig(fx=260.0, fy=260.0, cx=160.0, cy=60.0)
    poses = synthetic.forward_motion_poses(14, step=0.5, yaw_rate=0.012)
    lms = jnp.concatenate([
        synthetic.random_landmarks(jax.random.PRNGKey(40), 80, z_range=(4, 40)),
        synthetic.random_landmarks(jax.random.PRNGKey(41), 60,
                                   z_range=(10, 50)) + jnp.array([0., 0., 6.]),
    ])
    lefts, rights = synthetic.render_stereo_sequence(
        jax.random.PRNGKey(17), poses, lms, H=H, W=W, rig=rig)
    lefts, rights = np.array(lefts), np.array(rights)
    vo = JFused(small_config(), JDataset(lefts, rights, list(rig)))
    vo.initialize()
    for _ in range(7):
        vo.step()
    # numpy snapshots: the reference's map updates donate their inputs
    fs = jfe.FrontendState(**{
        f: (tuple(np.array(lv) for lv in v) if isinstance(v, tuple)
            else np.array(v)) for f, v in vo.fs._asdict().items()})
    ms = jmap.MapState(*(np.array(v) for v in vo.ms))
    return fs, ms, lefts, rights, rig


def _jax(state):
    """Fresh device copies of a numpy snapshot, for a reference call."""
    return type(state)(*(tuple(jnp.asarray(lv) for lv in v)
                         if isinstance(v, tuple) else jnp.asarray(v)
                         for v in state))


def _lanes_lk(monkeypatch):
    """Route the reference frontend's LK through its lanes kernel (run by
    the Pallas interpreter), the algorithm of the port's kernel A."""
    monkeypatch.setattr(jlk, "track", functools.partial(
        jlk.track, pallas_mode="lanes-interpret"))
    monkeypatch.setattr(jlk, "track_batched", functools.partial(
        jlk.track_batched, pallas_mode="lanes-interpret"))


def test_track_and_keyframe_steps(mid, monkeypatch):
    fs, ms, lefts, rights, rig = mid
    _lanes_lk(monkeypatch)
    cfg = small_config()
    lv = cfg.lk_num_levels
    jl, jr = rig
    tl, tr = (convert.camera(c) for c in rig)
    jp = jimg.build_pyramid(jnp.asarray(lefts[7]), lv)
    jpr = jimg.build_pyramid(jnp.asarray(rights[7]), lv)
    tp = timg.build_pyramid(torch.from_numpy(lefts[7].copy()), lv)
    tpr = timg.build_pyramid(torch.from_numpy(rights[7].copy()), lv)
    # the bench's LK budget (12) keeps the interpreted reference quick
    kw = dict(chi2_th=cfg.chi2_th, rounds=cfg.pose_rounds,
              iters=cfg.pose_iters_per_round, lk_iters=12)
    jfs, jn, jt = jfe.track_step.__wrapped__(
        _jax(fs), _jax(ms), tuple(jp), jl, tuple(jpr), jr,
        pose_impl="interpret", **kw)
    tfs, tn, tt = tfe.track_step(convert.frontend_state(fs),
                                 convert.map_state(ms), tp, tl, tpr, tr, **kw)
    assert (int(tn), int(tt)) == (int(jn), int(jt))
    on = np.asarray(jfs.feat_valid)
    np.testing.assert_array_equal(tfs.feat_valid.numpy(), on)
    np.testing.assert_array_equal(tfs.feat_lm.numpy(), np.asarray(jfs.feat_lm))
    np.testing.assert_allclose(tfs.feat_uv.numpy()[on],
                               np.asarray(jfs.feat_uv)[on], atol=1e-3)
    np.testing.assert_allclose(tfs.T_cur.numpy(), np.asarray(jfs.T_cur),
                               atol=1e-4)

    # keyframe step from the reference's tracked state
    kkw = dict(num_features=cfg.num_features,
               min_distance=cfg.gftt_min_distance,
               quality_level=cfg.gftt_quality_level,
               max_depth=cfg.max_triangulation_depth,
               num_active=cfg.num_active_keyframes, lk_iters=12)
    tfs_in = convert.frontend_state(jfs)
    jfs2, jms2, jev, jnew, jnr = jfe.keyframe_step.__wrapped__(
        jfs, _jax(ms), tuple(jpr), jl, jr, jnp.int32(7), jnp.int32(2), **kkw)
    tfs2, tms2, tev, tnew, tnr = tfe.keyframe_step(
        tfs_in, convert.map_state(ms), tpr, tl, tr, 7, 2, **kkw)
    assert (int(tnew), int(tnr)) == (int(jnew), int(jnr))
    assert int(tnew) > 0
    _eq_state(jms2, tms2, 1e-3)
    _eq_state(jev, tev, 1e-3)
    on = np.asarray(jfs2.feat_valid)
    np.testing.assert_array_equal(tfs2.feat_lm.numpy(),
                                  np.asarray(jfs2.feat_lm))
    np.testing.assert_allclose(tfs2.feat_uv.numpy()[on],
                               np.asarray(jfs2.feat_uv)[on], atol=1e-3)


@pytest.mark.parametrize("max_active", [None, 256])
def test_optimize_window(mid, max_active):
    """One BA pass on the same map, with and without landmark compaction."""
    _, ms, _, _, rig = mid
    jl, jr = rig
    tl, tr = (convert.camera(c) for c in rig)
    jm, jst = jbe.optimize_window.__wrapped__(
        _jax(ms), jl, jr, chi2_th=5.991, iters=6,
        max_active_landmarks=max_active)
    tm, tst = tbe.optimize_window(convert.map_state(ms), tl, tr,
                                  chi2_th=5.991, iters=6,
                                  max_active_landmarks=max_active)
    for a, b in zip(jst, tst):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    _eq_state(jm, tm, 1e-3, skip=("kf_pose",))
    np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                               atol=1e-4)
