"""Port parity, the FAST-9 detector (the config's ORB option):
`ops/fast.py`, `frontend.keyframe_step(detector="orb")`, the fused
pipeline with ORB against the JAX package, and the chunked pipeline with
ORB against the eager one.

Tolerances: the response within 1e-5 relative (both sum the ring's 16
excesses in ring order, so it is bit for bit on these inputs) and the
detections equal (points, validity; scores within 1e-5 relative); the
keyframe step's states as tests/test_torch_topologies.py holds GFTT's
(integers and flags equal, positions 1e-3 px, landmarks 1e-3 m); the
fused run as tests/test_torch_slice.py holds GFTT's (the same keyframe
frames, inlier counts within 3, keyframe poses within 2e-3); the chunked
run equals the eager one bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.ops import fast as jfast
from stereovision_slam_tpu.ops import gftt as jgftt
from stereovision_slam_tpu.slam import frontend as jfe
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert
from stereovision_slam_torch.ops import fast
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import fused
from tests import synthetic
from tests.test_pipeline_frontend import small_config
from tests.test_torch_scan import _assert_same_run, _port
from tests.test_torch_slice import scene  # noqa: F401  (module fixture)

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def frame():
    """A rendered textured frame at the loader's 188x620."""
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(1, step=0.0)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=188, W=620, rig=rig)
    return np.array(lefts[0], np.float32), np.array(rights[0], np.float32)


def _orb(cfg):
    return dataclasses.replace(cfg, keypoint_feature_detector="ORB")


def test_fast_response_matches_reference(frame):
    img = frame[0]
    r = fast.fast_response(torch.from_numpy(img)).numpy()
    jr = np.asarray(jfast.fast_response(jnp.asarray(img)))
    np.testing.assert_allclose(r, jr, rtol=RTOL, atol=0)
    assert (r > 0).sum() > 500


@pytest.mark.parametrize("masked", [False, True])
def test_fast_detect_matches_reference(frame, masked):
    img = frame[0]
    H, W = img.shape
    mask = None
    if masked:   # the keyframe path's occupancy mask around tracked points
        rng = np.random.default_rng(0)
        pts = rng.uniform([0, 0], [W, H], (60, 2)).astype(np.float32)
        mask = np.array(jgftt.occupancy_mask((H, W), jnp.asarray(pts),
                                             jnp.ones(60, bool), 10))
    jp, jv, js = jfast.detect(jnp.asarray(img), max_corners=250,
                              min_distance=20,
                              mask=None if mask is None else jnp.asarray(mask))
    p, v, s = fast.detect(torch.from_numpy(img), max_corners=250,
                          min_distance=20,
                          mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=0)
    assert v.sum() > 50


def test_fast_blobs_and_flat_image():
    """The reference's unit cases: blob corners found, a flat image none."""
    pts_true = np.array([[40.0, 40.0], [100.0, 60.0], [70.0, 90.0],
                         [130.0, 30.0]])
    img = np.array(synthetic.render_blobs(jnp.asarray(pts_true), 128, 160,
                                          sigma=2.5), np.float32)
    pts, valid, _ = fast.detect(torch.from_numpy(img), max_corners=16,
                                min_distance=8)
    p = pts.numpy()[valid.numpy()]
    assert len(p) >= 4
    for t in pts_true:
        assert np.linalg.norm(p - t, axis=1).min() <= 3.0
    _, valid, _ = fast.detect(torch.full((64, 64), 80.0), max_corners=16)
    assert int(valid.sum()) == 0


def test_keyframe_step_orb_matches_reference():
    """`keyframe_step(detector="orb")` on the reference test's tiny scene
    (tests/test_gftt_lk.py), from the same state in both packages."""
    import __graft_entry__
    fs, m, _, cam_l, cam_r = __graft_entry__._tiny_scene()
    tfs = convert.frontend_state(jax.tree.map(np.asarray, fs))
    tm = convert.map_state(jax.tree.map(np.asarray, m))
    # the reference donates the map
    jfs, jm, _, jn, jr = jfe.keyframe_step(fs, m, fs.pyr, cam_l, cam_r, 3, 3,
                                           detector="orb")
    pfs, pm, _, n, r = fe.keyframe_step(
        tfs, tm, tfs.pyr, convert.camera(cam_l), convert.camera(cam_r), 3, 3,
        detector="orb")
    assert int(n) == int(jn) and int(r) == int(jr)
    assert int(pfs.feat_valid.sum()) > int(tfs.feat_valid.sum())
    for f in ("feat_lm", "feat_valid"):
        np.testing.assert_array_equal(getattr(pfs, f).numpy(),
                                      np.asarray(getattr(jfs, f)), f)
    np.testing.assert_allclose(pfs.feat_uv.numpy(), np.asarray(jfs.feat_uv),
                               atol=1e-3)
    for f in ("lm_valid", "lm_id", "kf_valid", "obs_valid"):
        np.testing.assert_array_equal(getattr(pm, f).numpy(),
                                      np.asarray(getattr(jm, f)), f)
    np.testing.assert_allclose(pm.lm_pos.numpy(), np.asarray(jm.lm_pos),
                               atol=1e-3)
    # FAST picked other corners than GFTT would
    gfs = fe.keyframe_step(tfs, tm, tfs.pyr, convert.camera(cam_l),
                           convert.camera(cam_r), 3, 3)[0]
    assert not torch.equal(gfs.feat_uv, pfs.feat_uv)


def test_fused_orb_matches_reference(scene):  # noqa: F811
    lefts, rights, rig, _ = scene
    n = 8
    cfg = _orb(small_config())
    ref = JFused(cfg, JDataset(lefts[:n], rights[:n], list(rig)))
    ref.initialize()
    ref.run()
    kf_j, _, out_j = ref.drain()
    port = _port(fused.FusedVisualOdometry, (lefts[:n], rights[:n], rig, None),
                 cfg)
    port.run()
    kf_t, _, out_t = port.drain()
    est_j = {fid: p for fid, p in kf_j.values()}
    est_t = {fid: p for fid, p in kf_t.values()}
    assert sorted(est_t) == sorted(est_j) and len(est_t) >= 2
    n_j = np.array([int(o.n_inliers) for _, o in out_j])
    n_t = np.array([int(o.n_inliers) for _, o in out_t])
    print(f"inliers, reference {n_j.tolist()}, port {n_t.tolist()}")
    assert np.abs(n_j - n_t).max() <= 3
    assert min(n_t[1:]) > 10
    for fid in est_j:
        np.testing.assert_allclose(est_t[fid], est_j[fid], atol=2e-3)


def test_chunked_orb_equals_eager(scene):  # noqa: F811
    lefts, rights, rig, _ = scene
    cfg = _orb(small_config())
    eager = _port(fused.FusedVisualOdometry, scene, cfg)
    eager.run()
    vo = _port(fused.ScanVisualOdometry, scene, cfg, chunk_size=5)
    vo.run()
    _assert_same_run(eager, vo)
    assert vo._static["detector"] == "orb"
