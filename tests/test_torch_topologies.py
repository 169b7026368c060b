"""Port parity, the frontend's tracking topologies: `frontend.track_step`
with `anchored=False`, `multi_start=False`, mono (no right pyramid) and
`fused_tracks=False`, each against the reference's `track_step` with the
same flags, from one converted state over 3 frames.

The state: the reference's stereo initialization (its `keyframe_step`) on
frame 0 of a 120x320 synthetic scene, carried into the port (`convert`);
then each package tracks frames 1-3 from its own previous result. On the
CPU the reference takes its full-image LK and its LU pose solvers, the port
its kernels' plain versions (lanes LK, Cholesky pose solve; the mono solve
is the plain multi-start solver in both). Bar: inlier and tracked counts
within 2 of each other, poses within 1e-4 (m and rad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.slam import frontend as jfe
from stereovision_slam_tpu.slam import map_state as jmap
from stereovision_slam_torch import convert
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.slam import frontend as tfe
from tests import synthetic
from tests.test_pipeline_frontend import small_config

torch.set_num_threads(1)

TOPOLOGIES = {
    "unanchored": dict(anchored=False),
    "single_start": dict(multi_start=False),
    "mono": dict(stereo=False),
    "sequential": dict(fused_tracks=False),
}
FRAMES = 3
POSE_TOL = 1e-4
COUNT_TOL = 2


@pytest.fixture(scope="module")
def start():
    """The reference's stereo initialization on frame 0, and the frames."""
    H, W = 120, 320
    rig = synthetic.make_stereo_rig(fx=260.0, fy=260.0, cx=160.0, cy=60.0)
    poses = synthetic.forward_motion_poses(FRAMES + 1, step=0.5,
                                           yaw_rate=0.012)
    lms = jnp.concatenate([
        synthetic.random_landmarks(jax.random.PRNGKey(40), 80, z_range=(4, 40)),
        synthetic.random_landmarks(jax.random.PRNGKey(41), 60,
                                   z_range=(10, 50)) + jnp.array([0., 0., 6.]),
    ])
    lefts, rights = synthetic.render_stereo_sequence(
        jax.random.PRNGKey(17), poses, lms, H=H, W=W, rig=rig)
    lefts, rights = np.array(lefts), np.array(rights)
    cfg = small_config()
    lv = cfg.lk_num_levels
    pyr = jimg.build_pyramid(jnp.asarray(lefts[0]), lv)
    fs0 = jfe.init_state(cfg.max_features, pyr)
    ms0 = jmap.empty_map(cfg.max_keyframes_window, cfg.max_features,
                         cfg.max_landmarks)
    fs, ms, _, n_new, _ = jfe.keyframe_step(
        fs0, ms0, tuple(jimg.build_pyramid(jnp.asarray(rights[0]), lv)),
        rig[0], rig[1], 0, 0, num_features=cfg.num_features,
        min_distance=cfg.gftt_min_distance,
        quality_level=cfg.gftt_quality_level,
        max_depth=cfg.max_triangulation_depth,
        num_active=cfg.num_active_keyframes, detect_all=True)
    assert int(n_new) >= cfg.num_features_init
    # a moving start, so the starts of the multi-start solve differ
    rel = jse3.se3_exp(jnp.array([0.0, 0.0, -0.5, 0.0, 0.012, 0.0]))
    fs = fs._replace(T_rel=rel)
    fs = jfe.FrontendState(**{
        f: (tuple(np.array(x) for x in v) if isinstance(v, tuple)
            else np.array(v)) for f, v in fs._asdict().items()})
    ms = jmap.MapState(*(np.array(v) for v in ms))
    return fs, ms, lefts, rights, rig, cfg


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_matches_reference(start, name):
    fs, ms, lefts, rights, rig, cfg = start
    flags = dict(TOPOLOGIES[name])
    stereo = flags.pop("stereo", True)
    lv = cfg.lk_num_levels
    kw = dict(chi2_th=cfg.chi2_th, rounds=cfg.pose_rounds,
              iters=cfg.pose_iters_per_round, lk_iters=12, **flags)
    jl, jr = rig
    tl, tr = (convert.camera(c) for c in rig)
    jfs = jfe.FrontendState(*(tuple(jnp.asarray(x) for x in v)
                              if isinstance(v, tuple) else jnp.asarray(v)
                              for v in fs))
    jms = jmap.MapState(*(jnp.asarray(v) for v in ms))
    tfs, tms = convert.frontend_state(fs), convert.map_state(ms)
    for f in range(1, FRAMES + 1):
        jp = tuple(jimg.build_pyramid(jnp.asarray(lefts[f]), lv))
        tp = tuple(timg.build_pyramid(torch.from_numpy(lefts[f].copy()), lv))
        jpr = tpr = jr_ = tr_ = None
        if stereo:
            jpr = tuple(jimg.build_pyramid(jnp.asarray(rights[f]), lv))
            tpr = tuple(timg.build_pyramid(
                torch.from_numpy(rights[f].copy()), lv))
            jr_, tr_ = jr, tr
        jfs, jn, jt = jfe.track_step(jfs, jms, jp, jl, jpr, jr_, **kw)
        tfs, tn, tt = tfe.track_step(tfs, tms, tp, tl, tpr, tr_, **kw)
        assert abs(int(tn) - int(jn)) <= COUNT_TOL, (f, int(tn), int(jn))
        assert abs(int(tt) - int(jt)) <= COUNT_TOL, (f, int(tt), int(jt))
        assert int(tn) > cfg.num_features_tracking
        # the pose gap as a tangent: metres and radians
        gap = jse3.se3_log(jnp.asarray(tfs.T_cur.numpy()) @ jnp.concatenate(
            [jse3.se3_inverse(jfs.T_cur), jnp.array([[0., 0., 0., 1.]])]))
        assert float(jnp.abs(gap).max()) <= POSE_TOL, (f, np.asarray(gap))
        # the port keeps its pose on SO(3)
        R = tfs.T_cur[:, :3]
        assert float((R @ R.T - torch.eye(3)).abs().max()) < 1e-6
