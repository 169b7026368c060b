"""Port parity, the loop hook and shutdown PGO: `fused_loop._loop_hook` on
states carried across from the JAX package (`convert`), on a fabricated
revisit; `FusedLoopVisualOdometry.run_pgo` on the same graph; and the port
on a straight line, where no loop may close.

The revisit: the reference's fused odometry runs the scene of
tests/test_torch_slice.py; the hook adds its final keyframe to the loop
database as keyframe 0; the map and the pose are then moved by a rigid
1.4 m drift, and three groups of the keyframe's landmarks are changed so
that each case of the landmark merge fires (renamed: rewrite in place;
dropped and unlinked: insert; duplicated into a new slot: relink); the
hook then runs as keyframe 30 on the same frame, so the candidate scan,
the match, PnP, the edge record, LocalFusion and the merge all run.

Tolerances: integer and boolean tensors equal; poses within 1e-4 (PnP and
its LM solves round in another sum order); landmark positions within 1e-3
m; the edge information, a normalized Hessian, within 1e-3; PGO poses
within 1e-3 and landmarks within the reference drain's float16 rounding
(1e-2 m + 2e-3 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.models import place_net as jplace
from stereovision_slam_tpu.slam import fused_loop as jfl
from stereovision_slam_tpu.slam import map_state as jmapmod
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.slam import fused_loop
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam.config import PLACENET_LOOP_GATES
from tests import synthetic
from tests.test_pipeline_frontend import small_config
from tests.test_torch_slice import scene  # noqa: F401  (module fixture)

torch.set_num_threads(1)

GATES = dict(skip=PLACENET_LOOP_GATES["keyframes_to_skip_in_candidate_search"],
             cooldown=PLACENET_LOOP_GATES["keyframes_to_ignore_after_loop"],
             strong=PLACENET_LOOP_GATES["potential_loop_strong_threshold"],
             weak=PLACENET_LOOP_GATES["potential_loop_weak_threshold"],
             max_weak=PLACENET_LOOP_GATES["max_num_weak_threshold"],
             min_match=PLACENET_LOOP_GATES[
                 "min_num_acceptable_keypoint_match"],
             min_pose_diff=1.0, max_pose_diff=50.0, max_loop_dist=20.0,
             num_hypotheses=256)
DRIFT = [0.9, 0.1, 1.1, 0.0, 0.03, 0.0]


@pytest.fixture(scope="module")
def reference_run(scene):  # noqa: F811
    lefts, rights, rig, poses = scene
    # a keyframe on every frame, so the pose graph has 8 vertices
    cfg = dataclasses.replace(small_config(),
                              num_features_needed_for_keyframe=1000)
    ref = JFused(cfg, JDataset(lefts[:8], rights[:8], list(rig)))
    ref.initialize()
    ref.run()
    return ref, cfg, rig, poses


def _np(state):
    return type(state)(*(tuple(np.array(v) for v in x)
                         if isinstance(x, (tuple, list)) else np.array(x)
                         for x in state))


def _hooks(ls, fs, ms, arc, kf_id, cam):
    """The reference's hook and the port's on the same (numpy) states."""
    a = jfl._loop_hook(
        jax.tree.map(jnp.asarray, ls), jax.tree.map(jnp.asarray, fs),
        jax.tree.map(jnp.asarray, ms), tuple(jnp.asarray(x) for x in fs.pyr),
        jnp.int32(100 + kf_id), jnp.int32(kf_id),
        jax.tree.map(jnp.asarray, arc), cam_left=cam,
        mnv2_params=jplace.get_params(), **GATES)
    reads = {}
    b = fused_loop._loop_hook(
        convert.loop_state(ls), convert.frontend_state(fs),
        convert.map_state(ms), tuple(convert.tensor(x) for x in fs.pyr),
        100 + kf_id, kf_id, convert.archive_state(arc),
        cam_left=convert.camera(cam),
        place_params=place_net.get_params(device="cpu"), reads=reads, **GATES)
    return tuple(_np(x) for x in a), b, reads


def _hold(ref, port, atol=None):
    for f in ref._fields:
        p = getattr(port, f)
        if isinstance(p, tuple):          # pyramids: the same input levels
            continue
        r, p = np.asarray(getattr(ref, f)), p.numpy()
        if r.dtype == np.uint32:
            p = p.view(np.uint32)
        if r.dtype.kind in "biu":
            assert np.array_equal(r, p), f
        else:
            tol = (atol or {}).get(f, 1e-4)
            np.testing.assert_allclose(p, r, rtol=0, atol=tol, err_msg=f)


def _revisit_state(fs, ms):
    """The drifted, edited state of the fabricated revisit, and the feature
    indices of the three merge groups."""
    G = np.asarray(jse3.se3_exp(jnp.asarray(DRIFT)))
    Gi = np.asarray(jse3.se3_inverse(jnp.asarray(G)))
    kf_pose = np.asarray(jse3.se3_compose(jnp.asarray(ms.kf_pose),
                                          jnp.asarray(Gi)[None]))
    lm_pos = np.asarray(jse3.se3_apply(jnp.asarray(G)[None],
                                       jnp.asarray(ms.lm_pos)))
    kf_pose = np.where(ms.kf_valid[:, None, None], kf_pose, ms.kf_pose)
    lm_pos = np.where(ms.lm_valid[:, None], lm_pos, ms.lm_pos)
    T_cur = np.asarray(jse3.se3_compose(jnp.asarray(fs.T_cur),
                                        jnp.asarray(Gi)))
    lm_id, lm_valid = ms.lm_id.copy(), ms.lm_valid.copy()
    lm_count = ms.lm_obs_count.copy()
    feat_lm = fs.feat_lm.copy()
    linked = np.nonzero(fs.feat_valid & (fs.feat_lm >= 0))[0]
    rename, drop, dup = linked[:12], linked[12:24], linked[24:36]
    lm_id[feat_lm[rename]] = 100000 + rename
    lm_valid[feat_lm[drop]] = False
    feat_lm[drop] = -1
    free = np.nonzero(~lm_valid)[0]
    for i, s in zip(dup, free):
        lm_pos[s] = lm_pos[feat_lm[i]]
        lm_id[s], lm_valid[s], lm_count[s] = 200000 + i, True, 1
        feat_lm[i] = s
    ms2 = ms._replace(kf_pose=kf_pose, lm_pos=lm_pos, lm_id=lm_id,
                      lm_valid=lm_valid, lm_obs_count=lm_count)
    return fs._replace(T_cur=T_cur, feat_lm=feat_lm), ms2, (rename, drop, dup)


def test_loop_hook_matches_reference_on_fabricated_revisit(reference_run):
    ref, cfg, rig, _ = reference_run
    fs, ms, arc = _np(ref.fs), _np(ref.ms), _np(ref.arc)
    ls0 = _np(jfl.empty_loop_state(64, cfg.max_features, 16))
    # keyframe 0 joins the empty database: no candidate, one host read
    (fs1, ms1, ls1), (pfs1, pms1, pls1), reads = _hooks(ls0, fs, ms, arc, 0,
                                                        rig[0])
    assert reads == {"hook.candidate": 1} and bool(ls1.db_valid[0])
    _hold(ls1, pls1, atol={"db_embed": 1e-3})
    _hold(ms1, pms1)
    # the revisit as keyframe 30: candidate, match, PnP, edge, fusion, merge
    fs2, ms2, (rename, drop, dup) = _revisit_state(fs1, ms1)
    (fs3, ms3, ls3), (pfs3, pms3, pls3), reads = _hooks(ls1, fs2, ms2, arc,
                                                        30, rig[0])
    assert reads == {"hook.candidate": 1, "hook.correction": 1}
    assert int(ls3.n_loops) == int(pls3.n_loops) == 1
    assert int(pls3.loop_i[0]) == 30 and int(pls3.loop_j[0]) == 0
    assert int(pls3.last_closed) == 30
    _hold(ls3, pls3, atol={"db_embed": 1e-3, "db_lm_pos": 1e-3,
                           "loop_info": 1e-3})
    _hold(fs3, pfs3)
    _hold(ms3, pms3, atol={"lm_pos": 1e-3})
    # the fusion undid the drift, and every merge case fired
    np.testing.assert_allclose(pfs3.T_cur.numpy(), fs1.T_cur, atol=2e-2)
    new_lm = pfs3.feat_lm.numpy()
    assert (new_lm[rename] == fs2.feat_lm[rename]).all()          # rewritten
    assert (pms3.lm_id.numpy()[new_lm[rename]]
            == ms1.lm_id[fs1.feat_lm[rename]]).sum() >= 8
    assert (new_lm[drop] >= 0).sum() >= 8                         # inserted
    assert (new_lm[dup] == fs1.feat_lm[dup]).sum() >= 8           # relinked
    # relinked duplicates left the table (their slots may hold inserted
    # landmarks now)
    gone = dup[new_lm[dup] == fs1.feat_lm[dup]]
    assert not np.isin(pms3.lm_id.numpy()[pms3.lm_valid.numpy()],
                       200000 + gone).any()


def test_merge_loop_landmarks_matches_reference(reference_run):
    """The landmark merge alone, on the reference run's map: candidate
    features matched to current features, their landmarks in the table
    (relink), renamed away (rewrite in place) or dropped with the feature
    unlinked (insert), and two candidates on one current feature (the lower
    index wins)."""
    ref, cfg, _, _ = reference_run
    fs, ms = _np(ref.fs), _np(ref.ms)
    F = fs.feat_lm.shape[0]
    linked = np.nonzero(fs.feat_valid & (fs.feat_lm >= 0))[0]
    feat_lm, lm_id, lm_valid = (fs.feat_lm.copy(), ms.lm_id.copy(),
                                ms.lm_valid.copy())
    relink, rename, insert = linked[:10], linked[10:20], linked[20:30]
    cand_id = lm_id[feat_lm[linked[:30]]].copy()
    cand_first = ms.lm_first_kf[feat_lm[linked[:30]]].copy()
    cand_pos = ms.lm_pos[feat_lm[linked[:30]]] + 0.25
    # relink: the features point at other (duplicate) slots
    free = np.nonzero(~lm_valid)[0]
    for i, s in zip(relink, free):
        lm_valid[s], lm_id[s], feat_lm[i] = True, 300000 + i, s
    lm_id[feat_lm[rename]] = 400000 + rename            # rewrite in place
    lm_valid[feat_lm[insert]] = False                   # insert and link
    feat_lm[insert] = -1
    Fc = F
    match_idx = np.zeros(Fc, np.int32)
    usable = np.zeros(Fc, bool)
    match_idx[:30], usable[:30] = linked[:30], True
    match_idx[30], usable[30] = linked[0], True         # a second claimant
    pos = np.zeros((Fc, 3), np.float32)
    ids = np.full(Fc, -1, np.int32)
    first = np.full(Fc, -1, np.int32)
    pos[:30], ids[:30], first[:30] = cand_pos, cand_id, cand_first
    pos[30], ids[30], first[30] = cand_pos[5], cand_id[5], cand_first[5]
    ms2 = ms._replace(lm_id=lm_id, lm_valid=lm_valid)
    kf_slot = int(np.argmax(np.where(ms.kf_valid, ms.kf_id, -1)))
    args = (feat_lm, fs.feat_valid, np.int32(kf_slot), match_idx, usable,
            pos, ids, first)
    mj, lj = jmapmod.merge_loop_landmarks(
        jax.tree.map(jnp.asarray, ms2), *(jnp.asarray(a) for a in args))
    mt, lt = mapmod.merge_loop_landmarks(
        convert.map_state(ms2), *(convert.tensor(a) for a in args[:2]),
        torch.tensor(kf_slot), *(convert.tensor(a) for a in args[3:]))
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    _hold(_np(mj), mt)
    lt = lt.numpy()
    assert (lt[relink] == fs.feat_lm[relink]).all()
    assert (lt[rename] == feat_lm[rename]).all()
    assert (mt.lm_id.numpy()[lt[rename]] == cand_id[10:20]).all()
    assert (lt[insert] >= 0).all()
    np.testing.assert_allclose(mt.lm_pos.numpy()[lt[insert]],
                               cand_pos[20:30], atol=1e-6)


def test_run_pgo_matches_reference(reference_run):
    ref, cfg, rig, poses = reference_run
    jl = jfl.FusedLoopVisualOdometry(cfg, JDataset(
        np.zeros((1, 120, 320), np.float32), np.zeros((1, 120, 320),
                                                       np.float32), list(rig)))
    jl.initialize()
    for a in ("fs", "ms", "arc", "kf_count", "out_buf", "_fids"):
        setattr(jl, a, getattr(ref, a))
    kf, _, _ = ref.drain()
    ids = sorted(kf)
    assert len(ids) >= 4
    # one loop edge last -> first: the relative pose from ground truth, an
    # information with one blind direction
    fa, fb = kf[ids[-1]][0], kf[ids[0]][0]
    rel = np.asarray(jse3.se3_compose(jnp.asarray(poses[fa]),
                                      jse3.se3_inverse(jnp.asarray(poses[fb]))))
    info = np.diag([1.0, 1.0, 1e-3, 1.0, 1.0, 0.5]).astype(np.float32)
    ls = jfl.empty_loop_state(jl.Tmax, cfg.max_features, 16)
    jl.ls = ls._replace(
        loop_i=ls.loop_i.at[0].set(ids[-1]), loop_j=ls.loop_j.at[0].set(ids[0]),
        loop_rel=ls.loop_rel.at[0].set(rel), loop_info=ls.loop_info.at[0].set(
            info), n_loops=jnp.int32(1))
    traj_j = jl.run_pgo()

    port = fused_loop.FusedLoopVisualOdometry(
        convert.slam_config(cfg), ArraySequenceDataset(
            np.zeros((1, 120, 320), np.float32),
            np.zeros((1, 120, 320), np.float32),
            [convert.camera(c) for c in rig]), device="cpu")
    port.initialize()
    port.fs, port.ms = convert.frontend_state(ref.fs), convert.map_state(ref.ms)
    port.arc, port.ls = convert.archive_state(ref.arc), convert.loop_state(jl.ls)
    port.kf_count = int(ref.kf_count)
    assert [(e.kf_id, e.loop_kf_id) for e in port.loop_edges()] == \
        [(e.kf_id, e.loop_kf_id) for e in jl.loop_edges()]
    traj_t = port.run_pgo()
    assert sorted(traj_t) == sorted(traj_j)
    moved = 0.0
    for f in traj_j:
        np.testing.assert_allclose(traj_t[f], traj_j[f], rtol=0, atol=1e-3)
        moved = max(moved, float(np.abs(traj_t[f] - kf_pose_of(kf, f)).max()))
    assert moved > 1e-3                  # the loop edge moved the poses
    assert sorted(port.pgo_landmarks) == sorted(jl._pgo_landmarks)
    for i, p in jl._pgo_landmarks.items():
        np.testing.assert_allclose(port.pgo_landmarks[i], p, rtol=2e-3,
                                   atol=1e-2)


def kf_pose_of(kf, frame_id):
    return next(p for f, p in kf.values() if f == frame_id)


def test_no_false_positive_on_straight_line():
    """The reference's straight-line test at 188x620 (tests/test_fused_loop
    .py), cut to 20 frames with the candidate skip cut to 12, so that 8
    keyframes scan the database, and with the bench's 12 LK iterations: a
    keyframe on every frame, the reference's default similarity gates, the
    thumbnail embedder; no loop may close, and tracking is unaffected."""
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(20, step=0.5, yaw_rate=0.0)
    lefts, rights = synthetic.render_textured_stereo_sequence(
        poses, H=188, W=620, rig=rig)
    cfg = convert.slam_config(JConfig(
        num_features_needed_for_keyframe=1000,
        keyframes_to_skip_in_candidate_search=12,
        potential_loop_strong_threshold=0.95,
        potential_loop_weak_threshold=0.92, max_num_weak_threshold=100,
        min_num_acceptable_keypoint_match=10, lk_max_iters=12))
    vo = fused_loop.FusedLoopVisualOdometry(
        cfg, ArraySequenceDataset(np.asarray(lefts), np.asarray(rights),
                                  [convert.camera(c) for c in rig]),
        max_total_keyframes=256, max_total_landmarks=1 << 14, device="cpu")
    vo.initialize()
    vo.run()
    assert vo.loop_edges() == []
    _, _, frames = vo.drain()
    assert min(int(f.n_inliers) for _, f in frames[1:]) > 10
    assert all(bool(f.kf_inserted) for _, f in frames)
    assert vo.hook_reads == 19           # one candidate-gate read a keyframe
    assert float(vo.ls.last_score) > 0.5


def test_loop_entry_points_default_to_the_card():
    """The loop path's entry points default to "cuda" and raise without a
    card unless the caller asks for the CPU; the parameters' structure
    picks the embedder (MobileNet-V2 for "stem")."""
    from stereovision_slam_torch.slam.config import SlamConfig

    assert place_net.get_params(device="cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            fused_loop.FusedLoopVisualOdometry(SlamConfig(), None)
        with pytest.raises(RuntimeError):
            place_net.get_params()
    from stereovision_slam_torch.models import mobilenet_v2 as mnv2
    params = mnv2.init_params(device="cpu")
    img = torch.rand((48, 160)) * 255.0
    assert torch.equal(fused_loop.embed(params, img),
                       mnv2.embed_image(params, img))
    assert fused_loop.embed(None, torch.zeros((48, 160))).shape == (
        fused_loop.EMBED_DIM,)
