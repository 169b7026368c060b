"""Port parity, multi-stream serving (slam/batched.py,
frontend.track_step_serving, slam/pose_solver.py, kernel B over streams).

The streams of tests/test_batched.py (96x320 textured worlds, F = 96) made
by the reference's renderer. Tolerances, each with its reason:
  * the LU pose solve against the reference's: pose within 1e-4, inlier
    sets equal (the same float32 LM steps, sums in another order);
  * kernel B's plain version over a stream axis against a loop over the
    streams: bit-equal (the same operations row by row);
  * `track_step_serving(pallas_mode="xla")` from one batched state carried
    across from the reference: counts, links and flags equal, features
    within 1e-3 px, poses within 1e-4 (LK sums in another order, amplified
    by the pose solve);
  * the folded tracking against the per-stream topology, on the port:
    the reference's own contract (tests/test_batched.py:177-230), poses
    within 1e-5, features within 1e-4 px, counts and flags equal;
  * the staggered run against ground truth: the reference's gates
    (tests/test_batched.py:147-174), >= 2 keyframes, keyframe ATE < 5% of
    each stream's path, n_inliers > 10 on every frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.ops import image as jimg
from stereovision_slam_tpu.slam import frontend as jfe
from stereovision_slam_tpu.slam import map_state as jmap
from stereovision_slam_tpu.slam import pose_solver as jps
from stereovision_slam_tpu.slam.fused import FusedVisualOdometry as JFused
from stereovision_slam_torch import convert
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.ops import image as timg
from stereovision_slam_torch.ops import pose_kernel as pk
from stereovision_slam_torch.parallel.mesh import make_ba_mesh
from stereovision_slam_torch.slam import batched as tb
from stereovision_slam_torch.slam import frontend as tfe
from stereovision_slam_torch.slam import pose_solver as tps
from stereovision_slam_torch.slam.fused import FusedVisualOdometry
from tests.test_batched import make_stream, small_config
from tests.test_torch_pose import _problem

# One intra-op thread: the suite runs in parallel worker processes, and
# several multi-threaded torch pools on the same cores slow these many small
# ops tenfold (a worker imports every test module, so this holds in all).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def streams():
    """Four streams of 16 frames, as numpy, with their ground truth."""
    out = []
    for s in range(4):
        (lefts, rights, rig), poses = make_stream(s, T=16)
        out.append(((np.array(lefts), np.array(rights), rig),
                    np.array(poses)))
    return out


def _datasets(streams, T):
    return [ArraySequenceDataset(l[:T], r[:T], [convert.camera(c)
                                                for c in rig])
            for (l, r, rig), _ in streams]


def test_lu_pose_solver_matches_reference():
    cams, _, pts, uv_l, uv_r, vl, vr, T_inits = _problem(seed=2)
    F = pts.shape[0]
    jcam = jfe._blend_obs_cameras(cams[0], cams[1], F, F)
    tcam = tfe._blend_obs_cameras(*(convert.camera(c) for c in cams), F, F)
    pts2, obs2 = np.concatenate([pts, pts]), np.concatenate([uv_l, uv_r])
    valid2 = np.concatenate([vl, vr])
    Tj, ij, nj = jps.solve_pose_multi(
        jcam, jnp.asarray(T_inits), jnp.asarray(pts2), jnp.asarray(obs2),
        jnp.asarray(valid2), chi2_th=5.991, rounds=3, iters=6)
    Tt, it, nt = tps.solve_pose_multi(
        tcam, *(convert.tensor(x) for x in (T_inits, pts2, obs2, valid2)),
        chi2_th=5.991, rounds=3, iters=6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(nt) == int(nj) and not it[:6].any()


def test_pose_kernel_plain_over_streams_equals_loop():
    probs = [_problem(seed=s) for s in range(3)]
    camp = pk.camera_block(*(convert.camera(c) for c in probs[0][0]))
    args = [tuple(convert.tensor(x) for x in p[2:8]) for p in probs]
    kw = dict(chi2_th=5.991, rounds=3, iters=6)
    batched = pk.pose_lm_plain(camp, *(torch.stack(a) for a in zip(*args)),
                               **kw)
    for b, a in enumerate(args):
        for got, want in zip(batched, pk.pose_lm_plain(camp, *a, **kw)):
            assert torch.equal(got[b], want)
    # the pose entry point picks each stream's best start
    T, inl, n = pk.solve_pose_multi_lr(
        camp, *(convert.tensor(np.stack(x)) for x in (
            [p[7] for p in probs], [p[2] for p in probs],
            [p[3] for p in probs], [p[4] for p in probs],
            [p[5] for p in probs], [p[6] for p in probs])), **kw)
    for b, p in enumerate(probs):
        Tb, ib, nb = pk.solve_pose_multi_lr(
            camp, *(convert.tensor(x) for x in (p[7], p[2], p[3], p[4],
                                                p[5], p[6])), **kw)
        assert torch.equal(T[b], Tb) and torch.equal(inl[b], ib)
        assert int(n[b]) == int(nb)


def _snapshot(state):
    return type(state)(*(tuple(np.array(lv) for lv in v)
                         if isinstance(v, tuple) else np.array(v)
                         for v in state))


def _stack_np(states):
    return type(states[0])(*(
        tuple(np.stack(lv) for lv in zip(*vs)) if isinstance(vs[0], tuple)
        else np.stack(vs) for vs in zip(*states)))


def test_serving_xla_arm_matches_reference(streams):
    """B = 2 streams, each run 5 frames by the reference; the stacked state
    goes to both packages, which take frame 5 with the per-level LK and the
    LU pose solve."""
    fs_list, ms_list = [], []
    for (lefts, rights, rig), _ in streams[:2]:
        vo = JFused(small_config(), JDataset(lefts[:6], rights[:6], rig),
                    max_total_keyframes=64, max_total_landmarks=2048)
        vo.initialize()
        for _ in range(5):
            vo.step()
        fs_list.append(_snapshot(vo.fs))
        ms_list.append(_snapshot(vo.ms))
    fs, ms = _stack_np(fs_list), _stack_np(ms_list)
    rig = streams[0][0][2]
    frames = [(s[0][0][5], s[0][1][5]) for s in streams[:2]]
    jp = [jnp.stack(lv) for lv in zip(*(jimg.build_pyramid(jnp.asarray(l), 4)
                                        for l, _ in frames))]
    jr = [jnp.stack(lv) for lv in zip(*(jimg.build_pyramid(jnp.asarray(r), 4)
                                        for _, r in frames))]
    kw = dict(chi2_th=5.991, rounds=3, iters=6, lk_iters=12,
              pallas_mode="xla")
    # jitted: the eager reference takes twice as long on the CPU
    serving = jax.jit(functools.partial(jfe.track_step_serving, **kw))
    jfs, jn, jt = serving(
        jfe.FrontendState(*(tuple(jnp.asarray(lv) for lv in v)
                            if isinstance(v, tuple) else jnp.asarray(v)
                            for v in fs)),
        jmap.MapState(*(jnp.asarray(v) for v in ms)), tuple(jp), rig[0],
        tuple(jr), rig[1])
    tp = timg.build_pyramid(torch.from_numpy(np.stack([l for l, _ in frames])),
                            4)
    tr = timg.build_pyramid(torch.from_numpy(np.stack([r for _, r in frames])),
                            4)
    tfs, tn, tt = tfe.track_step_serving(
        convert.frontend_state(fs), convert.map_state(ms), tuple(tp),
        convert.camera(rig[0]), tuple(tr), convert.camera(rig[1]), **kw)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tn.min() > 30
    on = np.asarray(jfs.feat_valid)
    np.testing.assert_array_equal(tfs.feat_valid.numpy(), on)
    np.testing.assert_array_equal(tfs.feat_lm.numpy(), np.asarray(jfs.feat_lm))
    np.testing.assert_allclose(tfs.feat_uv.numpy()[on],
                               np.asarray(jfs.feat_uv)[on], atol=1e-3)
    np.testing.assert_allclose(tfs.T_cur.numpy(), np.asarray(jfs.T_cur),
                               atol=1e-4)


def test_fold_matches_per_stream_topology(streams):
    B = 3
    cfg = convert.slam_config(small_config())
    bvo = tb.BatchedFusedVisualOdometry(
        cfg, _datasets(streams[:B], 6), max_total_keyframes=64,
        max_total_landmarks=2048, kf_stagger=B, device="cpu")
    bvo.initialize()
    for _ in range(3):
        bvo.step()
    lefts = torch.from_numpy(np.stack([s[0][0][4] for s in streams[:B]]))
    rights = torch.from_numpy(np.stack([s[0][1][4] for s in streams[:B]]))
    statics = dict(
        num_levels=cfg.lk_num_levels, num_features=cfg.num_features,
        min_distance=cfg.gftt_min_distance,
        quality_level=cfg.gftt_quality_level,
        max_depth=cfg.max_triangulation_depth,
        num_active=cfg.num_active_keyframes,
        kf_threshold=cfg.num_features_needed_for_keyframe,
        bad_threshold=cfg.num_features_tracking_bad, chi2_th=cfg.chi2_th,
        backend_on=True, ba_iters=4, ba_max_active=None, m=1, lk_iters=12,
        pose_rounds=3, pose_iters=6)
    outs = {}
    for fold in (True, False):
        outs[fold] = tb.batched_staggered_step(
            bvo.fs, bvo.ms, bvo.arc, bvo.kf_count, lefts, rights, [4] * B, 0,
            bvo.cam_left, bvo.cam_right, fold_tracks=fold, **statics)
    fa, _, _, _, oa = outs[True]
    fb, _, _, _, ob = outs[False]
    torch.testing.assert_close(fa.T_cur, fb.T_cur, rtol=0, atol=1e-5)
    assert torch.equal(oa.n_inliers, ob.n_inliers)
    torch.testing.assert_close(fa.feat_uv, fb.feat_uv, rtol=0, atol=1e-4)
    assert torch.equal(fa.feat_valid, fb.feat_valid)


def test_staggered_serving_tracks_ground_truth(streams):
    """kf_stagger = B = 4: each stream's keyframe branch runs every fourth
    frame, and every stream still tracks its ground truth."""
    B, T = 4, 16
    bvo = tb.BatchedFusedVisualOdometry(
        convert.slam_config(small_config()), _datasets(streams, T),
        max_total_keyframes=64, max_total_landmarks=2048, kf_stagger=4,
        device="cpu")
    bvo.initialize()
    bvo.run()
    outputs = bvo.outputs
    for b, (((_, _, _), poses), traj) in enumerate(zip(streams,
                                                       bvo.trajectories())):
        assert len(traj) >= 2, f"stream {b}: no keyframes inserted"
        errs = [np.linalg.norm(-pose[:, :3].T @ pose[:, 3]
                               + poses[f][:, :3].T @ poses[f][:, 3])
                for f, pose in traj.items()]
        ate = float(np.sqrt(np.mean(np.square(errs))))
        dist = (0.35 + 0.05 * b) * T
        assert ate < 0.05 * dist, f"stream {b}: ATE {ate:.3f} of {dist} m"
        n_in = [int(o.n_inliers) for _, o in outputs[b]]
        assert len(n_in) == T - 1 and min(n_in) > 10, f"stream {b}: {n_in}"
        # a keyframe is inserted only on the stream's scheduled frames
        ins = [i for i, (_, o) in enumerate(outputs[b]) if o.kf_inserted]
        assert all(i % 4 == b for i in ins)
        assert len(ins) == len(traj) - 1


def test_per_frame_batched_matches_single_streams(streams):
    """kf_stagger = 0: the exact per-frame step, stream by stream, gives
    each stream's single-stream run (streams that never go LOST)."""
    _hold_batched_to_single_streams(streams, small_config())


def test_per_frame_batched_orb_matches_single_streams(streams):
    """The same with FAST corners (`keypoint_feature_detector: ORB`) in
    the batched keyframe branch."""
    cfg = small_config()
    cfg.keypoint_feature_detector = "ORB"
    _hold_batched_to_single_streams(streams, cfg)


def _hold_batched_to_single_streams(streams, ref_cfg):
    T = 8
    cfg = convert.slam_config(ref_cfg)
    bvo = tb.BatchedFusedVisualOdometry(
        cfg, _datasets(streams[:2], T), max_total_keyframes=64,
        max_total_landmarks=2048, device="cpu")
    bvo.initialize()
    bvo.run()
    for ds, batched in zip(_datasets(streams[:2], T), bvo.trajectories()):
        vo = FusedVisualOdometry(cfg, ds, max_total_keyframes=64,
                                 max_total_landmarks=2048, device="cpu")
        vo.initialize()
        vo.run()
        keyframes, _, _ = vo.drain()
        single = {f: p for f, p in keyframes.values()}
        assert set(single) == set(batched) and len(single) >= 2
        for f in single:
            np.testing.assert_allclose(batched[f], single[f], atol=1e-5)


def test_mesh_raises(streams):
    cfg = convert.slam_config(small_config())
    with pytest.raises(ValueError, match="kf_stagger"):
        tb.BatchedFusedVisualOdometry(
            cfg, _datasets(streams[:2], 4), kf_stagger=2,
            mesh=make_ba_mesh(2, device="cpu"), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tb.BatchedFusedVisualOdometry(
            cfg, _datasets(streams[:2], 4), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tb.BatchedFusedVisualOdometry(
            convert.slam_config(small_config()), _datasets(streams[:3], 4),
            kf_stagger=2, device="cpu")


def test_batched_mesh_requires_divisible_batch(streams):
    """The counterpart of tests/test_batched.py's: 3 streams over 8 ranks."""
    with pytest.raises(ValueError, match="divide"):
        tb.BatchedFusedVisualOdometry(
            convert.slam_config(small_config()), _datasets(streams[:3], 4),
            mesh=make_ba_mesh(8, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def mesh_runs(streams):
    """tests/test_batched.py's sharded case: 8 streams (stream s is world
    s % 4) of 8 frames, per-frame step, through the port unsharded and over
    an 8-rank CPU mesh."""
    T = 8

    def port(mesh):
        vo = tb.BatchedFusedVisualOdometry(
            convert.slam_config(small_config()),
            _datasets(streams, T) + _datasets(streams, T),
            max_total_keyframes=64, max_total_landmarks=2048, mesh=mesh,
            device="cpu")
        vo.initialize()
        vo.run()
        return vo

    return port(None), port(make_ba_mesh(8, device="cpu"))


def test_batched_mesh_sharded_matches_unsharded(streams, mesh_runs):
    """Streams are independent: each rank's sub-batch steps exactly as the
    unsharded batch does, so the two agree bit for bit (the reference holds
    its sharded run to 1e-3 of its unsharded one, its partitioned programs
    reordering float operations). Here a whole run is not held to the
    reference's: on the CPU the reference tracks with its full-image LK
    and the port with its windowed lanes LK, and they part from the first
    frame (1.5e-3 to 4.5e-2 apart on these streams). The reference's mesh
    run with its lanes LK interpreted is held to the port's at 1e-3 by
    `python -m tests.torch_serving_mesh_reference`, whose reference run
    takes minutes of the CPU (ROADMAP.md queue 3). Each stream is held to
    its ground truth instead, as `test_staggered_serving_tracks_ground_
    truth` holds it."""
    plain, sharded = mesh_runs
    T = 8
    assert [sh.streams for sh in sharded.shards] == [range(b, b + 1)
                                                     for b in range(8)]
    assert len(sharded.fs.T_cur) == 8 and len(sharded.kf_count) == 8
    for s, (a, b) in enumerate(zip(plain.trajectories(),
                                   sharded.trajectories())):
        assert set(a) == set(b) and len(a) >= 2
        for fid in a:
            np.testing.assert_array_equal(b[fid], a[fid])
        poses = streams[s % 4][1]
        errs = [np.linalg.norm(-p[:, :3].T @ p[:, 3]
                               + poses[f][:, :3].T @ poses[f][:, 3])
                for f, p in b.items()]
        dist = (0.35 + 0.05 * (s % 4)) * T
        assert np.sqrt(np.mean(np.square(errs))) < 0.05 * dist
    for oa, ob in zip(plain.outputs, sharded.outputs):
        assert [int(o.n_inliers) for _, o in oa] == \
            [int(o.n_inliers) for _, o in ob]
        assert all(o.n_inliers > 10 for _, o in ob)
