"""Port parity, the classic pipeline's loop closure (`slam/loop_closure.py`),
mirroring tests/test_loop_closure.py with the inputs carried across from
the reference: candidate gating, a closure on a fabricated revisit (PnP,
the pose gates, the edge, LocalFusion and the landmark merge), and the
shutdown PGO of `stop`; plus the embedder resolution and the window
write-back after PGO, which the port adds.

Tolerances: decisions, ids and slots equal; poses within 1e-4 and
landmarks within 1e-3 m (PnP's LM solves sum in another order); PGO within
the roadmap's 5e-2 (CG's stopping test flips with rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.geometry import jacobians as jjac
from stereovision_slam_tpu.geometry import se3 as jse3
from stereovision_slam_tpu.ops import descriptors as jdesc
from stereovision_slam_tpu.slam import frontend as jfe
from stereovision_slam_tpu.slam import loop_closure as jlc
from stereovision_slam_tpu.slam import map_state as jmap
from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
from stereovision_slam_tpu.slam.pipeline import KeyframeRecord as JRecord
from stereovision_slam_torch import convert
from stereovision_slam_torch.slam import loop_closure as tlc
from stereovision_slam_torch.slam import map_state as tmap
from stereovision_slam_torch.slam.pipeline import KeyframeRecord
from tests import synthetic
from tests.test_loop_closure import FakeVO, make_entry, unit_vec

torch.set_num_threads(1)

PGO_TOL = 5e-2


def _port_entry(entry):
    return tlc.ProcessedKeyframe(**dataclasses.asdict(entry))


def _pair(cfg, embedder="thumbnail"):
    left, _ = synthetic.make_stereo_rig()
    ref = jlc.LoopClosure(cfg, left, embedder=embedder)
    port = tlc.LoopClosure(convert.slam_config(cfg), convert.camera(left),
                           embedder=embedder)
    return ref, port


def test_candidate_gating_matches_reference():
    ref, port = _pair(JConfig(keyframes_to_skip_in_candidate_search=5))
    e0 = unit_vec(0)
    near = e0 + 0.01 * unit_vec(9)
    queries = [make_entry(3, e0), make_entry(30, near / np.linalg.norm(near)),
               make_entry(31, unit_vec(5))]
    db = {0: make_entry(0, e0), 1: make_entry(1, unit_vec(1))}

    def scan():
        out = []
        for q in queries:
            a = ref._find_candidate(q)
            b = port._find_candidate(_port_entry(q))
            out.append(None if a is None else a.kf_id)
            assert (None if b is None else b.kf_id) == out[-1]
            assert port.last_deep_score == pytest.approx(ref.last_deep_score,
                                                         abs=1e-6)
        return out
    for k, e in db.items():
        ref.db[k], port.db[k] = e, _port_entry(e)
    assert scan() == [None, 0, None]        # recent skipped, far found
    # weak-threshold flooding: too many similar keyframes
    for k in range(2, 8):
        e = make_entry(k, e0)
        ref.db[k], port.db[k] = e, _port_entry(e)
    assert scan() == [None, None, None]


def test_embedder_resolution(tmp_path):
    cam = convert.camera(synthetic.make_stereo_rig()[0])
    cfg = convert.slam_config(JConfig())
    assert tlc.LoopClosure(cfg, cam).embedder == "placenet"   # 'auto'
    assert tlc.LoopClosure(cfg, cam, embedder="thumbnail").params is None
    # a weights file makes 'auto' take MobileNet-V2, as the reference does
    from stereovision_slam_torch.models import onnx_reader
    from tests.torch_mnv2_weights import state_dict
    onnx = tmp_path / "mobilenet_v2.onnx"
    onnx_reader.write_onnx_initializers(str(onnx), state_dict(0))
    lc = tlc.LoopClosure(cfg, cam, mnv2_weights_path=str(onnx))
    assert lc.embedder == "mobilenet" and "stem" in lc.params
    assert tlc.LoopClosure(cfg, cam, embedder="mobilenet").embedder == \
        "mobilenet"
    with pytest.raises(ValueError):
        tlc.LoopClosure(cfg, cam, embedder="sift")


def _revisit():
    """The reference test's fabricated revisit, as numpy: the candidate
    keyframe 0 at identity, the current keyframe 30 whose estimate drifted
    by ~2 m, its map (one keyframe, drifted landmarks) and state."""
    left, _ = synthetic.make_stereo_rig()
    F, n = 96, 48
    lms = synthetic.random_landmarks(jax.random.PRNGKey(0), n)
    amps = jnp.asarray(80.0 + 170.0 * ((jnp.arange(n) * 0.731) % 1.0))
    uv0, _ = jjac.project_points(left, jse3.se3_identity(), lms)
    img0 = synthetic.render_blobs(uv0, 188, 620, sigma=2.2, amplitudes=amps,
                                  distinct=True)
    uv0_pad = jnp.zeros((F, 2)).at[:n].set(uv0)
    valid = jnp.zeros((F,), bool).at[:n].set(True)
    d0, ok0 = jdesc.compute(img0, uv0_pad, valid)
    cand = jlc.ProcessedKeyframe(
        kf_id=0, frame_id=0, embedding=unit_vec(0), desc=np.asarray(d0),
        desc_ok=np.asarray(ok0), feat_uv=np.asarray(uv0_pad),
        lm_pos=np.asarray(jnp.zeros((F, 3)).at[:n].set(lms)),
        lm_has=np.asarray(valid),
        lm_id=np.where(np.asarray(valid), 1000 + np.arange(F), -1).astype(
            np.int32),
        lm_first_kf=np.where(np.asarray(valid), 0, -1).astype(np.int32),
        pose=np.asarray(jse3.se3_identity()))
    T_true = jse3.se3_exp(jnp.array([0.2, 0.0, 0.3, 0.0, 0.02, 0.0]))
    T_drift = jse3.se3_compose(
        jse3.se3_exp(jnp.array([1.5, 0.3, -1.0, 0.0, 0.05, 0.0])), T_true)
    uv1, _ = jjac.project_points(left, T_true, lms)
    img1 = synthetic.render_blobs(uv1, 188, 620, sigma=2.2, amplitudes=amps,
                                  distinct=True)
    uv1_pad = jnp.zeros((F, 2)).at[:n].set(uv1)
    d1, ok1 = jdesc.compute(img1, uv1_pad, valid)
    m = jmap.empty_map(8, F, 256)
    D = jse3.se3_compose(jse3.se3_inverse(T_true), T_drift)
    m, slots = jmap.add_landmarks(
        m, jnp.zeros((F, 3)).at[:n].set(jse3.se3_apply(jse3.se3_inverse(D),
                                                      lms)),
        valid, jnp.asarray(30))
    feat_lm = jnp.where(valid, slots, -1)
    m, _ = jmap.insert_keyframe(m, T_drift, jnp.asarray(30), jnp.asarray(30),
                                uv1_pad, uv1_pad, feat_lm, valid, valid,
                                num_active=8)
    fs = jfe.FrontendState(T_cur=T_drift, T_rel=jse3.se3_identity(),
                           feat_uv=uv1_pad, feat_lm=feat_lm,
                           feat_valid=valid, pyr=(img1,), ref_uv=uv1_pad,
                           ref_pyr=(img1,))
    entry = jlc.ProcessedKeyframe(
        kf_id=30, frame_id=30, embedding=unit_vec(0), desc=np.asarray(d1),
        desc_ok=np.asarray(ok1), feat_uv=np.asarray(uv1_pad),
        lm_pos=np.zeros((F, 3), np.float32), lm_has=np.zeros(F, bool),
        lm_id=np.full(F, -1, np.int32), lm_first_kf=np.full(F, -1, np.int32),
        pose=np.asarray(T_drift))
    np_ = lambda x: type(x)(*(tuple(np.array(v) for v in f)   # noqa: E731
                              if isinstance(f, tuple) else np.array(f)
                              for f in x))
    return cand, entry, np_(fs), np_(m), np.asarray(slots[:n]), T_true, lms


def test_closure_on_fabricated_revisit_matches_reference():
    cand, entry, fs, ms, slots, T_true, lms = _revisit()
    cfg = JConfig(keyframes_to_skip_in_candidate_search=5,
                  min_num_acceptable_keypoint_match=11)
    ref, port = _pair(cfg)
    jvo, tvo = FakeVO(), FakeVO()
    jvo.kf_count = tvo.kf_count = 30
    jvo.fs = jfe.FrontendState(*(tuple(jnp.asarray(v) for v in f)
                                 if isinstance(f, tuple) else jnp.asarray(f)
                                 for f in fs))
    jvo.ms = jmap.MapState(*(jnp.asarray(v) for v in ms))
    tvo.fs, tvo.ms = convert.frontend_state(fs), convert.map_state(ms)
    jvo.archived_keyframes[30] = JRecord(frame_id=30, kf_id=30,
                                         pose=fs.T_cur.copy())
    tvo.archived_keyframes[30] = KeyframeRecord(frame_id=30, kf_id=30,
                                                pose=fs.T_cur.copy())
    # the port's copies first: the reference's closure rewrites its entry
    t_entry, t_cand = _port_entry(entry), _port_entry(cand)
    ref._attempt_closure(jvo, entry, cand)
    port._attempt_closure(tvo, t_entry, t_cand)

    assert [(e.kf_id, e.loop_kf_id) for e in port.loop_edges] == \
        [(e.kf_id, e.loop_kf_id) for e in ref.loop_edges] == [(30, 0)]
    assert port.last_closed_kf_id == ref.last_closed_kf_id == 30
    np.testing.assert_allclose(port.loop_edges[0].relative_pose,
                               ref.loop_edges[0].relative_pose, atol=1e-4)
    # the port weights the edge by its PnP information, as the fused path
    # does: symmetric, positive semi-definite, largest eigenvalue 1 (to
    # the 8 power-iteration steps that estimate it)
    info = port.loop_edges[0].info
    np.testing.assert_allclose(info, info.T, atol=1e-5)
    ev = np.linalg.eigvalsh(info.astype(np.float64))
    assert ev.min() > -1e-5 and abs(ev.max() - 1.0) < 2e-2
    np.testing.assert_allclose(tvo.fs.T_cur.numpy(), np.asarray(jvo.fs.T_cur),
                               atol=1e-4)
    np.testing.assert_allclose(tvo.archived_keyframes[30].pose,
                               jvo.archived_keyframes[30].pose, atol=1e-4)
    np.testing.assert_array_equal(tvo.fs.feat_lm.numpy(),
                                  np.asarray(jvo.fs.feat_lm))
    for f in ("lm_id", "lm_valid", "lm_first_kf", "kf_valid", "kf_id"):
        np.testing.assert_array_equal(getattr(tvo.ms, f).numpy(),
                                      np.asarray(getattr(jvo.ms, f)), f)
    np.testing.assert_allclose(tvo.ms.kf_pose.numpy(),
                               np.asarray(jvo.ms.kf_pose), atol=1e-4)
    np.testing.assert_allclose(tvo.ms.lm_pos.numpy(),
                               np.asarray(jvo.ms.lm_pos), atol=1e-3)
    # the reference test's own bars, on the port
    assert float(jse3.se3_distance(jnp.asarray(tvo.fs.T_cur.numpy()),
                                   T_true)) < 0.1
    np.testing.assert_allclose(tvo.ms.lm_pos.numpy()[slots], np.asarray(lms),
                               atol=0.3)
    assert int(np.sum(tvo.ms.lm_id.numpy()[slots] >= 1000)) >= 11


def _drifted_line(n: int = 30):
    """The reference test's drifted straight line of n keyframes, the true
    last-to-first loop edge, and one landmark anchored at the last one."""
    rng = np.random.default_rng(0)
    gt = [np.asarray(jse3.se3_identity())]
    est = [np.asarray(jse3.se3_identity())]
    step = np.asarray(jse3.se3_exp(jnp.array([0, 0, -0.5, 0, 0, 0.0])))
    for _ in range(1, n):
        gt.append(np.asarray(jse3.se3_compose(jnp.asarray(step),
                                              jnp.asarray(gt[-1]))))
        noisy = np.asarray(jse3.se3_compose(jse3.se3_exp(jnp.asarray(
            rng.normal(0, 0.01, 6), dtype=jnp.float32)), jnp.asarray(step)))
        est.append(np.asarray(jse3.se3_compose(jnp.asarray(noisy),
                                               jnp.asarray(est[-1]))))
    true_rel = np.asarray(jse3.se3_compose(
        jnp.asarray(gt[-1]), jse3.se3_inverse(jnp.asarray(gt[0]))))
    return gt, est, true_rel


def _fill(vo, lc, est, true_rel, record, edge):
    n = len(est)
    for k in range(n):
        rel = None if k == 0 else np.asarray(jse3.se3_compose(
            jnp.asarray(est[k]), jse3.se3_inverse(jnp.asarray(est[k - 1]))))
        vo.archived_keyframes[k] = record(frame_id=k, kf_id=k, pose=est[k],
                                          rel_to_prev=rel)
    lc.loop_edges.append(edge(kf_id=n - 1, loop_kf_id=0,
                              relative_pose=true_rel))
    vo.archived_landmarks[7] = np.array([1.0, 0.0, 5.0], np.float32)
    vo.archived_landmark_first_kf[7] = n - 1


def test_stop_matches_reference_pgo():
    gt, est, true_rel = _drifted_line()
    ref, port = _pair(JConfig())
    jvo, tvo = FakeVO(), FakeVO()
    _fill(jvo, ref, est, true_rel, JRecord, jlc.LoopEdge)
    _fill(tvo, port, est, true_rel, KeyframeRecord, tlc.LoopEdge)
    ref.stop(jvo)
    port.stop(tvo)
    assert port.pgo_ran and ref.pgo_ran
    for k, rec in jvo.archived_keyframes.items():
        np.testing.assert_allclose(tvo.archived_keyframes[k].pose, rec.pose,
                                   atol=PGO_TOL)
    np.testing.assert_allclose(tvo.archived_landmarks[7],
                               jvo.archived_landmarks[7], atol=PGO_TOL)
    n = len(est)
    before = np.linalg.norm(est[-1][:, 3] - gt[-1][:, 3])
    after = np.linalg.norm(tvo.archived_keyframes[n - 1].pose[:, 3]
                           - gt[-1][:, 3])
    assert after < 0.5 * before
    assert not np.allclose(tvo.archived_landmarks[7], [1.0, 0.0, 5.0])


def test_stop_writes_back_the_window():
    """After PGO the active window holds the optimized poses and
    landmarks, so that folding it into the archives again keeps them."""
    gt, est, true_rel = _drifted_line()
    _, port = _pair(JConfig())
    vo = FakeVO()
    _fill(vo, port, est, true_rel, KeyframeRecord, tlc.LoopEdge)
    n, K = len(est), 4
    ms = tmap.empty_map(K, 8, 16)
    ids = torch.arange(n - K, n, dtype=torch.int32)
    lm_valid = torch.zeros(16, dtype=torch.bool)
    lm_valid[3] = True
    lm_id = torch.full((16,), -1, dtype=torch.int32)
    lm_id[3] = 7
    vo.ms = ms._replace(
        kf_valid=torch.ones(K, dtype=torch.bool), kf_id=ids,
        kf_pose=torch.from_numpy(np.stack(est[n - K:])),
        lm_valid=lm_valid, lm_id=lm_id)
    port.stop(vo)
    for s in range(K):
        np.testing.assert_array_equal(
            vo.ms.kf_pose[s].numpy(), vo.archived_keyframes[n - K + s].pose)
    np.testing.assert_array_equal(vo.ms.lm_pos[3].numpy(),
                                  vo.archived_landmarks[7])
    assert not np.allclose(vo.ms.kf_pose[-1].numpy(), est[-1], atol=1e-3)
