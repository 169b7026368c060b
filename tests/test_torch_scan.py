"""The chunked modes (`ScanVisualOdometry`, `UnrolledVisualOdometry`,
`ScanLoopVisualOdometry`), the branch split of `fused_step` and the
device-scalar ids they rest on (the counterpart of tests/test_scan_mode.py).

On the CPU the graph runner calls the branch functions directly and makes
their writes into the static state, so a chunked run must equal the eager
`FusedVisualOdometry` bit for bit: that tests the split, the ids as
tensors and the runner's writes. Against the JAX package the chunked modes
are held with the tolerances of tests/test_torch_slice.py (the reference's
CPU route is its full-image LK and LU pose solve: the same keyframes,
inliers within 3, keyframe poses within 2e-3, ATEs within 2e-3 m) and of
tests/test_torch_loop_hook.py (the hook). `capture_lint` checks on the
CPU that nothing in the captured functions would refuse a capture on the
card.
"""

import contextlib
import dataclasses
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDataset
from stereovision_slam_tpu.slam.fused import ScanVisualOdometry as JScan
from stereovision_slam_tpu.utils.evaluation import ate_rmse
from stereovision_slam_torch import convert
from stereovision_slam_torch.geometry import se3
from stereovision_slam_torch.io.dataset import ArraySequenceDataset
from stereovision_slam_torch.models import place_net
from stereovision_slam_torch.ops import (descriptors, lk, lk_lanes, matching,
                                         pose_kernel, prng)
from stereovision_slam_torch.slam import fused, fused_loop, graphs
from stereovision_slam_torch.slam import frontend as fe
from stereovision_slam_torch.slam import map_state as mapmod
from stereovision_slam_torch.slam import pose_graph
from stereovision_slam_torch.slam.pnp import pnp_ransac
from tests.test_pipeline_frontend import small_config
from tests.test_torch_loop_hook import (GATES, _hold, _hooks, _np,  # noqa: F401
                                        _revisit_state, reference_run)
from tests.test_torch_slice import scene  # noqa: F401  (module fixture)

torch.set_num_threads(1)

# the kernels' plain versions stand in for kernels A and B on the CPU; the
# lint watches what the captured functions do around them
PLAIN = [(lk_lanes, "lk_pyramid"), (pose_kernel, "pose_lm"),
         (lk, "_track_level")]


class _Lint(TorchDispatchMode):
    """Records the operators that a CUDA graph capture refuses."""

    BAD = {"nonzero", "masked_select", "masked_scatter", "_unique2",
           "unique_dim", "unique_consecutive", "_linalg_check_errors",
           "_linalg_eigh", "linalg_eigh", "repeat_interleave", "item"}

    def __init__(self, found: list):
        super().__init__()
        self.found = found
        self.host: list = []            # tensors built from host data
        self.paused = 0

    def flag(self, what: str) -> None:
        frames = [f for f in traceback.extract_stack()[:-2]
                  if "stereovision_slam_torch" in f.filename]
        self.found.append((what, "".join(traceback.format_list(
            frames[-6:]))))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        name = func._schema.name.split("::")[-1]
        if name == "lift_fresh":
            self.host.append(out)
        elif name == "_local_scalar_dense":
            if not any(args[0] is h for h in self.host):
                self.flag("a device->host read (item, int, bool, float of "
                          "a tensor, or a 0-d tensor used as an index)")
        elif name == "copy_" and any(args[1] is h for h in self.host):
            self.flag("a copy of host data into a tensor (x[i] = a Python "
                      "number)")
        elif name in self.BAD:
            self.flag(f"{name}: an output sized by the data, or a result "
                      "checked on the host")
        elif name in ("index", "index_put", "index_put_") and any(
                torch.is_tensor(i) and i.dtype == torch.bool
                for i in (args[1] or ())):
            self.flag(f"{name} with a boolean mask")
        return out


@contextlib.contextmanager
def capture_lint(found: list, paused=()):
    """While active, every operator that would break a CUDA graph capture
    on the card is appended to `found` as (what, stack): host reads,
    `torch.tensor`/`torch.as_tensor` of host data with a `device=`, outputs
    sized by the data, host-checked linear algebra. The functions in
    `paused`, (module, name) pairs, run unwatched: the kernels' plain
    versions, which stand in for the kernels on the CPU."""
    mode = _Lint(found)

    def watch_new(fn):
        def new(data, *a, **kw):
            if not mode.paused and kw.get("device") is not None \
                    and not torch.is_tensor(data):
                mode.flag(f"{fn.__name__} of host data with device=")
            return fn(data, *a, **kw)
        return new

    def unwatched(fn):
        def call(*a, **kw):
            mode.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                mode.paused -= 1
        return call

    saved = [(torch, "tensor", torch.tensor),
             (torch, "as_tensor", torch.as_tensor)]
    saved += [(mod, name, getattr(mod, name)) for mod, name in paused]
    torch.tensor = watch_new(torch.tensor)
    torch.as_tensor = watch_new(torch.as_tensor)
    for mod, name in paused:
        setattr(mod, name, unwatched(getattr(mod, name)))
    try:
        with mode:
            yield mode
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _port(cls, scene, cfg=None, **kw):  # noqa: F811
    lefts, rights, rig, _ = scene
    vo = cls(convert.slam_config(cfg or small_config()),
             ArraySequenceDataset(lefts, rights,
                                  [convert.camera(c) for c in rig]),
             device="cpu", **kw)
    vo.initialize()
    return vo


@pytest.fixture(scope="module")
def eager(scene):  # noqa: F811
    vo = _port(fused.FusedVisualOdometry, scene)
    vo.run()
    return vo


def _assert_same_run(a, b):
    for name in ("fs", "ms", "arc"):
        for x, y in zip(graphs.leaves(getattr(a, name)),
                        graphs.leaves(getattr(b, name))):
            assert torch.equal(x, y), name
    assert a.kf_count == b.kf_count
    oa, ob = a.outputs, b.outputs
    assert [f for f, _ in oa] == [f for f, _ in ob]
    for (_, p), (_, q) in zip(oa, ob):
        for u, v in zip(p, q):
            assert np.array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("cls,chunk", [(fused.ScanVisualOdometry, 4),
                                       (fused.ScanVisualOdometry, 5),
                                       (fused.ScanVisualOdometry, 32),
                                       (fused.UnrolledVisualOdometry, 5)])
def test_chunked_equals_eager(scene, eager, cls, chunk):  # noqa: F811
    vo = _port(cls, scene, chunk_size=chunk)
    vo.run()
    _assert_same_run(eager, vo)
    kf_e, lm_e, _ = eager.drain()
    kf_s, lm_s, _ = vo.drain()
    assert sorted(kf_s) == sorted(kf_e) and sorted(lm_s) == sorted(lm_e)


def test_scan_matches_reference_scan(scene, eager):  # noqa: F811
    lefts, rights, rig, poses = scene
    ref = JScan(small_config(), JDataset(lefts, rights, list(rig)),
                chunk_size=4)
    ref.initialize()
    ref.run()
    kf_j, lm_j, out_j = ref.drain()
    vo = _port(fused.ScanVisualOdometry, scene, chunk_size=4)
    vo.run()
    kf_t, lm_t, out_t = vo.drain()
    est_j = {fid: p for fid, p in kf_j.values()}
    est_t = {fid: p for fid, p in kf_t.values()}
    assert sorted(est_t) == sorted(est_j) and len(est_t) >= 2
    n_j = np.array([int(o.n_inliers) for _, o in out_j])
    n_t = np.array([int(o.n_inliers) for _, o in out_t])
    assert np.abs(n_j - n_t).max() <= 3, (n_j, n_t)
    assert [bool(o.kf_inserted) for _, o in out_t] == \
        [bool(o.kf_inserted) for _, o in out_j]
    assert [int(o.kf_count) for _, o in out_t] == \
        [int(o.kf_count) for _, o in out_j]
    for fid in est_j:
        np.testing.assert_allclose(est_t[fid], est_j[fid], atol=2e-3)
    gt = {i: poses[i] for i in range(len(poses))}
    assert abs(ate_rmse(est_t, gt, align=False)
               - ate_rmse(est_j, gt, align=False)) < 2e-3
    assert abs(len(lm_t) - len(lm_j)) <= 0.05 * len(lm_j)


def test_scan_drain_idempotent(scene):  # noqa: F811
    vo = _port(fused.ScanVisualOdometry, scene, chunk_size=6)
    vo.run()
    kf1, lm1, fr1 = vo.drain()
    kf2, lm2, fr2 = vo.drain()
    assert len(fr2) == len(fr1) == 14
    assert set(kf2) == set(kf1) and set(lm2) == set(lm1)
    for (f1, a), (f2, b) in zip(fr1, fr2):
        assert f1 == f2 and np.array_equal(a.pose, b.pose)


def test_scan_output_buffer_guard(scene):  # noqa: F811
    """A chunk that would overflow the preallocated output buffer raises
    instead of overwriting earlier rows; a padded tail writes the
    sentinel row."""
    vo = _port(fused.ScanVisualOdometry, scene, chunk_size=6, max_frames=12)
    assert vo.step() and vo.step()          # frames 0-11: the buffer is full
    with pytest.raises(RuntimeError, match="output buffer full"):
        vo.step()
    vo = _port(fused.ScanVisualOdometry, scene, chunk_size=8, max_frames=16)
    vo.run()                                # 14 frames, 2 padded rows
    assert vo.out_buf.n_inliers[14:].tolist() == [-1, -1]
    assert not vo.out_buf.kf_inserted[14:].any()
    assert len(vo.outputs) == 14


def test_scan_loop_equals_eager_loop(scene):  # noqa: F811
    """`ScanLoopVisualOdometry` against `FusedLoopVisualOdometry`, a
    keyframe on every frame (so the hook runs on each): the same states,
    loop database included, and the same hook host reads."""
    cfg = dataclasses.replace(small_config(),
                              num_features_needed_for_keyframe=1000)
    a = _port(fused_loop.FusedLoopVisualOdometry, scene, cfg)
    a.run()
    b = _port(fused_loop.ScanLoopVisualOdometry, scene, cfg)
    b.run()
    _assert_same_run(a, b)
    for x, y in zip(a.ls, b.ls):
        assert torch.equal(x, y)
    assert a.hook_reads == b.hook_reads == 13


def _scan_loop_at(state, cfg, rig, kf_id: int):
    """A `ScanLoopVisualOdometry` whose static state holds (fs, ms, arc,
    ls) and whose ids name keyframe `kf_id`."""
    fs, ms, arc, ls = state
    H, W = fs.pyr[0].shape
    vo = fused_loop.ScanLoopVisualOdometry(
        convert.slam_config(cfg), ArraySequenceDataset(
            np.zeros((1, H, W), np.float32), np.zeros((1, H, W), np.float32),
            [convert.camera(c) for c in rig]),
        place_params=place_net.get_params(device="cpu"),
        max_total_keyframes=64, max_loop_edges=16, device="cpu")
    vo.initialize()
    vo._gates = dict(vo._gates, **GATES)
    vo._alloc((H, W))
    vo.ms, vo.arc = convert.map_state(ms), convert.archive_state(arc)
    vo.ls = convert.loop_state(ls)
    graphs.write([(vo.fs, convert.frontend_state(fs))])
    vo.kf_count = kf_id - 1
    vo._set_ids(100 + kf_id, kf_id, 0)
    return vo


def _run_hook(vo):
    """The chunked mode's hook graphs (stages 1, 2 and 3 on their gates,
    then the insert) on its static state, without the keyframe branch."""
    r, hs = vo.runner, vo._hs
    ids = vo._kf_ids()

    def scan():
        ls, emb, desc, desc_ok, best, cand = fused_loop.hook_candidates(
            vo.ls, vo.fs, vo.fs.pyr[0], ids.kf_id, **vo._gates)
        return [(vo.ls, ls), ((hs.emb, hs.desc, hs.desc_ok, hs.best,
                               hs.candidate_ok),
                              (emb, desc, desc_ok, best, cand))]
    r.run("scan", scan)
    if vo._host_bool(hs.candidate_ok):
        r.run("attempt", vo._attempt_graph)
        if vo._host_bool(hs.need_corr):
            r.run("correct", vo._correct_graph)
    r.run("insert", lambda: vo._insert_graph()[:1])


def test_scan_loop_matches_reference_on_fabricated_revisit(reference_run):
    """The revisit of tests/test_torch_loop_hook.py through the chunked
    mode's hook graphs, against the reference's hook (the body of its
    `ScanLoopVisualOdometry`'s keyframe branch): the same loop edge, the
    same correction and merge, at most two host reads a keyframe."""
    ref, cfg, rig, _ = reference_run
    fs, ms, arc = _np(ref.fs), _np(ref.ms), _np(ref.arc)
    from stereovision_slam_tpu.slam import fused_loop as jfl
    ls0 = _np(jfl.empty_loop_state(64, cfg.max_features, 16))
    (fs1, ms1, ls1), _, _ = _hooks(ls0, fs, ms, arc, 0, rig[0])
    fs2, ms2, _ = _revisit_state(fs1, ms1)
    (fs3, ms3, ls3), _, _ = _hooks(ls1, fs2, ms2, arc, 30, rig[0])
    vo = _scan_loop_at((fs2, ms2, arc, ls1), cfg, rig, 30)
    _run_hook(vo)
    assert vo.hook_reads == 2
    assert int(vo.ls.n_loops) == 1 and int(vo.ls.loop_i[0]) == 30
    assert int(vo.ls.loop_j[0]) == 0 and int(vo.ls.last_closed) == 30
    _hold(ls3, vo.ls, atol={"db_embed": 1e-3, "db_lm_pos": 1e-3,
                            "loop_info": 1e-3})
    _hold(fs3, vo.fs)
    _hold(ms3, vo.ms, atol={"lm_pos": 1e-3})
    np.testing.assert_allclose(vo.fs.T_cur.numpy(), fs1.T_cur, atol=2e-2)


def _one_piece_hook(ls, fs, ms, pyr, frame_id, kf_id: int, arc, *, cam_left,
                    place_params, skip, cooldown, strong, weak, max_weak,
                    min_match, min_pose_diff, max_pose_diff, max_loop_dist,
                    num_hypotheses, stats):
    """The loop hook before its split into stages (a test-local copy),
    with an int keyframe id and its two host reads in line."""
    left_img = pyr[0]
    dev = left_img.device
    Tdb = ls.db_embed.shape[0]
    emb = fused_loop.embed(place_params, left_img)
    desc, desc_ok = descriptors.compute(left_img, fs.feat_uv, fs.feat_valid,
                                        pattern=ls.pattern)
    ids = torch.arange(Tdb, device=dev)
    mask = ls.db_valid & (kf_id - ids >= skip)
    sims = torch.where(mask, ls.db_embed @ emb,
                       torch.full((), float("-inf"), device=dev))
    best = torch.argmax(sims)
    best_sim = sims[best]
    weak_count = torch.sum(sims > weak)
    in_cooldown = (ls.last_closed >= 0) & (kf_id - ls.last_closed <= cooldown)
    has_any = torch.any(mask)
    candidate_ok = (has_any & ~in_cooldown & (best_sim >= strong)
                    & (weak_count <= max_weak))
    ls = ls._replace(last_score=torch.clamp(torch.where(
        has_any, best_sim, torch.zeros_like(best_sim)), min=0.0).to(
            ls.last_score.dtype))
    stats["host_reads"] += 1
    if bool(candidate_ok):
        idx, _, good = matching.match(ls.db_desc[best], ls.db_desc_ok[best],
                                      desc, desc_ok)
        usable = good & ls.db_lm_has[best]
        cand_pos, cand_pose = ls.db_lm_pos[best], ls.db_pose[best]
        n_match = torch.sum(usable)
        uv_m = fs.feat_uv[torch.clamp(idx, min=0)]
        uniform = prng.uniform(kf_id, (num_hypotheses, cand_pos.shape[0]),
                               1e-9, 1.0, device=dev)
        T_corr, inl, n_in = pnp_ransac(cam_left, cand_pos, uv_m, usable,
                                       uniform, reproj_threshold=5.991)
        loop_rel = se3.se3_compose(T_corr, se3.se3_inverse(cand_pose))
        info = fused_loop.loop_information(cam_left, T_corr, cand_pos, uv_m,
                                           inl, loop_rel)
        pose_diff = se3.se3_distance(fs.T_cur, T_corr)
        accept = ((n_match >= min_match) & (n_in >= min_match)
                  & (torch.linalg.vector_norm(se3.se3_log(loop_rel))
                     <= max_loop_dist)
                  & (pose_diff <= max_pose_diff)
                  & torch.all(torch.isfinite(T_corr)))
        need_corr = accept & (pose_diff > min_pose_diff)
        Emax = ls.loop_i.shape[0]
        e = torch.where(accept, torch.clamp(ls.n_loops, 0, Emax - 1),
                        torch.full_like(ls.n_loops, Emax)).reshape(1)
        sd = mapmod.scatter_drop
        kid = torch.tensor(kf_id, dtype=torch.int32, device=dev)
        ls = ls._replace(
            loop_i=sd(ls.loop_i, e, kid.reshape(1)),
            loop_j=sd(ls.loop_j, e, best.to(torch.int32).reshape(1)),
            loop_rel=sd(ls.loop_rel, e, loop_rel[None]),
            loop_info=sd(ls.loop_info, e, info[None]),
            n_loops=ls.n_loops + accept.to(torch.int32),
            last_closed=torch.where(accept, kid, ls.last_closed))
        stats["host_reads"] += 1
        if bool(need_corr):
            D = se3.se3_compose(se3.se3_inverse(fs.T_cur), T_corr)
            Dinv = se3.se3_inverse(D)
            ms = ms._replace(
                kf_pose=torch.where(ms.kf_valid[:, None, None],
                                    se3.se3_compose(ms.kf_pose, D[None]),
                                    ms.kf_pose),
                lm_pos=torch.where(ms.lm_valid[:, None],
                                   se3.se3_apply(Dinv[None], ms.lm_pos),
                                   ms.lm_pos))
            fs = fs._replace(T_cur=se3.se3_compose(fs.T_cur, D))
            kf_slot = torch.argmax(torch.where(
                ms.kf_valid, ms.kf_id, torch.full_like(ms.kf_id, -1)))
            ms, new_feat_lm = mapmod.merge_loop_landmarks(
                ms, fs.feat_lm, fs.feat_valid, kf_slot, idx, usable & inl,
                cand_pos, ls.db_lm_id[best], ls.db_lm_first[best])
            fs = fs._replace(feat_lm=new_feat_lm)
    L = ms.lm_pos.shape[0]
    safe = torch.clamp(fs.feat_lm, 0, L - 1).to(torch.int64)
    lm_has = fs.feat_valid & (fs.feat_lm >= 0) & ms.lm_valid[safe]
    slot = torch.tensor(min(max(kf_id, 0), Tdb - 1), device=dev)
    none = torch.full_like(fs.feat_lm, -1)
    sr = mapmod.set_row
    ls = ls._replace(
        db_embed=sr(ls.db_embed, slot, emb),
        db_desc=sr(ls.db_desc, slot, desc),
        db_desc_ok=sr(ls.db_desc_ok, slot, desc_ok),
        db_uv=sr(ls.db_uv, slot, fs.feat_uv),
        db_lm_pos=sr(ls.db_lm_pos, slot, ms.lm_pos[safe]),
        db_lm_has=sr(ls.db_lm_has, slot, lm_has),
        db_lm_id=sr(ls.db_lm_id, slot,
                    torch.where(lm_has, ms.lm_id[safe], none)),
        db_lm_first=sr(ls.db_lm_first, slot,
                       torch.where(lm_has, ms.lm_first_kf[safe], none)),
        db_pose=sr(ls.db_pose, slot, fs.T_cur),
        db_valid=sr(ls.db_valid, slot, True))
    return fs, ms, ls


def test_hook_stages_equal_one_piece_hook(reference_run):
    """The staged hook (int and tensor keyframe ids) against the one-piece
    hook on the fixtures of tests/test_torch_loop_hook.py: keyframe 0 into
    the empty database, then the fabricated revisit as keyframe 30."""
    ref, cfg, rig, _ = reference_run
    from stereovision_slam_tpu.slam import fused_loop as jfl
    fs, ms = _np(ref.fs), _np(ref.ms)
    arc = convert.archive_state(_np(ref.arc))
    ls = convert.loop_state(_np(jfl.empty_loop_state(64, cfg.max_features,
                                                     16)))
    kw = dict(GATES, cam_left=convert.camera(rig[0]),
              place_params=place_net.get_params(device="cpu"))
    tfs, tms = convert.frontend_state(fs), convert.map_state(ms)
    for kf_id in (0, 30):
        if kf_id:
            fs2, ms2, _ = _revisit_state(
                _np(fe.FrontendState(*old[0])), _np(mapmod.MapState(
                    *old[1])))
            tfs, tms = convert.frontend_state(fs2), convert.map_state(ms2)
        s0, s1, s2 = ({"host_reads": 0} for _ in range(3))
        old = _one_piece_hook(ls, tfs, tms, tfs.pyr, 100 + kf_id, kf_id,
                              arc, stats=s0, **kw)
        for key, stats in ((kf_id, s1), (torch.tensor(kf_id), s2)):
            new = fused_loop._loop_hook(ls, tfs, tms, tfs.pyr, 100 + kf_id,
                                        key, arc, stats=stats, **kw)
            for a, b in zip(old, new):
                for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
                    assert torch.equal(x, y)
            assert stats == s0
        assert s0["host_reads"] == (2 if kf_id else 1)
        ls = old[2]
    assert int(ls.n_loops) == 1


@pytest.mark.parametrize("key", [0, 7, 30, 123_456])
def test_prng_tensor_key_matches_jax(key):
    shape = (16, 40)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(key), shape,
                                        jnp.float32, 1e-9, 1.0))
    for k in (key, torch.tensor(key, dtype=torch.int32),
              torch.tensor(key, dtype=torch.int64)):
        got = prng.uniform(k, shape, 1e-9, 1.0).numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_map_ops_with_tensor_ids():
    """add_landmarks and insert_keyframe (with eviction) give equal states
    with int ids and with 0-d tensor ids."""
    rng = np.random.default_rng(3)
    K, F, L = 3, 16, 64
    maps = [mapmod.empty_map(K, F, L), mapmod.empty_map(K, F, L)]
    for kf in range(5):
        pose = torch.from_numpy(np.c_[np.eye(3), rng.normal(0, 1 + kf, 3)]
                                .astype(np.float32))
        pos = torch.from_numpy(rng.normal(0, 5, (F, 3)).astype(np.float32))
        create = torch.from_numpy(rng.uniform(size=F) > 0.4)
        uv = torch.from_numpy(rng.uniform(0, 300, (2, F, 2))
                              .astype(np.float32))
        has_r = torch.from_numpy(rng.uniform(size=F) > 0.2)
        valid = torch.from_numpy(rng.uniform(size=F) > 0.1)
        outs = []
        for i, ids in enumerate(((10 * kf, kf), (torch.tensor(10 * kf),
                                                 torch.tensor(kf)))):
            m, slots = mapmod.add_landmarks(maps[i], pos, create, ids[1])
            m, ev = mapmod.insert_keyframe(m, pose, ids[0], ids[1], uv[0],
                                           uv[1], slots, has_r, valid,
                                           num_active=2)
            maps[i] = m
            outs.append((m, ev))
        for a, b in zip(graphs.leaves(outs[0]), graphs.leaves(outs[1])):
            assert torch.equal(a, b)
    assert bool(outs[0][1].happened)


def test_keyframe_step_with_tensor_ids(scene, eager):  # noqa: F811
    """`frontend.keyframe_step` from the eager run's final state, with int
    ids and with the chunked mode's 0-d int32 ids."""
    lefts, rights, rig, _ = scene
    vo = eager
    cfg = vo.cfg
    _, right_pyr = fused.frame_pyramids(
        torch.from_numpy(lefts[-1]), torch.from_numpy(rights[-1]),
        cfg.lk_num_levels)
    kw = fused._kf_kw(vo._statics())
    a = fe.keyframe_step(vo.fs, vo.ms, right_pyr, vo.cam_left, vo.cam_right,
                         13, vo.kf_count + 1, **kw)
    ids = fused.keyframe_ids(13, vo.kf_count + 1, vo.Tmax, "cpu")
    b = fe.keyframe_step(vo.fs, vo.ms, right_pyr, vo.cam_left, vo.cam_right,
                         ids.frame_id, ids.kf_id, **kw)
    for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
        assert torch.equal(x, y)
    assert int(a[3]) > 0


class _LintRunner(graphs.GraphRunner):
    """Calls each function under `capture_lint`, then makes its writes."""

    def __init__(self, found):
        super().__init__("cpu")
        self.found, self.keys = found, []

    def run(self, key, fn, warm=None):
        self.keys.append(key)
        with capture_lint(self.found, paused=PLAIN):
            writes = fn()
        graphs.write(writes)


def _lint_report(found) -> str:
    return "\n".join(f"{what}\n{stack}" for what, stack in found)


def test_captured_functions_lint_clean(scene, reference_run):  # noqa: F811
    """Every function the chunked modes and the PGO solver capture, run on
    the CPU under `capture_lint`: no host read, no tensor built from host
    data on the device, no output sized by the data, no linear algebra
    checked on the host."""
    found = []
    cfg = dataclasses.replace(small_config(),
                              num_features_needed_for_keyframe=1000)
    vo = _port(fused_loop.ScanLoopVisualOdometry, scene, cfg, chunk_size=4)
    vo.runner = _LintRunner(found)
    for _ in range(2):
        vo.step()
    keys = set(vo.runner.keys)
    # the attempt and the correction: the fabricated revisit
    ref, cfg, rig, _ = reference_run
    from stereovision_slam_tpu.slam import fused_loop as jfl
    fs, ms, arc = _np(ref.fs), _np(ref.ms), _np(ref.arc)
    ls0 = _np(jfl.empty_loop_state(64, cfg.max_features, 16))
    (fs1, ms1, ls1), _, _ = _hooks(ls0, fs, ms, arc, 0, rig[0])
    fs2, ms2, _ = _revisit_state(fs1, ms1)
    rv = _scan_loop_at((fs2, ms2, arc, ls1), cfg, rig, 30)
    rv.runner = _LintRunner(found)
    _run_hook(rv)
    keys |= set(rv.runner.keys)
    # the PGO solve on the run's keyframes, one loop edge
    g = _pose_graph(vo)
    solver = pose_graph.PoseGraphSolver("cpu")
    solver.runner = _LintRunner(found)
    solver.solve(g, iters=2, cg_iters=3)
    assert keys >= {"track", ("keyframe+scan", True), "insert", "attempt",
                    "correct"}
    assert not found, _lint_report(found)
    # and the lint sees what it must
    with capture_lint(found):
        x = torch.arange(4)
        int(x.sum())
        x[torch.argmax(x)]
        torch.tensor(1.0, device="cpu")
        torch.linalg.eigh(torch.eye(3))
        x[x > 1]
    assert len(found) >= 5, [w for w, _ in found]


def test_captured_fast_and_mobilenet_lint_clean(scene):  # noqa: F811
    """The branches this slice adds to the captured functions, under
    `capture_lint`: FAST corners in the keyframe graph (the ORB option)
    and the MobileNet-V2 embedding in the loop hook's insert stage."""
    from stereovision_slam_torch.models import mobilenet_v2 as mnv2
    found = []
    cfg = dataclasses.replace(small_config(), keypoint_feature_detector="ORB",
                              num_features_needed_for_keyframe=1000)
    vo = _port(fused_loop.ScanLoopVisualOdometry, scene, cfg, chunk_size=4,
               place_params=mnv2.init_params(device="cpu"))
    vo.runner = _LintRunner(found)
    for _ in range(2):
        vo.step()
    assert set(vo.runner.keys) >= {"track", ("keyframe+scan", True),
                                   "insert"}
    assert vo._static["detector"] == "orb"
    assert not found, _lint_report(found)


def _pose_graph(vo) -> pose_graph.PoseGraph:
    """The run's keyframes as a pose graph with odometry edges and one loop
    edge (unit information but a blind direction), padded as run_pgo."""
    kf, _, _ = vo.drain()
    ids = sorted(kf)
    T = len(ids)
    poses = np.stack([kf[k][1] for k in ids]).astype(np.float32)
    rel = vo.arc.kf_rel.numpy()
    ei = list(range(1, T)) + [T - 1]
    ej = list(range(T - 1)) + [0]
    meas = [rel[k] for k in ids[1:]] + [np.eye(3, 4, dtype=np.float32)]
    info = [np.eye(6, dtype=np.float32)] * (T - 1) + [
        np.diag([1, 1, 1e-3, 1, 1, .5]).astype(np.float32)]
    Tp, E = 64, len(ei)
    pp = np.tile(np.eye(3, 4, dtype=np.float32)[None], (Tp, 1, 1))
    pp[:T] = poses
    mp = np.tile(np.eye(3, 4, dtype=np.float32)[None], (Tp, 1, 1))
    mp[:E] = np.stack(meas)
    ip = np.tile(np.eye(6, dtype=np.float32)[None], (Tp, 1, 1))
    ip[:E] = np.stack(info)
    t = torch.as_tensor
    return pose_graph.PoseGraph(
        poses=t(pp), pose_valid=t(np.arange(Tp) < T),
        edge_i=t(np.pad(np.asarray(ei), (0, Tp - E))),
        edge_j=t(np.pad(np.asarray(ej), (0, Tp - E))),
        edge_meas=t(mp), edge_valid=t(np.arange(Tp) < E), edge_info=t(ip))


def test_pgo_solver_equals_eager(eager):
    """`PoseGraphSolver` (the graph's function, called directly on the
    CPU) against `optimize_pose_graph`, bit for bit, twice at one size."""
    g = _pose_graph(eager)
    want = pose_graph.optimize_pose_graph(g, iters=4, cg_iters=20)
    solver = pose_graph.PoseGraphSolver("cpu")
    for _ in range(2):
        assert torch.equal(solver.solve(g, iters=4, cg_iters=20), want)
    assert float((want - g.poses).abs().max()) > 1e-4
