"""Keyframe ATE of the reference and of the port on the bench's circuit, on
the CPU, from the same images.

    JAX_PLATFORMS=cpu python -m tests.torch_circuit_ate [--frames 120]
        [--from-frame K]

Renders the 120-frame 188x620 circuit with the reference fixture (the
images `bench.py` scores) and runs the odometry + BA path without the loop
hook three times:
  jax-cpu     the reference's `FusedVisualOdometry` as it runs on the CPU
              (full-image LK, LU pose solve);
  jax-kernels the same with the TPU main path's Pallas kernels (lanes LK,
              fused pose solve) in interpret mode;
  port-cpu    the port's `FusedVisualOdometry(device="cpu")`, whose kernels
              run as their plain versions.
It prints each run's keyframe count and keyframe ATE, and each keyframe's
position error. With --from-frame K it also takes the reference's state
after frames 0..K-1 (its Pallas kernels interpreted), carries it to the
port with `convert`, and runs frame K's `track_step` in both packages,
printing both poses' errors and inlier counts: whether the two agree from
one state.

A tool, not a test: it takes minutes.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np


def _center(p):
    return -p[:3, :3].T @ p[:3, 3]


def _errors(keyframes, gt):
    return [(fid, float(np.linalg.norm(_center(p) - _center(gt[fid]))))
            for fid, p in sorted(keyframes.values())]


def _report(name, keyframes, gt, dt):
    errs = _errors(keyframes, gt)
    ate = float(np.sqrt(np.mean(np.square([e for _, e in errs]))))
    print(f"{name}: {len(keyframes)} keyframes, keyframe ATE {ate:.4f} m "
          f"({dt:.1f} s)")
    print("  per keyframe (frame:error m) "
          + " ".join(f"{f}:{e:.3f}" for f, e in errs), flush=True)
    return ate


def _kernel_mode():
    """Route the reference's LK and pose solve through its Pallas kernels in
    interpret mode, as on the TPU. The compiled steps of earlier runs are
    dropped, or they would be reused."""
    import jax
    from stereovision_slam_tpu.ops import lk
    from stereovision_slam_tpu.slam import frontend
    lk.track = functools.partial(lk.track, pallas_mode="lanes-interpret")
    lk.track_batched = functools.partial(lk.track_batched,
                                         pallas_mode="lanes-interpret")
    frontend.track_step = functools.partial(frontend.track_step,
                                            pose_impl="interpret")
    jax.clear_caches()


def _run_jax(cfg, lefts, rights, rig):
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.slam.fused import FusedVisualOdometry
    vo = FusedVisualOdometry(cfg, ArraySequenceDataset(lefts, rights,
                                                       list(rig)),
                             max_total_keyframes=512,
                             max_total_landmarks=1 << 16)
    vo.initialize()
    t0 = time.perf_counter()
    vo.run()
    kf, _, _ = vo.drain()
    return kf, time.perf_counter() - t0


def _run_port(cfg, lefts, rights, rig):
    from stereovision_slam_torch import convert
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam.fused import FusedVisualOdometry
    vo = FusedVisualOdometry(
        convert.slam_config(cfg),
        ArraySequenceDataset(lefts, rights, [convert.camera(c) for c in rig]),
        max_total_keyframes=512, max_total_landmarks=1 << 16, device="cpu")
    vo.initialize()
    t0 = time.perf_counter()
    vo.run()
    kf, _, _ = vo.drain()
    return vo, kf, time.perf_counter() - t0


def _one_state(cfg, lefts, rights, rig, gt, K):
    """Frame K's track_step in both packages from the reference's state
    after frames 0..K-1 (reference with its Pallas kernels interpreted)."""
    import jax.numpy as jnp
    import torch
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.ops import image as jimg
    from stereovision_slam_tpu.slam import frontend as jfe
    from stereovision_slam_tpu.slam.fused import FusedVisualOdometry
    from stereovision_slam_torch import convert
    from stereovision_slam_torch.ops import image as timg
    from stereovision_slam_torch.slam import frontend as tfe

    vo = FusedVisualOdometry(cfg, ArraySequenceDataset(
        lefts[:K], rights[:K], list(rig)), max_total_keyframes=512,
        max_total_landmarks=1 << 16)
    vo.initialize()
    vo.run()
    kw = dict(chi2_th=cfg.chi2_th, rounds=cfg.pose_rounds,
              iters=cfg.pose_iters_per_round, lk_iters=cfg.lk_max_iters)
    L = cfg.lk_num_levels
    # frontend.track_step already carries pose_impl="interpret" here
    fs_j, n_j, _ = jfe.track_step(
        vo.fs, vo.ms, tuple(jimg.build_pyramid(jnp.asarray(lefts[K]), L)),
        rig[0], tuple(jimg.build_pyramid(jnp.asarray(rights[K]), L)), rig[1],
        **kw)
    cams = [convert.camera(c) for c in rig]
    fs_t, n_t, _ = tfe.track_step(
        convert.frontend_state(vo.fs), convert.map_state(vo.ms),
        tuple(timg.build_pyramid(torch.from_numpy(lefts[K]), L)), cams[0],
        tuple(timg.build_pyramid(torch.from_numpy(rights[K]), L)), cams[1],
        **kw)
    T_t, T_j = fs_t.T_cur.numpy(), np.asarray(fs_j.T_cur)
    e_t = float(np.linalg.norm(_center(T_t) - _center(gt[K])))
    e_j = float(np.linalg.norm(_center(T_j) - _center(gt[K])))
    e_prev = float(np.linalg.norm(_center(np.asarray(vo.fs.T_cur))
                                  - _center(gt[K - 1])))
    valid = np.asarray(fs_j.feat_valid)
    d_uv = float(np.abs(fs_t.feat_uv.numpy() - np.asarray(fs_j.feat_uv))[
        valid].max())
    d_T = float(np.abs(T_t - T_j).max())
    print(f"frame {K} from the reference's state (frame {K - 1} error "
          f"{e_prev:.4f} m): reference error {e_j:.4f} m, {int(n_j)} "
          f"inliers; port error {e_t:.4f} m, {int(n_t)} inliers; features "
          f"differ by {d_uv:.2e} px at most, poses by {d_T:.2e}")
    return dict(frame=K, prev_err=e_prev, ref_err=e_j, port_err=e_t,
                ref_inliers=int(n_j), port_inliers=int(n_t),
                max_feat_px=d_uv, max_pose=d_T)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import bench
    from tests import synthetic

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--from-frame", type=int, default=0)
    args = ap.parse_args()
    T = args.frames
    step = 0.35
    rig = synthetic.make_stereo_rig()
    poses = synthetic.forward_motion_poses(120, step=step,
                                           yaw_rate=2 * np.pi / 112)
    lefts, rights = synthetic.render_arena_stereo_sequence(
        poses, H=188, W=620, rig=rig, center=(0.0, 6.0), radius=25.0)
    lefts, rights = np.array(lefts)[:T], np.array(rights)[:T]
    gt = np.asarray(poses)
    cfg = bench.make_config()

    res = {}
    kf, dt = _run_jax(cfg, lefts, rights, rig)
    res["jax-cpu"] = _report("jax-cpu", kf, gt, dt)
    _, kf, dt = _run_port(cfg, lefts, rights, rig)
    res["port-cpu"] = _report("port-cpu", kf, gt, dt)
    _kernel_mode()
    kf, dt = _run_jax(cfg, lefts, rights, rig)
    res["jax-kernels"] = _report("jax-kernels", kf, gt, dt)
    if args.from_frame:
        res["one_state"] = _one_state(cfg, lefts, rights, rig, gt,
                                      args.from_frame)
    print(json.dumps({"keyframe_ate_m": res, "path_m": step * 120}))


if __name__ == "__main__":
    main()
