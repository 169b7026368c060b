"""What the JAX package does on the circuit where `chip_smoke.py` phases 16
and 18 set their gates, run on the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_slice9_reference \
        [--fast [--detector GFTT] [--lk lanes-interpret] [--port]]
        [--dense KEYFRAMES.txt | --dense-own] [--frames N]

`--fast`: the reference's fused odometry with `keypoint_feature_detector:
ORB` (FAST corners; `--detector` picks another) over the 120-frame
188x620 circuit with the bench's settings (`chip_smoke.bench_config`):
keyframes, the smallest inlier count of a tracked frame, keyframe ATE
against the path length, the frames/s of this CPU run. On the CPU the
reference tracks with its XLA LK (`ops/lk.track` samples the whole image);
`--lk lanes-interpret` makes it take the lanes LK, its TPU route and the
port's, interpreted (about 3 minutes). `--port`: the port's run on the
CPU too, and the first frame where the two part: keyframe decisions,
inlier counts, poses by more than 1e-4.

`--dense`: the reference's dense reconstruction of the circuit's colour
frames (`chip_smoke.rgb_frames`, as phase 14 writes them) at the keyframes
of a keyframes.txt (the card's fused run, saved by `tests/torch_slice9.py
--save-keyframes`), with the reference's defaults; `--dense-own` takes the
keyframes of a fused run of the port on the CPU instead. Prints the kept points and their share
within 0.5 m of the arena's ground plane or wall (`chip_smoke.arena_share`),
phase 16's measure (c).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _circuit(n):
    from stereovision_slam_torch import scenes
    lefts, rights, gt, dist, rig = scenes.circuit(120, 188, 620)
    return lefts[:n], rights[:n], gt[:n], dist * n / 120, rig


def _trace(label, vo, gt, dist, dt):
    """Per-frame (n_inliers, kf_inserted, pose) of a drained run, with its
    summary printed."""
    keyframes, landmarks, frames = vo.drain()
    n_in = np.array([int(f.n_inliers) for _, f in frames])

    def center(p):
        return -p[:, :3].T @ p[:, 3]
    errs = [np.linalg.norm(center(np.asarray(p)) - center(gt[f]))
            for f, p in keyframes.values()]
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"{label} ({len(n_in)} frames, CPU): {len(keyframes)} keyframes, "
          f"{len(landmarks)} landmarks, n_inliers min {n_in[1:].min()} "
          f"(frames under 11: {int((n_in[1:] <= 10).sum())}), keyframe ATE "
          f"{ate:.4f} m over {dist:.1f} m ({100 * ate / dist:.3f}%), "
          f"{len(n_in) / dt:.2f} fps on this CPU")
    return (n_in, np.array([bool(f.kf_inserted) for _, f in frames]),
            np.stack([np.asarray(f.pose) for _, f in frames]))


def fast_reference(n: int, detector: str, lk_mode: str | None):
    import chip_smoke
    from stereovision_slam_tpu.geometry.camera import Camera
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.ops import lk
    from stereovision_slam_tpu.slam.config import SlamConfig
    from stereovision_slam_tpu.slam.fused import FusedVisualOdometry

    if lk_mode:
        for name in ("track", "track_batched"):
            def routed(*a, _fn=getattr(lk, name), **kw):
                kw["pallas_mode"] = kw.get("pallas_mode") or lk_mode
                return _fn(*a, **kw)
            setattr(lk, name, routed)
    lefts, rights, gt, dist, rig = _circuit(n)
    cams = [Camera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy),
                          baseline=float(c.baseline), pose=c.pose.numpy())
            for c in rig]
    cfg = SlamConfig(**{k: getattr(chip_smoke.bench_config(), k)
                        for k in SlamConfig.__dataclass_fields__})
    cfg.keypoint_feature_detector = detector
    vo = FusedVisualOdometry(cfg, ArraySequenceDataset(lefts, rights, cams),
                             max_total_keyframes=512,
                             max_total_landmarks=1 << 16)
    vo.initialize()
    t0 = time.perf_counter()
    vo.run()
    return _trace(f"reference fused {detector}, LK {lk_mode or 'its own'}",
                  vo, gt, dist, time.perf_counter() - t0)


def fast_port(n: int, detector: str):
    import torch
    import chip_smoke
    torch.set_num_threads(4)
    lefts, rights, gt, dist, rig = _circuit(n)
    cfg = chip_smoke.bench_config()
    cfg.keypoint_feature_detector = detector
    vo = chip_smoke.slice_vo(lefts, rights, rig, "cpu", cfg)
    t0 = time.perf_counter()
    vo.run()
    return _trace(f"port fused {detector}", vo, gt, dist,
                  time.perf_counter() - t0)


def first_apart(ref, port) -> None:
    (n_r, kf_r, p_r), (n_p, kf_p, p_p) = ref, port
    gap = np.abs(p_p - p_r).reshape(len(p_r), -1).max(axis=1)

    def first(mask):
        idx = np.nonzero(mask)[0]
        return int(idx[0]) if len(idx) else None
    print(f"port against reference: keyframe decisions part at frame "
          f"{first(kf_p != kf_r)} ({int(kf_p.sum())} against "
          f"{int(kf_r.sum())} keyframe steps), inlier counts at "
          f"{first(n_p != n_r)} (by up to {np.abs(n_p - n_r).max()}), "
          f"poses by more than 1e-4 at {first(gap > 1e-4)} (by up to "
          f"{gap.max():.2e})")


def _own_keyframes(n):
    import torch
    import chip_smoke
    torch.set_num_threads(6)
    lefts, rights, _, _, rig = _circuit(n)
    vo, _ = chip_smoke.run_slice(lefts, rights, rig, "cpu")
    keyframes, _, _ = vo.drain()
    return sorted((fid, np.asarray(p, np.float32))
                  for fid, p in keyframes.values())


def dense_reference(kf_path: str | None, n: int) -> None:
    import tempfile

    import chip_smoke
    from stereovision_slam_tpu.dense.reconstruction import (
        DenseReconstruction, DenseReconstructionConfig)
    from stereovision_slam_tpu.geometry.camera import Camera
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.slam.outputs import (load_keyframes_file,
                                                    save_slam_output)

    lefts, rights, _, _, rig = _circuit(n)
    rl, rr = chip_smoke.rgb_frames(lefts), chip_smoke.rgb_frames(rights)
    if kf_path:
        _, _, kfs = load_keyframes_file(kf_path)
    else:
        kfs = _own_keyframes(n)
    cams = [Camera.create(float(c.fx), float(c.fy), float(c.cx), float(c.cy),
                          baseline=float(c.baseline), pose=c.pose.numpy())
            for c in rig]
    ds = ArraySequenceDataset(rl.astype(np.float32), rr.astype(np.float32),
                              cams)
    with tempfile.TemporaryDirectory() as tmp:
        out = save_slam_output(tmp, "<circuit>", 0, kfs, np.zeros((0, 3)),
                               timestamped_subdir=False)
        dr = DenseReconstruction(DenseReconstructionConfig(
            slam_output_dir=out), dataset_factory=lambda _: ds)
        dr.initialize()
        t0 = time.perf_counter()
        pts, cols = dr.dense_reconstruct()
        dt = time.perf_counter() - t0
    share = chip_smoke.arena_share(pts)
    print(f"reference dense on {len(kfs)} keyframes "
          f"({'card run ' + kf_path if kf_path else 'the port on the CPU'}):"
          f" {len(pts)} points, arena share {share:.4f} (within "
          f"{chip_smoke.ARENA_BAND} m of the ground or the wall), "
          f"{dt:.1f} s on this CPU")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--detector", default="ORB")
    ap.add_argument("--lk", default=None, metavar="PALLAS_MODE")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--dense", default=None, metavar="KEYFRAMES_TXT")
    ap.add_argument("--dense-own", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.fast:
        ref = fast_reference(args.frames, args.detector, args.lk)
        if args.port:
            first_apart(ref, fast_port(args.frames, args.detector))
    if args.dense or args.dense_own:
        dense_reference(args.dense, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
