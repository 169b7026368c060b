"""Per-stream keyframe ATE of multi-stream serving on the circuit, against
the size of BA's landmark compaction.

    python -m tests.torch_serving_ate [--device cuda] [--max-active 1024 2048 0]
    JAX_PLATFORMS=cpu python -m tests.torch_serving_ate --reference

Runs the serving streams of `chip_smoke.py` (4 streams of 90 frames of the
188x620 circuit, stream b from frame 10 b, `kf_stagger=4`, the bench's
settings) through the port's `BatchedFusedVisualOdometry` once per
`--max-active` value of `ba_max_active_landmarks` (0: no compaction), and
prints for each stream its keyframe ATE, its largest per-frame position
error and its smallest inlier count, and how many BA passes had more active
landmarks than the compaction holds (those landmarks stay out of that
pass). `--reference` runs the reference's `BatchedFusedVisualOdometry` on
the CPU instead (its CPU path: per-level LK, LU pose solve), with the
bench's settings.

A tool, not a test: it takes a minute on the card, minutes on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

import chip_smoke as cs


def _center(p):
    return -p[:, :3].T @ p[:, 3]


def _report(label, trajs, outputs, streams):
    path = 0.35 * cs.SERVE_T
    for b, (traj, out) in enumerate(zip(trajs, outputs)):
        gt = streams[b][2]
        ate = cs.stream_ate({f: np.asarray(p) for f, p in traj.items()}, gt)
        err = max(np.linalg.norm(_center(np.asarray(o.pose)) - _center(gt[f]))
                  for f, o in out)
        print(f"{label} stream {b}: {len(traj)} keyframes, keyframe ATE "
              f"{ate:.4f} m ({100 * ate / path:.2f}% of {path:.1f} m), "
              f"largest frame error {err:.2f} m, min n_inliers "
              f"{min(int(o.n_inliers) for _, o in out)}")


def _port(streams, rig, device, max_active):
    for la in max_active:
        cfg = cs.bench_config()
        cfg.ba_max_active_landmarks = la
        passes = []
        vo = cs.make_serving(streams, rig, device, cfg)
        vo.initialize()
        with cs.ba_overflow(passes):
            vo.run()
        over = [int(p) for p in passes if int(p) > 0]
        print(f"port, ba_max_active_landmarks={la}: {len(passes)} BA "
              f"passes, {len(over)} overflowed, by up to "
              f"{max(over, default=0)} landmarks")
        _report(f"  la={la}", vo.trajectories(), vo.outputs, streams)


def _reference(streams):
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.slam.batched import BatchedFusedVisualOdometry
    from stereovision_slam_tpu.slam.config import SlamConfig
    from tests import synthetic

    rig = synthetic.make_stereo_rig()
    c = cs.bench_config()
    cfg = SlamConfig(**{k: getattr(c, k) for k in (
        "num_features", "num_features_needed_for_keyframe", "lk_max_iters",
        "pose_rounds", "pose_iters_per_round", "ba_lm_iters")})
    vo = BatchedFusedVisualOdometry(
        cfg, [ArraySequenceDataset(l, r, list(rig)) for l, r, _ in streams],
        max_total_keyframes=512, max_total_landmarks=1 << 16,
        kf_stagger=cs.SERVE_STAGGER)
    vo.initialize()
    vo.run()
    print(f"reference (CPU), ba_max_active_landmarks="
          f"{cfg.ba_max_active_landmarks}")
    _report("  reference", vo.trajectories(), vo.outputs, streams)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-active", type=int, nargs="+",
                    default=[1024, 2048, 0])
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args()
    from stereovision_slam_torch import scenes

    dev = "cpu" if args.reference else args.device
    lefts, rights, gt, _, rig = scenes.circuit(120, 188, 620, device=dev)
    streams = cs.serving_streams(lefts, rights, gt)
    if args.reference:
        _reference(streams)
    else:
        _port(streams, rig, dev, args.max_active)


if __name__ == "__main__":
    main()
