"""Serving over a mesh, the port against the JAX package, on the CPU:

    python -m tests.torch_serving_mesh_reference [--frames N]

The case of tests/test_batched.py::test_batched_mesh_sharded_matches_
unsharded: 8 streams (stream s is world s % 4, 96x320, `small_config`) of
N frames (8), the per-frame step, sharded over 8 ranks. The reference runs
`BatchedFusedVisualOdometry(mesh=jax.make_mesh((8,), ("dp",)))` on 8
virtual CPU devices with its lanes LK interpreted (its TPU route and the
port's; on the CPU it would otherwise track with its full-image XLA LK),
the port `BatchedFusedVisualOdometry(mesh=make_ba_mesh(8, device="cpu"))`.
Held at the reference's own tolerance for its sharded run, 1e-3: every
frame's pose, and each stream's keyframe set and keyframe poses; the
inlier counts are printed beside each other. Exits 1 if any is missed.

The reference's run compiles and interprets its LK kernel for 2-4 minutes
of this CPU, so this is a tool, not a tier-1 test.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3      # tests/test_batched.py: sharded against unsharded
STREAMS = 8


def reference(streams, T):
    import jax
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset
    from stereovision_slam_tpu.ops import lk
    from stereovision_slam_tpu.slam.batched import BatchedFusedVisualOdometry
    from tests.test_batched import small_config

    for name in ("track", "track_batched"):
        def routed(*a, _fn=getattr(lk, name), **kw):
            kw["pallas_mode"] = kw.get("pallas_mode") or "lanes-interpret"
            return _fn(*a, **kw)
        setattr(lk, name, routed)
    vo = BatchedFusedVisualOdometry(
        small_config(), [ArraySequenceDataset(l[:T], r[:T], rig)
                         for (l, r, rig), _ in streams],
        max_total_keyframes=64, max_total_landmarks=2048,
        mesh=jax.make_mesh((STREAMS,), ("dp",)))
    vo.initialize()
    assert len(vo.fs.T_cur.sharding.device_set) == STREAMS
    vo.run()
    return vo


def port(streams, T):
    import torch
    from stereovision_slam_torch import convert
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.slam.batched import BatchedFusedVisualOdometry
    from tests.test_batched import small_config

    torch.set_num_threads(4)
    vo = BatchedFusedVisualOdometry(
        convert.slam_config(small_config()),
        [ArraySequenceDataset(l[:T], r[:T], [convert.camera(c) for c in rig])
         for (l, r, rig), _ in streams],
        max_total_keyframes=64, max_total_landmarks=2048,
        mesh=make_ba_mesh(STREAMS, device="cpu"), device="cpu")
    vo.initialize()
    vo.run()
    return vo


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{STREAMS}").strip()
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    T = ap.parse_args().frames
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from tests.test_batched import make_stream

    streams = [make_stream(s % 4, T=T) for s in range(STREAMS)]
    t0 = time.perf_counter()
    ref = reference(streams, T)
    t1 = time.perf_counter()
    ours = port(streams, T)
    t2 = time.perf_counter()
    print(f"{STREAMS} streams x {T} frames over {STREAMS} ranks: reference "
          f"{t1 - t0:.1f} s, port {t2 - t1:.1f} s (this CPU)")
    worst, ok = 0.0, True
    for s, (a, b) in enumerate(zip(ref.trajectories(), ours.trajectories())):
        frames = [np.abs(np.asarray(r.pose) - o.pose).max()
                  for (_, r), (_, o) in zip(ref.outputs[s], ours.outputs[s])]
        kf = [np.abs(np.asarray(a[f]) - b[f]).max() for f in a if f in b]
        gap = max(frames + kf)
        same = set(a) == set(b) and len(frames) == len(ref.outputs[s])
        worst = max(worst, gap)
        ok &= same and gap <= TOL
        print(f"  stream {s}: keyframes {sorted(b)} (reference equal: "
              f"{set(a) == set(b)}), poses within {gap:.3e}; inliers "
              f"reference {[int(r.n_inliers) for _, r in ref.outputs[s]]}, "
              f"port {[int(o.n_inliers) for _, o in ours.outputs[s]]}")
    print(f"largest gap {worst:.3e} (tolerance {TOL}): "
          f"{'met' if ok else 'MISSED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
