"""Classic mode's shutdown PGO from one saved state, in both packages.

On the card (the port, `chip_smoke.py` phase 14's classic run):

    python -m tests.torch_classic_pgo --save chiprun_out/classic.npz

writes the 120-frame circuit as a KITTI sequence, runs the command line in
classic mode with the bench's settings and `PLACENET_LOOP_GATES`, saves
the state after the last frame and before the shutdown, and keeps that
checkpoint. On the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_classic_pgo --load chiprun_out/classic.npz

loads it into the reference's `VisualOdometry` and into the port's, and
prints the keyframe ATE against the circuit's ground truth: the odometry;
the reference's PGO (unit information on every edge) before and after its
`finish` folds the window back into the archives; the port's PGO with
unit information; and the port's own (the loop edges weighted by their
PnP information, the window written back). Also each loop edge's error
against ground truth beside the odometry's between the same keyframes.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_FRAMES = 120


def save(path: str) -> None:
    import torch
    import yaml

    sys.path.insert(0, REPO)
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.apps import run_slam

    lefts, rights, _, _, rig = scenes.circuit(T_FRAMES, 188, 620,
                                              device="cuda")
    tmp = tempfile.mkdtemp(prefix="svslam_classic_")
    try:
        seq = os.path.join(tmp, "sequence")
        chip_smoke.write_kitti_sequence(seq, lefts, rights, rig)
        cfg = chip_smoke.loop_config()
        cfg.dataset_dir, cfg.output_dir = seq, os.path.join(tmp, "out")
        cfg.loopclosure_on = cfg.backend_on = cfg.visualizer_on = 1
        yml = os.path.join(tmp, "classic.yaml")
        with open(yml, "w") as f:
            yaml.safe_dump(dataclasses.asdict(cfg), f)
        r = run_slam.run(run_slam.parse_args(
            [yml, "--checkpoint-every", str(T_FRAMES)]))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        shutil.copy(os.path.join(cfg.output_dir, run_slam.CHECKPOINT_NAME),
                    path)
        print(f"saved {path} on {torch.cuda.get_device_name(0)}: "
              f"{r['loops']} loop(s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(path: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.slam import checkpoint as tck
    from stereovision_slam_torch.slam import loop_closure as tlc
    from stereovision_slam_torch.slam import pipeline as tpipe
    from stereovision_slam_tpu.geometry import se3 as jse3
    from stereovision_slam_tpu.geometry.camera import Camera as JCamera
    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDS
    from stereovision_slam_tpu.slam import checkpoint as jck
    from stereovision_slam_tpu.slam import loop_closure as jlc
    from stereovision_slam_tpu.slam import pipeline as jpipe
    from stereovision_slam_tpu.slam.config import SlamConfig as JConfig

    # the circuit's ground truth without rendering (scenes.circuit)
    gt = scenes.forward_motion_poses(
        T_FRAMES, step=0.35, yaw_rate=2 * math.pi / (T_FRAMES - 8)).numpy()
    rig = scenes.make_stereo_rig()
    cfg = chip_smoke.loop_config()
    blank = np.zeros((1, 188, 620), np.float32)

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    def ate(traj: dict) -> float:
        return float(np.sqrt(np.mean([np.sum(np.square(
            center(np.asarray(p)) - center(gt[f]))) for f, p in
            traj.items()])))

    def rel(a, b):
        return np.asarray(jse3.se3_compose(jnp.asarray(a),
                                           jse3.se3_inverse(jnp.asarray(b))))

    def tangent(T):
        return np.abs(np.asarray(jse3.se3_log(jnp.asarray(T))))

    def port(weighted: bool):
        vo = tpipe.VisualOdometry(cfg, ArraySequenceDataset(
            blank, blank, list(rig)), device="cpu")
        vo.initialize()
        vo.loop_closure = tlc.LoopClosure(cfg, vo.cam_left,
                                          embedder="thumbnail")
        tck.load_checkpoint(vo, path)
        if not weighted:
            for e in vo.loop_closure.loop_edges:
                e.info = None
        return vo

    vo = port(True)
    odo = dict(vo.trajectory())
    recs = vo.archived_keyframes
    print(f"{len(recs)} keyframes, odometry ATE {ate(odo):.4f} m")
    for e in vo.loop_closure.loop_edges:
        fi, fj = recs[e.kf_id].frame_id, recs[e.loop_kf_id].frame_id
        g = rel(gt[fi], gt[fj])
        m, o = tangent(rel(e.relative_pose, g)), tangent(
            rel(rel(recs[e.kf_id].pose, recs[e.loop_kf_id].pose), g))
        print(f"loop {e.kf_id} -> {e.loop_kf_id} (frames {fi} -> {fj}): "
              f"measurement off ground truth {m[:3].max():.4f} m, "
              f"{m[3:].max():.5f} rad; odometry {o[:3].max():.4f} m, "
              f"{o[3:].max():.5f} rad")

    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)
                      if hasattr(JConfig(), f.name)})
    jrig = [JCamera(*(np.asarray(x) for x in c)) for c in rig]
    ref = jpipe.VisualOdometry(jcfg, JDS(blank, blank, jrig))
    ref.initialize()
    ref.loop_closure = jlc.LoopClosure(jcfg, ref.cam_left,
                                       embedder="thumbnail")
    jck.load_checkpoint(ref, path)
    ref.loop_closure.stop(ref)
    pgo = {r.frame_id: r.pose for r in ref.archived_keyframes.values()}
    ref._sync_active_to_archive()
    print(f"reference PGO (unit information) {ate(pgo):.4f} m, after its "
          f"finish folds the window back {ate(ref.trajectory()):.4f} m")
    for weighted in (False, True):
        vo = port(weighted)
        vo.finish()
        print(f"port PGO ({'PnP' if weighted else 'unit'} information on "
              f"the loop edges, window written back) "
              f"{ate(vo.trajectory()):.4f} m")


def main() -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--save", metavar="PATH")
    g.add_argument("--load", metavar="PATH")
    args = ap.parse_args()
    if args.save:
        save(args.save)
    else:
        load(args.load)
    return 0


if __name__ == "__main__":
    sys.exit(main())
