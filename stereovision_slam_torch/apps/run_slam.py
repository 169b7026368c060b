"""Stereo visual SLAM command line (counterpart of `apps/run_slam.py`).

    python -m stereovision_slam_torch.apps.run_slam [CONFIG.yaml]
        [--device cuda|cpu] [--mode classic|fused|scan|unrolled]
        [--checkpoint-every N] [--resume PATH]

CONFIG is a YAML file with the reference's keys (default
configs/default.yaml); `dataset_dir` names a KITTI-format sequence
(calib.txt, image_0/, image_1/). Modes:
  classic - the interactive topology: per-frame status machine, BA after
            every keyframe, the loop closure on the host with its shutdown
            PGO, the viewer (the default);
  fused   - the streaming pipeline: stereo init, tracking, BA and, with
            `loopclosure_on`, the loop hook and the shutdown PGO, in one
            step per frame;
  scan    - fused semantics without loop closure, frames in chunks of 32,
            each frame CUDA-graph replays of the fused step's branches;
  unrolled - the same in chunks of 8 (the reference's unrolled chunk).
The run goes to the card unless `--device cpu` is given. `--checkpoint-
every N` saves the whole state every N frames to
<output_dir>/slam_checkpoint.npz; `--resume PATH` continues from such a
file (or from one the JAX package wrote). Without the rerun SDK the viewer
writes its transcript to <output_dir>/viewer.jsonl. Outputs:
<output_dir>/<timestamp>/keyframes.txt and landmarks.pcd.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "configs", "default.yaml")
MODES = ("classic", "fused", "scan", "unrolled")
CHECKPOINT_NAME = "slam_checkpoint.npz"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m stereovision_slam_torch.apps.run_slam",
        description="Stereo visual SLAM on a KITTI-format sequence.")
    ap.add_argument("config", nargs="?", default=None,
                    help=f"YAML config (default {DEFAULT_CONFIG})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mode", default="classic",
                    help="classic (default), fused, scan or unrolled")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N")
    ap.add_argument("--resume", default=None, metavar="PATH")
    return ap.parse_args(argv)


def _frames(vo, checkpoint_every: int, ckpt_path: str, save) -> None:
    """Step through the sequence, saving every `checkpoint_every` frames."""
    n = 0
    while vo.step():
        n += 1
        if checkpoint_every > 0 and n % checkpoint_every == 0:
            save(vo, ckpt_path)


def run(args: argparse.Namespace) -> dict:
    """Run the SLAM as the command line asks. Returns a summary: the
    pipeline (`vo`), `mode`, `fps`, `loops`, the odometry keyframe poses
    before any PGO (`odometry`, {frame_id: pose}), the seconds of the
    shutdown with its PGO (`pgo_s`), the written `output` folder, and
    `lines`, what was printed."""
    from stereovision_slam_torch.device import resolve_device
    from stereovision_slam_torch.io.kitti import KittiDataset
    from stereovision_slam_torch.slam import checkpoint as ckpt
    from stereovision_slam_torch.slam.config import SlamConfig

    lines = []

    def say(msg: str) -> None:
        lines.append(msg)
        print(msg)

    config_path = args.config or DEFAULT_CONFIG
    if args.config is None:
        say(f"No config file specified; using default config {config_path}")
    device = resolve_device(args.device)
    cfg = SlamConfig.from_yaml(config_path)
    dataset = KittiDataset(cfg.dataset_dir, cfg.left_cam_index,
                           cfg.right_cam_index, bool(cfg.is_color_input),
                           device=device)
    dataset.initialize()
    os.makedirs(cfg.output_dir or ".", exist_ok=True)
    ckpt_path = os.path.join(cfg.output_dir or ".", CHECKPOINT_NAME)

    if args.mode != "classic":
        vo = _fused(cfg, dataset, device, args.mode)
        vo.initialize()
        if args.resume:
            ckpt.load_fused_checkpoint(vo, args.resume)
            say(f"Resumed from {args.resume} "
                f"({len(vo.outputs)} frames already processed)")
        t0 = time.perf_counter()
        _frames(vo, args.checkpoint_every, ckpt_path,
                ckpt.save_fused_checkpoint)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        keyframes, landmarks, frames = vo.drain()
        odometry = {fid: pose for fid, pose in keyframes.values()}
        kfs, lms_d, n_loops, tag = list(keyframes.values()), landmarks, 0, ""
        t0 = time.perf_counter()
        if (hasattr(vo, "run_pgo")
                and int(cfg.global_pose_graph_optimization)):
            pgo_traj = vo.run_pgo()
            n_loops = len(vo.loop_edges())
            say(f"Loop closure: {n_loops} loop(s) closed"
                + (", global PGO applied" if n_loops else ""))
            if n_loops:
                kfs = [(fid, pgo_traj[fid]) for fid, _ in keyframes.values()]
                lms_d = getattr(vo, "pgo_landmarks", None) or landmarks
                tag = "+loop"
        pgo_s = time.perf_counter() - t0
        fps = len(frames) / dt
        out = _save(cfg, kfs, lms_d)
        say(f"SLAM finished ({args.mode}{tag}): {len(keyframes)} keyframes, "
            f"{len(lms_d)} landmarks, {fps:.2f} frames/s")
    else:
        vo = _classic(cfg, dataset, device)
        if args.resume:
            ckpt.load_checkpoint(vo, args.resume)
            say(f"Resumed from {args.resume} at frame {vo.frame_count}")
        _frames(vo, args.checkpoint_every, ckpt_path, ckpt.save_checkpoint)
        odometry = dict(vo.trajectory())
        t0 = time.perf_counter()
        vo.finish()
        pgo_s = time.perf_counter() - t0
        lc = vo.loop_closure
        n_loops = len(lc.loop_edges) if lc is not None else 0
        if lc is not None:
            say(f"Loop closure: {n_loops} loop(s) closed"
                + (", global PGO applied" if lc.pgo_ran else ""))
        out = vo.save_output()
        fps = vo.fps()
        say(f"SLAM finished (classic): {len(vo.archived_keyframes)} "
            f"keyframes, {len(vo.archived_landmarks)} landmarks, "
            f"{fps:.2f} frames/s")
    say(f"Output saved to {out}")
    return dict(vo=vo, mode=args.mode, fps=fps, loops=n_loops,
                odometry=odometry, pgo_s=pgo_s, output=out, lines=lines)


def _fused(cfg, dataset, device, mode: str = "fused"):
    from stereovision_slam_torch.slam import fused
    if mode != "fused" or not cfg.loopclosure_on:
        cls = {"fused": fused.FusedVisualOdometry,
               "scan": fused.ScanVisualOdometry,
               "unrolled": fused.UnrolledVisualOdometry}[mode]
        return cls(cfg, dataset, device=device)
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry)
    from stereovision_slam_torch.slam.loop_closure import resolve_embedder
    _, params = resolve_embedder("auto", cfg.dnn_weights_path, device)
    return FusedLoopVisualOdometry(cfg, dataset, place_params=params,
                                   device=device)


def _classic(cfg, dataset, device):
    from stereovision_slam_torch.slam.backend import Backend
    from stereovision_slam_torch.slam.loop_closure import LoopClosure
    from stereovision_slam_torch.slam.pipeline import VisualOdometry
    from stereovision_slam_torch.viz.viewer import _HAS_RERUN, Viewer

    backend = (Backend(chi2_th=cfg.chi2_th, iters=cfg.ba_lm_iters,
                       outlier_rounds=cfg.ba_outlier_rounds)
               if cfg.backend_on else None)
    viewer = None
    if cfg.visualizer_on:
        viewer = Viewer(jsonl_path=None if _HAS_RERUN else os.path.join(
            cfg.output_dir or ".", "viewer.jsonl"))
    vo = VisualOdometry(cfg, dataset, viewer=viewer, backend=backend,
                        device=device)
    vo.initialize()
    if cfg.loopclosure_on:
        vo.loop_closure = LoopClosure(
            cfg, vo.cam_left, mnv2_weights_path=cfg.dnn_weights_path)
    return vo


def _save(cfg, keyframes, landmarks: dict) -> str:
    from stereovision_slam_torch.slam import outputs as out_mod
    lms = (np.stack(list(landmarks.values())) if landmarks
           else np.zeros((0, 3), np.float32))
    return out_mod.save_slam_output(cfg.output_dir, cfg.dataset_dir,
                                    cfg.left_cam_index, keyframes, lms)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode not in MODES:
        print(f"Unknown --mode {args.mode}; expected "
              "classic|fused|scan|unrolled")
        return 1
    config_path = args.config or DEFAULT_CONFIG
    if not os.path.exists(config_path):
        print(f"Config file not found: {config_path}")
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
