"""The loop path's decisions from one state, in both packages.

On the card (imports no JAX):

    python -m tests.torch_loop_state --scene circuit --save OUT.npz
        [--loop N] [--after M] [--pose-launch K] [--device cuda]

runs the port's loop path (`FusedLoopVisualOdometry` on "cuda" with the
settings of `chip_smoke.py`'s phase 13 and the shipped PlaceNet weights)
over the scene, prints each loop as it closes, the keyframe ATE and the
ATE after the shutdown PGO, and saves the state before the frame on which
the N-th loop closed (default the first), the final state and the M
frames from that one on (default 16); with --pose-launch, kernel B's
inputs and outputs at its K-th launch (one a tracked frame).

On the CPU:

    JAX_PLATFORMS=cpu python -m tests.torch_loop_state --load OUT.npz
        [--frames M] [--xla]

carries the saved states into both packages (`convert` for the port, the
same arrays for the reference) and (1) runs the saved frames from the
state before the loop through the reference's `FusedLoopVisualOdometry`
(its CPU path) and through the port's on the CPU, printing each one's loop
decisions, its error to ground truth on each frame, and where the saved
frames reach the end of the scene the ATE before and after PGO; (2) runs
`run_pgo` of both packages on the card's final state; and with a saved
kernel B launch, the plain version on its inputs in float32 and float64
against the kernel's pose. So it shows whether the reference
reaches the card's loop decision and PGO result from the card's own state.
A tool, not a test: the reference's loop step compiles for about a minute.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

GROUPS = ("fs", "ms", "arc", "ls")


def _center(p):
    return -p[:3, :3].T @ p[:3, 3]


def _ates(keyframes, traj, gt):
    e0 = [np.linalg.norm(_center(p) - _center(gt[f]))
          for f, p in sorted(keyframes.values())]
    e1 = [np.linalg.norm(_center(np.asarray(p)) - _center(gt[f]))
          for f, p in traj.items()]
    return (float(np.sqrt(np.mean(np.square(e0)))),
            float(np.sqrt(np.mean(np.square(e1)))))


def _flat(prefix, state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, (tuple, list)):
            for i, lv in enumerate(v):
                out[f"{prefix}.{f}.{i}"] = lv.detach().cpu().numpy()
        else:
            out[f"{prefix}.{f}"] = v.detach().cpu().numpy()
    return out


def _unflat(data, prefix, cls) -> dict:
    vals = {}
    for f in cls._fields:
        if f"{prefix}.{f}" in data:
            vals[f] = data[f"{prefix}.{f}"]
        else:
            vals[f] = tuple(data[f"{prefix}.{f}.{i}"] for i in range(64)
                            if f"{prefix}.{f}.{i}" in data)
    return vals


def card(scene: str, out: str, device: str = "cuda", loop_no: int = 1,
         after: int = 16, pose_launch: int | None = None) -> None:
    import torch

    sys.path.insert(0, ".")
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.slam.fused_loop import (
        FusedLoopVisualOdometry)

    make = scenes.circuit if scene == "circuit" else scenes.circuit_long
    lefts, rights, gt, dist, rig = make(device=device)
    vo = FusedLoopVisualOdometry(
        chip_smoke.loop_config(), ArraySequenceDataset(lefts, rights,
                                                       list(rig)),
        place_params=place_net.get_params(device=device),
        max_total_keyframes=512, max_total_landmarks=1 << 16, device=device)
    vo.initialize()
    first, n_loops, k = None, 0, 0
    records = []
    with chip_smoke.recorded(records):
        while True:
            pre = (vo.fs, vo.ms, vo.arc, vo.kf_count, vo.ls)
            if not vo.step():
                break
            n = int(vo.ls.n_loops)
            if n > n_loops:
                e = vo.loop_edges()[-1]
                print(f"frame {k}: loop {n} closed, keyframe {e.kf_id} -> "
                      f"{e.loop_kf_id}")
                if first is None and n >= loop_no:
                    first = (k, pre)
                n_loops = n
            k += 1
    keyframes, _, _ = vo.drain()
    traj = vo.run_pgo()
    ate, ate_pgo = _ates(keyframes, traj, gt)
    print(f"port on {device}, {scene}: {len(keyframes)} keyframes, "
          f"{n_loops} loops, keyframe ATE {ate:.4f} m, after PGO "
          f"{ate_pgo:.4f} m over {dist:.1f} m")
    arrays = {"gt": gt, "dist": np.asarray(dist), "T": np.asarray(len(lefts)),
              "card_ate": np.asarray([ate, ate_pgo])}
    final = (vo.fs, vo.ms, vo.arc, vo.kf_count, vo.ls)
    for tag, st in (("final", final),) + ((("pre", first[1]),)
                                           if first else ()):
        for g, s in zip(GROUPS, (st[0], st[1], st[2], st[4])):
            arrays.update(_flat(f"{tag}.{g}", s))
        arrays[f"{tag}.kf_count"] = np.asarray(st[3])
    if pose_launch is not None:
        # kernel B's inputs and outputs at that launch (a launch per
        # tracked frame, in order)
        _, args, kw, res = [r for r in records if r[0] == "B"][pose_launch]
        for name, t in zip(("camp", "pts", "uv_l", "uv_r", "valid_l",
                            "valid_r", "T0"), args):
            arrays[f"pose.{name}"] = t.cpu().numpy()
        arrays["pose.kernel_T"] = res.T.cpu().numpy()
        arrays["pose.kw"] = np.asarray([kw["chi2_th"], kw["rounds"],
                                        kw["iters"]])
    if first is not None:
        k0 = first[0]
        arrays["k"] = np.asarray(k0)
        arrays["lefts"] = lefts[k0:k0 + after]
        arrays["rights"] = rights[k0:k0 + after]
    np.savez_compressed(out, **arrays)
    print(f"saved {out}")


def _port_on_reference_routes() -> None:
    """Run the port's frontend on the reference's CPU routes: the per-level
    LK over the full image and the LU pose solve (`pallas_mode="xla"`), so
    that the two packages differ only in sum orders."""
    import functools

    from stereovision_slam_torch.ops import lk
    from stereovision_slam_torch.slam import frontend

    serving = frontend.track_step_serving

    def track_step(fs, m, cur_pyr, cam_left, cur_right_pyr, cam_right, *,
                   camp=None, **kw):
        def one(x):
            return (tuple(lv[None] for lv in x) if isinstance(x, tuple)
                    else x[None])
        fs1, n_in, n_tr = serving(
            frontend.FrontendState(*map(one, fs)),
            frontend.mapmod.MapState(*map(one, m)), one(tuple(cur_pyr)),
            cam_left, one(tuple(cur_right_pyr)), cam_right,
            pallas_mode="xla", **kw)
        return (frontend.FrontendState(*(
            tuple(lv[0] for lv in x) if isinstance(x, tuple) else x[0]
            for x in fs1)), n_in[0], n_tr[0])

    frontend.track_step = track_step
    lk.track = functools.partial(lk.track, pallas_mode="xla")


def cpu(path: str, frames: int | None = None, xla: bool = False) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from stereovision_slam_tpu.io.kitti import ArraySequenceDataset as JDS
    from stereovision_slam_tpu.models import place_net as jplace
    from stereovision_slam_tpu.slam import fused as jfused
    from stereovision_slam_tpu.slam import fused_loop as jfl
    from stereovision_slam_tpu.slam import map_state as jmap
    from stereovision_slam_tpu.slam.config import SlamConfig as JConfig
    from stereovision_slam_tpu.slam.frontend import FrontendState as JFS
    from stereovision_slam_torch import convert, scenes
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.slam import fused as tfused
    from stereovision_slam_torch.slam import fused_loop as tfl
    from stereovision_slam_torch.slam import map_state as tmap
    from stereovision_slam_torch.slam.frontend import FrontendState as TFS
    from tests import synthetic

    sys.path.insert(0, ".")
    import chip_smoke

    if xla:
        _port_on_reference_routes()
    data = dict(np.load(path))
    if "pose.pts" in data:
        _pose_launch(data)
    gt, T = data["gt"], int(data["T"])
    rig = scenes.make_stereo_rig()
    cfg = chip_smoke.loop_config()
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jrig = synthetic.make_stereo_rig()
    classes = {"fs": (JFS, TFS), "ms": (jmap.MapState, tmap.MapState),
               "arc": (jfused.ArchiveState, tfused.ArchiveState),
               "ls": (jfl.LoopState, tfl.LoopState)}

    def jax_state(tag, g):
        vals = _unflat(data, f"{tag}.{g}", classes[g][0])
        fix = {}
        for f, v in vals.items():
            if isinstance(v, tuple):
                fix[f] = tuple(jnp.asarray(x) for x in v)
            elif g == "ls" and f == "db_desc":
                fix[f] = jnp.asarray(v.view(np.uint32))
            else:
                fix[f] = jnp.asarray(v)
        return classes[g][0](**fix)

    def port_state(tag, g):
        vals = _unflat(data, f"{tag}.{g}", classes[g][1])
        return classes[g][1](**{f: tuple(convert.tensor(x) for x in v)
                                if isinstance(v, tuple) else convert.tensor(v)
                                for f, v in vals.items()})

    def build(tag, lefts, rights, k):
        jl = jfl.FusedLoopVisualOdometry(jcfg, JDS(lefts, rights, jrig),
                                         max_total_keyframes=512,
                                         max_total_landmarks=1 << 16)
        jl.initialize()
        jl.mnv2_params = jplace.get_params()
        jl.fs, jl.ms, jl.arc, jl.ls = (jax_state(tag, g) for g in GROUPS)
        jl.kf_count = jnp.int32(int(data[f"{tag}.kf_count"]))
        jl._fids = list(range(k))
        pl = tfl.FusedLoopVisualOdometry(
            cfg, ArraySequenceDataset(lefts, rights, list(rig)),
            place_params=place_net.get_params(device="cpu"),
            max_total_keyframes=512, max_total_landmarks=1 << 16,
            device="cpu")
        pl.initialize()
        pl.fs, pl.ms, pl.arc, pl.ls = (port_state(tag, g) for g in GROUPS)
        pl.kf_count = int(data[f"{tag}.kf_count"])
        for vo in (jl, pl):
            vo.dataset.current_index = k
        return jl, pl

    from tests.torch_pose_drift import _drift
    for tag in ("pre", "final"):
        if f"{tag}.fs.T_cur" in data:
            win = data[f"{tag}.ms.kf_valid"]
            print(f"{tag} state: max |R R^T - I| of T_cur "
                  f"{_drift(data[f'{tag}.fs.T_cur']):.3e}, of the window's "
                  f"keyframes {_drift(data[f'{tag}.ms.kf_pose'][win]):.3e}")
    blank = np.zeros((T, 1, 1), np.float32)
    if "k" in data:
        k = int(data["k"])
        saved = len(data["lefts"]) if "lefts" in data else 0
        M = saved if frames is None else frames
        lefts = np.zeros((k + M, 188, 620), np.float32)
        rights = np.zeros_like(lefts)
        if M <= saved:
            lefts[k:], rights[k:] = data["lefts"][:M], data["rights"][:M]
            src = "the card's"
        else:    # the frames rendered again on the CPU
            make = (scenes.circuit if T == 120 else scenes.circuit_long)
            cl, cr = make(T)[:2]
            lefts[k:], rights[k:] = cl[k:k + M], cr[k:k + M]
            src = "CPU-rendered"
        jl, pl = build("pre", lefts, rights, k)
        n0 = int(jl.ls.n_loops)
        for name, vo in (("reference", jl), ("port", pl)):
            closed, errs, f = [], [], k
            while vo.step():
                n = int(vo.ls.n_loops)
                if n > n0 + len(closed):
                    e = vo.loop_edges()[-1]
                    closed.append(f"{f}:{e.kf_id}->{e.loop_kf_id}")
                errs.append(f"{f}:{np.linalg.norm(_center(np.asarray(vo.fs.T_cur)) - _center(gt[f])):.3f}")
                f += 1
            keyframes, _, _ = vo.drain()
            every = max(1, M // 16)
            print(f"{name} on the CPU from the card's state before frame {k} "
                  f"({M} {src} frames): new loops (frame:keyframes) "
                  f"{' '.join(closed)}; {len(keyframes)} keyframes; error "
                  f"(frame:m) {' '.join(errs[::every])}", flush=True)
            if k + M == T:
                ate, ate_pgo = _ates(keyframes, vo.run_pgo(), gt)
                print(f"  keyframe ATE {ate:.4f} m, after PGO {ate_pgo:.4f} m",
                      flush=True)
    jl, pl = build("final", blank, blank, T)
    for name, vo in (("reference", jl), ("port", pl)):
        keyframes, _, _ = vo.drain()
        ate, ate_pgo = _ates(keyframes, vo.run_pgo(), gt)
        print(f"{name} run_pgo on the card's final state: "
              f"{len(vo.loop_edges())} loops, keyframe ATE {ate:.4f} m, "
              f"after PGO {ate_pgo:.4f} m (the card: "
              f"{data['card_ate'][0]:.4f}, {data['card_ate'][1]:.4f})",
              flush=True)


def _pose_launch(data) -> None:
    """Kernel B's saved launch against its plain version in float32 and in
    float64 on the CPU: how far rounding alone moves the 3 x 6 schedule."""
    import torch

    from stereovision_slam_torch.ops import pose_kernel

    names = ("camp", "pts", "uv_l", "uv_r", "valid_l", "valid_r", "T0")
    chi2_th, rounds, iters = data["pose.kw"]
    kw = dict(chi2_th=float(chi2_th), rounds=int(rounds), iters=int(iters))
    out = {}
    for dt in (torch.float32, torch.float64):
        args = [torch.from_numpy(data[f"pose.{n}"]) for n in names]
        args = [a.to(dt) if a.is_floating_point() else a for a in args]
        out[dt] = pose_kernel.pose_lm_plain(*args, **kw)
    k = torch.from_numpy(data["pose.kernel_T"])
    p32, p64 = out[torch.float32], out[torch.float64]
    print(f"kernel B launch: left inliers plain f32 "
          f"{p32.n_inliers.tolist()}, plain f64 {p64.n_inliers.tolist()}; "
          f"chosen pose gaps: kernel - plain f32 "
          f"{float((k - p32.T).abs().max()):.3e}, plain f64 - plain f32 "
          f"{float((p64.T - p32.T.double()).abs().max()):.3e}, kernel - "
          f"plain f64 {float((k.double() - p64.T).abs().max()):.3e}; costs "
          f"f32 {p32.cost.tolist()} f64 {p64.cost.tolist()}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="circuit",
                    choices=("circuit", "circuit_long"))
    ap.add_argument("--save")
    ap.add_argument("--loop", type=int, default=1,
                    help="save the state before the frame that closes this "
                         "loop")
    ap.add_argument("--after", type=int, default=16,
                    help="frames saved from that frame on")
    ap.add_argument("--pose-launch", type=int,
                    help="with --save: also save kernel B's inputs and "
                         "outputs at this launch")
    ap.add_argument("--frames", type=int,
                    help="with --load: frames to run from the saved state "
                         "(beyond the saved ones, rendered on the CPU)")
    ap.add_argument("--xla", action="store_true",
                    help="with --load: the port on the reference's CPU "
                         "routes (full-image LK, LU pose solve)")
    ap.add_argument("--device", default="cuda",
                    help="where --save runs the port (the card by default)")
    ap.add_argument("--load")
    args = ap.parse_args()
    if args.load:
        cpu(args.load, args.frames, args.xla)
    else:
        card(args.scene, args.save, args.device, args.loop, args.after,
             args.pose_launch)


if __name__ == "__main__":
    main()
