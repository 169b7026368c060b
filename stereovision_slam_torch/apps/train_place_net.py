"""Train the PlaceNet place embedder on rendered arena worlds (counterpart of
`benchmarks/train_place_net.py`).

    python -m stereovision_slam_torch.apps.train_place_net --out PATH.npz \
        [--steps 1500] [--arenas 24] [--anchors 64] [--batch 192] \
        [--val-only] [--device cuda|cpu]

The synthetic renderer gives exact poses, so contrastive labels come free:
  * worlds: cylindrical arenas with a random radius, centre, ground height
    and texture phase (`scenes.render_textured_view_cylinder`'s
    `tex_phase`); phases 1 + 0.613 a, never the bench world's 0.0;
  * views: random in-arena poses, each anchor with a jittered positive
    (N(0, 0.4 m) of position, N(0, 4 deg) of heading), rendered at 188x620
    on the device in batches, then `place_net.preprocess`;
  * loss: symmetric InfoNCE over in-batch negatives (tau 0.07) on views
    with photometric augmentation (gain U(0.75, 1.3), bias U(-0.1, 0.1),
    noise N(0, 0.015)); pairs of one arena closer than 3 m and 25 deg are
    neither positive nor negative (`infonce_loss`);
  * optimizer: `init_params(seed=3)`, Adam (b1 0.9, b2 0.999, eps 1e-8)
    under optax's `cosine_decay_schedule(3e-4, steps, alpha=0.05)`; the
    forward in float32 with TF32 off;
  * validation: the candidate rule the loop hook runs (the argmax beyond
    a 24-frame skip window, gated at a threshold; a hit is a true revisit,
    under 2 m and 20 deg) on 96-frame circuits of held-out worlds (phase
    0.0, the bench world, and 91.3, 92.6, 95.1), at thresholds 0.5-0.8.

The data draws (`np.random.default_rng(7)`) are numpy's, so the views are
the reference tool's views. Batches and augmentation come from an explicit
`torch.Generator` (seed 11): they are not `jax.random.choice`'s draws. The
tool writes only `--out`, which has no default and may not be the shipped
weights file; `--val-only` validates the weights already at `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W = 188, 620            # the bench's size
VAL_PHASES = (0.0, 91.3, 92.6, 95.1)
THRESHOLDS = (0.5, 0.6, 0.7, 0.8)
RENDER_BATCH = 16
TAU = 0.07


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m stereovision_slam_torch.apps.train_place_net",
        description="Train PlaceNet on rendered arenas and validate it.")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--arenas", type=int, default=24)
    ap.add_argument("--anchors", type=int, default=64)
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--val-only", action="store_true",
                    help="validate the weights at --out, train nothing")
    ap.add_argument("--out", required=True,
                    help="the npz the weights are written to (or read from, "
                         "with --val-only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def pose_from_xz_yaw(x, z, yaw) -> np.ndarray:
    """World->rig pose of a camera at (x, 0, z) heading `yaw` (0 looks
    along world +z; camera +z forward, y down)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, -s],
                  [0.0, 1.0, 0.0],
                  [s, 0.0, c]], np.float32)
    o = np.array([x, 0.0, z], np.float32)
    t = -R @ o
    return np.concatenate([R, t[:, None]], axis=1)


def _render(poses: np.ndarray, device, **kw) -> torch.Tensor:
    """Preprocessed (N, IN_H, IN_W) views of the arena from the left camera
    of the bench rig, RENDER_BATCH poses a pass."""
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.models import place_net

    cam = scenes.make_stereo_rig()[0]
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy)
    out = [place_net.preprocess(scenes.render_textured_views_cylinder(
        cam_params, torch.from_numpy(poses[i:i + RENDER_BATCH]), H, W,
        device=device, **kw)) for i in range(0, len(poses), RENDER_BATCH)]
    return torch.cat(out)


def sample_arena_views(rng, phase: float, n_anchors: int, device):
    """n_anchors (anchor, positive) pairs in one random arena. Returns
    (views (2n, IN_H, IN_W) on `device`, anchor first, then its positive;
    (2n, 3) float32 numpy x, z, yaw)."""
    radius = rng.uniform(18.0, 32.0)
    cx = rng.uniform(-3.0, 3.0)
    cz = rng.uniform(3.0, 9.0)
    ground_y = rng.uniform(1.4, 2.0)
    poses, meta = [], []
    for _ in range(n_anchors):
        r = radius * np.sqrt(rng.uniform(0.0, 1.0)) * 0.72
        th = rng.uniform(0.0, 2 * np.pi)
        x, z = cx + r * np.sin(th), cz + r * np.cos(th)
        yaw = rng.uniform(0.0, 2 * np.pi)
        poses.append(pose_from_xz_yaw(x, z, yaw))
        meta.append((x, z, yaw))
        xp = x + rng.normal(0.0, 0.4)
        zp = z + rng.normal(0.0, 0.4)
        yp = yaw + rng.normal(0.0, np.deg2rad(4.0))
        poses.append(pose_from_xz_yaw(xp, zp, yp))
        meta.append((xp, zp, yp))
    views = _render(np.stack(poses), device, ground_y=ground_y,
                    center_x=cx, center_z=cz, radius=radius, tex_phase=phase)
    return views, np.asarray(meta, np.float32)


def build_dataset(rng, arenas: int, anchors: int, device, log=None):
    """Views of `arenas` training worlds (phases 1 + 0.613 a): ((P, 2,
    IN_H, IN_W) anchor/positive pairs on `device`, (P, 2, 4) float32 meta
    x, z, yaw, arena on `device`)."""
    t0 = time.perf_counter()
    imgs, meta = [], []
    phases = 1.0 + np.arange(arenas, dtype=np.float64) * 0.613
    for ai, phase in enumerate(phases):
        views, mt = sample_arena_views(rng, float(phase), anchors, device)
        imgs.append(views)
        meta.append(np.concatenate(
            [mt, np.full((len(mt), 1), ai, np.float32)], axis=1))
        if log:
            log(f"arena {ai}: {len(views)} views "
                f"({time.perf_counter() - t0:.1f} s)")
    imgs = torch.cat(imgs)
    n_pairs = len(imgs) // 2
    meta = torch.from_numpy(np.concatenate(meta)).to(imgs.device)
    return (imgs.reshape(n_pairs, 2, *imgs.shape[1:]),
            meta.reshape(n_pairs, 2, 4))


def infonce_loss(params: dict, x, meta, gain, bias, noise,
                 tau: float = TAU) -> torch.Tensor:
    """The symmetric InfoNCE of a batch: x (2B, IN_H, IN_W) views, anchor
    b at 2b and its positive at 2b + 1; meta (B, 2, 4) x, z, yaw, arena of
    each; gain, bias (2B, 1, 1) and noise (2B, IN_H, IN_W) the photometric
    augmentation. Off-diagonal pairs of one arena within 3 m and 25 deg are
    masked out of the logits (-1e9)."""
    from stereovision_slam_torch.models import place_net

    B = meta.shape[0]
    x = x * gain + bias + noise
    z = place_net.forward(params, x,
                          compute_dtype=torch.float32).reshape(B, 2, -1)
    logits = z[:, 0] @ z[:, 1].T / tau
    ma, mp = meta[:, 0], meta[:, 1]
    d2 = torch.sum((ma[:, None, :2] - mp[None, :, :2]) ** 2, dim=-1)
    dd = ma[:, None, 2] - mp[None, :, 2]
    dyaw = torch.abs(torch.atan2(torch.sin(dd), torch.cos(dd)))
    near = ((ma[:, None, 3] == mp[None, :, 3]) & (d2 < 9.0)
            & (dyaw < math.radians(25.0)))
    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    logits = torch.where(near & ~eye, torch.full_like(logits, -1e9), logits)
    labels = torch.arange(B, device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def cosine_lr(step: int, steps: int, init: float = 3e-4,
              alpha: float = 0.05) -> float:
    """optax's `cosine_decay_schedule(init, steps, alpha)` at `step`."""
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))
    return init * ((1.0 - alpha) * cosine + alpha)


def optimizer(ps: list, steps: int) -> torch.optim.Adam:
    """optax's `adam(cosine_decay_schedule(3e-4, steps, alpha=0.05))`:
    b1 0.9, b2 0.999, eps 1e-8 outside the root; `set_lr` before each
    step."""
    return torch.optim.Adam(ps, lr=cosine_lr(0, steps), betas=(0.9, 0.999),
                            eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, step: int, steps: int) -> None:
    for group in opt.param_groups:
        group["lr"] = cosine_lr(step, steps)


def leaves(params: dict) -> list:
    """The parameter tensors in a fixed order."""
    return ([t for c in params["convs"] for t in (c["w"], c["b"])]
            + [params["proj"]["w"], params["proj"]["b"]])


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train(data, meta, steps: int, batch: int, device, seed: int = 11,
          log=None):
    """Adam on `infonce_loss` from `init_params(seed=3)` over `steps`
    batches of `batch` pairs drawn without replacement. Returns (params,
    the loss of every step as a float32 numpy array, seconds)."""
    from stereovision_slam_torch.models import place_net

    params = place_net.init_params(seed=3, device=device)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    opt = optimizer(ps, steps)
    gen = torch.Generator(device=data.device).manual_seed(seed)
    n_pairs = data.shape[0]
    shape = (2 * batch, 1, 1)
    losses = []
    t0 = time.perf_counter()
    with no_tf32():
        for step in range(steps):
            idx = torch.randperm(n_pairs, generator=gen,
                                 device=data.device)[:batch]
            x = data[idx].reshape(2 * batch, *data.shape[2:])
            gain = 0.75 + 0.55 * torch.rand(shape, generator=gen,
                                            device=data.device)
            bias = -0.1 + 0.2 * torch.rand(shape, generator=gen,
                                           device=data.device)
            noise = 0.015 * torch.randn(x.shape, generator=gen,
                                        device=data.device)
            set_lr(opt, step, steps)
            opt.zero_grad(set_to_none=True)
            loss = infonce_loss(params, x, meta[idx], gain, bias, noise)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if log and (step % 100 == 0 or step == steps - 1):
                log(f"step {step}: loss {float(losses[-1]):.4f} "
                    f"({time.perf_counter() - t0:.1f} s)")
    if data.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for p in ps:
        p.requires_grad_(False)
    return params, torch.stack(losses).cpu().numpy(), dt


def render_circuit(phase: float, T: int, rng, device):
    """A bench-like closed circuit (yaw 2 pi / (T - 8)) in the world of
    `phase`, with a random radius and step: (preprocessed views (T,
    IN_H, IN_W) on `device`, centres (T, 2), yaws (T,))."""
    from stereovision_slam_torch import scenes

    radius = rng.uniform(20.0, 30.0)
    step = rng.uniform(0.3, 0.45)
    gt = scenes.forward_motion_poses(T, step=step,
                                     yaw_rate=2 * np.pi / (T - 8)).numpy()
    views = _render(gt, device, center_x=0.0, center_z=6.0, radius=radius,
                    tex_phase=phase)
    cen = np.stack([-p[:, :3].T @ p[:, 3] for p in gt])[:, [0, 2]]
    yaws = np.array([np.arctan2(-p[2, 0], p[2, 2]) for p in gt])
    return views, cen, yaws


def candidate_pr(embs, cen, yaws, threshold: float, skip: int = 24):
    """(precision, recall, fired, frames with a true revisit) of the loop
    hook's candidate rule: per frame the argmax over the database beyond
    the skip window, fired at `threshold`, right when under 2 m and 20 deg
    of the frame."""
    T = len(embs)
    sims = embs @ embs.T
    fired = correct = have = hit = 0
    for i in range(skip + 1, T):
        js = sims[i, :i - skip]
        j = int(np.argmax(js))
        d = np.linalg.norm(cen[i][None] - cen[:i - skip], axis=1)
        dy = np.abs(np.angle(np.exp(1j * (yaws[i] - yaws[:i - skip]))))
        true_exists = bool(((d < 2.0) & (dy < np.deg2rad(20))).any())
        have += true_exists
        if js[j] >= threshold:
            fired += 1
            good = (np.linalg.norm(cen[i] - cen[j]) < 2.0
                    and abs(np.angle(np.exp(1j * (yaws[i] - yaws[j]))))
                    < np.deg2rad(20))
            correct += good
            hit += true_exists and good
    return (correct / max(fired, 1), hit / max(have, 1), fired, have)


def validate(params: dict, device, phases=VAL_PHASES,
             thresholds=THRESHOLDS, T: int = 96) -> dict:
    """{(phase, threshold): candidate_pr} on a T-frame circuit of each
    held-out world (the embeddings of the deployed bf16 forward)."""
    from stereovision_slam_torch.models import place_net

    table = {}
    for phase in phases:
        views, cen, yaws = render_circuit(
            phase, T, np.random.default_rng(int(phase * 10) + 5), device)
        embs = place_net.forward(params, views).cpu().numpy()
        for thr in thresholds:
            table[(phase, thr)] = candidate_pr(embs, cen, yaws, thr)
    return table


def heldout_discrimination(params: dict, device, pairs: int = 6):
    """The held-out world test of the reference's suite (texture phase
    57.3, radius 24, never trained on): per random place, the cosine of a
    jittered same-place view (positive) and of a far place and the same
    place turned 120 deg (negatives). Returns (positives, negatives)."""
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.models import place_net

    rng = np.random.default_rng(3)
    cam = scenes.make_stereo_rig()[0]
    cam_params = (cam.fx, cam.fy, cam.cx, cam.cy)

    def embed(x, z, yaw):
        img = scenes.render_textured_view_cylinder(
            cam_params, pose_from_xz_yaw(x, z, yaw), H, W, center_x=0.0,
            center_z=6.0, radius=24.0, tex_phase=57.3, device=device)
        return place_net.embed_image(params, img).cpu().numpy()

    pos, neg = [], []
    for _ in range(pairs):
        x = rng.uniform(-8, 8)
        z = rng.uniform(-2, 14)
        yaw = rng.uniform(0, 2 * np.pi)
        e0 = embed(x, z, yaw)
        e1 = embed(x + rng.normal(0, 0.3), z + rng.normal(0, 0.3),
                   yaw + rng.normal(0, np.deg2rad(3)))
        e2 = embed(rng.uniform(-8, 8), rng.uniform(-2, 14),
                   rng.uniform(0, 2 * np.pi))
        e3 = embed(x, z, yaw + 2 * np.pi / 3)
        pos.append(float(e0 @ e1))
        neg.extend([float(e0 @ e2), float(e0 @ e3)])
    return pos, neg


def print_table(table: dict, log) -> None:
    log("phase  thr   precision  recall  fired/have")
    for (phase, thr), (p, r, f, hv) in table.items():
        log(f"{phase:5.1f}  {thr:.2f}  {p:9.2f}  {r:6.2f}  {f}/{hv}")


def run(args: argparse.Namespace) -> dict:
    """Train (unless --val-only), write --out, validate. Returns a summary:
    `losses` (every step's), `train_s`, `steps_per_s`, `render_s`, `table`
    (`validate`'s) and `out`."""
    from stereovision_slam_torch.device import resolve_device
    from stereovision_slam_torch.models import place_net

    out = os.path.abspath(args.out)
    if out == os.path.abspath(place_net.WEIGHTS_PATH):
        raise ValueError(f"--out {args.out} is the shipped weights file")
    device = resolve_device(args.device)

    def log(msg):
        print(msg, file=sys.stderr)

    summary = dict(out=out, losses=None, train_s=0.0, steps_per_s=0.0,
                   render_s=0.0)
    if not args.val_only:
        t0 = time.perf_counter()
        data, meta = build_dataset(np.random.default_rng(7), args.arenas,
                                   args.anchors, device, log)
        summary["render_s"] = time.perf_counter() - t0
        log(f"dataset: {2 * data.shape[0]} views, {data.shape[0]} pairs, "
            f"{data.numel() * 4 / 1e6:.0f} MB, rendered in "
            f"{summary['render_s']:.1f} s")
        params, losses, dt = train(data, meta, args.steps, args.batch,
                                   device, log=log)
        place_net.save_params(params, out)
        log(f"saved {out}")
        summary.update(losses=losses, train_s=dt,
                       steps_per_s=args.steps / max(dt, 1e-9))
    params = place_net.load_params(out, device=device)
    summary["table"] = validate(params, device)
    print_table(summary["table"], log)
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.val_only and not os.path.exists(args.out):
        print(f"no weights at {args.out}", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
