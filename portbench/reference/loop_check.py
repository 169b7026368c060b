"""The loop cell's comparison with the plain reference (`step.py` and the
modules it uses, on the CPU, after the window).

A SLAM trajectory is chaotic in its rounding, so the reference follows the
program from the program's own state rather than running a drive of its
own. It checks:

* the stereo start of the first drive that starts in the window, from the
  empty window;
* at the frames drawn from the seed (`Driver.samples`, at least one of
  them a keyframe), the whole frame from the state copied before it, with
  the pyramids built again from the benchmark's images (the frame, the
  previous frame, the anchor keyframe): tracking, the reference's own
  choice of branch from its own inlier count, and on a keyframe the
  keyframe's window, bundle adjustment and loop hook (with PnP and the
  local fusion where a loop closes). `pose_gap`: the frame's pose;
  `inlier_gap`: the inlier counts' difference, or where the program took
  another branch, how far the reference's count lies from the counts that
  lead to the program's branch, whichever is larger; where both made a
  keyframe, `window_gap`: the window's keyframe poses by keyframe id, and
  `landmark_gap`: the median over the landmarks in the same slot with the
  same id of the position gap over the landmark's distance from the
  camera;
* loop edges of the drives in the window (`edge_samples` a drive, drawn
  from the seed), verified again from the loop database the program kept
  (`edge_gap`, the relative pose), the ORB descriptors of both keyframes
  recomputed from their images (`desc_bits`, the share of differing bits)
  and the PlaceNet embeddings of the edges' keyframes and of keyframes
  drawn from the seed (`embed_gap`, 1 - cosine);
* the shutdown PGO of `pgo_samples` drives that ended in the window, solved
  again on the graph of the program's final state (`pgo_cost_gap`: |ln|
  of the cost at the program's poses over the cost at the reference's).

A pose gap is the largest absolute difference of the (3, 4) entries. A
run's number is the largest over its samples (`common.reduce`). The
control (`control=True`) is the reference put in the program's place at
the next precision down: every float input of each stage (images, state,
database rows, graph) stored in bfloat16.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import harness
from portbench.reference import common, loop, pgo, window
from portbench.reference.step import Reference

NAMES = ("pose_gap", "inlier_gap", "window_gap", "landmark_gap", "edge_gap",
         "desc_bits", "embed_gap", "pgo_cost_gap")


def _d(x) -> dict:
    return {k: v for k, v in x._asdict().items() if torch.is_tensor(v)}


def pose_gap(a, b) -> float:
    return float((torch.as_tensor(a).double()
                  - torch.as_tensor(b).double()).abs().max())


def window_gaps(prog: dict, ref: dict, T):
    """(largest keyframe pose gap by id, 1 where the two windows hold
    different keyframes; the median landmark gap over its distance from
    the camera at T, or None without common landmarks)."""
    def slots(w):
        return {int(w["kf_id"][s]): s
                for s in torch.nonzero(w["kf_valid"]).flatten().tolist()}
    sp, sr = slots(prog), slots(ref)
    gap = 0.0 if set(sp) == set(sr) else 1.0
    for k in set(sp) & set(sr):
        gap = max(gap, pose_gap(prog["kf_pose"][sp[k]], ref["kf_pose"][sr[k]]))
    both = prog["lm_valid"] & ref["lm_valid"] & (prog["lm_id"]
                                                 == ref["lm_id"])
    if not bool(both.any()):
        return gap, None
    T = torch.as_tensor(T).float()
    center = -T[:, :3].T @ T[:, 3]
    q = ref["lm_pos"][both]
    dist = torch.clamp(torch.linalg.vector_norm(q - center, dim=1), min=1.0)
    rel = torch.linalg.vector_norm(prog["lm_pos"][both] - q, dim=1) / dist
    return gap, float(rel.median())


def inlier_gap(ref: Reference, n_prog: int, kf_prog: bool, n_ref: int,
               branch_ref: str) -> float:
    gap = abs(n_prog - n_ref)
    branch = "lost" if n_prog <= ref.bad_threshold else (
        "keyframe" if kf_prog else "track")
    if branch != branch_ref:
        lo, hi = ref.branch_range(branch)
        gap = max(gap, lo - n_ref, n_ref - hi)
    return float(gap)


def frame_numbers(ref: Reference, drv, s: dict, control: bool) -> dict:
    d = drv.drives[s["drive"]]

    def img(t, side=0):
        """The drive's frame t (left, or right with side 1)."""
        lap = (drv.lap_l, drv.lap_r)[side]
        return common.lower(lap[drv.lap_index(d, t)], control)

    pyr, rpyr = ref.pyramid(img(s["t"])), ref.pyramid(img(s["t"], 1))
    if s["pre"] is None:
        T, n, w = ref.start(pyr, rpyr, s["t"])
        if n < ref.n_init:
            w = ref.empty_window()
        out = {"pose_gap": pose_gap(s["pose"], T),
               "inlier_gap": float(abs(s["n_in"] - n))}
    else:
        fs, w0, _, ls = (common.lower(_d(x), control) for x in s["pre"])
        anchor = int(w0["kf_frame_id"][window.newest(w0)])
        T, n, branch, w = ref.frame(
            fs, w0, ls, ref.pyramid(img(s["t"] - 1)), ref.pyramid(img(anchor)),
            pyr, rpyr, s["t"], s["pre_kf"] + 1)
        out = {"pose_gap": pose_gap(s["pose"], T),
               "inlier_gap": inlier_gap(ref, s["n_in"], s["kf"], n, branch)}
    if s["kf"] and w is not None:
        out["window_gap"], lm = window_gaps(_d(s["post"][1]), w, T)
        if lm is not None:
            out["landmark_gap"] = lm
    return out


def edge_numbers(ref: Reference, drv, d: dict, edge_pick, kf_pick,
                 control: bool) -> dict:
    """Loop edges drawn from the seed (`edge_pick(n)`) of one drive from
    its final state, their keyframes' descriptors, and embeddings."""
    arc, _, ls = (_d(x) for x in d["state"])
    ls = common.lower(ls, control)
    n = min(int(ls["n_loops"]), ls["loop_i"].shape[0])
    out = {"edge_gap": [], "desc_bits": [], "embed_gap": []}
    frame_of = {k: int(arc["kf_frame_id"][k])
                for k in torch.nonzero(arc["kf_set"]).flatten().tolist()}

    def image(kf):
        return common.lower(drv.lap_l[drv.lap_index(d, frame_of[kf])],
                            control)

    kfs = set()
    for e in edge_pick(n):
        i, j = int(ls["loop_i"][e]), int(ls["loop_j"][e])
        _, rel, _, _, _ = ref.attempt(ls, j, ls["db_desc"][i],
                                      ls["db_desc_ok"][i], ls["db_uv"][i], i)
        out["edge_gap"].append(pose_gap(ls["loop_rel"][e], rel))
        kfs.update((i, j))
    for kf in sorted(kfs):
        desc, ok = loop.orb(image(kf), ls["db_uv"][kf],
                            ls["db_desc_ok"][kf], ref.pattern)
        same = ok == ls["db_desc_ok"][kf]
        x = (desc.long() ^ ls["db_desc"][kf].long())[ok & same] & 0xFFFFFFFF
        differ = int(((x[..., None] >> torch.arange(32)) & 1).sum())
        out["desc_bits"].append((differ + int((~same).sum()) * 256)
                                / max(x.numel() * 32, 1))
    valid = [k for k in frame_of if bool(ls["db_valid"][k])]
    for kf in sorted((kfs | set(kf_pick(valid))) & set(frame_of)):
        emb = loop.embed(ref.place, image(kf))
        out["embed_gap"].append(1.0 - float(emb @ ls["db_embed"][kf]))
    return out


def pgo_numbers(d: dict, iters: int, control: bool):
    """|ln| of the cost at the program's poses over the cost at the
    reference's solve; None without a loop edge. Not the poses' gap: the
    graph has nearby minima of about equal cost, and two sound solves
    land in different ones (PERF.md)."""
    arc, ms, ls = (_d(x) for x in d["state"])
    built = pgo.graph(arc, ms, ls)
    if built is None:
        return None
    g, slot, kfs = built
    prog = g["poses"].clone()
    for k, s in slot.items():
        prog[s] = torch.as_tensor(d["traj"][kfs[k][0]], dtype=torch.float64)
    ref_poses = pgo.solve(common.lower(g, control), iters)
    return abs(math.log(pgo.cost(g, prog) / pgo.cost(g, ref_poses)))


def numbers(drv, control: bool = False) -> dict:
    """{name: [value, ...]} of everything compared (see the module)."""
    ref = Reference(drv.cfg_file)
    vals = {k: [] for k in NAMES}
    t0 = time.perf_counter()
    for s in drv.samples:
        for k, v in frame_numbers(ref, drv, s, control).items():
            vals[k].append(v)
    t1 = time.perf_counter()
    rng = harness.rng(drv.seed, 3)

    def kf_pick(valid):
        k = min(len(valid), drv.wl["embed_samples"])
        return rng.choice(sorted(valid), size=k, replace=False).tolist()

    def edge_pick(n):
        k = min(n, drv.wl["edge_samples"])
        return sorted(rng.choice(n, size=k, replace=False).tolist())

    t_pgo = 0.0
    drives = [d for d in drv.drives if d["in_window"] and "state" in d]
    ended = [d["no"] for d in drives if d.get("traj") is not None]
    chosen = set(rng.choice(ended, size=min(len(ended),
                                            drv.wl["pgo_samples"]),
                            replace=False).tolist()) if ended else set()
    for d in drives:
        for k, v in edge_numbers(ref, drv, d, edge_pick, kf_pick,
                                 control).items():
            vals[k] += v
        if d["no"] in chosen:
            t2 = time.perf_counter()
            v = pgo_numbers(d, drv.cfg_file["pgo_iters"], control)
            if v is not None:
                vals["pgo_cost_gap"].append(v)
            t_pgo += time.perf_counter() - t2
    drv.ref_times = {"frames_s": t1 - t0, "pgo_s": t_pgo,
                     "edges_s": time.perf_counter() - t1 - t_pgo}
    return vals


def check(drv, control: bool = False) -> list:
    return common.judge(numbers(drv, control), drv.wl["limits"])
