"""Kernels A, B and C at the main path's shapes, for a bitwise comparison
of two builds (on the card; imports no JAX):

    python -m tests.torch_kernel_bits --tree DIR --save OUT.pt
    python -m tests.torch_kernel_bits --compare A.pt B.pt

`--save` imports the port from the tree DIR (for example a `git archive`
of another commit unpacked under a git-ignored directory), builds its
kernels there and saves their outputs on fixed inputs: kernel A
(`lk_pyramid`, G = 2, 256 GFTT corners, win 11, 12 iterations) and the
per-level route with kernel C (`pallas_mode="pallas"`) on three frame
pairs of the circuit, and kernel B (`pose_lm`, F = 256, S = 3, one step and
3 x 6) for 1 and 4 streams. `--compare` exits non-zero unless the two files
hold the same bits (NaNs in the same places).
"""

from __future__ import annotations

import argparse
import sys


def save(tree: str, out: str) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.geometry import jacobians, se3
    from stereovision_slam_torch.ops import gftt, image as imops, lk, lk_lanes
    from stereovision_slam_torch.ops import pose_kernel as pk

    dev = "cuda"
    lefts, rights, _, _, _ = scenes.circuit(device=dev)
    res = {}
    for fr in (0, 30, 60):
        prev, cur, right = (imops.build_pyramid(torch.as_tensor(f, device=dev),
                                                4)
                            for f in (lefts[fr], lefts[fr + 1],
                                      rights[fr + 1]))
        pts, valid, _ = gftt.detect(prev[0], 256)
        args = ([torch.stack([p, p]) for p in prev],
                [torch.stack([c, r]) for c, r in zip(cur, right)],
                torch.stack([pts, pts]), torch.stack([pts, pts - 10.0]),
                torch.stack([valid, valid]))
        res[f"A{fr}"] = lk_lanes.lk_pyramid(*args, max_iters=12)
        res[f"C{fr}"] = lk.track_batched(*args, max_iters=12,
                                         pallas_mode="pallas")
    rng = np.random.default_rng(0)
    left, right = (c.to(dev) for c in scenes.make_stereo_rig())

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)
    for B in (1, 4):
        F, S = 256, 3
        T_gt = se3.se3_exp(t(rng.normal(0, [0.3, 0.1, 0.3, 0.02, 0.03, 0.02],
                                        (B, 6))))
        pts = t(np.stack([rng.uniform(-8, 8, (B, F)),
                          rng.uniform(-3, 3, (B, F)),
                          rng.uniform(6, 40, (B, F))], -1))
        uv_l, uv_r = (jacobians.project_points(c, T_gt[:, None], pts)[0]
                      + t(rng.normal(0, 0.3, (B, F, 2))) for c in (left, right))
        uv_l[:, :10] += 30.0
        vl = torch.tensor(rng.uniform(size=(B, F)) > 0.1, device=dev)
        vr = vl & torch.tensor(rng.uniform(size=(B, F)) > 0.1, device=dev)
        T0 = se3.se3_compose(se3.se3_exp(t(rng.normal(0, 0.05, (B, S, 6)))),
                             T_gt[:, None])
        a = (pk.camera_block(left, right), pts.contiguous(),
             uv_l.contiguous(), uv_r.contiguous(), vl, vr, T0.contiguous())
        for kw in (dict(rounds=1, iters=1), dict(rounds=3, iters=6)):
            res[f"B{B}_{kw['rounds']}"] = tuple(pk.pose_lm(*a, chi2_th=5.991,
                                                           **kw))
    torch.cuda.synchronize()
    torch.save({k: tuple(x.cpu() for x in v) for k, v in res.items()}, out)
    print(f"saved {len(res)} results of {tree} to {out}")


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    differ = []
    for k in sorted(a):
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            same = torch.equal(x, y)
            if not same and x.is_floating_point():
                same = (torch.equal(torch.isnan(x), torch.isnan(y))
                        and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))
            if not same:
                differ.append(f"{k}[{i}]")
    print(f"{len(a)} results, bit-equal: {not differ}; differ: {differ}")
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    save(args.tree, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
