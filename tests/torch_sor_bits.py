"""Where SOR's mean k-NN distances part between the card and the CPU: one
query chunk of a far cloud (a wall 5-40 m out) through each step of
`ops/sor.mean_knn_chunk` on both devices, each step fed the CPU's result of
the step before, and the count of elements that differ printed per step:

    python -m tests.torch_sor_bits
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from stereovision_slam_torch.ops import sor

    rng = np.random.default_rng(0)
    n = 8192
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 2, n),
                    rng.uniform(5, 40, n)], axis=1).astype(np.float32)
    q = torch.from_numpy(pts[:1024])
    ref_t = torch.from_numpy(np.ascontiguousarray(pts.T))
    k = 50

    def steps(q, ref_t):
        out = {}
        q_t = q.T.contiguous()
        out["outer"] = torch.outer(q_t[0], ref_t[0])
        dot = out["outer"].clone()
        dot.add_(torch.outer(q_t[1], ref_t[1]))
        dot.add_(torch.outer(q_t[2], ref_t[2]))
        out["dot"] = dot.clone()
        out["q2"] = sor._sq_norm(q_t)
        out["r2"] = sor._sq_norm(ref_t)
        d2 = out["q2"][:, None] + out["r2"][None, :]
        out["q2+r2"] = d2.clone()
        d2.sub_(dot.mul_(2.0)).clamp_(min=0.0)
        out["d2"] = d2
        out["topk"] = torch.topk(d2, k + 1, dim=1, largest=False,
                                 sorted=True).values
        out["sqrt"] = sor._sqrt(out["topk"])
        out["tree"] = sor._tree_sum(out["sqrt"])
        out["mean"] = sor.mean_knn_chunk(q, ref_t, k)
        return out

    cpu = steps(q, ref_t)
    card = steps(q.cuda(), ref_t.cuda())
    for name, c in cpu.items():
        g = card[name].cpu()
        diff = (g != c)
        print(f"{name}: {int(diff.sum())} of {c.numel()} differ, largest "
              f"{float((g - c).abs().max()):.3e}")
    # each step alone, from the CPU's input; torch's float32 sqrt beside
    # the float64 one that `sor._sqrt` rounds
    x = cpu["topk"]
    print("float32 torch.sqrt alone:", int((torch.sqrt(x.cuda()).cpu()
                                            != torch.sqrt(x)).sum()))
    print("sor._sqrt alone:", int((sor._sqrt(x.cuda()).cpu()
                                   != sor._sqrt(x)).sum()))
    s = cpu["sqrt"]
    print("tree alone:", int((sor._tree_sum(s.cuda()).cpu()
                              != sor._tree_sum(s)).sum()))
    d2 = cpu["d2"]
    print("topk alone:", int((torch.topk(d2.cuda(), k + 1, dim=1,
                                         largest=False).values.cpu()
                              != torch.topk(d2, k + 1, dim=1,
                                            largest=False).values).sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
