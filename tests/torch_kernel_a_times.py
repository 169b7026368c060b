"""Kernel A's device time per call against pyramid depth, Gauss-Newton
iterations and the number of points.

    python -m tests.torch_kernel_a_times

On the circuit's first two frames (188x620, the inputs of `chip_smoke.py`
phase 2: GFTT's 256 corners of frame 0 tracked into frame 1), times one
launch of `lk_ops.lk_pyramid` with the pyramid cut to its finest 1 to 4
levels, with max_iters 0, 1 and 12, and with the 256 points repeated over
G = 1, 2 and 8 groups. Device time per call (`chip_smoke.device_ms`: CUDA
events around 50 back-to-back calls queued behind a sleep kernel), and the
mean Gauss-Newton iterations per point and level that the run took. Prints
the card's name, power limit and SM clocks. A tool, not a test: it needs
the card.
"""

from __future__ import annotations

import subprocess

import chip_smoke as cs


def main() -> None:
    import torch
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.ops import gftt, image as imops
    from stereovision_slam_torch.ops import lk_lanes as lk_ops

    dev = "cuda"
    lefts, _, _, _, _ = scenes.circuit(device=dev)
    L0, L1 = (imops.build_pyramid(torch.as_tensor(lefts[i], device=dev), 4)
              for i in (0, 1))
    pts, valid, _ = gftt.detect(L0[0], max_corners=256, min_distance=20)
    print(cs.smi_line())
    print("G levels max_iters: device ms per call, mean iterations per "
          "point and level")
    for G in (1, 2, 8):
        for levels in (1, 2, 3, 4):
            for iters in (0, 1, 12):
                args = ([lv[None].expand(G, -1, -1).contiguous()
                         for lv in L0[:levels]],
                        [lv[None].expand(G, -1, -1).contiguous()
                         for lv in L1[:levels]],
                        pts[None].expand(G, -1, -1).contiguous(),
                        pts[None].expand(G, -1, -1).contiguous(),
                        valid[None].expand(G, -1).contiguous())
                call = lambda: lk_ops.lk_pyramid(*args, max_iters=iters)
                rows = call()[2]
                ms = cs.device_ms(call, 50)
                print(f"{G} {levels} {iters}: {ms:.4f} ms, "
                      f"{float(rows[:, :, 5].mean()):.2f}")
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"SM clock after the run, and its maximum: {clocks}")


if __name__ == "__main__":
    main()
