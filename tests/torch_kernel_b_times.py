"""Kernel B's device time per call against the LM schedule and the number
of starts and streams.

    python -m tests.torch_kernel_b_times

On the inputs of `chip_smoke.py` phase 3 (F = 256 points, 3 starts), times
one launch of `pose_kernel.pose_lm` with rounds x iters = 1 x 0 (the
round's first pass and the final pass, no LM step), 1 x 1 (one step), 1 x
6 and 3 x 6 (the slice's schedule), then 3 x 6 at S = 1 against S = 3
starts and at B = 4 streams. Device time per call (`chip_smoke.device_ms`:
CUDA events around 50 back-to-back calls queued behind a sleep kernel), and
from the 1 x 1 and 1 x 6 times the time per further LM step. Prints the
card's name, power limit and SM clocks. A tool, not a test: it needs the
card.
"""

from __future__ import annotations

import subprocess

import chip_smoke as cs


def main() -> None:
    import torch
    from stereovision_slam_torch.ops import pose_kernel as pk

    dev = "cuda"
    one = cs.pose_args(dev)
    four = [cs.pose_args(dev, seed) for seed in range(4)]
    four = (four[0][0], *(torch.stack(x).contiguous()
                          for x in list(zip(*four))[1:]))
    print(cs.smi_line())

    def ms(args, rounds, iters):
        return cs.device_ms(lambda: pk.pose_lm(*args, chi2_th=5.991,
                                               rounds=rounds, iters=iters), 50)

    t = {}
    for rounds, iters in ((1, 0), (1, 1), (1, 6), (3, 6)):
        t[rounds, iters] = ms(one, rounds, iters)
        print(f"B 1, S 3, {rounds} x {iters}: {t[rounds, iters]:.4f} ms")
    step = (t[1, 6] - t[1, 1]) / 5
    print(f"per further LM step: {step:.5f} ms; one step alone (1 x 1 - 1 x "
          f"0): {t[1, 1] - t[1, 0]:.5f} ms")
    s1 = ms(tuple(x[:1] if i == 6 else x for i, x in enumerate(one)), 3, 6)
    print(f"B 1, S 1, 3 x 6: {s1:.4f} ms; S 3: {t[3, 6]:.4f} ms")
    print(f"B 4, S 3, 3 x 6: {ms(four, 3, 6):.4f} ms")
    clocks = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"SM clock after the run, and its maximum: {clocks}")


if __name__ == "__main__":
    main()
