"""Kernel D's device time in one process at the sharded BA's payload.

    python -m tests.torch_kernel_d_times [--rounds N]

On `chip_smoke.py` phase 10's payload (8 ranks x 4832 x 128 float32, mesh
dp 4 x mp 2, along dp), times one launch of `ring_all_reduce_flat` warm
(`chip_smoke.device_ms`: CUDA events around 50 back-to-back calls queued
behind a sleep kernel) and cold (`chip_smoke.cuda_ms_cold`, the L2 flushed
before each of 20 calls), N rounds of each, and prints them with the
source's hash, the card's name and power limit. A tool, not a test: it
needs the card. To compare two versions of `csrc/ring_reduce.cu` in one
chip call, copy each in turn over the source and run the tool after each
copy (a library is named by a hash of its source, so it rebuilds), in
the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import hashlib

import chip_smoke as cs


def main() -> None:
    import numpy as np
    import torch
    from stereovision_slam_torch.ops import _cuda
    from stereovision_slam_torch.parallel import ring_reduce as rr

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    src = _cuda.CSRC / "ring_reduce.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    print(cs.smi_line())
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(8, cs.RING_PATH_ROWS, rr.LANES))
                     .astype(np.float32), device="cuda")
    ma = (("dp", 4), ("mp", 2))

    def call():
        return rr.ring_all_reduce_flat(x, "dp", ma)

    if not torch.equal(call(), rr.ring_all_reduce_plain(x, "dp", ma)):
        raise SystemExit("kernel D differs from its plain version")
    warm = [cs.device_ms(call, 50) for _ in range(args.rounds)]
    cold = [cs.cuda_ms_cold(call, 20) for _ in range(args.rounds)]
    print(f"kernel D, source {digest}: warm "
          + " ".join(f"{t:.4f}" for t in warm) + " ms; cold "
          + " ".join(f"{t:.4f}" for t in cold) + " ms; median warm "
          f"{np.median(warm):.4f}, cold {np.median(cold):.4f} ms")


if __name__ == "__main__":
    main()
