"""Kernel D's owner form across the cards of one process: where its time
goes.

    python -m tests.torch_kernel_d_cards [--reps N]

On every card of the machine (at least two), one rank a card along dp, it
times three launches a call of the owner form, each N calls queued behind
a sleep kernel on every card with CUDA events around them (the device's
time a call on each card; the least is the card that started last, the
others having waited for it in their first call):
  full   `ring_all_reduce_ranks` at chip_smoke's RING_PATH_ROWS x 128
         float32 a rank: the reads, the stores and both handshakes;
  floor  the same at 8 x cards rows a rank: the launch and the two
         handshakes with almost no data;
  data   the owner form at RING_PATH_ROWS with the handshake compiled out
         (tables with no flag block, launched on every card at once; the
         inputs are never rewritten, so the sums are still right): the
         reads and stores alone.
Each result is checked against the one-card launch. It prints the cards'
name and power limit, the source's hash and the function's least time
(`chip_smoke.ring_least_ms`). A tool, not a test: it needs two cards or
more. To compare two versions of `csrc/ring_reduce.cu` in one chip call,
copy each in turn over the source and run the tool after each copy (a
library is named by a hash of its source, so it rebuilds), A B B A.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time


def per_card_ms(cards, call, reps: int) -> list[float]:
    """Device ms a call on each card: `reps` calls of call() queued while
    a sleep kernel holds every card's stream."""
    import torch

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    for _ in range(2):               # warm, and the caching allocator
        [call() for _ in range(reps)]
        sync()
    t0 = time.perf_counter()
    [call() for _ in range(reps)]
    sync()
    ahead_ms = (time.perf_counter() - t0) * 1e3
    starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
    ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
    for c, e in zip(cards, starts):
        with torch.cuda.device(c):
            torch.cuda._sleep(int(3 * ahead_ms * 2e6))
        e.record(torch.cuda.current_stream(c))
    [call() for _ in range(reps)]
    for c, e in zip(cards, ends):
        e.record(torch.cuda.current_stream(c))
    sync()
    return [s.elapsed_time(e) / reps for s, e in zip(starts, ends)]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from stereovision_slam_torch.ops import _cuda
    from stereovision_slam_torch.parallel import ring_reduce as rr

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_kernel_d_cards: needs two CUDA devices or more",
              file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    src = _cuda.CSRC / "ring_reduce.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    print(f"{cs.smi_line()} x {n}; source {digest}")
    _cuda.build_all(("ring_reduce",))
    ma = (("dp", n), ("mp", 1))
    rng = np.random.default_rng(cs.DIST_SEED)
    failed = []
    for name, rows in (("full", cs.RING_PATH_ROWS), ("floor", 8 * n),
                       ("data", cs.RING_PATH_ROWS)):
        x = torch.from_numpy(rng.normal(size=(n, rows, rr.LANES)).astype(
            np.float32)).to(cards[0])
        parts = [x[r].to(c) for r, c in enumerate(cards)]
        want = rr.ring_all_reduce_flat(x, "dp", ma)
        if name == "data":
            route = rr.OwnedRoute([0] * n, range(n))
            tables = route.tables([p.data_ptr() for p in parts], range(n), n,
                                  1, rows)

            def call():
                outs = [torch.empty_like(p) for p in parts]
                rr._launch_owned(tables, list(range(n)),
                                 [o.data_ptr() for o in outs], n, 1, rows, 0)
                return outs
        else:
            def call():
                return rr.ring_all_reduce_ranks(parts, "dp", ma)
        got = call()
        for c in cards:
            torch.cuda.synchronize(c)
        same = all(torch.equal(g.to(cards[0]), want[r])
                   for r, g in enumerate(got))
        ms = per_card_ms(cards, call, args.reps)
        bound, by, link = cs.ring_least_ms(ma, "dp", rows, list(range(n)), 0)
        print(f"{name}: {n} x {rows} x 128 float32, bit for bit the one-card "
              f"launch: {same}; device ms a call per card "
              f"{', '.join(f'{v:.4f}' for v in ms)} (least {min(ms):.4f}); "
              f"bound {bound:.6f} ({by}, {link})", flush=True)
        if not same:
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
