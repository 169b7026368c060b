"""Phase 23 of chip_smoke.py alone (the recorder on the loop path), and a
count of each loop graph's device kernels per replay. On the card:

    python -m tests.torch_tracing

(about 2 minutes with the kernels' build): the card's name and power
limit, then phase 23's lines and the recorder's span table; exits
non-zero if a gate of phase 23 fails.

    python tests/torch_tracing.py --kernels-only --root DIR

imports the package and chip_smoke.py from another tree DIR (an older
one, unpacked under `.archive/`, needs none of the recorder) and prints
only the device kernels a replay of each graph launches, untraced, after
the same 200 frames: what the recorder-off graphs are held to across
versions.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 200     # chip_smoke.TRACE_T


def graph_kernels(vo) -> dict:
    """{graph key: device kernels one replay launches} of the pipeline's
    captured graphs (torch.profiler over one replay each; the replays move
    the state, so call this after the run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for key, graph in vo.runner.graphs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        out[str(key)] = sum(
            1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation())
    return out


@contextlib.contextmanager
def stubbed_recorder():
    """Every recorder call of the program replaced by a bare stand-in that
    touches no tensor: the program as it was before the recorder."""
    from stereovision_slam_torch.utils import profiling

    def none(*a, **k):
        return None

    def read(name, x, cast=bool, counts=None):
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
        return cast(x)
    stubs = dict(span=lambda *a, **k: profiling.NO_SPAN,
                 device_span=lambda *a, **k: profiling.NO_SPAN,
                 count=none, device_count=none, kernel_launch=none,
                 host_read=read, enabled=lambda: False, prepare=none)
    saved = {k: getattr(profiling, k) for k in stubs}
    for k, v in stubs.items():
        setattr(profiling, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(profiling, k, v)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true")
    ap.add_argument("--root", default=HERE,
                    help="the tree whose package and chip_smoke.py run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_tracing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi_line())
    print(f"package from {os.path.dirname(chip_smoke.__file__)}")
    _cuda.build_all()
    dev = "cuda"
    scene = scenes.circuit_long(FRAMES, 188, 620, device=dev)
    params = place_net.get_params(device=dev)
    if args.kernels_only:
        from stereovision_slam_torch.slam.fused_loop import (
            ScanLoopVisualOdometry)
        import numpy as np
        lefts, rights, _, _, rig = scene
        vo = chip_smoke.loop_vo(ScanLoopVisualOdometry, lefts, rights, rig,
                                dev, params, chunk_size=1,
                                max_frames=FRAMES + 8)
        ld, rd = (torch.as_tensor(x, device=dev) for x in (lefts, rights))
        for t in range(FRAMES):
            vo.step_chunk(ld[t:t + 1], rd[t:t + 1], None, np.ones(1, bool),
                          host_fids=[t], n=1)
        print(f"device kernels per replay, untraced: {graph_kernels(vo)}")
        return 0
    missed = chip_smoke.tracing_phase(scene, dev, params)
    for m in missed:
        print(f"MISSED: {m}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
