"""One process of the port's two-process distributed backend on the CPU
(tests/test_torch_distributed.py), the counterpart of tests/dist_ba_worker.py.

Run as: python tests/torch_dist_worker.py <process_id> <num_processes>
<port> <inputs.npz> <outdir> [cpu|cuda], or through `spawn`.

The processes join a gloo group on 127.0.0.1:<port>. With "cuda"
(tests/test_torch_cuda.py: two processes on cuda:0 over gloo, or one
process a card over NCCL where the machine has a card for each) only
kernel D runs across the processes, twice along each axis of the (dp 4,
mp 2) mesh on the payload "payload" (the second call reuses the IPC
mappings); with "late" = (p, s) in <inputs.npz>, process p sleeps s
seconds before each second call, while its peers' kernels wait. On the
window of
<inputs.npz> (a port MapState and its two cameras, fields prefixed "m_",
"cl_", "cr_") each runs the sharded BA over an 8-rank (dp 4, mp 2) mesh,
4 ranks a process, with the "xla" and the "ring" reduction, and over a
(dp 1, mp 2) mesh, one rank a process; kernel D's plain route across the
processes on the payload "payload" along both axes; and the sharded PGO
over 8 ranks on the graph (fields prefixed "g_"). With four processes on
the CPU the mesh is (dp 2, mp 2), one rank a process: the sharded BA with
"xla" and "ring", kernel D's plain route along both axes on the first 4
ranks of "payload", and the sharded PGO over the 4 ranks. Each process
writes <outdir>/result_<process_id>.npz. Imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stereovision_slam_torch.geometry.camera import Camera  # noqa: E402
from stereovision_slam_torch.parallel import ring_reduce  # noqa: E402
from stereovision_slam_torch.parallel.mesh import (  # noqa: E402
    initialize_multihost, make_ba_mesh)
from stereovision_slam_torch.parallel.sharded_ba import (  # noqa: E402
    build_sharded_ba)
from stereovision_slam_torch.parallel.sharded_pgo import (  # noqa: E402
    build_sharded_pgo)
from stereovision_slam_torch.slam.map_state import MapState  # noqa: E402
from stereovision_slam_torch.slam.pose_graph import PoseGraph  # noqa: E402

ITERS = 8
WORKER = os.path.abspath(__file__)


def spawn(inputs: str, outdir: str, device: str = "cpu", nproc: int = 2,
          timeout: float = 120) -> list[dict]:
    """Run `nproc` workers on `inputs` (a free port on 127.0.0.1) and
    return each one's results; a worker that fails or outlives `timeout`
    seconds fails the caller."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(nproc), str(port), inputs,
         outdir, device], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} failed:\n{outs[i][-3000:]}")
    return [dict(np.load(os.path.join(outdir, f"result_{i}.npz")))
            for i in range(nproc)]


def _tuple(cls, d, prefix):
    return cls(**{f: (torch.from_numpy(d[prefix + f]) if prefix + f in d
                      else None) for f in cls._fields})


def ring_on_card(d, device: str) -> dict:
    mesh = make_ba_mesh(8, dp=4, mp=2, device=device)
    mine = torch.from_numpy(d["payload"])[mesh.ranks.start:mesh.ranks.stop]
    mine = mine.to(mesh.device)
    out = {}
    ring_reduce.trace = []
    before = ring_reduce.launch_count
    owned = ring_reduce.owned_launch_count
    late, pid = d["late"] if "late" in d else (-1, 0), \
        torch.distributed.get_rank()
    for axis in ("dp", "mp"):
        first = ring_reduce.ring_all_reduce_flat(mine, axis, mesh.mesh_axes,
                                                 mesh)
        if pid == int(late[0]):
            time.sleep(float(late[1]))
        again = ring_reduce.ring_all_reduce_flat(mine, axis, mesh.mesh_axes,
                                                 mesh)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        out[f"ring_{axis}"] = first.cpu().numpy()
    out["launches"] = np.int64(ring_reduce.launch_count - before)
    out["owned_launches"] = np.int64(ring_reduce.owned_launch_count - owned)
    out["device_ms"] = np.array([t["device_ms"]
                                 for t in ring_reduce.read_trace()])
    return out


def main() -> None:
    pid, nproc, port = (int(a) for a in sys.argv[1:4])
    inputs, outdir = sys.argv[4], sys.argv[5]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    # one intra-op thread: the suite's parallel workers share the cores
    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", nproc, pid, device=device)
    d = np.load(inputs)
    if device != "cpu":
        out = ring_on_card(d, device)
        np.savez(os.path.join(outdir, f"result_{pid}.npz"), **out)
        ring_reduce.release_peer_buffers()
        torch.distributed.destroy_process_group()
        print(f"worker {pid} done", flush=True)
        return
    m = _tuple(MapState, d, "m_")
    cl, cr = _tuple(Camera, d, "cl_"), _tuple(Camera, d, "cr_")
    g = _tuple(PoseGraph, d, "g_")
    run = two_processes if nproc == 2 else one_rank_a_process
    out = run(d, m, cl, cr, g, pid)
    np.savez(os.path.join(outdir, f"result_{pid}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"worker {pid} done", flush=True)


def one_rank_a_process(d, m, cl, cr, g, pid: int) -> dict:
    """Four processes, one rank each, mesh (dp 2, mp 2)."""
    K, F = m.obs_lm.shape
    L = m.lm_pos.shape[0]
    mesh = make_ba_mesh(4, dp=2, mp=2, device="cpu")
    assert mesh.ranks == range(pid, pid + 1), mesh.ranks
    out = {}
    for impl in ("xla", "ring"):
        kf, lm = build_sharded_ba(mesh, K, F, L, iters=ITERS,
                                  reduce_impl=impl)(m, cl, cr)
        out[f"kf_{impl}"], out[f"lm_{impl}"] = kf.numpy(), lm.numpy()
    mine = torch.from_numpy(d["payload"])[pid:pid + 1]
    for axis in ("dp", "mp"):
        out[f"ring_{axis}"] = ring_reduce.ring_all_reduce_flat(
            mine, axis, mesh.mesh_axes, mesh).numpy()
    out["pgo"] = build_sharded_pgo(mesh)(g).numpy()
    return out


def two_processes(d, m, cl, cr, g, pid: int) -> dict:
    """Two processes, 4 of the 8 ranks each, and the (dp 1, mp 2) mesh."""
    K, F = m.obs_lm.shape
    L = m.lm_pos.shape[0]
    out = {}
    mesh = make_ba_mesh(8, dp=4, mp=2, device="cpu")
    assert mesh.ranks == range(4 * pid, 4 * pid + 4), mesh.ranks
    for impl in ("xla", "ring"):
        kf, lm = build_sharded_ba(mesh, K, F, L, iters=ITERS,
                                  reduce_impl=impl)(m, cl, cr)
        out[f"kf_{impl}"], out[f"lm_{impl}"] = kf.numpy(), lm.numpy()

    mesh_mp = make_ba_mesh(2, dp=1, mp=2, device="cpu")
    assert mesh_mp.local_cols == range(pid, pid + 1)
    kf, lm = build_sharded_ba(mesh_mp, K, F, L, iters=ITERS)(m, cl, cr)
    out["kf_mp"], out["lm_mp"] = kf.numpy(), lm.numpy()

    mine = torch.from_numpy(d["payload"])[mesh.ranks.start:mesh.ranks.stop]
    for axis in ("dp", "mp"):
        out[f"ring_{axis}"] = ring_reduce.ring_all_reduce_flat(
            mine, axis, mesh.mesh_axes, mesh).numpy()

    out["pgo"] = build_sharded_pgo(make_ba_mesh(8, device="cpu"))(g).numpy()
    return out


if __name__ == "__main__":
    main()
