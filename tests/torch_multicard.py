"""The distributed backend over four cards of one machine, the port's
counterpart of the JAX package's `dryrun_multichip` (which runs the sharded
BA, the sharded PGO and the ring all-reduce over n chips and holds each to
the single-device solvers):

    python -m tests.torch_multicard

It needs four NVIDIA cards and exits 1 on fewer, and on any gate missed
(every gate is checked, a part that raises counts as missed, and the
misses are listed at the end). It prints the cards' `nvidia-smi
--query-gpu=name,power.limit` lines, `nvidia-smi topo -m` (or, where that
is refused, `nvidia-smi nvlink --status`) and the peer-access matrix.
One process, one rank a card (`make_ba_mesh(devices=...)`, the per-rank
route), then four processes, one card each, over NCCL:

  (a) kernel D over the 4 cards, (dp 4, mp 1), chip_smoke's
      RING_PATH_ROWS x 128 float32 a rank: the owner form, one launch a
      card, bit for bit the one-card launch, with no CUDA event on the
      route; side by side: ms per card (CUDA events on each card's stream)
      against the function's least time (`chip_smoke.ring_least_ms`:
      2 (n - 1) / n of a rank each way over NVLink at 450 GB/s), the host's
      enqueue a call, the wall a call back to back, and
      `torch.cuda.comm.reduce_add` then `broadcast` on the same payload
      (each loop timed after an untimed one, so that the caching allocator
      holds its results); the plain version's ms;
  (b) the sharded BA on chip_smoke phase 11's window (the slice's final
      window at `make_config` settings, perturbed as there) over the 4
      cards at (2, 2) and (4, 1), "ring" (every kernel D call held to its
      plain version; bit for bit the one-card run) and "xla", within
      SHARD_RING_TOL of the one-card run at the same split and
      SHARD_SINGLE_TOL of the single-card BA; ms a call;
  (c) the sharded PGO over the 4 cards on phase 12's graph and on the
      long circuit's keyframe graph with its loops (`scenes.circuit_long`
      through `ScanLoopVisualOdometry`), each within PGO_SHARD_TOL of the
      single solve; seconds a solve;
  (d) the classic pipeline's shutdown with `LoopClosure(pgo_mesh=
      make_local_mesh())` from the state after the circuit's last frame
      (the command line's classic run, checkpointed there): ATE after PGO
      within PGO_SHARD_TOL of the unsharded shutdown's;
  (e) chip_smoke phase 7's four serving streams, one a card
      (`make_local_mesh()`), bit for bit the same streams on one card;
  (f) the dense tool with `--mesh` over the 4 cards on the fused command
      line run's keyframes (phase 16), equal to the serial cloud;
  (g) four processes, one card each, over NCCL: kernel D across the
      processes (the owner form, no host barrier) bit for bit the one-card
      launch; side by side: its device ms a launch against the function's
      least time, the host clock a call, and `dist.all_reduce` on the same
      payload; the sharded BA at (2, 2) within SHARD_RING_TOL of the
      one-card run ("ring" bit for bit); the sharded PGO on phase 12's
      graph within PGO_SHARD_TOL of the single solve, seconds a solve.
      Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = 4
RING_REPS = 50
PROC_TIMEOUT_S = 420


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(fn):
    """(result, host seconds) of fn(), every card synchronized at both
    ends."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def kernel_d(cs, cards, payload) -> tuple[dict, list]:
    """(a): kernel D in one process over the cards."""
    import torch
    import torch.cuda.comm as comm
    from stereovision_slam_torch.parallel import ring_reduce as rr

    missed = []
    ma = (("dp", len(cards)), ("mp", 1))
    x = payload.to(cards[0])
    parts = [x[r].to(c) for r, c in enumerate(cards)]
    one = rr.ring_all_reduce_flat(x, "dp", ma)
    plain = rr.ring_all_reduce_plain(x, "dp", ma)
    rr.ring_all_reduce_ranks(parts, "dp", ma)   # the flag blocks, once
    sync_all()
    events = []
    real_event = torch.cuda.Event

    def counted(*a, **kw):
        events.append(a)
        return real_event(*a, **kw)
    before = rr.launch_count
    torch.cuda.Event = counted
    try:
        got = rr.ring_all_reduce_ranks(parts, "dp", ma)
    finally:
        torch.cuda.Event = real_event
    sync_all()
    launches = rr.launch_count - before
    same = torch.equal(one, plain) and all(
        torch.equal(g.to(cards[0]), one[r]) for r, g in enumerate(got))

    def call():
        return rr.ring_all_reduce_ranks(parts, "dp", ma)
    # warm: the caching allocator then holds RING_REPS results a card (the
    # first such loop spends its time in cudaMalloc)
    timed(lambda: [call() for _ in range(RING_REPS)])
    _, t_wall = timed(lambda: [call() for _ in range(RING_REPS)])
    # the device's own time: every card's stream held by a sleep kernel
    # until all the calls are queued, then CUDA events around them
    starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
    ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
    for c, e in zip(cards, starts):
        with torch.cuda.device(c):
            torch.cuda._sleep(int(3 * t_wall * 1e3 * 2e6))
        e.record(torch.cuda.current_stream(c))
    t0 = time.perf_counter()
    for _ in range(RING_REPS):
        call()
    host = (time.perf_counter() - t0) * 1e3 / RING_REPS
    for c, e in zip(cards, ends):
        e.record(torch.cuda.current_stream(c))
    sync_all()
    per_card = [s.elapsed_time(e) / RING_REPS for s, e in zip(starts, ends)]
    # the enqueue again with the packed tables rebuilt every call (the
    # route's cache emptied before each), the streams held the same way
    route = rr._card_routes[tuple(c.index for c in cards)]
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda._sleep(int(3 * t_wall * 1e3 * 2e6))
    rebuilt, t_miss = [], 0.0
    for _ in range(RING_REPS):
        route._tables.clear()
        t0 = time.perf_counter()
        rebuilt.append(call())
        t_miss += time.perf_counter() - t0
    sync_all()
    host_miss = t_miss * 1e3 / RING_REPS
    same_miss = all(torch.equal(g.to(cards[0]), one[r])
                    for r, g in enumerate(rebuilt[-1]))

    def plain_call():
        return rr.ring_all_reduce_plain(torch.stack(
            [p.to(cards[0]) for p in parts]), "dp", ma)
    plain_call()
    _, t_plain = timed(lambda: [plain_call() for _ in range(5)])

    def library():
        total = comm.reduce_add(parts, destination=0)
        return comm.broadcast(total, devices=cards)
    timed(lambda: [library() for _ in range(RING_REPS)])
    _, t_lib = timed(lambda: [library() for _ in range(RING_REPS)])
    R = payload.shape[1]
    bound, by, link = cs.ring_least_ms(ma, "dp", R, list(range(len(cards))),
                                       0)
    row = dict(name="ring_all_reduce across cards", launches=launches,
               ms_per_card=per_card, host_ms=host,
               host_ms_tables_rebuilt=host_miss,
               wall_ms=1e3 * t_wall / RING_REPS, plain_ms=1e3 * t_plain / 5,
               library_ms=1e3 * t_lib / RING_REPS, bound_ms=bound,
               bound_by=f"{by} ({link})", bit_equal=same, events=len(events))
    print(f"(a) kernel D over {len(cards)} cards in one process, "
          f"({len(cards)}, {R}, 128) along dp ({4 * R * 128 / 1e6:.2f} MB a "
          f"rank), the owner form: {launches} launches a call (one a card), "
          f"{len(events)} CUDA events made by a call; bit for bit the "
          f"one-card launch and the plain version: {same}")
    print(f"(a) ms a call: device per card "
          f"{', '.join(f'{v:.4f}' for v in per_card)} (CUDA events, the "
          f"streams held until every call was queued; the least, "
          f"{min(per_card):.4f}, is the card that started last, the others "
          f"waited for it in their first call) | bound {bound:.6f} "
          f"({by}, {link}) | host enqueue {host:.4f}, with the tables "
          f"rebuilt every call {host_miss:.4f} | back to back, every "
          f"card synchronized at the ends {row['wall_ms']:.4f} | reduce_add "
          f"+ broadcast {row['library_ms']:.4f} | plain {row['plain_ms']:.3f}")
    if not (same and same_miss):
        missed.append("(a) kernel D across cards differs from the one-card "
                      "launch")
    if launches != len(cards):
        missed.append(f"(a) kernel D launched {launches} times, not "
                      f"{len(cards)}")
    if events:
        missed.append(f"(a) a call of kernel D across cards made "
                      f"{len(events)} CUDA events")
    return row, missed


def sharded_ba(cs, cards, ba, counters) -> tuple[dict, list]:
    """(b): the sharded BA over the cards."""
    import torch
    from stereovision_slam_torch.parallel import ring_reduce as rr
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.slam.backend import optimize_window_plain

    missed, refs = [], {}
    m, cl, cr, K, F, L, kw = (ba[k] for k in ("m", "cl", "cr", "K", "F",
                                              "L", "kw"))
    ms1, _ = optimize_window_plain(
        m, cl, cr, chi2_th=kw["chi2_th"], iters=kw["iters"],
        outlier_rounds=0, max_active_landmarks=kw["max_active_landmarks"])
    for dp, mp in ((2, 2), (4, 1)):
        mesh = make_ba_mesh(devices=cards, dp=dp, mp=mp)
        one_card = make_ba_mesh(len(cards), dp=dp, mp=mp, device=cards[0])
        for impl in ("ring", "xla"):
            k1, l1 = build_sharded_ba(one_card, K, F, L, reduce_impl=impl,
                                      **kw)(m, cl, cr)
            (_, t1) = timed(lambda: build_sharded_ba(
                one_card, K, F, L, reduce_impl=impl, **kw)(m, cl, cr))
            refs[(dp, mp, impl)] = (k1, l1)
            run = build_sharded_ba(mesh, K, F, L, reduce_impl=impl, **kw)
            for mod in counters.values():
                mod.launch_count = 0
            rr.owned_launch_count = 0
            records = []
            with cs.ranks_held(records):
                (k, lm), _ = timed(lambda: run(m, cl, cr))
            n_d = counters["ring_all_reduce"].launch_count
            n_owned = rr.owned_launch_count
            route = rr._card_routes.get(tuple(c.index for c in cards))
            looked = (route.hits, route.misses) if route else (0, 0)
            _, t = timed(lambda: run(m, cl, cr))
            if route is not None:
                looked = (route.hits - looked[0], route.misses - looked[1])
            held = bool(records) and all(r["equal"] for r in records)
            bits = torch.equal(k, k1) and torch.equal(lm, l1)
            print(f"(b) sharded BA over {len(cards)} cards ({dp}, {mp}) "
                  f"{impl}: {1e3 * t:.1f} ms a call (one card, the same "
                  f"split: {1e3 * t1:.1f} ms); kernel D launches {n_d} "
                  f"({n_owned} of the owner form), "
                  f"packed tables on the timed call: {looked[0]} hits, "
                  f"{looked[1]} misses; "
                  f"{len(records)} calls held to the plain version: "
                  f"{held if impl == 'ring' else 'none made'}; bit for bit "
                  f"the one-card run: {bits}")
            for name, kb, lb, tol in (
                    ("the one-card run", k1, l1, cs.SHARD_RING_TOL),
                    ("the single-card BA", ms1.kf_pose, ms1.lm_pos,
                     cs.SHARD_SINGLE_TOL)):
                ok, msg = ba["compare"](f"({dp}, {mp}) {impl} vs {name}", k,
                                        lm, kb, lb, tol)
                if not ok:
                    missed.append(f"(b) {msg}")
            want = kw["iters"] * len(cards) if impl == "ring" else 0
            if n_d != want or n_owned != want or (impl == "ring"
                                                  and not held):
                missed.append(f"(b) ({dp}, {mp}) {impl}: kernel D launched "
                              f"{n_d} times, {n_owned} of the owner form "
                              f"(want {want}), held {held}")
            if impl == "ring" and not bits:
                missed.append(f"(b) ({dp}, {mp}) ring is not the one-card "
                              "run bit for bit")
            if k.device != cards[0]:
                missed.append(f"(b) the result is on {k.device}")
    return refs, missed


def pgo_over_cards(cs, cards, pgo, long_graph) -> list:
    """(c): the sharded PGO over the cards on phase 12's graph and on the
    long circuit's."""
    import torch
    from stereovision_slam_torch.parallel.mesh import make_ba_mesh
    from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
    from stereovision_slam_torch.slam import pose_graph as pg

    missed = []
    mesh = make_ba_mesh(devices=cards)
    for name, g, single in (("phase 12's graph", pgo["g"], pgo["out1"]),
                            ("the long circuit's graph", long_graph, None)):
        if g is None:
            missed.append(f"(c) {name}: no graph (no loop closed)")
            continue
        if single is None:
            single, t_single = timed(lambda: pg.optimize_pose_graph(g))
        else:
            t_single = pgo["s_single_first"]
        out, t_first = timed(lambda: build_sharded_pgo(mesh)(g))
        _, t_again = timed(lambda: build_sharded_pgo(mesh)(g))
        valid = g.pose_valid
        d = float((out - single).abs()[valid].max())

        def chi2(poses):
            r, _, _ = pg._linearize(pg._edge_ranks(g._replace(poses=poses)))
            return float(r.square().sum())
        c1, cs_ = chi2(single), chi2(out)
        print(f"(c) sharded PGO over {len(cards)} cards, {name} "
              f"({int(valid.sum())} poses, {int(g.edge_valid.sum())} edges):"
              f" {d:.3e} from the single solve (tolerance "
              f"{cs.PGO_SHARD_TOL}), chi2 {cs_:.4e} (single {c1:.4e}); "
              f"{t_first:.2f} s the first solve, {t_again:.2f} s again "
              f"(single {t_single:.2f} s)")
        if not (d <= cs.PGO_SHARD_TOL and cs_ <= c1 * 1.05 + 1e-8
                and bool(torch.isfinite(out).all())):
            missed.append(f"(c) {name}: {d}, chi2 {cs_} vs {c1}")
    return missed


def long_circuit_graph(cs, params):
    """The long circuit through the chunked loop path; its shutdown PGO's
    graph (None without a loop)."""
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.slam.fused_loop import ScanLoopVisualOdometry

    lefts, rights, _, _, rig = scenes.circuit_long(cs.LONG_T, 188, 620,
                                                   device="cuda")
    vo = cs.loop_vo(ScanLoopVisualOdometry, lefts, rights, rig, "cuda",
                    params, chunk_size=cs.SCEN_CHUNK)
    _, dt = timed(vo.run)
    keyframes, _, _ = vo.drain()
    problem = vo.pose_graph(keyframes)
    print(f"(c) the long circuit: {cs.LONG_T} frames in {dt:.1f} s, "
          f"{len(keyframes)} keyframes, {len(vo.loop_edges())} loop edges")
    return None if problem is None else problem[0]


def command_line(cs, scene, tmp: str) -> dict:
    """The circuit as a KITTI sequence; the command line's classic run
    (checkpointed after its last frame) and fused run."""
    import yaml
    from stereovision_slam_torch.apps import run_slam

    lefts, rights, _, _, rig = scene
    T = len(lefts)
    seq = os.path.join(tmp, "sequence")
    cs.write_kitti_sequence(seq, lefts, rights, rig)
    out = {"sequence": seq}
    for mode in ("classic", "fused"):
        cfg = cs.loop_config()
        cfg.dataset_dir, cfg.output_dir = seq, os.path.join(tmp, mode)
        cfg.loopclosure_on = cfg.backend_on = cfg.visualizer_on = 1
        yml = os.path.join(tmp, f"{mode}.yaml")
        with open(yml, "w") as f:
            yaml.safe_dump(dataclasses.asdict(cfg), f)
        argv = [yml, "--mode", mode]
        if mode == "classic":
            argv += ["--checkpoint-every", str(T)]
        r = run_slam.run(run_slam.parse_args(argv))
        out[mode] = r["output"]
        if mode == "classic":
            out["checkpoint"] = os.path.join(cfg.output_dir,
                                             run_slam.CHECKPOINT_NAME)
        print(f"command line, {mode}: {r['loops']} loops, {r['fps']:.2f} fps")
    return out


def classic_shutdown(cs, scene, paths: dict) -> list:
    """(d): the classic shutdown from the checkpoint, unsharded and over
    every card."""
    import numpy as np
    from stereovision_slam_torch.io.dataset import ArraySequenceDataset
    from stereovision_slam_torch.parallel.mesh import make_local_mesh
    from stereovision_slam_torch.slam import checkpoint as ck
    from stereovision_slam_torch.slam import loop_closure as lc
    from stereovision_slam_torch.slam import pipeline

    _, _, gt, dist, rig = scene
    cfg = cs.loop_config()
    blank = np.zeros((1,) + tuple(scene[0].shape[1:]), np.float32)

    def center(p):
        return -p[:, :3].T @ p[:, 3]

    def ate(traj: dict) -> float:
        return float(np.sqrt(np.mean([np.sum(np.square(
            center(np.asarray(p)) - center(gt[f]))) for f, p in
            traj.items()])))

    runs = {}
    for name, mesh in (("unsharded", None), ("over the cards",
                                             make_local_mesh())):
        vo = pipeline.VisualOdometry(cfg, ArraySequenceDataset(
            blank, blank, list(rig)), device="cuda")
        vo.initialize()
        vo.loop_closure = lc.LoopClosure(cfg, vo.cam_left,
                                         embedder="thumbnail", pgo_mesh=mesh)
        ck.load_checkpoint(vo, paths["checkpoint"])
        odo = ate(dict(vo.trajectory()))
        _, t = timed(vo.finish)
        runs[name] = ate(dict(vo.trajectory()))
        print(f"(d) the classic shutdown {name} (mesh "
              f"{None if mesh is None else mesh.devices}): "
              f"{len(vo.loop_closure.loop_edges)} loop edges, ATE "
              f"{odo:.4f} m before PGO, {runs[name]:.4f} m after over "
              f"{dist:.1f} m; {t:.2f} s")
    gap = abs(runs["over the cards"] - runs["unsharded"])
    if not gap <= cs.PGO_SHARD_TOL:
        return [f"(d) ATE after PGO over the cards {runs['over the cards']}"
                f" against {runs['unsharded']}"]
    return []


def serving(cs, streams, rig, counters) -> list:
    """(e): four streams, one a card, against the same streams on one
    card."""
    from stereovision_slam_torch.parallel.mesh import make_local_mesh

    return cs.serving_mesh_phase(streams, rig, counters, "cuda",
                                 mesh=make_local_mesh(), label="(e)")[1]


def nccl_worker(rank: int, world: int, port: int, tmp: str) -> None:
    """(g), process `rank` of `world`: NCCL, card `rank`."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from stereovision_slam_torch.geometry.camera import Camera
    from stereovision_slam_torch.parallel import ring_reduce as rr
    from stereovision_slam_torch.parallel.mesh import (
        initialize_multihost, make_ba_mesh)
    from stereovision_slam_torch.parallel.sharded_ba import build_sharded_ba
    from stereovision_slam_torch.parallel.sharded_pgo import build_sharded_pgo
    from stereovision_slam_torch.slam.map_state import MapState
    from stereovision_slam_torch.slam.pose_graph import PoseGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_multihost(f"127.0.0.1:{port}", world, rank)
    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    ring_mesh = make_ba_mesh(world, dp=world, mp=1)
    dev = ring_mesh.device
    out = {"backend": dist.get_backend(), "device": str(dev)}
    ma = ring_mesh.mesh_axes
    x = inp["payload"][rank:rank + 1].to(dev)

    def ring():
        return rr.ring_all_reduce_flat(x, "dp", ma, ring_mesh)
    out["ring"] = ring().cpu()
    timed(lambda: [ring() for _ in range(RING_REPS)])   # the allocator warm
    _, t = timed(lambda: [ring() for _ in range(RING_REPS)])
    out["ring_host_ms"] = 1e3 * t / RING_REPS
    rr.trace = []
    timed(lambda: [ring() for _ in range(RING_REPS)])
    traced = rr.read_trace()
    out["ring_device_ms"] = [v["device_ms"] for v in traced]
    out["ring_sync_ms"] = [v["sync_ms"] for v in traced]
    rr.trace = None

    def nccl():
        y = x.clone()
        dist.all_reduce(y)
        return y
    out["nccl_err"] = float((nccl() - out["ring"].to(dev)).abs().max())
    timed(lambda: [nccl() for _ in range(RING_REPS)])
    _, t = timed(lambda: [nccl() for _ in range(RING_REPS)])
    out["nccl_ms"] = 1e3 * t / RING_REPS

    m = MapState(*(t.to(dev) for t in inp["m"]))
    cl, cr = (Camera(*(t.to(dev) for t in inp[c])) for c in ("cl", "cr"))
    K, F, L = inp["KFL"]
    mesh = make_ba_mesh(world, dp=2, mp=2)
    for impl in ("ring", "xla"):
        run = build_sharded_ba(mesh, K, F, L, reduce_impl=impl, **inp["kw"])
        rr.launch_count = rr.owned_launch_count = 0
        (kf, lm), _ = timed(lambda: run(m, cl, cr))
        out[f"launches_{impl}"] = rr.launch_count
        out[f"owned_{impl}"] = rr.owned_launch_count
        out[f"kf_{impl}"], out[f"lm_{impl}"] = kf.cpu(), lm.cpu()
        routes = [e["route"] for e in rr._peer_cache.values() if e["route"]]
        looked = [sum(r.hits for r in routes), sum(r.misses for r in routes)]
        _, t = timed(lambda: run(m, cl, cr))
        out[f"tables_{impl}"] = [sum(r.hits for r in routes) - looked[0],
                                 sum(r.misses for r in routes) - looked[1]]
        out[f"ms_{impl}"] = 1e3 * t
    g = PoseGraph(*(None if t is None else t.to(dev) for t in inp["g"]))
    pgo = build_sharded_pgo(make_ba_mesh(world))
    poses, t1 = timed(lambda: pgo(g))
    _, t2 = timed(lambda: pgo(g))
    out["pgo"], out["pgo_s"] = poses.cpu(), (t1, t2)
    torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    rr.release_peer_buffers()
    dist.destroy_process_group()


def nccl_processes(cs, payload, one, ba, refs, pgo) -> tuple[dict, list]:
    """(g): four processes over NCCL against the one-process runs."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    missed = []
    tmp = tempfile.mkdtemp(prefix="svslam_nccl_")
    torch.save(dict(payload=payload, m=[t.cpu() for t in ba["m"]],
                    cl=[t.cpu() for t in ba["cl"]],
                    cr=[t.cpu() for t in ba["cr"]],
                    KFL=[ba["K"], ba["F"], ba["L"]], kw=ba["kw"],
                    g=[None if t is None else t.cpu() for t in pgo["g"]]),
               os.path.join(tmp, "inputs.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(nccl_worker, args=(CARDS, port, tmp),
                             nprocs=CARDS, join=False, start_method="spawn")
    failure = None
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > PROC_TIMEOUT_S:
                failure = f"the workers ran past {PROC_TIMEOUT_S} s"
                break
    except Exception as e:            # a worker raised or died
        failure = f"a worker failed: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    if failure is not None:
        shutil.rmtree(tmp, ignore_errors=True)
        return {}, [f"(g) {failure}"]
    res = [torch.load(os.path.join(tmp, f"result_{i}.pt"))
           for i in range(CARDS)]
    shutil.rmtree(tmp, ignore_errors=True)
    dev = ba["m"].kf_pose.device
    got = torch.cat([r["ring"] for r in res])
    same = torch.equal(got, one.cpu())
    dev_ms = [v for r in res for v in r["ring_device_ms"]]
    sync_ms = [v for r in res for v in r["ring_sync_ms"]]
    R = payload.shape[1]
    bound, by, link = cs.ring_least_ms((("dp", CARDS), ("mp", 1)), "dp", R,
                                       list(range(CARDS)), 0)
    row = dict(name="ring_all_reduce across processes, one card each",
               launches=sum(r["launches_ring"] for r in res),
               device_ms=float(np.median(dev_ms)),
               sync_ms=float(np.median(sync_ms)),
               host_ms=float(np.mean([r["ring_host_ms"] for r in res])),
               library_ms=float(np.mean([r["nccl_ms"] for r in res])),
               bound_ms=bound, bound_by=f"{by} ({link})", bit_equal=same)
    print(f"(g) {CARDS} processes, backends {[r['backend'] for r in res]}, "
          f"on {[r['device'] for r in res]}, {time.perf_counter() - t0:.1f} "
          f"s from spawn to exit; kernel D across the processes on "
          f"({CARDS}, {R}, 128) along dp bit for bit the one-card launch: "
          f"{same}")
    print(f"(g) ms: device a launch (CUDA events, {RING_REPS} calls a "
          f"process) median {row['device_ms']:.4f}, min {min(dev_ms):.4f} | "
          f"bound {bound:.6f} ({by}, {link}) | host synchronizes and "
          f"barriers median {row['sync_ms']:.3f} | a call on the host clock "
          f"{row['host_ms']:.4f} | NCCL all_reduce {row['library_ms']:.4f} "
          f"a call (up to {max(r['nccl_err'] for r in res):.2e} from "
          f"kernel D's sums)")
    if not same:
        missed.append("(g) kernel D across processes differs from the "
                      "one-card launch")
    if any(r["backend"] != "nccl" for r in res):
        missed.append("(g) the processes did not join over NCCL")
    iters = ba["kw"]["iters"]
    for impl in ("ring", "xla"):
        k1, l1 = refs[(2, 2, impl)]
        kf, lm = res[0][f"kf_{impl}"].to(dev), res[0][f"lm_{impl}"].to(dev)
        ok, msg = ba["compare"](f"(g) four processes {impl} vs the one-card "
                                "run", kf, lm, k1, l1, cs.SHARD_RING_TOL)
        bits = torch.equal(kf, k1) and torch.equal(lm, l1)
        print(f"(g) sharded BA over four processes ({impl}) "
              f"{np.mean([r[f'ms_{impl}'] for r in res]):.1f} ms a call, "
              f"kernel D launches per process "
              f"{[r[f'launches_{impl}'] for r in res]} (owner form "
              f"{[r[f'owned_{impl}'] for r in res]}), packed tables on the "
              f"timed call (hits, misses) "
              f"{[r[f'tables_{impl}'] for r in res]}; bit for bit the "
              f"one-card run: {bits}")
        if not ok:
            missed.append(msg)
        if impl == "ring" and not bits:
            missed.append("(g) the four-process ring BA is not the one-card "
                          "run bit for bit")
        want = iters if impl == "ring" else 0
        if any(r[f"launches_{impl}"] != want or r[f"owned_{impl}"] != want
               for r in res):
            missed.append(f"(g) {impl}: kernel D launches "
                          f"{[r[f'launches_{impl}'] for r in res]}, not "
                          f"{want} a process")
        for r in res[1:]:
            if not (torch.equal(r[f"kf_{impl}"], res[0][f"kf_{impl}"])
                    and torch.equal(r[f"lm_{impl}"], res[0][f"lm_{impl}"])):
                missed.append(f"(g) the processes' {impl} results differ")
    d = float((res[0]["pgo"].to(dev) - pgo["out1"]).abs().max())
    c2 = pgo["chi2"](res[0]["pgo"].to(dev))
    print(f"(g) sharded PGO over four processes (NCCL) {d:.3e} from the "
          f"single solve (tolerance {cs.PGO_SHARD_TOL}), chi2 {c2:.4e} "
          f"(single {pgo['c1']:.4e}); seconds a solve "
          f"{[tuple(round(v, 3) for v in r['pgo_s']) for r in res]} (first, "
          f"again; each process)")
    if not (d <= cs.PGO_SHARD_TOL and c2 <= pgo["c1"] * 1.05 + 1e-8):
        missed.append(f"(g) four-process PGO {d}, chi2 {c2}")
    return row, missed


def links() -> str:
    """How the cards are joined: `nvidia-smi topo -m`, else (a sandboxed
    machine may refuse it) `nvidia-smi nvlink --status` of card 0."""
    for cmd in (["nvidia-smi", "topo", "-m"],
                ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return f"$ {' '.join(cmd)}\n{r.stdout.rstrip()}"
        print(f"$ {' '.join(cmd)}: {(r.stdout + r.stderr).strip()[:200]}")
    return "the link is not reported"


def part(name: str, missed: list, fn, *args):
    """fn(*args), or None with the failure recorded in `missed` (a gate
    missed: the tool still reports the other parts, then exits 1)."""
    import traceback
    try:
        return fn(*args)
    except (Exception, SystemExit) as e:
        traceback.print_exc()
        missed.append(f"{name} failed: {type(e).__name__}: {e}")
        return None


def main() -> int:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"torch_multicard: needs {CARDS} CUDA devices, found {n}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import chip_smoke as cs
    from stereovision_slam_torch import scenes
    from stereovision_slam_torch.models import place_net
    from stereovision_slam_torch.ops import (_cuda, gather, lk_iterate,
                                             lk_lanes, pose_kernel)
    from stereovision_slam_torch.parallel import ring_reduce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi())
    print(links())
    cards = [torch.device("cuda", i) for i in range(CARDS)]
    peers = [[torch.cuda.can_device_access_peer(a, b) for b in range(CARDS)]
             for a in range(CARDS)]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}; "
          f"peer access {peers}")
    t_all = time.perf_counter()
    _cuda.build_all()
    counters = {"lk_pyramid": lk_lanes, "pose_lm": pose_kernel,
                "lk_iterate": lk_iterate, "gather_windows": gather,
                "ring_all_reduce": ring_reduce}
    missed = []
    rng = np.random.default_rng(cs.DIST_SEED)
    payload = torch.from_numpy(rng.normal(
        size=(CARDS, cs.RING_PATH_ROWS, ring_reduce.LANES)).astype(
        np.float32))
    row_a, failed = part("(a)", missed, kernel_d, cs, cards, payload) or \
        (None, [])
    missed += failed
    one = ring_reduce.ring_all_reduce_flat(payload.to(cards[0]), "dp",
                                           (("dp", CARDS), ("mp", 1)))

    scene = lefts, rights, gt, dist, rig = scenes.circuit(120, 188, 620,
                                                          device="cuda")
    vo, _ = cs.run_slice(lefts, rights, rig, "cuda")
    keyframes, _, _ = vo.drain()
    ba, pgo = {}, {}
    cs.sharded_ba_phase(vo, counters, "cuda", 0.0, False, ba)
    cs.pgo_phase(keyframes, gt, "cuda", False, pgo)
    refs, failed = part("(b)", missed, sharded_ba, cs, cards, ba,
                        counters) or ({}, [])
    missed += failed
    params = place_net.get_params(device="cuda")
    long_graph = part("(c) the long circuit", missed, long_circuit_graph,
                      cs, params)
    missed += part("(c)", missed, pgo_over_cards, cs, cards, pgo,
                   long_graph) or []
    tmp = tempfile.mkdtemp(prefix="svslam_multicard_")
    try:
        paths = part("the command line", missed, command_line, cs, scene,
                     tmp)
        if paths is not None:
            missed += part("(d)", missed, classic_shutdown, cs, scene,
                           paths) or []
        missed += part("(e)", missed, serving, cs, cs.serving_streams(
            lefts, rights, gt), rig, counters) or []
        if paths is not None:
            dense = {}
            missed += part("phase 16", missed, cs.dense_phase,
                           {"fused": paths["fused"]}, tmp, "cuda", None,
                           dense) or []
            missed += [f"(f) {m}" for m in part(
                "(f)", missed, cs.dense_mesh_phase, dense, tmp, "cuda")
                or []]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row_g, failed = part("(g)", missed, nccl_processes, cs, payload, one,
                         ba, refs, pgo) or (None, [])
    missed += failed
    print(f"kernel rows: {row_a} {row_g}")
    print(f"torch_multicard: {time.perf_counter() - t_all:.1f} s")
    print("missed: " + ("none" if not missed else "; ".join(missed)))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
