"""Distributed pose-graph optimization over a rank mesh (counterpart of
`parallel/sharded_pgo.py`).

The edges are split over every rank of the mesh (contiguous equal chunks
of the padded edge list), the poses and the CG vectors are kept once
(replicated), and each edge sum of the LM/PCG body (`pose_graph._optimize`)
is a per-rank partial that a sum over the rank axis completes: the
counterpart of the reference's `psum` over all mesh axes. Padding edges are
invalid and weigh nothing. On a mesh over processes each process holds
the edges of its own ranks, and the sum is the local one followed by
`all_reduce` over the processes.

On a per-rank mesh (one device per rank in this process) each rank's
edges live on its device (`_RankEdges`): every edge sum is each rank's
partial on its device, folded in rank order on `mesh.device`, where the
vertex state is kept once; each CG vector goes to the ranks' devices
before their products. The reference replicates the vertex state on
every chip because each chip runs its own program; in one process one
copy serves them all, and the solve's host work grows with the ranks'
edge work only.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.parallel.mesh import Mesh, fold
from stereovision_slam_torch.slam.pose_graph import (
    PoseGraph, _Edges, _edge_ranks, _optimize)


def _pad_edges(g: PoseGraph, n: int) -> PoseGraph:
    """Pad the edge list to a multiple of n with invalid identity self
    edges at vertex 0. The information matrices, where given, are padded
    with identities (the reference's sharded PGO takes no `edge_info`)."""
    E = g.edge_i.shape[0]
    pad = (-E) % n
    if pad == 0:
        return g
    dt, dev = g.edge_meas.dtype, g.edge_meas.device
    eye34 = torch.eye(3, 4, dtype=dt, device=dev).expand(pad, 3, 4)
    info = g.edge_info
    if info is not None:
        info = torch.cat([info, torch.eye(6, dtype=info.dtype, device=dev)
                          .expand(pad, 6, 6)])
    return g._replace(
        edge_i=torch.cat([g.edge_i, g.edge_i.new_zeros(pad)]),
        edge_j=torch.cat([g.edge_j, g.edge_j.new_zeros(pad)]),
        edge_meas=torch.cat([g.edge_meas, eye34]),
        edge_valid=torch.cat([g.edge_valid, g.edge_valid.new_zeros(pad)]),
        edge_info=info)


class _RankEdges:
    """The edge side of the LM/PCG body (`pose_graph._Edges`) over the ranks
    of a per-rank mesh: rank r's edges on its device, each sum each rank's
    partial folded in rank order on `device`."""

    def __init__(self, ranks: PoseGraph, devices, device):
        self.device = device
        self.ranks = [(_Edges(ranks._replace(**{
            f: getattr(ranks, f)[r:r + 1].to(d) for f in ranks._fields[2:]
            if getattr(ranks, f) is not None})), d)
            for r, d in enumerate(devices)]

    def _fold(self, parts):
        return fold([p.to(self.device) for p in parts])

    def chi2(self, poses):
        return self._fold([e.chi2(poses.to(d)) for e, d in self.ranks])

    def linearize(self, poses):
        return [e.linearize(poses.to(d)) for e, d in self.ranks]

    def gradient(self, lin, T: int):
        return self._fold([e.gradient(li, T)
                           for (e, _), li in zip(self.ranks, lin)])

    def diag_blocks(self, lin, T: int):
        return self._fold([e.diag_blocks(li, T)
                           for (e, _), li in zip(self.ranks, lin)])

    def hvp(self, lin, x):
        return self._fold([e.hvp(li, x.to(d))
                           for (e, d), li in zip(self.ranks, lin)])


def build_sharded_pgo(mesh: Mesh, iters: int = 22, cg_iters: int = 100):
    """A distributed PGO: returns run(PoseGraph) -> refined (T, 3, 4) poses
    (the graph on `mesh.device`), the LM/PCG of
    `optimize_pose_graph(g, iters, cg_iters)` with the edges over all
    `mesh.size` ranks."""
    n = mesh.size
    if mesh.per_rank:
        mesh.check_rank_devices()
    r0, r1 = mesh.ranks.start, mesh.ranks.stop

    def run(g: PoseGraph) -> torch.Tensor:
        if g.poses.device != mesh.device:
            raise ValueError(f"the graph is on {g.poses.device}, the mesh on "
                             f"{mesh.device}")
        ranks = _edge_ranks(_pad_edges(g, n), n)
        if mesh.per_rank:
            edges = _RankEdges(ranks, mesh.devices, mesh.device)
        else:
            if r1 - r0 < n:
                ranks = ranks._replace(**{
                    f: getattr(ranks, f)[r0:r1] for f in ranks._fields[2:]
                    if getattr(ranks, f) is not None})
            edges = _Edges(ranks, reduce_fn=lambda partials: mesh.all_reduce(
                partials.sum(0)))
        return _optimize(edges, g.pose_valid, g.poses, iters, cg_iters)

    return run
