"""Distributed pose-graph optimization over a rank mesh (counterpart of
`parallel/sharded_pgo.py`).

The edges are split over every rank of the mesh (contiguous equal chunks
of the padded edge list), the poses and the CG vectors are kept once
(replicated), and each edge sum of the LM/PCG body (`pose_graph._optimize`)
is a per-rank partial that a sum over the rank axis completes: the
counterpart of the reference's `psum` over all mesh axes. Padding edges are
invalid and weigh nothing.
"""

from __future__ import annotations

import torch

from stereovision_slam_torch.parallel.mesh import Mesh
from stereovision_slam_torch.slam.pose_graph import (
    PoseGraph, _edge_ranks, _optimize)


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


def build_sharded_pgo(mesh: Mesh, iters: int = 22, cg_iters: int = 100):
    """A distributed PGO: returns run(PoseGraph) -> refined (T, 3, 4) poses
    (the graph on `mesh.device`), the LM/PCG of
    `optimize_pose_graph(g, iters, cg_iters)` with the edges over all
    `mesh.size` ranks."""
    n = mesh.size

    def run(g: PoseGraph) -> torch.Tensor:
        if g.poses.device != mesh.device:
            raise ValueError(f"the graph is on {g.poses.device}, the mesh on "
                             f"{mesh.device}")
        return _optimize(_edge_ranks(_pad_edges(g, n), n), iters, cg_iters,
                         reduce_fn=lambda partials: partials.sum(0))

    return run
