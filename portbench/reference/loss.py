"""The mesh regularizers (the perceptual loss is the configuration's own,
``portbench/losses/<loss>.py``).

Regularizers (``pytorch3d.loss``, uniform Laplacian): the mean over unique
edges of their squared length; the mean over vertices with neighbours of
``|mean of the neighbours - v|``; the mean over pairs of faces sharing an
edge of ``1 - cos(n0, n1)`` with ``n0 = (v1 - v0) x (a - v0)`` and
``n1 = -(v1 - v0) x (b - v0)``, a and b the faces' opposite vertices; and
the mean squared offset of the vertices from the content mesh's.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch


class Topology:
    """Unique edges, vertex degrees and the (v0, v1, a, b) of every pair of
    faces sharing an edge, from the faces alone."""

    def __init__(self, faces: np.ndarray, n_verts: int, device):
        corners = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
        by_edge: Dict[tuple, list] = {}
        for f in np.asarray(faces, np.int64):
            for i, j, k in corners:
                a, b = int(f[i]), int(f[j])
                by_edge.setdefault((min(a, b), max(a, b)), []).append(
                    int(f[k]))
        edges = np.array(sorted(by_edge), np.int64)
        pairs = [(e[0], e[1], p, q) for e in sorted(by_edge)
                 for p, q in itertools.combinations(by_edge[e], 2)]
        deg = np.bincount(edges.reshape(-1), minlength=n_verts)
        self.edges = torch.as_tensor(edges, device=device)
        self.pairs = torch.as_tensor(np.array(pairs, np.int64),
                                     device=device)
        self.degree = torch.as_tensor(deg, dtype=torch.float32,
                                      device=device)


def regularizers(verts: torch.Tensor, verts0: torch.Tensor,
                 topo: Topology, w: Dict[str, float]) -> torch.Tensor:
    e = verts[topo.edges]
    edge = torch.mean(torch.sum((e[:, 0] - e[:, 1]) ** 2, dim=-1))
    nbr = torch.zeros_like(verts)
    nbr = nbr.index_add(0, topo.edges[:, 0], verts[topo.edges[:, 1]])
    nbr = nbr.index_add(0, topo.edges[:, 1], verts[topo.edges[:, 0]])
    has = topo.degree > 0
    lap = torch.linalg.norm(
        nbr[has] / topo.degree[has, None] - verts[has], dim=-1).mean()
    p = topo.pairs
    v0, v1, a, b = (verts[p[:, k]] for k in range(4))
    n0 = torch.linalg.cross(v1 - v0, a - v0)
    n1 = -torch.linalg.cross(v1 - v0, b - v0)
    cos = (n0 * n1).sum(-1) / torch.clamp(
        torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1),
        min=1e-12)
    normal = torch.mean(1.0 - cos)
    offset = torch.mean((verts - verts0) ** 2)
    return (w["mesh_verts_weight"] * offset
            + w["mesh_edge_loss_weight"] * edge
            + w["mesh_laplacian_smoothing_weight"] * lap
            + w["mesh_normal_consistency_weight"] * normal)
