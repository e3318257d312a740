"""Mesh and UV-texture data model, plus the static topology of the mesh
regularizers (counterpart of ``st3d/core/mesh.py``).

A ``Mesh`` is a plain dataclass of tensors; ``.to(device)`` moves it and
``.replace(**fields)`` returns a copy with fields swapped (the functional
update the JAX pytree had). ``compute_topology`` extracts unique edges,
vertex degrees and the face pairs of shared edges once, with NumPy on the
host, in the JAX package's order; ``Mesh.with_topology`` attaches them as
tensors on the mesh's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MeshTopology:
    """Static connectivity, precomputed on the host.

    edges (E, 2) int64: unique undirected edges, each row sorted (v0 < v1),
    lexicographically ordered. degree (V,) float32: edge neighbours per
    vertex. nc_pairs (P, 4) int64: for every pair of faces sharing an edge,
    (v0, v1, a, b) with (v0, v1) the edge and a, b the opposite vertices;
    all C(n, 2) pairs for an edge shared by n > 2 faces.
    """

    edges: torch.Tensor
    degree: torch.Tensor
    nc_pairs: torch.Tensor

    def to(self, device) -> "MeshTopology":
        return MeshTopology(self.edges.to(device), self.degree.to(device),
                            self.nc_pairs.to(device))


@dataclasses.dataclass
class Mesh:
    """A single triangle mesh with a UV-mapped texture.

    verts (V, 3) float32; faces (F, 3) int64; verts_uvs (Vt, 2) float32
    with uv (0, 0) at the BOTTOM-left of the texture image; faces_uvs
    (F, 3) int64; texture (Ht, Wt, 3) float32 in [0, 1], row 0 at the top;
    topology, optional, for the mesh regularizers.
    """

    verts: torch.Tensor
    faces: torch.Tensor
    verts_uvs: torch.Tensor
    faces_uvs: torch.Tensor
    texture: torch.Tensor
    topology: Optional[MeshTopology] = None

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def to(self, device) -> "Mesh":
        return Mesh(**{f.name: (None if getattr(self, f.name) is None
                                else getattr(self, f.name).to(device))
                       for f in dataclasses.fields(self)})

    def replace(self, **changes) -> "Mesh":
        return dataclasses.replace(self, **changes)

    def with_topology(self) -> "Mesh":
        """A copy carrying the topology on the mesh's device (no-op if
        present)."""
        if self.topology is not None:
            return self
        topo = compute_topology(self.faces.cpu().numpy(),
                                int(self.verts.shape[0]))
        return self.replace(topology=topo.to(self.device))


def compute_topology(faces: np.ndarray, num_verts: int) -> MeshTopology:
    """Host-side (NumPy) connectivity extraction, as the JAX package's
    ``compute_topology`` (the same edge order and pair order); CPU
    tensors."""
    faces = np.asarray(faces, dtype=np.int64)
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {faces.shape}")

    # All directed edges with, per edge, the opposite vertex of its face.
    all_edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    opposite = np.concatenate([faces[:, 2], faces[:, 0], faces[:, 1]], axis=0)
    edges, inverse = np.unique(np.sort(all_edges, axis=1), axis=0,
                               return_inverse=True)
    inverse = inverse.reshape(-1)

    degree = np.zeros((num_verts,), dtype=np.float32)
    np.add.at(degree, edges.reshape(-1), 1.0)

    # Opposite vertices grouped by edge id: each edge's run in edge order.
    order = np.argsort(inverse, kind="stable")
    opp_sorted = opposite[order]
    counts = np.bincount(inverse[order], minlength=len(edges))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])

    pairs = []
    two = np.nonzero(counts == 2)[0]     # manifold edges, vectorised
    if two.size:
        s = starts[two]
        pairs.append(np.stack([edges[two, 0], edges[two, 1], opp_sorted[s],
                               opp_sorted[s + 1]], axis=1))
    for eid in np.nonzero(counts > 2)[0]:  # non-manifold: all pairs
        s, n = starts[eid], counts[eid]
        opp = opp_sorted[s:s + n]
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append(np.array(
                    [[edges[eid, 0], edges[eid, 1], opp[i], opp[j]]],
                    dtype=np.int64))
    nc_pairs = (np.concatenate(pairs, axis=0) if pairs
                else np.zeros((0, 4), dtype=np.int64))
    return MeshTopology(edges=torch.from_numpy(edges.astype(np.int64)),
                        degree=torch.from_numpy(degree),
                        nc_pairs=torch.from_numpy(nc_pairs.astype(np.int64)))


def build_mesh(verts_uvs, faces_uvs, texture_map, verts, faces,
               with_topology: bool = False) -> Mesh:
    """Assemble a Mesh; same argument order as ``st3d.core.mesh.build_mesh``.
    Accepts arrays or tensors, batched (1, ...) or not."""

    def _t(a, rank, dtype):
        t = (a.detach() if isinstance(a, torch.Tensor)
             else torch.tensor(np.asarray(a)))
        if t.dim() == rank + 1 and t.shape[0] == 1:
            t = t[0]
        if t.dim() != rank:
            raise ValueError(
                f"expected rank {rank} (or 1+{rank}), got {tuple(t.shape)}")
        return t.to(dtype)

    mesh = Mesh(
        verts=_t(verts, 2, torch.float32),
        faces=_t(faces, 2, torch.int64),
        verts_uvs=_t(verts_uvs, 2, torch.float32),
        faces_uvs=_t(faces_uvs, 2, torch.int64),
        texture=_t(texture_map, 3, torch.float32),
    )
    return mesh.with_topology() if with_topology else mesh


def finalize_mesh(mesh: Mesh) -> Mesh:
    """Detached copy with the texture clamped to [0, 1]; the vertices (moved
    by a mesh or both optimisation) are kept as they are."""
    return mesh.replace(verts=mesh.verts.detach(),
                        texture=mesh.texture.detach().clamp(0.0, 1.0))
