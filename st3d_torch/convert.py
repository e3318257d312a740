"""Carry weights and state across from the JAX package, given as NumPy
arrays (``jax.random`` and ``torch`` draw different bits from one seed, so
parity tests build a model in JAX and load it here). Every VGG route of
the port, the opt-in stage 1 v3 (kernels E, F) and fused-pool (K8) routes
included, runs on the weights ``vgg19_from_numpy`` carries; no route has
packed weights of its own."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from st3d_torch.core.mesh import Mesh, MeshTopology, build_mesh
from st3d_torch.models.vgg import VGG19


def vgg19_from_numpy(kernels: Sequence, biases: Sequence,
                     device=None) -> VGG19:
    """The port's VGG-19 from ``st3d``'s ``VGG19.kernels`` (HWIO) and
    ``.biases``, each copied into a float32 array."""
    return VGG19([np.array(k, np.float32) for k in kernels],
                 [np.array(b, np.float32) for b in biases]).to(device)


def mesh_from_numpy(verts, faces, verts_uvs, faces_uvs, texture,
                    device=None, topology=None) -> Mesh:
    """A port ``Mesh`` from ``st3d`` mesh arrays. ``topology``, any object
    with ``edges``, ``degree`` and ``nc_pairs`` arrays (``st3d``'s
    ``MeshTopology``), is carried over as it is."""
    mesh = build_mesh(np.asarray(verts_uvs, np.float32),
                      np.asarray(faces_uvs, np.int64),
                      np.asarray(texture, np.float32),
                      np.asarray(verts, np.float32),
                      np.asarray(faces, np.int64))
    if topology is not None:
        mesh = mesh.replace(topology=MeshTopology(
            edges=torch.tensor(np.asarray(topology.edges, np.int64)),
            degree=torch.tensor(np.asarray(topology.degree, np.float32)),
            nc_pairs=torch.tensor(np.asarray(topology.nc_pairs, np.int64))))
    return mesh.to(device) if device is not None else mesh
