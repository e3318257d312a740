"""Carry weights and state across from the JAX package, given as NumPy
arrays (``jax.random`` and ``torch`` draw different bits from one seed, so
parity tests build a model in JAX and load it here): VGG-19's weights, a
mesh, and optax's Adam state from a JAX checkpoint. Every VGG route of
the port, the opt-in stage 1 v3 (kernels E, F) and fused-pool (K8) routes
included, runs on the weights ``vgg19_from_numpy`` carries; no route has
packed weights of its own."""

from __future__ import annotations

from typing import Dict, Sequence

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


def adam_state_from_numpy(optimizer: torch.optim.Optimizer,
                          params: Dict[str, torch.Tensor], count,
                          mu: Sequence, nu: Sequence) -> None:
    """Load optax's ``ScaleByAdamState`` leaves (``count``, and ``mu`` and
    ``nu`` per leaf in sorted-key order, as a JAX checkpoint's ``o{i}``
    keys hold them) into ``optimizer``, a ``torch.optim.Adam`` over the
    tensors of ``params``: every leaf takes the shared ``count`` as its
    ``step``."""
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    sd = optimizer.state_dict()
    sd["state"] = {}
    for k, m, v in zip(sorted(params), mu, nu):
        p = params[k]
        sd["state"][index[id(p)]] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.tensor(np.asarray(m)).to(p),
            "exp_avg_sq": torch.tensor(np.asarray(v)).to(p)}
    optimizer.load_state_dict(sd)
