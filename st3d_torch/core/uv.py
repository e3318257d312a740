"""UV generation for UV-less meshes and padding to static budgets
(counterpart of ``st3d/core/uv.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from st3d_torch.core.mesh import Mesh
from st3d_torch.io.image import resize_bilinear_chw


def generate_uvs(mesh: Mesh, mode: str = "sphere",
                 texture_size: int = 512) -> Mesh:
    """Copy of ``mesh`` with synthesized verts_uvs/faces_uvs and a fresh
    mid-gray texture. ``"sphere"``: spherical projection from the bounding
    box center with the azimuth seam cut by duplicated UVs; ``"face_atlas"``:
    one isolated triangle per face in a square grid. Same arithmetic as
    the JAX package (host NumPy)."""
    verts = mesh.verts.detach().cpu().numpy().astype(np.float64)
    faces = mesh.faces.detach().cpu().numpy().astype(np.int64)

    if mode == "sphere":
        center = (verts.min(0) + verts.max(0)) / 2.0
        d = verts - center
        r = np.maximum(np.linalg.norm(d, axis=1), 1e-12)
        u = 0.5 + np.arctan2(d[:, 0], d[:, 2]) / (2 * math.pi)
        v = 0.5 + np.arcsin(np.clip(d[:, 1] / r, -1, 1)) / math.pi
        uvs = np.stack([u, v], axis=1)
        faces_uvs = faces.copy()
        # Faces spanning the u wraparound get duplicated UVs shifted by +1,
        # then all u are squeezed back into [0, 1] uniformly.
        extra_uvs = []
        fu = uvs[faces_uvs][:, :, 0]
        wrap = (fu.max(1) - fu.min(1)) > 0.5
        for fi in np.nonzero(wrap)[0]:
            for k in range(3):
                if uvs[faces_uvs[fi, k], 0] < 0.5:
                    src = uvs[faces_uvs[fi, k]]
                    extra_uvs.append([src[0] + 1.0, src[1]])
                    faces_uvs[fi, k] = len(uvs) + len(extra_uvs) - 1
        if extra_uvs:
            uvs = np.concatenate([uvs, np.asarray(extra_uvs)], axis=0)
            umax = uvs[:, 0].max()
            if umax > 1.0:
                uvs[:, 0] /= umax
    elif mode == "face_atlas":
        f = len(faces)
        grid = int(math.ceil(math.sqrt(f)))
        cell = 1.0 / grid
        margin = cell * 0.05
        uvs = np.zeros((f * 3, 2))
        for i in range(f):
            gx, gy = i % grid, i // grid
            x0, y0 = gx * cell + margin, gy * cell + margin
            s = cell - 2 * margin
            uvs[3 * i + 0] = (x0, y0)
            uvs[3 * i + 1] = (x0 + s, y0)
            uvs[3 * i + 2] = (x0, y0 + s)
        faces_uvs = np.arange(f * 3, dtype=np.int64).reshape(f, 3)
    else:
        raise ValueError(f"unknown uv mode {mode!r}")

    dev = mesh.device
    return mesh.replace(
        verts_uvs=torch.as_tensor(uvs, dtype=torch.float32, device=dev),
        faces_uvs=torch.as_tensor(faces_uvs, dtype=torch.int64, device=dev),
        texture=torch.full((texture_size, texture_size, 3), 0.5,
                           dtype=torch.float32, device=dev),
    )


def pad_mesh(mesh: Mesh, num_verts: int, num_faces: int,
             num_uvs: int = None, texture_size: int = None) -> Mesh:
    """Pad to static budgets for multi-mesh stacking (the fleet).

    Padding faces and face UVs are (0, 0, 0): zero screen area, so every
    rasterizer drops them through ``AREA_EPS`` and they sort after every
    face of the mesh; padding vertices sit at vertex 0's position, so they
    never extend the silhouette; padding UVs are zero. With
    ``texture_size``, a texture of another size in either dimension is
    resized (``resize_bilinear_chw``, which equals ``jax.image.resize``).
    The topology is kept (the regularizers see only real geometry).
    """
    v, f = mesh.verts.shape[0], mesh.faces.shape[0]
    t = mesh.verts_uvs.shape[0]
    if num_verts < v or num_faces < f:
        raise ValueError(
            f"budgets ({num_verts} verts, {num_faces} faces) below actual "
            f"({v}, {f})")
    num_uvs = num_uvs if num_uvs is not None else t
    if num_uvs < t:
        raise ValueError(f"uv budget {num_uvs} below actual {t}")

    def grow(x, n, fill):
        return torch.cat([x, fill.expand((n - x.shape[0],) + x.shape[1:])])

    zero_f = mesh.faces.new_zeros((1, 3))
    texture = mesh.texture
    if texture_size is not None and tuple(texture.shape[:2]) != (
            texture_size, texture_size):
        texture = resize_bilinear_chw(texture.permute(2, 0, 1),
                                      texture_size).permute(1, 2, 0)
    return mesh.replace(
        verts=grow(mesh.verts, num_verts, mesh.verts[:1]),
        faces=grow(mesh.faces, num_faces, zero_f),
        verts_uvs=grow(mesh.verts_uvs, num_uvs, mesh.verts_uvs.new_zeros(
            (1, 2))),
        faces_uvs=grow(mesh.faces_uvs, num_faces, zero_f),
        texture=texture.contiguous())
