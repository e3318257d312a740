"""Rasterization: per-pixel visibility, winning face id and depth
(counterpart of ``st3d/render/rasterize.py``).

Visibility is discrete and carries no gradient: ``rasterize_batch`` returns
``pix_to_face``, ``zbuf`` and, in soft mode, ``nearest_face``; the shading
epilogue recomputes barycentrics and distances differentiably from the
projected vertices. One backend, ``st3d_torch.kernels.raster``: the
kernels for CUDA tensors, their plain versions for CPU tensors.

Dispatch, as the JAX package's: hard mode with a blur window or K > 1
faces per pixel goes through ``topk.rasterize_hard_k`` (kernel K7) and
keeps its nearest slot; otherwise K1 (hard or soft) runs, or K6 for meshes
past the resident coefficient budget.

Conventions: face vertices arrive as screen-space (x_pix, y_pix, z_view);
pixel (i, j) center is (x=j, y=i); no backface culling; depth ties go to
the lower face index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from st3d_torch.kernels.raster import AREA_EPS, BIG_Z, Z_EPS  # noqa: F401
from st3d_torch.kernels.raster import (
    rasterize_batched,
    rasterize_batched_soft,
)


@dataclasses.dataclass(frozen=True)
class RasterizationSettings:
    """PyTorch3D-style settings plus the soft-rasterization knobs, with the
    JAX package's defaults (``st3d/render/rasterize.py:46-76``)."""

    image_size: int = 256
    blur_radius: float = 0.0
    faces_per_pixel: int = 1
    soft: bool = False
    soft_sigma_px: float = 1.0
    sigma: float = 1e-4
    gamma: float = 1e-4
    hard_k_slack: int = 4

    @property
    def hard_k(self) -> bool:
        """Hard mode with a blur window or several faces per pixel."""
        return not self.soft and (self.blur_radius != 0.0
                                  or self.faces_per_pixel != 1)

    @property
    def softras(self) -> bool:
        """Full SoftRas: soft mode with several faces per pixel."""
        return self.soft and self.faces_per_pixel > 1


@dataclasses.dataclass
class Fragments:
    """Per-pixel rasterization output for a view batch: pix_to_face
    (N, H, W) int32 (-1 = background), zbuf (N, H, W) float32 (BIG_Z where
    uncovered) and, in soft mode, nearest_face (N, H, W) int32, the face of
    largest signed boundary distance."""

    pix_to_face: torch.Tensor
    zbuf: torch.Tensor
    nearest_face: Optional[torch.Tensor] = None


def rasterize_batch(face_verts: torch.Tensor,
                    settings: RasterizationSettings,
                    image_height: Optional[int] = None,
                    row0: int = 0) -> Fragments:
    """Rasterize a batch of views (N, F, 3, 3) in one kernel launch; with
    ``image_height``, the rows ``[row0, row0 + image_height)`` of the
    image (hard K = 1 takes a ``row0``: the tiled render's bands)."""
    face_verts = face_verts.detach()
    if row0 and (settings.hard_k or settings.soft):
        raise NotImplementedError(
            f"a row offset (row0={row0}) is for hard K=1 rasterization only")
    if settings.hard_k:
        if image_height is not None and image_height != settings.image_size:
            raise NotImplementedError(
                f"banded rasterization (image_height={image_height}) is not "
                "supported with blur_radius > 0 or faces_per_pixel > 1")
        from st3d_torch.render.topk import rasterize_hard_k

        hk = rasterize_hard_k(face_verts, settings)
        p2f = hk.pix_to_face[..., 0]
        zbuf = torch.where(p2f >= 0, hk.zbuf[..., 0],
                           torch.full_like(hk.zbuf[..., 0], BIG_Z))
        return Fragments(pix_to_face=p2f, zbuf=zbuf)
    if settings.soft:
        p2f, zbuf, near = rasterize_batched_soft(
            face_verts, settings.image_size, settings.soft_sigma_px,
            image_height)
        return Fragments(pix_to_face=p2f, zbuf=zbuf, nearest_face=near)
    p2f, zbuf = rasterize_batched(face_verts, settings.image_size,
                                  image_height, row0=row0)
    return Fragments(pix_to_face=p2f, zbuf=zbuf)


def face_verts_screen(verts: torch.Tensor, faces: torch.Tensor, cameras,
                      image_size: int) -> torch.Tensor:
    """Project mesh vertices and gather per-face screen verts:
    (N_cams, F, 3, 3) of (x_pix, y_pix, z_view), differentiable in
    ``verts``."""
    from st3d_torch.core.cameras import transform_points_screen

    scr = transform_points_screen(cameras, verts, (image_size, image_size))
    return scr[:, faces]
