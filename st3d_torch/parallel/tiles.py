"""Image-tile sharding: one render spread over the ranks by pixel rows
(counterpart of ``st3d/parallel/tiles.py``), the ``--tile_parallel`` path
of the final renders.

Rank r rasterizes and shades rows ``[r0, r0 + H/n)`` of every view, with
``r0 = r·H/n``. Row ownership is exclusive, so the bands are gathered in
rank order with no halo. The JAX package subtracts r0 from the projected y
and rasterizes an ``H/n``-row image; that rounds the face planes
differently, and at 1024² a few pixels a view flipped at near-ties (NVIDIA
H100, ``chip_smoke.py``). Here the planes are the whole frame's and K1 and
K6 take the band's first row (``row0``), as the shading does, so every
band equals those rows of the untiled render bit for bit.

The render is differentiable in ``mesh.texture`` and ``mesh.verts`` like
the single-device renderer: every rank computes the loss of the whole
(gathered) image, so the gather's backward hands each band its own rows of
the cotangent, and the bands' partial cotangents of the replicated inputs
are summed over the ranks (what ``shard_map``'s transpose does in the JAX
package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from st3d_torch.core.mesh import Mesh
from st3d_torch.parallel.sharding import World, make_device_mesh
from st3d_torch.render.rasterize import (
    RasterizationSettings,
    face_verts_screen,
    rasterize_batch,
)
from st3d_torch.render.shading import shade_textured


class _SumGradOverRanks(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the ranks: the
    input is replicated and each rank's band adds part of its gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


class _GatherBands(torch.autograd.Function):
    """Every rank's (N, rows, W, C) band, the first ``n_bands`` of them
    concatenated along the rows in rank order; the backward keeps this
    rank's rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, band, world, n_bands):
        ctx.rank, ctx.rows = world.rank, band.shape[1]
        band = band.contiguous()
        parts = [torch.empty_like(band) for _ in range(world.size)]
        dist.all_gather(parts, band)
        return torch.cat(parts[:n_bands], dim=1)

    @staticmethod
    def backward(ctx, grad):
        r0 = ctx.rank * ctx.rows
        out = grad.new_zeros(grad.shape[:1] + (ctx.rows,) + grad.shape[2:])
        if r0 < grad.shape[1]:
            out.copy_(grad[:, r0:r0 + ctx.rows])
        return out, None, None


def pick_tile_count(image_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices whose row bands tile image_size."""
    n = max(1, min(n_devices, image_size))
    while image_size % n:
        n -= 1
    return n


def render_rgba_tiled(mesh: Mesh, cameras, settings: RasterizationSettings,
                      world: World, n_tiles: Optional[int] = None
                      ) -> torch.Tensor:
    """(N_cams, H, W, 4) RGBA with the rows banded over the first
    ``n_tiles`` ranks (all by default); every rank of ``world`` calls it
    and gets the whole image. A rank past ``n_tiles`` renders a band below
    the image, which the gather drops. Hard K = 1 only: the soft, blurred
    and K > 1 modes would render another image than the single-device
    renderer."""
    if settings.soft or settings.blur_radius > 0 or \
            settings.faces_per_pixel > 1:
        raise ValueError(
            "tile-parallel rendering requires hard K=1 rasterization "
            f"(got soft={settings.soft}, blur_radius="
            f"{settings.blur_radius}, faces_per_pixel="
            f"{settings.faces_per_pixel}); render without --tile_parallel "
            "for soft or blurred rasterization")
    n = len(make_device_mesh(world, n_tiles))
    h = settings.image_size
    if h % n:
        raise ValueError(f"image_size {h} must divide across {n} devices")
    rows = h // n

    fv = face_verts_screen(mesh.verts, mesh.faces, cameras, h)
    texture = mesh.texture
    if world.sharded:
        fv = _SumGradOverRanks.apply(fv)
        texture = _SumGradOverRanks.apply(texture)
    r0 = world.rank * rows
    frags = rasterize_batch(fv, settings, image_height=rows, row0=r0)
    band = shade_textured(fv, frags.pix_to_face, mesh.verts_uvs,
                          mesh.faces_uvs, texture, row0=r0)
    if not world.sharded:
        return band
    return _GatherBands.apply(band, world, n)


def render_meshes_tiled(mesh: Mesh, cameras,
                        settings: RasterizationSettings, world: World,
                        n_tiles: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``render_meshes``-shaped output, images (N, 3, H, W) and masks (N, 1,
    H, W), rendered by ``render_rgba_tiled`` over ``pick_tile_count``
    ranks (by default)."""
    n = n_tiles or pick_tile_count(settings.image_size, world.size)
    rgba = render_rgba_tiled(mesh, cameras, settings, world, n)
    images = rgba[..., :3].permute(0, 3, 1, 2)
    masks = (rgba[..., 3:4] > 0).to(images.dtype).permute(0, 3, 1, 2)
    return images, masks
