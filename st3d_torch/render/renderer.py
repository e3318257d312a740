"""Renderer: camera batch in, RGBA images out (counterpart of
``st3d/render/renderer.py``), in every raster mode.

``render_rgba`` rasterizes and shades every view of a batch: hard mode
(K1 or K6, or K7 with a blur window or K > 1), soft mode (K1's soft mode
or K6, ``shade_soft``) or full SoftRas (K7, ``shade_softras``). It is
differentiable in the vertices and the texture, so a vertex optimisation
calls it every step.

For a texture-only optimization the geometry never moves, so visibility is
a per-batch constant: ``precompute_visibility`` runs the rasterizer once
(and in hard mode the barycentric/UV interpolation too), and
``render_rgba_static`` shades from the cached constants each step,
differentiable in the texture. ``compact_visibility`` keeps only the
covered pixels of hard-mode constants (a no-op in the soft modes), so a
step samples (and back-propagates into the texture) nothing else; the
images are the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from st3d_torch.core.cameras import FoVPerspectiveCameras
from st3d_torch.core.mesh import Mesh
from st3d_torch.render.rasterize import (
    RasterizationSettings,
    face_verts_screen,
    rasterize_batch,
)
from st3d_torch.render.shading import (
    pixel_uvs,
    shade_compact,
    shade_from_uvs,
    shade_textured,
)
from st3d_torch.render.soft import shade_soft
from st3d_torch.render.topk import (
    check_hard_k_saturation,
    rasterize_topk,
    shade_softras,
)
from st3d_torch.utils import trace


def shade_views(mesh: Mesh, fv: torch.Tensor, vis: Dict[str, torch.Tensor],
                settings: RasterizationSettings) -> torch.Tensor:
    """RGBA (N, H, W, 4) from screen verts ``fv`` (N, F, 3, 3) and the
    discrete visibility ``vis`` of ``rasterize_views``; differentiable in
    ``fv`` and ``mesh.texture``."""
    if settings.softras:
        return shade_softras(fv, vis["p2f_k"], mesh.verts_uvs,
                             mesh.faces_uvs, mesh.texture,
                             sigma_px=settings.soft_sigma_px,
                             gamma=settings.gamma)
    if settings.soft:
        return shade_soft(fv, vis["p2f"], vis["near"], mesh.verts_uvs,
                          mesh.faces_uvs, mesh.texture,
                          sigma_px=settings.soft_sigma_px)
    return shade_textured(fv, vis["p2f"], mesh.verts_uvs, mesh.faces_uvs,
                          mesh.texture)


def rasterize_views(fv: torch.Tensor, settings: RasterizationSettings
                    ) -> Dict[str, torch.Tensor]:
    """One raster launch for the view batch ``fv``: the discrete fragments
    ``shade_views`` reads (``p2f_k`` for SoftRas, else ``p2f``, and
    ``near`` in soft mode)."""
    if settings.softras:
        return {"p2f_k": rasterize_topk(fv, settings).pix_to_face}
    frags = rasterize_batch(fv, settings)
    vis = {"p2f": frags.pix_to_face}
    if settings.soft:
        vis["near"] = frags.nearest_face
    return vis


@trace.spanned("render")
def render_rgba(mesh: Mesh, cameras: FoVPerspectiveCameras,
                settings: RasterizationSettings) -> torch.Tensor:
    """(N, H, W, 4) RGBA for every camera: white background, alpha =
    coverage (soft coverage in the soft modes)."""
    fv = face_verts_screen(mesh.verts, mesh.faces, cameras,
                           settings.image_size)
    return shade_views(mesh, fv, rasterize_views(fv, settings), settings)


def warn_if_hard_k_saturated(mesh: Mesh, cameras: FoVPerspectiveCameras,
                             settings: RasterizationSettings,
                             context: str = "render") -> int:
    """With a blur window or K > 1 in hard mode, rasterize once and warn
    where the selection saturated; returns the at-risk pixel count, 0 at
    once for the configurations that cannot saturate."""
    if not settings.hard_k:
        return 0
    with torch.no_grad():
        fv = face_verts_screen(mesh.verts, mesh.faces, cameras,
                               settings.image_size)
    return check_hard_k_saturation(fv, settings, context=context)


def render_meshes(mesh: Mesh, cameras: FoVPerspectiveCameras,
                  settings: RasterizationSettings
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (N, 3, H, W) and binary masks (N, 1, H, W), mask = alpha > 0."""
    rgba = render_rgba(mesh, cameras, settings)
    images = rgba[..., :3].permute(0, 3, 1, 2)
    masks = (rgba[..., 3:4] > 0).to(images.dtype).permute(0, 3, 1, 2)
    return images, masks


def precompute_visibility(mesh: Mesh, cameras: FoVPerspectiveCameras,
                          settings: RasterizationSettings
                          ) -> Dict[str, torch.Tensor]:
    """Visibility constants for ``render_rgba_static``: screen face verts
    ``fv`` and the fragments (``p2f_k`` for SoftRas, ``p2f`` and ``near``
    in soft mode); in hard mode also the per-pixel ``uv`` (N, H, W, 2) and
    ``mask`` (N, H, W)."""
    with torch.no_grad():
        fv = face_verts_screen(mesh.verts, mesh.faces, cameras,
                               settings.image_size)
        vis = {"fv": fv, **rasterize_views(fv, settings)}
        if not settings.soft:
            vis["uv"], vis["mask"] = pixel_uvs(fv, vis["p2f"],
                                               mesh.verts_uvs,
                                               mesh.faces_uvs)
    return vis


def compact_visibility(vis: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Keep only the covered pixels of hard-mode visibility: ``cov_idx``
    (flat indices into the N*H*W frame), their ``uv_cov`` and the
    ``mask``. ``render_rgba_static`` then samples the texture at covered
    pixels only; its images are identical to the ``uv``/``mask`` form.
    Soft-mode constants (no ``uv``) pass through."""
    if "uv" not in vis:
        return vis
    mask = vis["mask"]
    cov_idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    return {"mask": mask, "cov_idx": cov_idx,
            "uv_cov": vis["uv"].reshape(-1, 2)[cov_idx]}


@trace.spanned("render")
def render_rgba_static(mesh: Mesh, vis: Dict[str, torch.Tensor],
                       settings: RasterizationSettings) -> torch.Tensor:
    """``render_rgba`` with the visibility pass replaced by the constants of
    ``precompute_visibility`` (or their ``compact_visibility`` form);
    differentiable in ``mesh.texture`` only."""
    if "cov_idx" in vis:
        return shade_compact(mesh.texture, vis["cov_idx"], vis["uv_cov"],
                             vis["mask"])
    if "uv" in vis:
        return shade_from_uvs(mesh.texture, vis["uv"], vis["mask"])
    return shade_views(mesh, vis["fv"], vis, settings)
