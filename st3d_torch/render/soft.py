"""Soft (SoftRas-style) differentiable silhouette shading (counterpart of
``st3d/render/soft.py``).

The rasterizer's soft mode reports per pixel the face of largest signed
boundary distance (the covering face inside coverage, the nearest face
outside): a discrete selection. Here the exact signed pixel distance to
that face is recomputed from the differentiable projected vertices and
``alpha = sigmoid(d / sigma_px)`` blends the face's texel with the
background, so vertices get silhouette gradients that the hard path lacks.

Ties in min/max/clip are taken with ``torch.minimum``/``torch.maximum``,
which split the gradient evenly there as JAX's do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from st3d_torch.render.shading import (
    gather_faces,
    interpolate_face_attributes,
    pixel_grid,
    recompute_barycentrics,
    sample_texture,
)


def _clip01(t: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(t, 0, 1)``, with JAX's gradient at the bounds."""
    return torch.minimum(torch.maximum(t, torch.zeros_like(t)),
                         torch.ones_like(t))


def signed_distance_at(tri: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor) -> torch.Tensor:
    """Exact signed pixel distance of points (px, py) to triangles ``tri``
    (..., 3, 3): positive inside (min distance to the edge lines), negative
    outside (minus the min distance to the edge segments). Differentiable
    in ``tri``."""
    x0, y0 = tri[..., 0, 0], tri[..., 0, 1]
    x1, y1 = tri[..., 1, 0], tri[..., 1, 1]
    x2, y2 = tri[..., 2, 0], tri[..., 2, 1]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    sgn = torch.sign(area)

    def edge_line_dist(xa, ya, xb, yb):
        cross = (xb - xa) * (py - ya) - (yb - ya) * (px - xa)
        length = torch.sqrt((xb - xa) ** 2 + (yb - ya) ** 2) + 1e-12
        return sgn * cross / length

    def edge_segment_dist(xa, ya, xb, yb):
        ex, ey = xb - xa, yb - ya
        qx, qy = px - xa, py - ya
        len2 = ex * ex + ey * ey
        t = _clip01((qx * ex + qy * ey)
                    / torch.maximum(len2, torch.full_like(len2, 1e-12)))
        dx, dy = qx - t * ex, qy - t * ey
        return torch.sqrt(dx * dx + dy * dy + 1e-20)

    inside_d = torch.minimum(torch.minimum(edge_line_dist(x1, y1, x2, y2),
                                           edge_line_dist(x2, y2, x0, y0)),
                             edge_line_dist(x0, y0, x1, y1))
    outside_d = torch.minimum(
        torch.minimum(edge_segment_dist(x1, y1, x2, y2),
                      edge_segment_dist(x2, y2, x0, y0)),
        edge_segment_dist(x0, y0, x1, y1))
    return torch.where(inside_d >= 0.0, inside_d, -outside_d)


def signed_distance_to_faces(face_verts: torch.Tensor,
                             face_ids: torch.Tensor) -> torch.Tensor:
    """(N, H, W) signed pixel distance of each pixel to its face
    ``face_ids`` (N, H, W) (>= 0) of face_verts (N, F, 3, 3)."""
    px, py = pixel_grid(face_ids.shape[-2], face_ids.shape[-1],
                        face_verts.device)
    return signed_distance_at(gather_faces(face_verts, face_ids), px, py)


def clamped_barycentrics(bary: torch.Tensor) -> torch.Tensor:
    """Negative barycentrics clamped to 0 and renormalised, so a pixel
    outside its face samples the nearest edge's color."""
    bary = torch.maximum(bary, torch.zeros_like(bary))
    s = torch.sum(bary, dim=-1, keepdim=True)
    return bary / torch.maximum(s, torch.full_like(s, 1e-8))


def shade_soft(face_verts: torch.Tensor, pix_to_face: torch.Tensor,
               nearest_face: torch.Tensor, verts_uvs: torch.Tensor,
               faces_uvs: torch.Tensor, texture: torch.Tensor,
               sigma_px: float = 1.0,
               background_color: Tuple[float, float, float] = (
                   1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGBA (N, H, W, 4) with sigmoid soft coverage as alpha: covered
    pixels take their z-winner's texel, the others the nearest face's,
    faded by alpha."""
    fid = torch.where(pix_to_face >= 0, pix_to_face, nearest_face)
    sd = signed_distance_to_faces(face_verts, fid)
    alpha = torch.sigmoid(sd / sigma_px)
    bary = clamped_barycentrics(recompute_barycentrics(face_verts, fid))
    uv = interpolate_face_attributes(verts_uvs[faces_uvs], fid, bary)
    rgb_face = sample_texture(texture, uv)
    bg = torch.tensor(background_color, dtype=rgb_face.dtype,
                      device=rgb_face.device)
    a = alpha[..., None]
    rgb = a * rgb_face + (1.0 - a) * bg
    return torch.cat([rgb, a], dim=-1)
