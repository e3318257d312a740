"""Differentiable shading epilogue: barycentric recompute, UV interpolation,
bilinear texture sampling and background fill (counterpart of
``st3d/render/shading.py``).

Ambient-only shading: pixel = sampled texel where covered, the background
color elsewhere, alpha = coverage. Texture convention (PyTorch3D
TexturesUV, as in the JAX package): uv (0, 0) is the BOTTOM-left of the
texture image, bilinear with align_corners=True and border clamping.

The texture gradient is autograd's gather backward (an index-add); the
dynamic ``shade_textured`` and the compact static form feed it covered
pixels only. The JAX package's quad packing, sampling plan and plan tree
were TPU gather and scatter workarounds and have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from st3d_torch.kernels.raster import AREA_EPS


def barycentrics_at(tri: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor) -> torch.Tensor:
    """Perspective-correct barycentrics of triangles ``tri`` (..., 3, 3) at
    pixel centers (px, py) broadcastable to ``tri.shape[:-2]`` ->
    (..., 3). Differentiable."""
    x0, y0, z0 = tri[..., 0, 0], tri[..., 0, 1], tri[..., 0, 2]
    x1, y1, z1 = tri[..., 1, 0], tri[..., 1, 1], tri[..., 1, 2]
    x2, y2, z2 = tri[..., 2, 0], tri[..., 2, 1], tri[..., 2, 2]

    w0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    w1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    w2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    denom_a = torch.where(torch.abs(area) > AREA_EPS, area,
                          torch.full_like(area, AREA_EPS))
    b = torch.stack([w0, w1, w2], dim=-1) / denom_a[..., None]

    z = torch.stack([z0, z1, z2], dim=-1)
    bw = b / torch.clamp(z, min=1e-8)
    denom = torch.sum(bw, dim=-1, keepdim=True)
    return bw / torch.where(torch.abs(denom) > 1e-12, denom,
                            torch.full_like(denom, 1e-12))


def pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py) float32 (H, W) pixel-center coordinates."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def barycentrics_of_triangles(tri: torch.Tensor) -> torch.Tensor:
    """Perspective-correct barycentrics at pixel centers for per-pixel
    triangles ``tri`` (..., H, W, 3, 3) -> (..., H, W, 3). Differentiable."""
    px, py = pixel_grid(tri.shape[-4], tri.shape[-3], tri.device)
    return barycentrics_at(tri, px, py)


def face_rows(values: torch.Tensor, view: torch.Tensor,
              fid: torch.Tensor) -> torch.Tensor:
    """Rows ``values[view, fid]`` of per-view face data (N, F, ...) for
    index tensors of one shape. An ``index_select`` on the flattened rows:
    its backward is an atomic index-add, where advanced indexing's sorts
    the indices and walks each face's duplicates serially (46 ms a step on
    an H100 for soft mode's far field at 512² x 4, where one face is the
    nearest of thousands of pixels)."""
    n, f = values.shape[0], values.shape[1]
    flat = values.reshape((n * f,) + values.shape[2:])
    idx = (view * f + fid).reshape(-1)
    return flat.index_select(0, idx).reshape(fid.shape + values.shape[2:])


def gather_faces(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-view face rows: ``values`` (N, F, ...) at ``ids`` (N, ...)
    clamped to >= 0 -> ids.shape + values.shape[2:]."""
    n = values.shape[0]
    view = torch.arange(n, device=ids.device).reshape(
        (n,) + (1,) * (ids.dim() - 1))
    return face_rows(values, view, torch.clamp(ids, min=0).long())


def recompute_barycentrics(face_verts: torch.Tensor,
                           pix_to_face: torch.Tensor) -> torch.Tensor:
    """Barycentrics (N, H, W, 3) of each pixel in its face, for face_verts
    (N, F, 3, 3) and pix_to_face (N, H, W); arbitrary where pix_to_face < 0.
    Differentiable in ``face_verts``, the ids acting as constants."""
    return barycentrics_of_triangles(gather_faces(face_verts, pix_to_face))


def interpolate_face_attributes(attrs: torch.Tensor,
                                pix_to_face: torch.Tensor,
                                barycentrics: torch.Tensor) -> torch.Tensor:
    """(..., H, W, D) barycentric interpolation of per-corner attributes
    ``attrs`` (F, 3, D) at pix_to_face (..., H, W)."""
    a = attrs[torch.clamp(pix_to_face, min=0).long()]
    return torch.sum(a * barycentrics[..., None], dim=-2)


def pixel_uvs(face_verts: torch.Tensor, pix_to_face: torch.Tensor,
              verts_uvs: torch.Tensor, faces_uvs: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel texture coordinates (N, H, W, 2) and coverage (N, H, W)
    for face_verts (N, F, 3, 3) and pix_to_face (N, H, W)."""
    n, f = face_verts.shape[0], face_verts.shape[1]
    face_uv = verts_uvs[faces_uvs]                      # (F, 3, 2)
    pack = torch.cat([face_verts.reshape(n, f, 9),
                      face_uv.reshape(1, f, 6).expand(n, f, 6)], dim=-1)
    safe = torch.clamp(pix_to_face, min=0).long()       # (N, H, W)
    g = pack[torch.arange(n, device=pack.device)[:, None, None], safe]
    tri = g[..., 0:9].reshape(g.shape[:-1] + (3, 3))
    uvf = g[..., 9:15].reshape(g.shape[:-1] + (3, 2))
    bary = barycentrics_of_triangles(tri)
    uv = torch.sum(uvf * bary[..., None], dim=-2)
    return uv, pix_to_face >= 0


def sample_coords(texture_hw, uv: torch.Tensor):
    """Bilinear sample coordinates (align_corners=True): (x0, y0) int64
    top-left texel and (fx, fy) fractions, with border clamping and the V
    flip."""
    ht, wt = texture_hw
    x = uv[..., 0] * (wt - 1)
    y = (1.0 - uv[..., 1]) * (ht - 1)
    x = torch.clamp(x, 0.0, wt - 1)
    y = torch.clamp(y, 0.0, ht - 1)
    x0 = torch.clamp(torch.floor(x), 0, wt - 2)
    y0 = torch.clamp(torch.floor(y), 0, ht - 2)
    return x0.long(), y0.long(), x - x0, y - y0


def _bilerp(flat: torch.Tensor, idx: torch.Tensor, wt: int,
            fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Bilinear lerp of a flat atlas ``flat`` (rows of ``wt`` texels, C
    channels) from the top-left texels ``idx`` -> idx.shape + (C,); ``fx``
    and ``fy`` broadcast against ``idx``. The lerp association
    (top/bottom, then vertical) is the JAX package's."""
    ch = flat.shape[-1]

    def tap(i):
        # index_select's backward is an index-add into the atlas.
        return flat.index_select(0, i.reshape(-1)).reshape(idx.shape + (ch,))

    g00, g01 = tap(idx), tap(idx + 1)
    g10, g11 = tap(idx + wt), tap(idx + wt + 1)
    fx, fy = fx[..., None], fy[..., None]
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy


def sample_texture(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Differentiable bilinear sampling of texture (Ht, Wt, 3) at uv
    (..., 2) -> (..., 3)."""
    ht, wt, ch = texture.shape
    x0, y0, fx, fy = sample_coords((ht, wt), uv)
    return _bilerp(texture.reshape(ht * wt, ch), y0 * wt + x0, wt, fx, fy)


def shade_from_uvs(texture: torch.Tensor, uv: torch.Tensor,
                   mask: torch.Tensor,
                   background_color: Tuple[float, float, float] = (
                       1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGBA (..., H, W, 4) from per-pixel UVs and coverage."""
    rgb = sample_texture(texture, uv)
    m = mask[..., None]
    bg = torch.tensor(background_color, dtype=rgb.dtype, device=rgb.device)
    rgb = torch.where(m, rgb, bg)
    return torch.cat([rgb, m.to(rgb.dtype)], dim=-1)


def shade_compact(texture: torch.Tensor, cov_idx: torch.Tensor,
                  uv_cov: torch.Tensor, mask: torch.Tensor,
                  background_color: Tuple[float, float, float] = (
                      1.0, 1.0, 1.0)) -> torch.Tensor:
    """``shade_from_uvs`` sampling only the covered pixels: ``cov_idx``
    (P,) flat indices into the (N*H*W) frame and ``uv_cov`` (P, 2) their
    UVs. The sampled colors land in a background-filled frame, so the
    values equal ``shade_from_uvs`` exactly, and the texture gradient never
    sees the uncovered pixels (whose UVs pile onto the texture border).
    ``shade_compact_styles`` at one mesh and one texture."""
    rgb = shade_compact_styles(texture[None, None], cov_idx, uv_cov,
                               mask[None], None, background_color)[0, 0]
    return torch.cat([rgb, mask[..., None].to(rgb.dtype)], dim=-1)


def shade_compact_styles(textures: torch.Tensor, cov_idx: torch.Tensor,
                         uv_cov: torch.Tensor, mask: torch.Tensor,
                         group: torch.Tensor = None,
                         background_color: Tuple[float, float, float] = (
                             1.0, 1.0, 1.0)) -> torch.Tensor:
    """Compact shading's RGB for S textures of each of G meshes at once:
    ``textures`` (G, S, Ht, Wt, 3), ``mask`` (G, N, H, W), the covered
    pixels' ``cov_idx`` (P,) flat indices into their mesh's (N*H*W) frame
    and ``uv_cov`` (P, 2), and ``group`` (P,) the mesh of each (None: G =
    1). Returns (G, S, N, H, W, 3); the uncovered pixels hold the
    background, so each image equals ``shade_from_uvs``'s RGB of its
    texture. One gather (``index_select``, whose backward is an
    index-add into the stacked atlas) and one scatter into the stacked
    frame serve every texture."""
    g, s, ht, wt, ch = textures.shape
    frame = mask[0].numel()
    x0, y0, fx, fy = sample_coords((ht, wt), uv_cov)
    cell = torch.arange(s, device=cov_idx.device)[:, None]
    if group is not None:
        cell = cell + group[None, :] * s                  # (S, P)
    idx = cell * (ht * wt) + (y0 * wt + x0)[None, :]
    rgb = _bilerp(textures.reshape(-1, ch), idx, wt, fx, fy)
    bg = torch.tensor(background_color, dtype=rgb.dtype, device=rgb.device)
    out = bg.expand(g * s * frame, ch).contiguous().index_put(
        ((cell * frame + cov_idx[None, :]).reshape(-1),), rgb.reshape(-1, ch))
    return out.reshape((g, s) + tuple(mask.shape[1:]) + (ch,))


def shade_textured(face_verts: torch.Tensor, pix_to_face: torch.Tensor,
                   verts_uvs: torch.Tensor, faces_uvs: torch.Tensor,
                   texture: torch.Tensor,
                   background_color: Tuple[float, float, float] = (
                       1.0, 1.0, 1.0), row0: int = 0) -> torch.Tensor:
    """Ambient-shaded RGBA (N, H, W, 4) of a view batch, differentiable in
    ``face_verts`` and ``texture``; ``pix_to_face`` holds the image rows
    ``[row0, row0 + H)``.

    Only the covered pixels are gathered, interpolated and sampled; their
    colors land in a background-filled frame. The values are the dense
    form's (``pixel_uvs`` + ``shade_from_uvs``) exactly, and neither
    backward sees the uncovered pixels, whose face-0 rows and border texels
    would otherwise take the gradient adds of most of the frame one at a
    time."""
    n, h, w = pix_to_face.shape
    cov = torch.nonzero(pix_to_face.reshape(-1) >= 0).reshape(-1)
    view, pix = cov // (h * w), cov % (h * w)
    fid = pix_to_face.reshape(-1)[cov].long()
    tri = face_rows(face_verts, view, fid)               # (P, 3, 3)
    uvf = verts_uvs[faces_uvs][fid]                      # (P, 3, 2)
    bary = barycentrics_at(tri, (pix % w).float(),
                           (pix // w + row0).float())
    uv = torch.sum(uvf * bary[..., None], dim=-2)
    rgb_cov = sample_texture(texture, uv)
    bg = torch.tensor(background_color, dtype=rgb_cov.dtype,
                      device=rgb_cov.device)
    frame = bg.expand(n * h * w, 3).contiguous().index_put((cov,), rgb_cov)
    mask = (pix_to_face >= 0)[..., None].to(frame.dtype)
    return torch.cat([frame.reshape(n, h, w, 3), mask], dim=-1)
