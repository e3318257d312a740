"""K-face rasterization and full SoftRas softmax-z aggregation, and the hard
K-face fragments with a blur window (counterpart of
``st3d/render/topk.py``).

Per pixel the top-K kernel K7 keeps the K nearest-by-depth faces whose
signed boundary distance exceeds ``-window_px``. ``shade_softras`` blends
their colors with soft coverage ``D_k = sigmoid(d_k / sigma)`` and depth
softmax weights ``w_k ∝ D_k * exp(znorm_k / gamma)`` against a background
weight ``exp(eps / gamma)``; alpha is ``1 - prod_k (1 - D_k)``.
``rasterize_hard_k`` runs K7 with slack slots, recomputes exact distances
and keeps PyTorch3D's admission rule. Selection is discrete; everything
after it is recomputed differentiably from the projected vertices.

The dense arrays of the JAX package carry face 0 in every empty slot, so a
backward pass would add each empty slot's (zero) gradient into face 0's
rows and texels one at a time. ``shade_softras`` gathers the filled
(pixel, slot) pairs only and scatters them into zero-filled planes; the
values are the same because empty slots are masked out of every sum.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Tuple

import torch

from st3d_torch.kernels.raster import rasterize_topk_batched
from st3d_torch.render.shading import (
    barycentrics_at,
    face_rows,
    gather_faces,
    pixel_grid,
    sample_texture,
)
from st3d_torch.render.soft import clamped_barycentrics, signed_distance_at


@dataclasses.dataclass
class KFragments:
    """Top-K visibility: pix_to_face (N, H, W, K) int32 sorted near to far
    (-1 = no eligible face in that slot)."""

    pix_to_face: torch.Tensor


def rasterize_topk(face_verts: torch.Tensor, settings,
                   window_px: Optional[float] = None) -> KFragments:
    """Top-K ids of a view batch (N, F, 3, 3) in one K7 launch; the window
    defaults to soft mode's 3 * soft_sigma_px."""
    window = 3.0 * settings.soft_sigma_px if window_px is None else window_px
    return KFragments(pix_to_face=rasterize_topk_batched(
        face_verts.detach(), settings.image_size, settings.faces_per_pixel,
        window))


def shade_softras(face_verts: torch.Tensor, pix_to_face_k: torch.Tensor,
                  verts_uvs: torch.Tensor, faces_uvs: torch.Tensor,
                  texture: torch.Tensor, sigma_px: float = 1.0,
                  gamma: float = 1e-2, znear: float = 0.1,
                  zfar: float = 100.0,
                  background_color: Tuple[float, float, float] = (
                      1.0, 1.0, 1.0),
                  bg_eps: float = 0.0) -> torch.Tensor:
    """Full SoftRas color aggregation over the K faces of each pixel;
    face_verts (N, F, 3, 3), pix_to_face_k (N, H, W, K) -> RGBA
    (N, H, W, 4)."""
    n, h, w, k = pix_to_face_k.shape
    valid = pix_to_face_k >= 0
    pair = torch.nonzero(valid.reshape(-1)).reshape(-1)    # filled slots
    view = pair // (h * w * k)
    pix = (pair // k) % (h * w)
    fid = pix_to_face_k.reshape(-1)[pair].long()
    tri = face_rows(face_verts, view, fid)                # (P, 3, 3)
    uvf = verts_uvs[faces_uvs][fid]                       # (P, 3, 2)
    px, py = (pix % w).float(), (pix // w).float()
    bary = clamped_barycentrics(barycentrics_at(tri, px, py))
    rgb_p = sample_texture(texture, torch.sum(uvf * bary[..., None], dim=-2))
    sd_p = signed_distance_at(tri, px, py)
    z_p = torch.sum(tri[..., 2] * bary, dim=-1)

    def plane(values, width=None):
        shape = (n * h * w * k,) + ((width,) if width else ())
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_put((pair,), values).reshape(
            (n, h, w, k) + ((width,) if width else ()))

    rgb_k, sd_k, z_k = plane(rgb_p, 3), plane(sd_p), plane(z_p)
    zero = torch.zeros_like(sd_k)
    d_cov = torch.where(valid, torch.sigmoid(sd_k / sigma_px), zero)
    alpha = 1.0 - torch.prod(1.0 - d_cov, dim=-1)
    znorm = torch.minimum(torch.maximum((zfar - z_k) / (zfar - znear), zero),
                          torch.ones_like(z_k))
    znorm = torch.where(valid, znorm, torch.full_like(znorm, -math.inf))
    zmax = torch.amax(znorm, dim=-1, keepdim=True)
    m = torch.maximum(zmax, torch.full_like(zmax, bg_eps))
    w_face = d_cov * torch.exp((znorm - m) / gamma)
    w_bg = torch.exp((bg_eps - m[..., 0]) / gamma)
    denom = torch.sum(w_face, dim=-1) + w_bg
    bg = torch.tensor(background_color, dtype=rgb_k.dtype,
                      device=rgb_k.device)
    rgb = (torch.sum(w_face[..., None] * rgb_k, dim=-2)
           + w_bg[..., None] * bg) / denom[..., None]
    return torch.cat([rgb, alpha[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Hard K-face fragments with blur_radius (PyTorch3D rasterizer API parity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HardKFragments:
    """PyTorch3D-shaped rasterizer output: per pixel the K nearest-by-depth
    faces that cover the pixel or lie within the blur window.

    pix_to_face (N, H, W, K) int32 near to far, -1 empty; zbuf (N, H, W, K)
    view z (-1 empty); bary (N, H, W, K, 3) raw barycentrics (-1 empty);
    dists (N, H, W, K) signed squared NDC distance, negative inside (-1
    empty); saturated (N,) int32 count of pixels where every selection slot
    (K + slack) was filled and the exact filter rejected one, so a true
    candidate may have been evicted (0 means exact).
    """

    pix_to_face: torch.Tensor
    zbuf: torch.Tensor
    bary: torch.Tensor
    dists: torch.Tensor
    saturated: Optional[torch.Tensor] = None


def blur_window_px(blur_radius: float, image_size: int) -> float:
    """PyTorch3D's blur_radius is a squared NDC distance: |dist_px| <
    sqrt(blur) * size / 2."""
    return math.sqrt(max(float(blur_radius), 0.0)) * image_size / 2.0


def rasterize_hard_k(face_verts: torch.Tensor, settings) -> HardKFragments:
    """Hard rasterization with faces_per_pixel >= 1 and blur_radius >= 0
    for a view batch (N, F, 3, 3): K7 selects K + slack candidates by the
    proxy distance (a lower bound of the exact one, so a superset), the
    epilogue recomputes exact segment distances, keeps PyTorch3D's
    admission (covers the pixel, or squared NDC distance < blur) and
    compacts the survivors near to far. Not differentiable."""
    k = settings.faces_per_pixel
    size = settings.image_size
    blur = float(settings.blur_radius)
    win_eff = max(blur_window_px(blur, size), 1e-3)
    slack = settings.hard_k_slack if (blur > 0.0 or k > 1) else 0
    with torch.no_grad():
        fv = face_verts.detach()
        ids = rasterize_topk_batched(fv, size, k + slack, win_eff)
        valid = ids >= 0
        tri = gather_faces(fv, ids)                   # (N, H, W, K', 3, 3)
        px, py = pixel_grid(size, size, fv.device)
        px, py = px[..., None], py[..., None]
        bary = barycentrics_at(tri, px, py)
        z = torch.sum(bary * tri[..., 2], dim=-1)
        sd_px = signed_distance_at(tri, px, py)
        sd_ndc = sd_px * (2.0 / size)
        dists = -torch.sign(sd_px) * sd_ndc * sd_ndc
        keep = valid & ((sd_px >= 0.0) | (dists < blur))
        risky = valid.all(dim=-1) & (valid & ~keep).any(dim=-1)
        n_risky = risky.reshape(risky.shape[0], -1).sum(dim=1).int()
        order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)

        def take(a):
            return torch.gather(a, -1, order)[..., :k]

        keep_c = take(keep)
        ids_out = torch.where(keep_c, take(ids), torch.full_like(ids[..., :k],
                                                                 -1))
        neg = torch.full_like(z[..., :k], -1.0)
        zbuf = torch.where(keep_c, take(z), neg)
        dists_c = torch.where(keep_c, take(dists), neg)
        bary = torch.gather(bary, -2, order[..., None].expand(bary.shape))
        bary = torch.where(keep_c[..., None], bary[..., :k, :],
                           torch.full_like(bary[..., :k, :], -1.0))
    return HardKFragments(pix_to_face=ids_out, zbuf=zbuf, bary=bary,
                          dists=dists_c, saturated=n_risky)


def check_hard_k_saturation(face_verts: torch.Tensor, settings,
                            context: str = "render") -> int:
    """Rasterize ``face_verts`` (N, F, 3, 3) once with the hard-K settings
    and warn, with the remedy, where the selection saturated; returns the
    at-risk pixel count. 0 without rasterizing for configurations that
    cannot saturate (soft mode, or blur 0 with one face per pixel)."""
    if not settings.hard_k:
        return 0
    total = int(rasterize_hard_k(face_verts, settings).saturated.sum())
    if total:
        warnings.warn(
            f"hard-K rasterization saturated at {total} pixel(s) during "
            f"{context}: every selection slot (K={settings.faces_per_pixel}"
            f" + slack={settings.hard_k_slack}) filled and the exact "
            "filter rejected at least one — a true candidate may have "
            "been evicted, so face selection at those pixels is not "
            "provably exact. Remedy: raise settings.hard_k_slack "
            f"(--hard_k_slack; try {2 * settings.hard_k_slack}) and "
            "re-run.",
            stacklevel=2)
    return total
