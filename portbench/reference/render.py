"""A hard z-buffer rasterizer with barycentrics, and UV shading over white.

Rasterization (no gradient), as PyTorch3D's hard rasterizer and the port's
K1 define it: a pixel center (x = j, y = i) is covered by a face when its
three screen barycentrics are all >= 0; of the covering faces with
1/z > 0 (1/z is affine in screen space), the largest 1/z wins, ties going
to the face whose top screen row comes first (a stable sort, then the
lower index). Faces with a vertex at view z of 1e-5 or less, or a screen
area of 1e-10 or less, cover nothing. The barycentrics and 1/z are
evaluated as affine planes ``px * A + py * B + C`` whose coefficients are
pre-divided by the signed area, each operation in float32 in the port's
order (a frozen copy of its plain arithmetic), so that a pixel center on
an edge falls on the same side in both: visibility is discrete, and a
flipped silhouette or seam pixel moves its texels' gradient whole. Every
(face, pixel) pair of each face's screen box (one pixel wider on each
side) is tested at once.

Shading (differentiable in the screen vertices and the texture): the
winning face's perspective-correct barycentrics at the pixel center
interpolate its corner UVs; the texture is sampled bilinearly with
``align_corners=True`` and border clamping, uv (0, 0) at its bottom-left
corner (PyTorch3D ``TexturesUV``); uncovered pixels are white.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Z_MIN = 1e-5
AREA_MIN = 1e-10
MAX_PAIRS = 1 << 24


def _edges(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Screen barycentric numerators (w0, w1, w2) and the signed area."""
    x0, y0 = tri[..., 0, 0], tri[..., 0, 1]
    x1, y1 = tri[..., 1, 0], tri[..., 1, 1]
    x2, y2 = tri[..., 2, 0], tri[..., 2, 1]
    w0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    w1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    w2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    return w0, w1, w2, area


def planes(tri: torch.Tensor):
    """(valid (F,), planes (F, 12)): the (A, B, C) of b0, b1, b2 and 1/z
    of screen triangles (F, 3, 3)."""
    x0, y0, z0 = tri[:, 0, 0], tri[:, 0, 1], tri[:, 0, 2]
    x1, y1, z1 = tri[:, 1, 0], tri[:, 1, 1], tri[:, 1, 2]
    x2, y2, z2 = tri[:, 2, 0], tri[:, 2, 1], tri[:, 2, 2]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = ((z0 > Z_MIN) & (z1 > Z_MIN) & (z2 > Z_MIN)
             & (torch.abs(area) > AREA_MIN))
    one = torch.ones_like(area)
    ia = torch.where(valid, 1.0 / torch.where(valid, area, one),
                     torch.zeros_like(area))

    def edge(xa, ya, xb, yb):
        return (-(yb - ya) * ia, (xb - xa) * ia,
                ((yb - ya) * xa - (xb - xa) * ya) * ia)

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    iz0 = 1.0 / torch.clamp(z0, min=Z_MIN)
    iz1 = 1.0 / torch.clamp(z1, min=Z_MIN)
    iz2 = 1.0 / torch.clamp(z2, min=Z_MIN)
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2
    return valid, torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2,
                               az, bz, cz], dim=1)


def _raster_view(tri: torch.Tensor, size: int) -> torch.Tensor:
    """Winning face per pixel, (size * size,) int64, -1 where uncovered."""
    dev = tri.device
    valid, pl = planes(tri)
    ys = tri[..., 1]
    top = torch.where(valid, ys.amin(dim=1),
                      torch.full_like(ys[:, 0], float("inf")))
    rank = torch.empty_like(top, dtype=torch.int64)
    order = torch.argsort(top, stable=True)
    rank[order] = torch.arange(len(order), device=dev)
    x0 = (torch.floor(tri[..., 0].amin(dim=1)) - 1).clamp(0, size)
    x1 = (torch.ceil(tri[..., 0].amax(dim=1)) + 1).clamp(-1, size - 1)
    y0 = (torch.floor(ys.amin(dim=1)) - 1).clamp(0, size)
    y1 = (torch.ceil(ys.amax(dim=1)) + 1).clamp(-1, size - 1)
    bw = (x1 - x0 + 1).clamp(min=0).long()
    bh = (y1 - y0 + 1).clamp(min=0).long()
    n_pix = torch.where(valid, bw * bh, torch.zeros_like(bw))
    best = torch.full((size * size,), -float("inf"), device=dev)
    faces = torch.nonzero(n_pix).reshape(-1)
    # Blocks of faces whose boxes hold at most MAX_PAIRS pixels together.
    csum = torch.cumsum(n_pix[faces], 0)
    starts = [0]
    while starts[-1] < faces.numel():
        base = csum[starts[-1] - 1] if starts[-1] else 0
        nxt = int(torch.searchsorted(csum, base + MAX_PAIRS, right=True))
        starts.append(max(nxt, starts[-1] + 1))
    hits = []
    for a, b in zip(starts[:-1], starts[1:]):
        fid = faces[a:b]
        cnt = n_pix[fid]
        face = torch.repeat_interleave(fid, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(face.numel(), device=dev) - torch.repeat_interleave(
            first, cnt)
        px = x0[face] + (local % bw[face]).float()
        py = y0[face] + torch.div(local, bw[face], rounding_mode="floor"
                                  ).float()
        p = pl[face]

        def aff(k):
            return px * p[:, k] + py * p[:, k + 1] + p[:, k + 2]

        iz = aff(9)
        inside = ((aff(0) >= 0.0) & (aff(3) >= 0.0) & (aff(6) >= 0.0)
                  & (iz > 0.0))
        pix = (py * size + px).long()[inside]
        face, iz = face[inside], iz[inside]
        best.scatter_reduce_(0, pix, iz, "amax")
        hits.append((pix, face, iz))
    big = torch.iinfo(torch.int64).max
    win = torch.full((size * size,), big, dtype=torch.int64, device=dev)
    for pix, face, iz in hits:
        top = iz == best[pix]
        win.scatter_reduce_(0, pix[top], rank[face[top]], "amin")
    return torch.where(win == big, torch.full_like(win, -1),
                       order[win.clamp(max=len(order) - 1)])


def rasterize(screen: torch.Tensor, faces: torch.Tensor, size: int
              ) -> torch.Tensor:
    """pix_to_face (n, size * size) int64 of screen verts (n, V, 3)."""
    with torch.no_grad():
        return torch.stack([_raster_view(screen[v][faces], size)
                            for v in range(screen.shape[0])])


def shade(screen: torch.Tensor, faces: torch.Tensor, p2f: torch.Tensor,
          face_uvs: torch.Tensor, texture: torch.Tensor, size: int
          ) -> torch.Tensor:
    """(n, 3, size, size) images: textured where covered, white elsewhere.
    ``face_uvs`` (F, 3, 2); ``texture`` (H, W, 3) float32."""
    n = screen.shape[0]
    cov = torch.nonzero(p2f.reshape(-1) >= 0).reshape(-1)
    view = torch.div(cov, size * size, rounding_mode="floor")
    pix = cov % (size * size)
    fid = p2f.reshape(-1)[cov]
    tri = screen[view[:, None], faces[fid]]                  # (P, 3, 3)
    px = (pix % size).float()
    py = torch.div(pix, size, rounding_mode="floor").float()
    w0, w1, w2, area = _edges(tri, px, py)
    area = torch.where(area.abs() > AREA_MIN, area,
                       torch.full_like(area, AREA_MIN))
    b = torch.stack([w0, w1, w2], dim=-1) / area[:, None]
    b = b / torch.clamp(tri[..., 2], min=1e-8)
    den = b.sum(dim=-1, keepdim=True)
    b = b / torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    uv = (face_uvs[fid] * b[..., None]).sum(dim=1)           # (P, 2)
    grid = torch.stack([2.0 * uv[:, 0] - 1.0, 1.0 - 2.0 * uv[:, 1]], -1)
    rgb = F.grid_sample(texture.permute(2, 0, 1)[None], grid[None, None],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)[0, :, 0].t()      # (P, 3)
    frame = torch.ones((n * size * size, 3), dtype=rgb.dtype,
                       device=rgb.device).index_put((cov,), rgb)
    return frame.reshape(n, size, size, 3).permute(0, 3, 1, 2)


def render(screen: torch.Tensor, faces: torch.Tensor, face_uvs, texture,
           size: int, p2f: torch.Tensor = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (n, 3, size, size), pix_to_face); the visibility is
    rasterized from ``screen`` unless given."""
    if p2f is None:
        p2f = rasterize(screen.detach(), faces, size)
    return shade(screen, faces, p2f, face_uvs, texture, size), p2f
