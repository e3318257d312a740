"""Hard-mode visibility kernel K1 and the preprocessing around it.

Counterpart of ``st3d/kernels/raster_pallas.py`` (``face_coeffs``,
``_rasterize_pallas_impl`` and ``_raster_kernel`` in hard mode):

1. ``face_coeffs`` turns each projected face into affine coefficient planes
   (screen barycentrics pre-divided by the signed area, and 1/z); invalid
   faces get planes that never cover a pixel.
2. ``preprocess`` sorts faces by their top screen row (stable, so the
   lowest mesh id keeps ties), pads to whole 128-face chunks and computes
   each chunk's [ymin, ymax] row band.
3. ``raster_hard`` is the kernel (``csrc/raster_hard.cu``) for CUDA tensors
   and ``raster_hard_plain`` for CPU tensors: per pixel, the covering face
   of largest 1/z, lowest sorted id on ties, with the kernel's own chunk
   culling so both agree bit for bit.
4. ``rasterize_batched`` maps sorted ids back to mesh ids.

Preprocessing is torch ops (it was XLA). ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from st3d_torch.kernels import build

Z_EPS = 1e-5          # faces with any vertex at view-z below this are dropped
AREA_EPS = 1e-10      # degenerate-triangle rejection threshold
BIG_Z = 1e10

FACE_CHUNK = 128      # faces per chunk (csrc/raster_hard.cu CHUNK)
TILE_PIXELS = 256     # pixels per block (csrc/raster_hard.cu TILE)
N_COEFF_ROWS = 20

LAUNCHES: Dict[str, int] = {"raster_hard": 0}


def face_coeffs(face_verts: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 3) screen verts -> (..., 20, F) coefficient planes.

    Rows 0..8: (A, B, C) of b0, b1, b2 with b_k = A_k*px + B_k*py + C_k;
    rows 9..11: 1/z = Az*px + Bz*py + Cz; rows 12..14: metric edge scales;
    rows 15..18: screen bbox; row 19 pads (raster_pallas.py:50-131, same
    operations in the same order).
    """
    fv = face_verts
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = ((z0 > Z_EPS) & (z1 > Z_EPS) & (z2 > Z_EPS)
             & (torch.abs(area) > AREA_EPS))
    one_ = torch.ones_like(area)
    ia = torch.where(valid, 1.0 / torch.where(valid, area, one_),
                     torch.zeros_like(area))

    def edge(xa, ya, xb, yb):
        a = -(yb - ya) * ia
        b = (xb - xa) * ia
        c = ((yb - ya) * xa - (xb - xa) * ya) * ia
        return a, b, c

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)

    iz0 = 1.0 / torch.clamp(z0, min=Z_EPS)
    iz1 = 1.0 / torch.clamp(z1, min=Z_EPS)
    iz2 = 1.0 / torch.clamp(z2, min=Z_EPS)
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2

    abs_area = torch.abs(area)

    def elen(xa, ya, xb, yb):
        return torch.sqrt((xb - xa) ** 2 + (yb - ya) ** 2) + 1e-12

    h0 = abs_area / elen(x1, y1, x2, y2)
    h1 = abs_area / elen(x2, y2, x0, y0)
    h2 = abs_area / elen(x0, y0, x1, y1)

    neg = torch.full_like(c0, -1.0e9)
    zero = torch.zeros_like(c0)
    big = torch.full_like(c0, 1.0e9)
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    rows = [
        (a0, zero), (b0, zero), (c0, neg),
        (a1, zero), (b1, zero), (c1, neg),
        (a2, zero), (b2, zero), (c2, neg),
        (az, zero), (bz, zero), (cz, zero),
        (h0, one_), (h1, one_), (h2, one_),
        (xmin, big), (xmax, -big), (ymin, big), (ymax, -big),
    ]
    planes = [torch.where(valid, v, d) for v, d in rows] + [zero]
    return torch.stack(planes, dim=-2)


def preprocess(face_verts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, F, 3, 3) -> coeffs (N, 20, F_pad) in y-sorted order, chunk
    bounds (N, 2, n_chunks) = [ymin; ymax] per chunk, and the sort order
    (N, F) (raster_pallas.py:275-312)."""
    n, f = face_verts.shape[0], face_verts.shape[1]
    n_chunks = max(1, -(-f // FACE_CHUNK))
    f_pad = n_chunks * FACE_CHUNK
    fv = face_verts.float()
    zs, ys = fv[..., 2], fv[..., 1]
    x0, y0 = fv[:, :, 0, 0], fv[:, :, 0, 1]
    x1, y1 = fv[:, :, 1, 0], fv[:, :, 1, 1]
    x2, y2 = fv[:, :, 2, 0], fv[:, :, 2, 1]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = torch.all(zs > Z_EPS, dim=2) & (torch.abs(area) > AREA_EPS)
    inf = torch.full_like(area, float("inf"))
    ymin = torch.where(valid, ys.amin(dim=2), inf)
    ymax = torch.where(valid, ys.amax(dim=2), -inf)
    order = torch.argsort(ymin, dim=1, stable=True)   # invalid faces last

    idx = order[:, :, None, None].expand(n, f, 3, 3)
    coeffs = face_coeffs(torch.gather(fv, 1, idx))      # (N, 20, F)
    ymin_s = torch.gather(ymin, 1, order)
    ymax_s = torch.gather(ymax, 1, order)
    pad = f_pad - f
    if pad:
        pad_col = torch.zeros((N_COEFF_ROWS,), dtype=coeffs.dtype,
                              device=coeffs.device)
        pad_col[2] = -1.0e9
        pad_col[15], pad_col[16] = 1.0e9, -1.0e9
        pad_col[17], pad_col[18] = 1.0e9, -1.0e9
        coeffs = torch.cat(
            [coeffs, pad_col[None, :, None].expand(n, N_COEFF_ROWS, pad)],
            dim=2)
        ymin_s = torch.cat([ymin_s, inf[:, :1].expand(n, pad)], dim=1)
        ymax_s = torch.cat([ymax_s, -inf[:, :1].expand(n, pad)], dim=1)
    chunk_ymin = ymin_s.reshape(n, n_chunks, FACE_CHUNK).amin(dim=2)
    chunk_ymax = ymax_s.reshape(n, n_chunks, FACE_CHUNK).amax(dim=2)
    bounds = torch.stack([chunk_ymin, chunk_ymax], dim=1)
    return coeffs.contiguous(), bounds.contiguous(), order


def raster_hard_plain(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                      w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (p2f (N, H*W) int32 in sorted ids, zbuf
    (N, H*W)). Same per-pixel arithmetic, chunk culling and selection as
    the kernel, evaluated one chunk at a time."""
    n, _, f_pad = coeffs.shape
    n_chunks = f_pad // FACE_CHUNK
    hw = h * w
    dev = coeffs.device
    flat = torch.arange(hw, device=dev)
    px = (flat % w).float()[:, None]
    py = (flat // w).float()[:, None]
    t0 = (flat // TILE_PIXELS) * TILE_PIXELS
    last = torch.clamp(t0 + TILE_PIXELS - 1, max=hw - 1)
    row0 = (t0 // w).float()
    row1 = (last // w).float()
    p2f = torch.full((n, hw), -1, dtype=torch.int32, device=dev)
    zbuf = torch.empty((n, hw), dtype=torch.float32, device=dev)
    for v in range(n):
        best = torch.zeros(hw, dtype=torch.float32, device=dev)
        fid = torch.full((hw,), -1, dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            ymin, ymax = bounds[v, 0, c], bounds[v, 1, c]
            cull = (ymax >= row0) & (ymin <= row1)
            if not bool(cull.any()):
                continue
            blk = coeffs[v, :12, c * FACE_CHUNK:(c + 1) * FACE_CHUNK]

            def aff(r):
                return px * blk[r] + py * blk[r + 1] + blk[r + 2]

            b0, b1, b2, iz = aff(0), aff(3), aff(6), aff(9)
            covered = ((b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
                       & cull[:, None])
            mz = torch.where(covered, iz, torch.full_like(iz, -1.0))
            cmax, carg = torch.max(mz, dim=1)       # first max on ties
            better = cmax > best
            fid = torch.where(better, c * FACE_CHUNK + carg, fid)
            best = torch.maximum(best, cmax)
        hit = best > 0.0
        p2f[v] = torch.where(hit, fid, torch.full_like(fid, -1)).int()
        zbuf[v] = torch.where(hit, 1.0 / torch.clamp(best, min=1e-12),
                              torch.full_like(best, BIG_Z))
    return p2f, zbuf


def raster_hard(coeffs: torch.Tensor, bounds: torch.Tensor, h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on preprocessed faces: coeffs (N, 20, F_pad) float32, bounds
    (N, 2, n_chunks) -> (p2f (N, H*W) int32 sorted ids, zbuf (N, H*W))."""
    n, rows, f_pad = coeffs.shape
    if rows != N_COEFF_ROWS or f_pad % FACE_CHUNK:
        raise ValueError(f"raster_hard: bad coeffs shape {tuple(coeffs.shape)}")
    if bounds.shape != (n, 2, f_pad // FACE_CHUNK):
        raise ValueError(f"raster_hard: bad bounds shape {tuple(bounds.shape)}")
    if coeffs.device.type == "cpu":
        return raster_hard_plain(coeffs, bounds, h, w)
    if coeffs.device.type != "cuda" or bounds.device != coeffs.device:
        raise ValueError(f"raster_hard: expected CUDA tensors, got "
                         f"{coeffs.device} and {bounds.device}")
    if coeffs.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError("raster_hard: coeffs and bounds must be float32")
    coeffs = coeffs.contiguous()
    bounds = bounds.contiguous()
    p2f = torch.empty((n, h * w), dtype=torch.int32, device=coeffs.device)
    zbuf = torch.empty((n, h * w), dtype=torch.float32, device=coeffs.device)
    fn = build.symbol("raster_hard", "st3d_raster_hard", 4, 5)
    err = fn(coeffs.data_ptr(), bounds.data_ptr(), p2f.data_ptr(),
             zbuf.data_ptr(), n, h, w, f_pad, f_pad // FACE_CHUNK,
             build.stream_handle(coeffs.device))
    build.check(err, "raster_hard")
    LAUNCHES["raster_hard"] += 1
    return p2f, zbuf


def rasterize_batched(face_verts: torch.Tensor, image_size: int,
                      image_height: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard visibility of a view batch (N, F, 3, 3) -> pix_to_face
    (N, H, W) int32 in mesh face ids (-1 = background) and zbuf (N, H, W)
    (counterpart of ``rasterize_pallas_batched`` in hard mode)."""
    w = image_size
    h = image_height if image_height is not None else image_size
    n = face_verts.shape[0]
    with torch.no_grad():
        coeffs, bounds, order = preprocess(face_verts.detach())
        p2f, zbuf = raster_hard(coeffs, bounds, h, w)
        ids = torch.gather(order, 1, torch.clamp(p2f, min=0).long())
        p2f = torch.where(p2f >= 0, ids.int(), p2f)
    return p2f.reshape(n, h, w), zbuf.reshape(n, h, w)
