"""Visibility kernels K1 (hard and soft), K6 (streaming), K7 (top-K) and K9
(2D tiles), and the preprocessing around them.

Counterpart of ``st3d/kernels/raster_pallas.py``:

1. ``face_coeffs`` turns each projected face into affine coefficient planes
   (screen barycentrics pre-divided by the signed area, 1/z, the metric
   edge scales and the screen bbox); invalid faces get planes that never
   cover a pixel.
2. ``preprocess`` sorts faces by their top screen row (stable, so the
   lowest mesh id keeps ties), pads to whole 128-face chunks and computes
   each chunk's [ymin, ymax] row band.
3. The kernels, each a CUDA source for CUDA tensors and a plain PyTorch
   version for CPU tensors, with the same per-pixel arithmetic, chunk
   culling and selection so both agree bit for bit:

   - ``raster_hard`` (K1, ``csrc/raster_hard.cu``): per pixel, the covering
     face of largest 1/z, lowest sorted id on ties; each warp tests only
     the faces that can still cover one of its 32 pixels with a larger
     1/z (``csrc/raster_walk.cuh``). ``raster_hard_every_face`` is the
     earlier walk (every face of every chunk in band), launched by no
     route.
   - ``raster_soft`` (K1's soft mode, ``csrc/raster_soft.cu``): the same,
     plus ``nearest``, the face of largest bbox-gated signed edge distance,
     with the row-band cull widened by ``soft_cull_margin``; each warp tests
     only the faces that can still change one of its 32 pixels
     (``csrc/raster_walk.cuh``). ``raster_soft_every_face`` is the earlier
     walk (every face of every chunk in band), launched by no route.
   - ``raster_stream`` (K6, ``csrc/raster_stream.cu``): K1's outputs, hard
     or soft, with each tile walking every chunk of its own [c_lo, c_hi]
     range (``stream_ranges``), as the TPU kernel does, through a double
     buffer; each warp tests only the faces K1's and K1-soft's exact lists
     keep. Used for meshes whose coefficients pass
     ``RESIDENT_COEFF_BUDGET``. ``raster_stream_every_chunk`` is the TPU
     kernel's walk (every face of every chunk of the range), launched by
     no route.
   - ``raster_topk`` (K7, ``csrc/raster_topk.cu``): per pixel, the K
     nearest-by-raw-1/z faces with signed distance > -window, near to far;
     each warp tests only the faces within the window of its 32 pixels.
     ``raster_topk_every_face`` is the earlier walk, launched by no route.
   - ``raster_2d`` (K9, ``csrc/raster_2d.cu``): K1's hard outputs on
     16 x 16 pixel tiles over faces in Morton order (``preprocess_2d``),
     each chunk culled in x and y; exact 1/z ties go to the lowest
     Morton-sorted id, not K1's lowest y-sorted one. Each warp tests only
     the faces that can still cover one of its 8 x 4 pixels with a larger
     1/z (K1's walk). ``raster_2d_every_face`` is the earlier kernel
     (every face of every chunk the cull leaves), launched by no route.

4. ``rasterize_batched``, ``rasterize_batched_soft``,
   ``rasterize_topk_batched`` and ``rasterize_2d_batched`` run
   preprocessing and kernel for a view batch and map sorted ids back to
   mesh ids. No entry point calls ``rasterize_2d_batched``, as none of the
   JAX package calls its K9.

Soft culling is tile-dependent for pixels farther than the margin from
every face (their nearest face is whatever survives the cull), so the soft
kernels cull on the JAX package's 1024-pixel tiles (``cull_tile``); hard
coverage and top-K eligibility do not depend on the tile. Preprocessing is
torch ops (it was XLA). ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from st3d_torch.kernels import build

Z_EPS = 1e-5          # faces with any vertex at view-z below this are dropped
AREA_EPS = 1e-10      # degenerate-triangle rejection threshold
BIG_Z = 1e10

FACE_CHUNK = 128      # faces per chunk (csrc/raster_*.cu CHUNK)
TILE_PIXELS = 256     # pixels per block (csrc/raster_*.cu TILE)
SOFT_TILE_PIXELS = 1024   # raster_pallas.TILE_PIXELS: the soft cull tile
N_COEFF_ROWS = 20
HARD_ROWS, SOFT_ROWS = 12, 19   # coefficient rows each mode reads
NEG_INIT = -3.0e38    # empty soft/top-K score
MAX_TOPK = 16         # slots the top-K kernel is instantiated for
# raster_pallas.RESIDENT_COEFF_BUDGET: the JAX package streams (K6) when a
# view's (20, F) float32 coefficients pass this many bytes.
RESIDENT_COEFF_BUDGET = 7 * 1024 * 1024

LAUNCHES: Dict[str, int] = {"raster_hard": 0, "raster_hard_every_face": 0,
                            "raster_soft": 0,
                            "raster_soft_every_face": 0,
                            "raster_stream": 0,
                            "raster_stream_every_chunk": 0,
                            "raster_topk": 0, "raster_topk_every_face": 0,
                            "raster_2d": 0, "raster_2d_every_face": 0}
TILE_2D = 16          # pixels per side of K9's tile (csrc/raster_2d.cu)


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


def _face_boxes(fv: torch.Tensor):
    """Per face of (N, F, 3, 3) float32 screen verts: valid (z > Z_EPS at
    every vertex, |area| > AREA_EPS) and the screen bbox ymin, ymax, xmin,
    xmax, with (inf, -inf) for invalid faces so they sort last and bound
    nothing."""
    x0, y0 = fv[:, :, 0, 0], fv[:, :, 0, 1]
    x1, y1 = fv[:, :, 1, 0], fv[:, :, 1, 1]
    x2, y2 = fv[:, :, 2, 0], fv[:, :, 2, 1]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    valid = torch.all(fv[..., 2] > Z_EPS, dim=2) & (torch.abs(area)
                                                   > AREA_EPS)
    inf = torch.full_like(area, float("inf"))
    ys, xs = fv[..., 1], fv[..., 0]
    return valid, (torch.where(valid, ys.amin(dim=2), inf),
                   torch.where(valid, ys.amax(dim=2), -inf),
                   torch.where(valid, xs.amin(dim=2), inf),
                   torch.where(valid, xs.amax(dim=2), -inf))


def _sort_and_chunk(fv: torch.Tensor, key: torch.Tensor, lims):
    """Faces sorted by ``key`` (stable), cut into FACE_CHUNK-face chunks:
    coeffs (N, 20, F_pad), bounds (N, len(lims), n_chunks) with the min of
    each even-indexed lim and the max of each odd one per chunk, and the
    order (N, F). Padding columns never cover a pixel."""
    n, f = fv.shape[0], fv.shape[1]
    n_chunks = max(1, -(-f // FACE_CHUNK))
    pad = n_chunks * FACE_CHUNK - f
    order = torch.argsort(key, dim=1, stable=True)
    idx = order[:, :, None, None].expand(n, f, 3, 3)
    coeffs = face_coeffs(torch.gather(fv, 1, idx))      # (N, 20, F)
    lims = [torch.gather(t, 1, order) for t in lims]
    if pad:
        pad_col = torch.zeros((N_COEFF_ROWS,), dtype=coeffs.dtype,
                              device=coeffs.device)
        pad_col[2] = -1.0e9
        pad_col[15], pad_col[16] = 1.0e9, -1.0e9
        pad_col[17], pad_col[18] = 1.0e9, -1.0e9
        coeffs = torch.cat(
            [coeffs, pad_col[None, :, None].expand(n, N_COEFF_ROWS, pad)],
            dim=2)
        fill = torch.full((n, pad), float("inf"), device=fv.device)
        lims = [torch.cat([t, fill if i % 2 == 0 else -fill], dim=1)
                for i, t in enumerate(lims)]
    chunks = [t.reshape(n, n_chunks, FACE_CHUNK) for t in lims]
    bounds = torch.stack([c.amin(dim=2) if i % 2 == 0 else c.amax(dim=2)
                          for i, c in enumerate(chunks)], dim=1)
    return coeffs.contiguous(), bounds.contiguous(), order


def preprocess(face_verts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, F, 3, 3) -> coeffs (N, 20, F_pad) in y-sorted order, chunk
    bounds (N, 2, n_chunks) = [ymin; ymax] per chunk, and the sort order
    (N, F) (raster_pallas.py:275-312)."""
    fv = face_verts.float()
    _, (ymin, ymax, _, _) = _face_boxes(fv)
    return _sort_and_chunk(fv, ymin, (ymin, ymax))


def morton_codes(cx: torch.Tensor, cy: torch.Tensor,
                 size: float) -> torch.Tensor:
    """Interleave the 10-bit quantised (x, y) bbox centres into int32
    Morton codes (raster_pallas.py:869 ``_morton_codes``). Its masks spread
    only the low 8 bits of each coordinate; they are kept (ROADMAP F9)."""

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 8)) & 0x00F00F
        v = (v | (v << 4)) & 0x0C30C3
        return (v | (v << 2)) & 0x249249

    qx = torch.clamp(cx / size * 1024.0, 0, 1023).to(torch.int32)
    qy = torch.clamp(cy / size * 1024.0, 0, 1023).to(torch.int32)
    return spread(qx) | (spread(qy) << 1)


def preprocess_2d(face_verts: torch.Tensor, image_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, F, 3, 3) -> coeffs (N, 20, F_pad) in Morton order of the bbox
    centres, chunk bounds (N, 4, n_chunks) = [ymin; ymax; xmin; xmax] per
    chunk, and the sort order (N, F) (raster_pallas.py:958-999): invalid
    faces get code 2³⁰ and sort last."""
    fv = face_verts.float()
    valid, (ymin, ymax, xmin, xmax) = _face_boxes(fv)
    code = morton_codes((xmin + xmax) * 0.5, (ymin + ymax) * 0.5,
                        float(image_size))
    code = torch.where(valid, code, torch.full_like(code, 2 ** 30))
    return _sort_and_chunk(fv, code, (ymin, ymax, xmin, xmax))


def soft_cull_margin(soft_sigma_px: float) -> float:
    """Rows beyond a face's bbox that still see it as a nearest-face
    candidate: sigmoid(d / sigma) coverage decays to <0.3% past 6 sigma
    (raster_pallas.py:237-241)."""
    return max(8.0, 6.0 * float(soft_sigma_px))


def cull_tile(h: int, w: int, soft: bool) -> int:
    """Pixels per cull band: the block's 256 in hard mode; in soft mode the
    JAX package's tile, min(1024, H*W), where it divides the frame (a
    256-pixel block then never straddles two bands), else 256."""
    if not soft:
        return TILE_PIXELS
    hw = h * w
    t = min(SOFT_TILE_PIXELS, hw)
    return t if hw % t == 0 else TILE_PIXELS


def _tile_rows(h: int, w: int, tile: int, device, row0: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First and last image row (float32) of every ``tile``-pixel band of a
    frame whose first row is image row ``row0``."""
    hw = h * w
    t0 = torch.arange(0, hw, tile, device=device)
    last = torch.clamp(t0 + tile - 1, max=hw - 1)
    return (t0 // w + row0).float(), (last // w + row0).float()


def _band_overlap(bounds: torch.Tensor, h: int, w: int, tile: int,
                  margin: float, row0: int = 0) -> torch.Tensor:
    """(N, n_tiles, n_chunks): chunk c's row band meets tile t's rows
    widened by ``margin`` (the kernels' per-chunk cull test)."""
    row0, row1 = _tile_rows(h, w, tile, bounds.device, row0)
    return ((bounds[:, None, 1, :] >= (row0 - margin)[None, :, None])
            & (bounds[:, None, 0, :] <= (row1 + margin)[None, :, None]))


def stream_ranges(bounds: torch.Tensor, h: int, w: int, tile: int,
                  margin: float, row0: int = 0) -> torch.Tensor:
    """(N, n_tiles, 2) int32 [c_lo, c_hi] per tile: the first and last chunk
    whose band meets the tile's rows (+ margin); (1, 0) when none does
    (raster_pallas.py:605-624). ``row0``: the frame's first image row."""
    ov = _band_overlap(bounds, h, w, tile, margin, row0)
    n_chunks = bounds.shape[2]
    c = torch.arange(n_chunks, dtype=torch.int32, device=bounds.device)
    first = torch.where(ov, c, n_chunks).amin(dim=2)
    last = torch.where(ov, c, -1).amax(dim=2)
    hit = ov.any(dim=2)
    c_lo = torch.where(hit, first, torch.ones_like(first))
    c_hi = torch.where(hit, last, torch.zeros_like(last))
    return torch.stack([c_lo, c_hi], dim=2).int().contiguous()


def outside_band(bounds: torch.Tensor, ids: torch.Tensor, h: int, w: int,
                 tile: int = TILE_PIXELS, margin: float = 0.0
                 ) -> torch.Tensor:
    """(N, H*W) bool: the sorted face id ``ids`` (N, H*W) of each pixel lies
    in a chunk whose row band misses the rows of the pixel's ``tile``-pixel
    band widened by ``margin``. K1 never tests such a face there; K6 does
    when the chunk is in the tile's range, and a sliver whose rounded
    barycentrics cover the pixel can win it, so only at such pixels may
    K6's outputs differ from K1's."""
    ov = _band_overlap(bounds, h, w, tile, margin)   # (N, tiles, chunks)
    t = (torch.arange(h * w, device=ids.device) // tile).expand_as(ids)
    chunk = ids.long().clamp(min=0) // FACE_CHUNK
    inside = ov.flatten(1).gather(1, t * ov.shape[2] + chunk)
    return (ids >= 0) & ~inside


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _chunk_planes(blk: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                  soft: bool):
    """b0, b1, b2, 1/z (and the gated signed distance when ``soft``) of a
    chunk's faces at pixels (P, 1): the kernels' expressions, rounded at
    every operation in the same order."""

    def aff(r):
        return px * blk[r] + py * blk[r + 1] + blk[r + 2]

    b0, b1, b2, iz = aff(0), aff(3), aff(6), aff(9)
    if not soft:
        return b0, b1, b2, iz, None
    sd = torch.minimum(torch.minimum(b0 * blk[12], b1 * blk[13]),
                       b2 * blk[14])
    bbox = torch.minimum(torch.minimum(px - blk[15], blk[16] - px),
                         torch.minimum(py - blk[17], blk[18] - py))
    return b0, b1, b2, iz, torch.minimum(sd, bbox)


def _scan_plain(coeffs: torch.Tensor, active: torch.Tensor, h: int, w: int,
                tile: int, soft: bool,
                tile_pix: Optional[torch.Tensor] = None, row0: int = 0):
    """Shared plain body of K1, K1-soft, K6 and K9: chunk c is tested at the
    pixels of every tile t with ``active[v, t, c]``, in chunk order; hard
    selection by strict '>' on 1/z over a first-index chunk maximum, soft
    ``nearest`` the same on the signed distance from -3e38 and id 0.
    Only the active (pixel, chunk) pairs are evaluated. A tile's pixels are
    ``tile_pix[t]`` (flat indices, ``h*w`` past the image), by default the
    run of ``tile`` flat pixels from ``t*tile``. The frame's rows are the
    image rows ``[row0, row0 + h)``."""
    n, _, f_pad = coeffs.shape
    hw = h * w
    dev = coeffs.device
    flat = torch.arange(hw, device=dev)
    pxf, pyf = (flat % w).float(), (flat // w + row0).float()
    if tile_pix is None:
        tile_pix = torch.arange(active.shape[1] * tile,
                                device=dev).reshape(-1, tile)
    rows = SOFT_ROWS if soft else HARD_ROWS
    p2f = torch.empty((n, hw), dtype=torch.int32, device=dev)
    zbuf = torch.empty((n, hw), dtype=torch.float32, device=dev)
    near = torch.empty((n, hw), dtype=torch.int32, device=dev)
    for v in range(n):
        best = torch.zeros(hw, dtype=torch.float32, device=dev)
        fid = torch.full((hw,), -1, dtype=torch.int64, device=dev)
        sbest = torch.full((hw,), NEG_INIT, dtype=torch.float32, device=dev)
        sid = torch.zeros(hw, dtype=torch.int64, device=dev)
        act = active[v]
        for c in torch.nonzero(act.any(dim=0)).reshape(-1).tolist():
            sel = tile_pix[torch.nonzero(act[:, c]).reshape(-1)].reshape(-1)
            sel = sel[sel < hw]
            blk = coeffs[v, :rows, c * FACE_CHUNK:(c + 1) * FACE_CHUNK]
            b0, b1, b2, iz, sd = _chunk_planes(blk, pxf[sel, None],
                                               pyf[sel, None], soft)
            covered = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
            mz = torch.where(covered, iz, torch.full_like(iz, -1.0))
            cmax, carg = torch.max(mz, dim=1)
            better = cmax > best[sel]
            fid[sel] = torch.where(better, c * FACE_CHUNK + carg, fid[sel])
            best[sel] = torch.maximum(best[sel], cmax)
            if soft:
                smax, sarg = torch.max(sd, dim=1)
                sbetter = smax > sbest[sel]
                sid[sel] = torch.where(sbetter, c * FACE_CHUNK + sarg,
                                       sid[sel])
                sbest[sel] = torch.maximum(sbest[sel], smax)
        hit = best > 0.0
        p2f[v] = torch.where(hit, fid, torch.full_like(fid, -1)).int()
        zbuf[v] = torch.where(hit, 1.0 / torch.clamp(best, min=1e-12),
                              torch.full_like(best, BIG_Z))
        near[v] = sid.int()
    return p2f, zbuf, near


def raster_hard_plain(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                      w: int, row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (p2f (N, H*W) int32 in sorted ids, zbuf
    (N, H*W)) of the image rows ``[row0, row0 + h)``, the row-band cull on
    the kernel's 256-pixel blocks."""
    active = _band_overlap(bounds, h, w, TILE_PIXELS, 0.0, row0)
    return _scan_plain(coeffs, active, h, w, TILE_PIXELS, soft=False,
                       row0=row0)[:2]


def raster_soft_plain(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                      w: int, margin: float, tile: int):
    """Plain version of K1's soft mode: (p2f, zbuf, nearest) (N, H*W), the
    row-band cull on ``tile``-pixel bands widened by ``margin``."""
    active = _band_overlap(bounds, h, w, tile, margin)
    return _scan_plain(coeffs, active, h, w, tile, soft=True)


def raster_stream_plain(coeffs: torch.Tensor, ranges: torch.Tensor, h: int,
                        w: int, tile: int, soft: bool, row0: int = 0):
    """Plain version of K6: every chunk of each tile's [c_lo, c_hi] range
    is tested there. (p2f, zbuf, nearest) (N, H*W) of the image rows
    ``[row0, row0 + h)``; nearest is None in hard mode."""
    c = torch.arange(coeffs.shape[2] // FACE_CHUNK, device=coeffs.device)
    active = ((c[None, None, :] >= ranges[..., 0:1])
              & (c[None, None, :] <= ranges[..., 1:2]))
    p2f, zbuf, near = _scan_plain(coeffs, active, h, w, tile, soft,
                                  row0=row0)
    return p2f, zbuf, (near if soft else None)


def tiles_2d(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's 16 x 16 tiles, row-major: their flat pixel indices (n_tiles,
    256), ``h*w`` past the image, and their extents (4, n_tiles) = first
    and last row, first and last column (float32, not clipped)."""
    t = TILE_2D
    ty = torch.arange(-(-h // t), device=device)
    tx = torch.arange(-(-w // t), device=device)
    y = ty[:, None, None, None] * t + torch.arange(t, device=device)[
        None, None, :, None]
    x = tx[None, :, None, None] * t + torch.arange(t, device=device)[
        None, None, None, :]
    pix = torch.where((y < h) & (x < w), y * w + x, h * w)
    ext = torch.stack(torch.broadcast_tensors(
        (ty * t)[:, None], (ty * t + t - 1)[:, None],
        (tx * t)[None, :], (tx * t + t - 1)[None, :])).float()
    return pix.reshape(-1, t * t), ext.reshape(4, -1)


def cull_2d(bounds: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, n_tiles, n_chunks): chunk c's (ymin, ymax, xmin, xmax) bounds
    meet tile t's rows and columns (K9's per-chunk cull test)."""
    _, ext = tiles_2d(h, w, bounds.device)
    b = bounds[:, :, None, :]                       # (N, 4, 1, n_chunks)
    e = ext[None, :, :, None]                       # (1, 4, n_tiles, 1)
    return ((b[:, 1] >= e[:, 0]) & (b[:, 0] <= e[:, 1])
            & (b[:, 3] >= e[:, 2]) & (b[:, 2] <= e[:, 3]))


def raster_2d_plain(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                    w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: (p2f (N, H*W) int32 in Morton-sorted ids, zbuf
    (N, H*W)), chunk c tested on a 16 x 16 tile where ``cull_2d`` says."""
    pix, _ = tiles_2d(h, w, coeffs.device)
    return _scan_plain(coeffs, cull_2d(bounds, h, w), h, w,
                       TILE_2D * TILE_2D, False, pix)[:2]


def _insert(slot_s, slot_i, new_s, new_i):
    """The TPU kernel's vector insertion into K sorted slots (descending):
    walk the slots, swap wherever the carried entry is strictly greater
    (raster_pallas.py:752-760). In place on (P, K) slot tensors."""
    for s in range(slot_s.shape[1]):
        take = new_s > slot_s[:, s]
        old_s, old_i = slot_s[:, s].clone(), slot_i[:, s].clone()
        slot_s[:, s] = torch.where(take, new_s, old_s)
        slot_i[:, s] = torch.where(take, new_i, old_i)
        new_s = torch.where(take, old_s, new_s)
        new_i = torch.where(take, old_i, new_i)


def raster_topk_plain(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                      w: int, k: int, window: float) -> torch.Tensor:
    """Plain version of K7: ids (N, H*W, K) int32 in sorted face ids, near
    to far, -1 empty. Per chunk (culled on 256-pixel bands widened by
    window + 2), the chunk's eligible faces are ranked by a stable
    descending sort of their raw 1/z (the TPU kernel's repeated first-index
    argmax) and its top K are inserted into the slots in that order."""
    n, _, f_pad = coeffs.shape
    hw = h * w
    dev = coeffs.device
    flat = torch.arange(hw, device=dev)
    pxf, pyf = (flat % w).float(), (flat // w).float()
    lane = torch.arange(TILE_PIXELS, device=dev)
    active = _band_overlap(bounds, h, w, TILE_PIXELS, window + 2.0)
    ids = torch.empty((n, hw, k), dtype=torch.int32, device=dev)
    for v in range(n):
        slot_s = torch.full((hw, k), NEG_INIT, device=dev)
        slot_i = torch.full((hw, k), -1, dtype=torch.int64, device=dev)
        act = active[v]
        for c in torch.nonzero(act.any(dim=0)).reshape(-1).tolist():
            tiles = torch.nonzero(act[:, c]).reshape(-1)
            sel = (tiles[:, None] * TILE_PIXELS + lane).reshape(-1)
            sel = sel[sel < hw]
            blk = coeffs[v, :SOFT_ROWS, c * FACE_CHUNK:(c + 1) * FACE_CHUNK]
            _, _, _, iz, sd = _chunk_planes(blk, pxf[sel, None],
                                            pyf[sel, None], soft=True)
            mz = torch.where(sd > -window, iz, torch.full_like(iz, NEG_INIT))
            cs, ci = torch.sort(mz, dim=1, descending=True, stable=True)
            ss, si = slot_s[sel], slot_i[sel]
            for e in range(min(k, FACE_CHUNK)):
                _insert(ss, si, cs[:, e], c * FACE_CHUNK + ci[:, e])
            slot_s[sel], slot_i[sel] = ss, si
        ids[v] = torch.where(slot_s > -1.0e38, slot_i,
                             torch.full_like(slot_i, -1)).int()
    return ids


# ---------------------------------------------------------------------------
# Kernel wrappers: the plain version for CPU tensors, the kernel or an
# error for anything else
# ---------------------------------------------------------------------------

def _check_coeffs(name: str, coeffs: torch.Tensor, aux: torch.Tensor,
                  aux_shape: tuple, aux_dtype: torch.dtype) -> bool:
    """Shape checks; True for CPU tensors (take the plain version). Raises
    for operands the kernel does not take."""
    n, rows, f_pad = coeffs.shape
    if rows != N_COEFF_ROWS or f_pad % FACE_CHUNK:
        raise ValueError(f"{name}: bad coeffs shape {tuple(coeffs.shape)}")
    if tuple(aux.shape) != aux_shape:
        raise ValueError(f"{name}: bad auxiliary shape {tuple(aux.shape)}, "
                         f"want {aux_shape}")
    if coeffs.device.type == "cpu" and aux.device.type == "cpu":
        return True
    if coeffs.device.type != "cuda" or aux.device != coeffs.device:
        raise ValueError(f"{name}: expected CUDA tensors, got "
                         f"{coeffs.device} and {aux.device}")
    if coeffs.dtype != torch.float32 or aux.dtype != aux_dtype:
        raise TypeError(f"{name}: coeffs must be float32 and the auxiliary "
                        f"{aux_dtype}")
    return False


def raster_hard(coeffs: torch.Tensor, bounds: torch.Tensor, h: int, w: int,
                tested: Optional[torch.Tensor] = None, row0: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on preprocessed faces: coeffs (N, 20, F_pad) float32, bounds
    (N, 2, n_chunks) -> (p2f (N, H*W) int32 sorted ids, zbuf (N, H*W)) of
    the image rows ``[row0, row0 + h)`` (a band of the tiled render: the
    whole frame's rows, bit for bit). A CUDA kernel adds the (pixel, face)
    pairs of its warps' face lists to ``tested`` (a one-element int64 CUDA
    tensor) if given."""
    return _hard("raster_hard", 2, raster_hard_plain, coeffs, bounds, h, w,
                 tested, row0)


def raster_hard_every_face(coeffs: torch.Tensor, bounds: torch.Tensor,
                           h: int, w: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raster_hard`` by the earlier walk: every face of every chunk in
    band is tested at every pixel. Launched by no route; the twin the
    per-warp face lists are held against."""
    return _hard("raster_hard_every_face", 2, raster_hard_plain, coeffs,
                 bounds, h, w, None)


def _hard(name: str, bound_rows: int, plain, coeffs: torch.Tensor,
          bounds: torch.Tensor, h: int, w: int,
          tested: Optional[torch.Tensor], row0: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch of K1 or G (``name``, in ``csrc/<name>.cu``) or of its
    twin (``<name>_every_face``, in the same source, with no counter) on
    bounds (N, ``bound_rows``, n_chunks); ``plain`` for CPU tensors. Only
    K1 takes a first row ``row0``."""
    n, _, f_pad = coeffs.shape
    if row0 and name != "raster_hard":
        raise ValueError(f"{name}: no row offset (row0={row0})")
    extra = [row0] if name == "raster_hard" else []
    if _check_coeffs(name, coeffs, bounds,
                     (n, bound_rows, f_pad // FACE_CHUNK), torch.float32):
        return plain(coeffs, bounds, h, w, *extra)
    coeffs, bounds = coeffs.contiguous(), bounds.contiguous()
    dev = coeffs.device
    p2f = torch.empty((n, h * w), dtype=torch.int32, device=dev)
    zbuf = torch.empty((n, h * w), dtype=torch.float32, device=dev)
    args = [coeffs.data_ptr(), bounds.data_ptr(), p2f.data_ptr(),
            zbuf.data_ptr()]
    lib = name.removesuffix("_every_face")
    if name == lib:
        args.append(_check_tested(name, tested, dev))
    ints = [n, h, w, f_pad, f_pad // FACE_CHUNK] + extra
    fn = build.symbol(lib, "st3d_" + name, len(args), len(ints))
    err = fn(*args, *ints, build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return p2f, zbuf


def raster_soft(coeffs: torch.Tensor, bounds: torch.Tensor, h: int, w: int,
                margin: float, tile: int,
                tested: Optional[torch.Tensor] = None):
    """K1's soft mode: (p2f, zbuf, nearest) (N, H*W) in sorted ids. A CUDA
    kernel adds the (pixel, face) pairs of its warps' face lists to
    ``tested`` (a one-element int64 CUDA tensor) if given."""
    return _soft("raster_soft", coeffs, bounds, h, w, margin, tile, tested)


def raster_soft_every_face(coeffs: torch.Tensor, bounds: torch.Tensor,
                           h: int, w: int, margin: float, tile: int):
    """``raster_soft`` by the earlier walk: every face of every chunk in
    band is tested at every pixel. Launched by no route; the twin the
    per-warp face lists are held against."""
    return _soft("raster_soft_every_face", coeffs, bounds, h, w, margin,
                 tile, None)


def _check_tested(name: str, tested: Optional[torch.Tensor], dev) -> int:
    """The pointer of a pair counter (0 for none); raises unless it is one
    int64 on ``dev``."""
    if tested is None:
        return 0
    if (tested.device != dev or tested.dtype != torch.int64
            or tested.numel() != 1):
        raise ValueError(f"{name}: tested must be one int64 on {dev}")
    return tested.data_ptr()


def _soft(name: str, coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
          w: int, margin: float, tile: int, tested: Optional[torch.Tensor]):
    n, _, f_pad = coeffs.shape
    if _check_coeffs(name, coeffs, bounds, (n, 2, f_pad // FACE_CHUNK),
                     torch.float32):
        return raster_soft_plain(coeffs, bounds, h, w, margin, tile)
    coeffs, bounds = coeffs.contiguous(), bounds.contiguous()
    dev = coeffs.device
    p2f = torch.empty((n, h * w), dtype=torch.int32, device=dev)
    zbuf = torch.empty((n, h * w), dtype=torch.float32, device=dev)
    near = torch.empty((n, h * w), dtype=torch.int32, device=dev)
    args = [coeffs.data_ptr(), bounds.data_ptr(), p2f.data_ptr(),
            zbuf.data_ptr(), near.data_ptr()]
    if name == "raster_soft":
        args.append(_check_tested(name, tested, dev))
    fn = build.symbol("raster_soft", "st3d_" + name, len(args), 6, 1)
    err = fn(*args, n, h, w, f_pad, f_pad // FACE_CHUNK, tile, margin,
             build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return p2f, zbuf, near


def raster_stream(coeffs: torch.Tensor, bounds: torch.Tensor,
                  ranges: torch.Tensor, h: int, w: int, tile: int,
                  soft: bool, margin: float = 0.0,
                  tested: Optional[torch.Tensor] = None, row0: int = 0):
    """K6 on preprocessed faces, their chunk bounds (N, 2, n_chunks) and
    per-tile chunk ranges (N, n_tiles, 2) int32 (``stream_ranges`` with the
    same ``tile``, ``margin`` and ``row0``): (p2f, zbuf, nearest) (N, H*W)
    in sorted ids of the image rows ``[row0, row0 + h)``; nearest is None
    in hard mode. A CUDA kernel adds the (pixel, face) pairs of its warps'
    face lists to ``tested`` (a one-element int64 CUDA tensor) if
    given."""
    return _stream("raster_stream", coeffs, bounds, ranges, h, w, tile, soft,
                   margin, tested, row0)


def raster_stream_every_chunk(coeffs: torch.Tensor, bounds: torch.Tensor,
                              ranges: torch.Tensor, h: int, w: int,
                              tile: int, soft: bool, margin: float = 0.0,
                              tested: Optional[torch.Tensor] = None):
    """``raster_stream`` by the TPU kernel's walk: every face of every
    chunk of each range is tested at every pixel of the tile. Launched by
    no route; the twin the redesigned walk is held against. A CUDA kernel
    adds the chunks its blocks walked to ``tested`` if given."""
    return _stream("raster_stream_every_chunk", coeffs, bounds, ranges, h, w,
                   tile, soft, margin, tested)


def _stream(name: str, coeffs: torch.Tensor, bounds: torch.Tensor,
            ranges: torch.Tensor, h: int, w: int, tile: int, soft: bool,
            margin: float, tested: Optional[torch.Tensor], row0: int = 0):
    n, _, f_pad = coeffs.shape
    n_tiles = -(-(h * w) // tile)
    if row0 and name != "raster_stream":
        raise ValueError(f"{name}: no row offset (row0={row0})")
    if _check_coeffs(name, coeffs, ranges, (n, n_tiles, 2), torch.int32):
        return raster_stream_plain(coeffs, ranges, h, w, tile, soft, row0)
    _check_coeffs(name, coeffs, bounds, (n, 2, f_pad // FACE_CHUNK),
                  torch.float32)
    if tile % TILE_PIXELS and tile < h * w:
        raise ValueError(f"{name}: tile {tile} must be a multiple of "
                         f"{TILE_PIXELS} or cover the frame")
    coeffs, ranges = coeffs.contiguous(), ranges.contiguous()
    if coeffs.data_ptr() % 16:
        raise ValueError(f"{name}: coeffs must be 16-byte aligned")
    dev = coeffs.device
    counter = _check_tested(name, tested, dev)
    p2f = torch.empty((n, h * w), dtype=torch.int32, device=dev)
    zbuf = torch.empty((n, h * w), dtype=torch.float32, device=dev)
    near = torch.empty((n, h * w) if soft else (1,), dtype=torch.int32,
                       device=dev)
    # The kernels read the ranges, not the bounds or the margin they were
    # made with.
    ints = [n, h, w, f_pad, n_tiles, tile, int(soft)] + (
        [row0] if name == "raster_stream" else [])
    fn = build.symbol("raster_stream", "st3d_" + name, 6, len(ints))
    err = fn(coeffs.data_ptr(), ranges.data_ptr(), p2f.data_ptr(),
             zbuf.data_ptr(), near.data_ptr(), counter, *ints,
             build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return p2f, zbuf, (near if soft else None)


def raster_topk(coeffs: torch.Tensor, bounds: torch.Tensor, h: int, w: int,
                k: int, window: float,
                tested: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 on preprocessed faces: ids (N, H*W, K) int32 in sorted ids, near
    to far by raw 1/z among faces with signed distance > -window, -1
    empty. A CUDA kernel adds the (pixel, face) pairs of its warps' face
    lists to ``tested`` (a one-element int64 CUDA tensor) if given."""
    return _topk("raster_topk", coeffs, bounds, h, w, k, window, tested)


def raster_topk_every_face(coeffs: torch.Tensor, bounds: torch.Tensor,
                           h: int, w: int, k: int,
                           window: float) -> torch.Tensor:
    """``raster_topk`` by the earlier walk: every face of every chunk in
    band is tested at every pixel. Launched by no route; the twin the
    per-warp face lists are held against."""
    return _topk("raster_topk_every_face", coeffs, bounds, h, w, k, window,
                 None)


def _topk(name: str, coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
          w: int, k: int, window: float,
          tested: Optional[torch.Tensor]) -> torch.Tensor:
    n, _, f_pad = coeffs.shape
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"{name}: K={k} outside 1..{MAX_TOPK}")
    if _check_coeffs(name, coeffs, bounds, (n, 2, f_pad // FACE_CHUNK),
                     torch.float32):
        return raster_topk_plain(coeffs, bounds, h, w, k, window)
    coeffs, bounds = coeffs.contiguous(), bounds.contiguous()
    dev = coeffs.device
    ids = torch.empty((n, h * w, k), dtype=torch.int32, device=dev)
    args = [coeffs.data_ptr(), bounds.data_ptr(), ids.data_ptr()]
    if name == "raster_topk":
        args.append(_check_tested(name, tested, dev))
    # The cull margin is rounded to float32 from the double sum, as the
    # JAX package's Python-side ``window_px + 2.0`` is.
    fn = build.symbol("raster_topk", "st3d_" + name, len(args), 6, 2)
    err = fn(*args, n, h, w, f_pad, f_pad // FACE_CHUNK, k, window,
             window + 2.0, build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return ids


def raster_2d(coeffs: torch.Tensor, bounds: torch.Tensor, h: int, w: int,
              tested: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 on faces from ``preprocess_2d``: coeffs (N, 20, F_pad) float32,
    bounds (N, 4, n_chunks) -> (p2f (N, H*W) int32 Morton-sorted ids, zbuf
    (N, H*W)). A CUDA kernel adds the (pixel, face) pairs of its warps'
    face lists to ``tested`` (a one-element int64 CUDA tensor) if given."""
    return _hard("raster_2d", 4, raster_2d_plain, coeffs, bounds, h, w,
                 tested)


def raster_2d_every_face(coeffs: torch.Tensor, bounds: torch.Tensor, h: int,
                         w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raster_2d`` by the earlier kernel: every face of every chunk the
    2D cull leaves is tested at every pixel of the tile. Launched by no
    route; the twin the per-warp face lists are held against."""
    return _hard("raster_2d_every_face", 4, raster_2d_plain, coeffs, bounds,
                 h, w, None)


# ---------------------------------------------------------------------------
# View-batch entry points (mesh face ids out)
# ---------------------------------------------------------------------------

def _to_mesh_ids(order: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Sorted ids (N, P) -> mesh ids, keeping -1."""
    mapped = torch.gather(order, 1, torch.clamp(ids, min=0).long())
    return torch.where(ids >= 0, mapped.int(), ids)


def use_stream(n_faces: int) -> bool:
    """The JAX package's dispatch rule (raster_pallas.py:392-395)."""
    return n_faces * N_COEFF_ROWS * 4 > RESIDENT_COEFF_BUDGET


def _rasterize(face_verts: torch.Tensor, w: int, h: int, soft: bool,
               margin: float, stream: Optional[bool], row0: int = 0):
    n = face_verts.shape[0]
    if stream is None:
        stream = use_stream(face_verts.shape[1])
    if row0 and soft:
        raise ValueError("a row offset (row0) is for hard mode only")
    tile = cull_tile(h, w, soft)
    with torch.no_grad():
        coeffs, bounds, order = preprocess(face_verts.detach())
        if stream:
            ranges = stream_ranges(bounds, h, w, tile, margin, row0)
            p2f, zbuf, near = raster_stream(coeffs, bounds, ranges, h, w,
                                            tile, soft, margin, row0=row0)
        elif soft:
            p2f, zbuf, near = raster_soft(coeffs, bounds, h, w, margin, tile)
        else:
            p2f, zbuf = raster_hard(coeffs, bounds, h, w, row0=row0)
            near = None
        p2f = _to_mesh_ids(order, p2f).reshape(n, h, w)
        if near is not None:
            near = _to_mesh_ids(order, near).reshape(n, h, w)
    return p2f, zbuf.reshape(n, h, w), near


def rasterize_batched(face_verts: torch.Tensor, image_size: int,
                      image_height: Optional[int] = None,
                      stream: Optional[bool] = None, row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard visibility of a view batch (N, F, 3, 3) -> pix_to_face
    (N, H, W) int32 in mesh face ids (-1 = background) and zbuf (N, H, W)
    (counterpart of ``rasterize_pallas_batched`` in hard mode), of the
    image rows ``[row0, row0 + H)``. K6 runs where ``use_stream`` says
    so; ``stream`` forces either kernel."""
    h = image_height if image_height is not None else image_size
    p2f, zbuf, _ = _rasterize(face_verts, image_size, h, False, 0.0, stream,
                              row0)
    return p2f, zbuf


def rasterize_batched_soft(face_verts: torch.Tensor, image_size: int,
                           soft_sigma_px: float = 1.0,
                           image_height: Optional[int] = None,
                           stream: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Soft visibility: ``rasterize_batched``'s outputs plus nearest_face
    (N, H, W) int32 mesh ids, the face of largest gated signed distance
    (``rasterize_pallas_batched(soft=True)``)."""
    h = image_height if image_height is not None else image_size
    return _rasterize(face_verts, image_size, h, True,
                      soft_cull_margin(soft_sigma_px), stream)


def rasterize_topk_batched(face_verts: torch.Tensor, image_size: int, k: int,
                           window_px: float) -> torch.Tensor:
    """(N, F, 3, 3) -> (N, H, W, K) top-K mesh face ids near to far, -1
    empty (``rasterize_pallas_topk``), one K7 launch for the batch."""
    n = face_verts.shape[0]
    s = image_size
    with torch.no_grad():
        coeffs, bounds, order = preprocess(face_verts.detach())
        ids = raster_topk(coeffs, bounds, s, s, k, float(window_px))
        ids = _to_mesh_ids(order, ids.reshape(n, s * s * k))
    return ids.reshape(n, s, s, k)


def rasterize_2d_batched(face_verts: torch.Tensor, image_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rasterize_batched``'s outputs through K9 (raster_pallas.py:1043
    ``rasterize_pallas2d_batched``): pix_to_face (N, S, S) int32 mesh ids
    and zbuf (N, S, S). On exact 1/z ties the lowest Morton-sorted face
    wins. The JAX function's ``face_chunk`` has no counterpart: the output
    does not depend on it."""
    n = face_verts.shape[0]
    s = image_size
    with torch.no_grad():
        coeffs, bounds, order = preprocess_2d(face_verts.detach(), s)
        p2f, zbuf = raster_2d(coeffs, bounds, s, s)
        p2f = _to_mesh_ids(order, p2f).reshape(n, s, s)
    return p2f, zbuf.reshape(n, s, s)
