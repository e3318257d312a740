"""K6's redesigned walk (``csrc/raster_stream.cu``) as a plain Python model
on the CPU, against the plain version of K6 (``raster_stream_plain``: every
chunk of each tile's range) and the JAX package's streaming kernel in
interpret mode, on stretched faces: an ico-sphere with seeded vertex noise
large enough that chunk bands span the frame, at 64², hard and soft.

The model walks each 256-pixel block's [c_lo, c_hi] in chunk order as the
kernel does. Hard: a chunk is tested where its row band meets the block's
rows; inside it each 32-pixel warp leaves out the faces whose bbox stays 1
or more from the block's rows or the warp's columns. Soft: a chunk is skipped only where it is out of band by the margin
(fl(ymax - row0) <= -margin or fl(row1 - ymin) <= -margin, float32) and,
when it was chosen, every pixel of the block had a nearest-face distance
>= -margin: the kernel picks the chunk after the one it is testing on the
running best before that test, so the model keeps, per block, that flag
as of the last tested chunk's start."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d.core import cameras as jcams
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.kernels.raster_pallas import rasterize_pallas_batched
from st3d.render.rasterize import face_verts_screen as jax_fvs

from st3d_torch.kernels import raster as kr

SIZE = 64
TIE = 2e-5          # test_torch_softras.py's near-tie scale (F4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stretched():
    """Screen faces (2, 1280, 3, 3) of the level-3 ico-sphere (10 chunks)
    with 4% of its vertices thrown by seeded noise of 0.6 radii, seen from
    1.6 radii so that it fills the frame: every pixel of a block comes near
    a face, and the soft skip has blocks to act on."""
    m = jax_ico_sphere(level=3)
    verts = np.asarray(m.verts)
    rng = np.random.RandomState(3)
    moved = rng.rand(verts.shape[0]) < 0.04
    verts = verts + (rng.randn(*verts.shape) * 0.6 * moved[:, None]
                     ).astype(np.float32)
    fv = np.asarray(jax_fvs(jnp.asarray(verts), m.faces,
                            jcams.build_fixed_cameras(2, dist=1.6, seed=2),
                            SIZE))
    return fv


def walk_plain(coeffs, bounds, ranges, h, w, tile, soft, margin):
    """The kernel's walk, block by block: (p2f, zbuf, nearest or None) as
    ``raster_stream`` returns them, and the chunks tested (summed over the
    blocks)."""
    n, _, f_pad = coeffs.shape
    hw, blk = h * w, kr.TILE_PIXELS
    nblk = -(-hw // blk)
    flat = torch.arange(nblk * blk)
    valid = flat < hw
    px, py = (flat % w).float(), (flat // w).float()
    t0 = torch.arange(nblk) * blk
    row0 = (t0 // w).float()
    row1 = (torch.clamp(t0 + blk - 1, max=hw - 1) // w).float()
    m = torch.tensor(margin, dtype=torch.float32)
    # Each 32-pixel warp's first and last column (the whole row where it
    # wraps one).
    first, last = flat[0::32], flat[31::32]
    wraps = (first // w) != (last // w)
    col0 = torch.where(wraps, 0.0, (first % w).float())
    col1 = torch.where(wraps, float(w - 1), (last % w).float())
    rows = kr.SOFT_ROWS if soft else kr.HARD_ROWS
    outs, tested = [], 0
    for v in range(n):
        rng = ranges[v, t0 // tile]
        best = torch.zeros(nblk * blk)
        fid = torch.full((nblk * blk,), -1, dtype=torch.int64)
        sbest = torch.full((nblk * blk,), kr.NEG_INIT)
        sid = torch.zeros(nblk * blk, dtype=torch.int64)
        near_dec = torch.zeros(nblk, dtype=torch.bool)
        for c in range(f_pad // kr.FACE_CHUNK):
            ymin, ymax = bounds[v, 0, c], bounds[v, 1, c]
            in_range = (c >= rng[:, 0]) & (c <= rng[:, 1])
            if soft:
                out = ((ymax - row0) <= -m) | ((row1 - ymin) <= -m)
                test = in_range & (~out | ~near_dec)
                near = ((sbest >= -m) | ~valid).reshape(nblk, blk).all(1)
                near_dec = torch.where(test, near, near_dec)
                near_at = near
            else:
                test = in_range & (ymax >= row0) & (ymin <= row1)
            tested += int(test.sum())
            sel = (torch.nonzero(test).reshape(-1, 1) * blk
                   + torch.arange(blk)).reshape(-1)
            sel = sel[sel < hw]
            if not len(sel):
                continue
            chunk = coeffs[v, :, c * kr.FACE_CHUNK:(c + 1) * kr.FACE_CHUNK]
            b0, b1, b2, iz, sd = kr._chunk_planes(chunk[:rows], px[sel, None],
                                                  py[sel, None], soft)
            # Soft, the per-pixel skip: 1 or more outside the face's bbox
            # and no nearer than the pixel's best at the chunk's start (a
            # subset of what the kernel skips face by face).
            box = torch.minimum(
                torch.minimum(px[sel, None] - chunk[15],
                              chunk[16] - px[sel, None]),
                torch.minimum(py[sel, None] - chunk[17],
                              chunk[18] - py[sel, None]))
            skip = (box <= -1.0) & (box <= sbest[sel, None]) & soft
            # Each warp's face list: faces whose bbox stays 1 (soft, once
            # near: the margin) or more from the block's rows or the warp's
            # 32 columns are left out.
            blk_of, wp = sel // blk, sel // 32
            lim = -m if soft else torch.tensor(-1.0)
            drop = (((chunk[18][None] - row0[blk_of, None]) <= lim)
                    | ((row1[blk_of, None] - chunk[17][None]) <= lim)
                    | ((chunk[16][None] - col0[wp, None]) <= lim)
                    | ((col1[wp, None] - chunk[15][None]) <= lim))
            if soft:
                drop &= near_at[blk_of, None]
            skip |= drop
            if soft:
                sd = torch.where(skip, torch.full_like(sd, kr.NEG_INIT), sd)
            cov = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0) & ~skip
            cmax, carg = torch.max(torch.where(cov, iz, torch.full_like(
                iz, -1.0)), dim=1)
            better = cmax > best[sel]
            fid[sel] = torch.where(better, c * kr.FACE_CHUNK + carg, fid[sel])
            best[sel] = torch.maximum(best[sel], cmax)
            if soft:
                smax, sarg = torch.max(sd, dim=1)
                sbetter = smax > sbest[sel]
                sid[sel] = torch.where(sbetter, c * kr.FACE_CHUNK + sarg,
                                       sid[sel])
                sbest[sel] = torch.maximum(sbest[sel], smax)
        hit = best[:hw] > 0.0
        outs.append((torch.where(hit, fid[:hw], -1).int(),
                     torch.where(hit, 1.0 / torch.clamp(best[:hw], min=1e-12),
                                 torch.full((hw,), kr.BIG_Z)),
                     sid[:hw].int()))
    p2f, zbuf, near = (torch.stack(t) for t in zip(*outs))
    return p2f, zbuf, (near if soft else None), tested


def _stream_inputs(fv, soft):
    coeffs, bounds, order = kr.preprocess(torch.tensor(fv))
    tile = kr.cull_tile(SIZE, SIZE, soft)
    margin = kr.soft_cull_margin(1.0) if soft else 0.0
    ranges = kr.stream_ranges(bounds, SIZE, SIZE, tile, margin)
    return coeffs, bounds, order, ranges, tile, margin


@pytest.mark.parametrize("soft", [False, True])
def test_walk_equals_the_plain_version(stretched, soft):
    """Bit for bit, on faces whose chunk bands span the frame; the walk
    tests fewer chunks than the ranges hold."""
    coeffs, bounds, _, ranges, tile, margin = _stream_inputs(stretched, soft)
    assert coeffs.shape[2] // kr.FACE_CHUNK >= 3
    spans = ranges[..., 1] - ranges[..., 0] + 1
    got = walk_plain(coeffs, bounds, ranges, SIZE, SIZE, tile, soft, margin)
    want = kr.raster_stream_plain(coeffs, ranges, SIZE, SIZE, tile, soft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if soft:
        assert torch.equal(got[2], want[2])
    # Chunks the ranges hold, per 256-pixel block (a tile of ``tile``
    # pixels holds tile / 256 blocks).
    walked = int(spans.clamp(min=0).sum()) * (tile // kr.TILE_PIXELS)
    assert 0 < got[3] < walked
    # The stretched faces widen the bands: most ranges reach past their
    # tile's own chunks.
    assert float(spans.float().mean()) >= 3


def _scores(fv, ids):
    coeffs = kr.face_coeffs(torch.tensor(fv))
    flat = torch.arange(SIZE * SIZE)
    px, py = (flat % SIZE).float()[:, None], (flat // SIZE).float()[:, None]
    out = []
    for v in range(fv.shape[0]):
        sd = kr._chunk_planes(coeffs[v, :19], px, py, soft=True)[4]
        idx = torch.tensor(ids[v].reshape(-1, 1)).long()
        out.append(torch.gather(sd, 1, idx).reshape(-1).numpy())
    return np.stack(out)


@pytest.mark.parametrize("soft", [False, True])
def test_walk_matches_pallas_stream(stretched, soft):
    """Against the JAX streaming kernel (``stream=True``, interpret mode)
    in mesh ids: pix_to_face equal, zbuf within rtol 1e-4 (F4), nearest
    equal except at near-ties of the gated distance (F4, F7)."""
    coeffs, bounds, order, ranges, tile, margin = _stream_inputs(stretched,
                                                                 soft)
    p2f, zbuf, near, _ = walk_plain(coeffs, bounds, ranges, SIZE, SIZE, tile,
                                    soft, margin)
    j = rasterize_pallas_batched(jnp.asarray(stretched), SIZE, soft=soft,
                                 stream=True)
    ids = kr._to_mesh_ids(order, p2f).numpy()
    np.testing.assert_array_equal(ids.reshape(np.asarray(j.pix_to_face).shape),
                                  np.asarray(j.pix_to_face))
    np.testing.assert_allclose(zbuf.numpy().reshape(np.asarray(j.zbuf).shape),
                               np.asarray(j.zbuf), rtol=1e-4)
    if soft:
        got = kr._to_mesh_ids(order, near).numpy()
        want = np.asarray(j.nearest_face).reshape(got.shape)
        diff = got != want
        if diff.any():
            a, b = _scores(stretched, got), _scores(stretched, want)
            gap = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
            assert gap[diff].max() <= TIE
        assert diff.mean() <= 0.05
