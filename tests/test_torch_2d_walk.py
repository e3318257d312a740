"""The per-warp face lists of kernel G (K9 on 2D tiles, ``csrc/raster_2d.cu``)
as a plain Python model on the CPU, against the plain version
(``raster_2d_plain``: every face of every chunk the 2D cull leaves) and the
JAX package's K9 in interpret mode.

G walks the chunks in Morton-sorted order, one 16 x 16 tile a block (a chunk
is tested where ``cull_2d`` says: its bounds meet the tile's rows and
columns), and splits each tile into eight warps, each owning a rectangle of
the tile: 8 x 4 pixels (the kernel's choice) or 16 x 2. For each tested
chunk a warp drops a face when, over its rectangle (lanes past the frame
included), the corner value of b0, b1 or b2 is < 0, or the corner value of
1/z is <= s_w, the least best 1/z over the warp's pixels in the frame at the
chunk's start (``test_torch_hard_walk.py``'s rule and lemma, on 2D
rectangles). The model counts the (pixel, face) pairs of the lists, as the
kernel's ``tested`` counter does, and asserts on the data that the corner
bound held at every pixel and that no dropped pair could have won.

Scenes: ``test_torch_hard_walk.py``'s (the pristine and the stretched
level-3 sphere at 64², two views; 48² with a face count that is not a
multiple of 128; the adversarial one with slivers, edges through pixel
centres, exact 1/z ties and faces behind the camera), and at 40² (tiles run
past the frame) the sphere with 1,203 faces, projected by the port so the
CUDA tests can build it without JAX.
"""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import raster as kr
from test_torch_hard_walk import _adversarial_faces, corner_max
from test_torch_soft_walk import _scene_faces

TS = kr.TILE_2D
WARP = 32
WARPS = TS * TS // WARP
SHAPES = ((16, 2), (8, 4))      # a warp's rectangle: columns x rows
KERNEL_SHAPE = SHAPES[1]        # csrc/raster_2d.cu WW x WH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile_warps(h, w, shape=KERNEL_SHAPE):
    """Every warp of the 16 x 16 tiles, tile-major in ``tiles_2d``'s tile
    order, then warp index in the tile: its rectangle (col0, col1, row0,
    row1, float32, not clipped to the frame), its 32 flat pixels by lane
    (``h*w`` past the frame) and its count of lanes in the frame."""
    ww, wh = shape
    n_ty, n_tx = -(-h // TS), -(-w // TS)
    ty = torch.arange(n_ty).repeat_interleave(n_tx * WARPS)
    tx = torch.arange(n_tx).repeat_interleave(WARPS).repeat(n_ty)
    k = torch.arange(WARPS).repeat(n_ty * n_tx)
    col0 = tx * TS + (k % (TS // ww)) * ww
    row0 = ty * TS + (k // (TS // ww)) * wh
    lane = torch.arange(WARP)
    x = col0[:, None] + lane % ww
    y = row0[:, None] + lane // ww
    inside = (x < w) & (y < h)
    pix = torch.where(inside, y * w + x, h * w)
    box = (col0.float(), (col0 + ww - 1).float(), row0.float(),
           (row0 + wh - 1).float())
    return box, pix, inside.sum(1)


def walk_2d(coeffs, bounds, h, w, shape=KERNEL_SHAPE, depth=True):
    """G's walk: (p2f, zbuf) (N, H*W) as ``raster_2d`` returns them, and
    the (pixel, face) pairs of the warps' lists (``depth=False``: without
    the 1/z drop, to count what it saves)."""
    n = coeffs.shape[0]
    hw = h * w
    flat = torch.arange(hw)
    px, py = (flat % w).float(), (flat // w).float()
    cull = kr.cull_2d(bounds, h, w)
    box_all, pix_all, live_all = tile_warps(h, w, shape)
    # One slot past the frame: pixels there never lower s_w.
    best = torch.cat([torch.zeros((n, hw)), torch.full((n, 1), 3.0e38)], 1)
    fid = torch.full((n, hw), -1, dtype=torch.int64)
    tested = 0
    for v in range(n):
        for c in range(coeffs.shape[2] // kr.FACE_CHUNK):
            tiles = torch.nonzero(cull[v, :, c]).reshape(-1)
            if not len(tiles):
                continue
            warps = (tiles[:, None] * WARPS + torch.arange(WARPS)).reshape(-1)
            box = tuple(t[warps] for t in box_all)
            chunk = coeffs[v, :kr.HARD_ROWS,
                           c * kr.FACE_CHUNK:(c + 1) * kr.FACE_CHUNK]
            s_w = best[v, pix_all[warps]].amin(1)
            m0 = corner_max(chunk[0], chunk[1], chunk[2], box)
            m1 = corner_max(chunk[3], chunk[4], chunk[5], box)
            m2 = corner_max(chunk[6], chunk[7], chunk[8], box)
            mz = corner_max(chunk[9], chunk[10], chunk[11], box)
            drop = (m0 < 0) | (m1 < 0) | (m2 < 0)
            if depth:
                drop |= mz <= s_w[:, None]
            keep = ~drop
            tested += int((keep.sum(1) * live_all[warps]).sum())
            # Per pixel in the frame: its warp's row of each mask.
            pix = pix_all[warps].reshape(-1)
            inside = pix < hw
            pix = pix[inside]

            def per_pixel(m):
                return m.repeat_interleave(WARP, dim=0)[inside]

            kp = per_pixel(keep)
            b0, b1, b2, iz, _ = kr._chunk_planes(chunk, px[pix, None],
                                                 py[pix, None], soft=False)
            # The lemma on this data: the corner values bound every pixel's.
            for m, val in ((m0, b0), (m1, b1), (m2, b2), (mz, iz)):
                assert (per_pixel(m) >= val).all()
            covered = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
            # What the proof says of a dropped pair: it cannot win.
            assert not (covered & (iz > best[v, pix, None]) & ~kp).any()
            mzk = torch.where(covered & kp, iz, torch.full_like(iz, -1.0))
            cmax, carg = torch.max(mzk, dim=1)
            better = cmax > best[v, pix]
            fid[v, pix] = torch.where(better, c * kr.FACE_CHUNK + carg,
                                      fid[v, pix])
            best[v, pix] = torch.maximum(best[v, pix], cmax)
    best = best[:, :hw]
    hit = best > 0.0
    p2f = torch.where(hit, fid, torch.full_like(fid, -1)).int()
    zbuf = torch.where(hit, 1.0 / torch.clamp(best, min=1e-12),
                       torch.full_like(best, kr.BIG_Z))
    return p2f, zbuf, tested


def every_face_pairs_2d(bounds, h, w):
    """(pixel, face) pairs the earlier kernel tests: every face of every
    chunk the cull leaves, at every pixel of the tile in the frame."""
    pix, _ = kr.tiles_2d(h, w, bounds.device)
    live = (pix < h * w).sum(1)
    per_tile = kr.cull_2d(bounds, h, w).long().sum(dim=(0, 2))
    return int((per_tile * live).sum()) * kr.FACE_CHUNK


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def ragged_faces():
    """(faces (2, 1203, 3, 3) float32 numpy, 40): the level-3 sphere under
    two fixed views at 40², where the last tile of each row and column runs
    8 pixels past the frame, cut to a face count that is not a multiple of
    128. The port projects it."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=3)
    size = 40
    fv = face_verts_screen(mesh.verts, mesh.faces,
                           build_fixed_cameras(2, seed=0), size)
    return fv[:, :1203].numpy(), size


SCENES = ("pristine", "stretched", "padded48", "ragged40", "adversarial")


@pytest.fixture(scope="module")
def scenes():
    out = {name: _scene_faces(name) for name in SCENES[:3]}
    out["ragged40"] = ragged_faces()
    out["adversarial"] = _adversarial_faces()
    return out


def _prep(fv, size):
    return kr.preprocess_2d(torch.tensor(fv), size)


def _plane_values(fv, ids, pix, size):
    """(M, 4) b0, b1, b2 and 1/z of the mesh faces ``ids`` (M,) of view
    ``pix[:, 0]`` at flat pixels ``pix[:, 1]``, by the port's planes."""
    cf = kr.face_coeffs(torch.tensor(fv))
    v, p = torch.tensor(pix[:, 0]), torch.tensor(pix[:, 1])
    blk = cf[v, :, torch.tensor(ids).long()]
    x, y = (p % size).float(), (p // size).float()
    return torch.stack([x * blk[:, r] + y * blk[:, r + 1] + blk[:, r + 2]
                        for r in (0, 3, 6, 9)], 1)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", SCENES)
def test_2d_walk_equals_the_plain_version(scenes, scene):
    """Bit for bit, p2f and zbuf; the lists hold fewer pairs than the
    earlier kernel tests."""
    fv, size = scenes[scene]
    coeffs, bounds, _ = _prep(fv, size)
    if scene in ("padded48", "ragged40", "adversarial"):
        assert coeffs.shape[2] > fv.shape[1]
    if scene == "ragged40":
        assert size % TS
    p2f, zbuf, tested = walk_2d(coeffs, bounds, size, size)
    want = kr.raster_2d_plain(coeffs, bounds, size, size)
    assert torch.equal(p2f, want[0]) and torch.equal(zbuf, want[1])
    assert (p2f >= 0).any()
    assert 0 < tested < every_face_pairs_2d(bounds, size, size)


@pytest.mark.parametrize("scene", SCENES)
def test_2d_walk_matches_pallas2d(scenes, scene):
    """Against ``rasterize_pallas2d_batched`` in interpret mode, in mesh
    ids: equal but at exact 1/z ties, where both faces cover the pixel with
    bit-equal 1/z by the port's planes; zbuf within rtol 1e-4 (F4). On the
    adversarial scene, whose edges run through pixel centres, the JAX
    planes (FMA-contracted, F4) may also decide an on-edge pixel the other
    way: there one of the two faces has a barycentric within 1e-6 of 0;
    and the 1/z of its one-ulp slivers (area under 1e-3 px²) cancels
    catastrophically, so their zbuf is left out."""
    import jax.numpy as jnp

    from st3d.kernels.raster_pallas import rasterize_pallas2d_batched

    fv, size = scenes[scene]
    coeffs, bounds, order = _prep(fv, size)
    p2f, zbuf, _ = walk_2d(coeffs, bounds, size, size)
    j = rasterize_pallas2d_batched(jnp.asarray(fv), size)
    got = kr._to_mesh_ids(order, p2f).numpy()
    want = np.asarray(j.pix_to_face).reshape(fv.shape[0], -1)
    diff = np.argwhere(got != want)
    if len(diff):
        a = _plane_values(fv, got[diff[:, 0], diff[:, 1]], diff, size)
        b = _plane_values(fv, want[diff[:, 0], diff[:, 1]], diff, size)
        tie = ((a[:, :3] >= 0).all(1) & (b[:, :3] >= 0).all(1)
               & (a[:, 3] == b[:, 3])).numpy()
        if scene == "adversarial":
            edge = ((a[:, :3].abs().amin(1) <= 1e-6)
                    | (b[:, :3].abs().amin(1) <= 1e-6)).numpy()
            assert (tie | edge).all() and len(diff) <= 0.05 * got.size
        else:
            assert tie.all()
    same = got == want
    x, y = fv[..., 0], fv[..., 1]
    area = np.abs((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
                  - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    hit = ((p2f.numpy() >= 0) & same
           & (np.take_along_axis(area, np.maximum(got, 0), axis=1) >= 1e-3))
    np.testing.assert_allclose(
        zbuf.numpy()[hit], np.asarray(j.zbuf).reshape(fv.shape[0], -1)[hit],
        rtol=1e-4)


@pytest.mark.parametrize("scene", SCENES)
def test_2d_walk_equals_k1_except_at_exact_ties(scenes, scene):
    """Against K1's plain version on the same faces, in mesh ids: zbuf
    bit-equal, and where the ids differ (K1 keeps the lowest y-sorted face,
    G the lowest Morton-sorted one) both faces cover the pixel with
    bit-equal 1/z. The adversarial scene's shared grid edges hold such
    ties."""
    fv, size = scenes[scene]
    coeffs, bounds, order = _prep(fv, size)
    p2f, zbuf, _ = walk_2d(coeffs, bounds, size, size)
    got = kr._to_mesh_ids(order, p2f).numpy()
    c1, b1, o1 = kr.preprocess(torch.tensor(fv))
    p1, z1 = kr.raster_hard_plain(c1, b1, size, size)
    assert torch.equal(zbuf, z1)
    want = kr._to_mesh_ids(o1, p1).numpy()
    diff = np.argwhere(got != want)
    if scene == "adversarial":
        assert len(diff)
    a = _plane_values(fv, got[diff[:, 0], diff[:, 1]], diff, size)
    b = _plane_values(fv, want[diff[:, 0], diff[:, 1]], diff, size)
    assert (a[:, :3] >= 0).all() and (b[:, :3] >= 0).all()
    assert torch.equal(a[:, 3], b[:, 3])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_corner_bounds_every_pixel_of_the_warp_rectangles(seed, shape):
    """The lemma in float32 torch ops on random coefficients (both signs,
    zeros, magnitudes up to 1e7 so rounding matters) over the warp
    rectangles of random 16 x 16 tiles of a 520-pixel frame (the last
    tiles past its edge): the corner value is >= the value at every pixel
    of the rectangle, frame or not, and equals it at the corner pixel."""
    rng = np.random.RandomState(seed)
    n = 64
    mag = 10.0 ** rng.uniform(-6, 7, size=(3, n))
    coef = (rng.randn(3, n) * mag).astype(np.float32)
    coef[:2, :8] = 0.0
    coef[1, 8:12] = -0.0
    a, b, c = (torch.tensor(coef[k]) for k in range(3))
    size = 520
    box_all, _, _ = tile_warps(size, size, shape)
    pick = torch.tensor(rng.choice(len(box_all[0]), 24, replace=False))
    pick = torch.cat([pick, torch.tensor([len(box_all[0]) - 1])])
    box = tuple(t[pick] for t in box_all)
    top = corner_max(a, b, c, box)                       # (warps, n)
    ww, wh = shape
    lane = torch.arange(WARP)
    xs = box[0][:, None] + (lane % ww).float()
    ys = box[2][:, None] + (lane // ww).float()
    vals = xs[:, :, None] * a + ys[:, :, None] * b + c   # (warps, 32, n)
    assert (top[:, None, :] >= vals).all()
    assert (xs.amax() > size - 1) and (ys.amax() > size - 1)
    cx = torch.where(a >= 0, box[1][:, None], box[0][:, None])
    cy = torch.where(b >= 0, box[3][:, None], box[2][:, None])
    assert torch.equal(top, cx * a + cy * b + c)


def test_lists_drop_most_pairs_and_the_depth_drop_pays(scenes):
    """The lists hold far fewer pairs than the every-face kernel tests; the
    1/z drop never adds a pair, and on the stretched sphere, whose faces
    overlap deeply, it removes some."""
    for name in ("pristine", "stretched"):
        fv, size = scenes[name]
        coeffs, bounds, _ = _prep(fv, size)
        tested = walk_2d(coeffs, bounds, size, size)[2]
        corner_only = walk_2d(coeffs, bounds, size, size, depth=False)[2]
        every = every_face_pairs_2d(bounds, size, size)
        assert 4 * tested < every
        assert tested <= corner_only
        if name == "stretched":
            assert tested < corner_only


def test_the_kernels_warp_shape_keeps_fewer_pairs(scenes):
    """The kernel's 8 x 4 rectangles against 16 x 2 on every scene: the
    same outputs, and the 8 x 4 lists hold fewer pairs on each."""
    for name in SCENES:
        fv, size = scenes[name]
        coeffs, bounds, _ = _prep(fv, size)
        outs, counts = {}, {}
        for shape in SHAPES:
            p2f, zbuf, counts[shape] = walk_2d(coeffs, bounds, size, size,
                                               shape)
            outs[shape] = (p2f, zbuf)
        assert all(torch.equal(x, y) for x, y in zip(*outs.values()))
        other = max(counts.values())
        assert counts[KERNEL_SHAPE] < other


def test_twin_and_counter_take_the_plain_version_on_the_cpu(scenes):
    """On CPU tensors ``raster_2d`` and its twin return the plain version:
    nothing launches and ``tested`` stays as it was."""
    fv, size = scenes["ragged40"]
    coeffs, bounds, _ = _prep(fv, size)
    tested = torch.zeros(1, dtype=torch.int64)
    before = dict(kr.LAUNCHES)
    want = kr.raster_2d_plain(coeffs, bounds, size, size)
    for got in (kr.raster_2d(coeffs, bounds, size, size, tested),
                kr.raster_2d_every_face(coeffs, bounds, size, size)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(tested) == 0 and kr.LAUNCHES == before


def test_twin_rejects_bad_bounds():
    """K1's (N, 2, n_chunks) bounds are not G's (N, 4, n_chunks)."""
    with pytest.raises(ValueError):
        kr.raster_2d_every_face(torch.zeros(1, 20, 128),
                                torch.zeros(1, 2, 1), 8, 8)
