"""The per-warp face lists of K1 in hard mode (``csrc/raster_hard.cu``) as a
plain Python model on the CPU, against the plain version
(``raster_hard_plain``: every face of every chunk in band) and the JAX
package's kernel in interpret mode.

K1 walks the chunks in sorted order, one block of 256 pixels at a time (a
chunk is tested where its row band meets the block's rows), and splits each
block into warps of 32 consecutive pixels. For each tested chunk a warp
drops a face when, over its pixel rectangle [col0, col1] x [row0, row1] (a
warp that wraps a row takes the columns [0, W-1]), the corner value of b0,
b1 or b2 is < 0, or the corner value of 1/z is <= s_w, the least best 1/z
over the warp's pixels at the chunk's start. The corner of
affine(px, py, a, b, c) = fl(fl(fl(px*a) + fl(py*b)) + c) is
(col1 if a >= 0 else col0, row1 if b >= 0 else row0): rounding is
monotone, so no pixel of the rectangle has a larger value. The model counts
the (pixel, face) pairs of the lists, as the kernel's ``tested`` counter
does, and asserts on the data that no dropped pair could have changed a
result and that the corner bound held at every pixel.

Scenes: ``test_torch_soft_walk.py``'s (the pristine level-3 ico-sphere and
one stretched by seeded vertex noise at 64², two views; at 48², where warps
wrap rows, a face count that is not a multiple of 128), and an adversarial
one: slivers just above ``AREA_EPS``, edges through pixel centres, exact
1/z ties (duplicated faces) and faces behind the camera.
"""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import raster as kr
from test_torch_soft_walk import (BLOCK, _pixels, _scene_faces, _walk, _warps,
                                  corner_keep, corner_max, every_face_pairs,
                                  warp_least)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hard_walk(coeffs, bounds, h, w, depth=True, active=None):
    """K1's walk: (p2f, zbuf) (N, H*W) as ``raster_hard`` returns them, and
    the (pixel, face) pairs of the warps' lists (``depth=False``: without
    the 1/z drop, to count what it saves). ``active`` (N, blocks, chunks):
    the blocks' chunk test, by default the row band."""
    n = coeffs.shape[0]
    hw = h * w
    flat = torch.arange(hw)
    px, py = (flat % w).float(), (flat // w).float()
    if active is None:
        active = kr._band_overlap(bounds, h, w, BLOCK, 0.0)
    n_warps = len(_warps(h, w)[4])
    best = torch.zeros((n, hw))
    fid = torch.full((n, hw), -1, dtype=torch.int64)
    tested = [0]

    def visit(v, c, warps, chunk, box, live):
        s_w = warp_least(best[v], n_warps, hw)[warps]
        m0 = corner_max(chunk[0], chunk[1], chunk[2], box)
        m1 = corner_max(chunk[3], chunk[4], chunk[5], box)
        m2 = corner_max(chunk[6], chunk[7], chunk[8], box)
        mz = corner_max(chunk[9], chunk[10], chunk[11], box)
        keep = corner_keep(chunk, box, s_w, depth)
        tested[0] += int((keep.sum(1) * live).sum())
        pix, kp = _pixels(warps, keep, hw)
        b0, b1, b2, iz, _ = kr._chunk_planes(chunk, px[pix, None],
                                             py[pix, None], soft=False)
        # The lemma on this data: the corner values bound every pixel's.
        for m, val in ((m0, b0), (m1, b1), (m2, b2), (mz, iz)):
            per_pix = _pixels(warps, m, hw)[1]
            assert (per_pix >= val).all()
        covered = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
        # What the proof says of a dropped pair: it cannot win.
        assert not (covered & (iz > best[v, pix, None]) & ~kp).any()
        mzk = torch.where(covered & kp, iz, torch.full_like(iz, -1.0))
        cmax, carg = torch.max(mzk, dim=1)
        better = cmax > best[v, pix]
        fid[v, pix] = torch.where(better, c * kr.FACE_CHUNK + carg,
                                  fid[v, pix])
        best[v, pix] = torch.maximum(best[v, pix], cmax)

    _walk(coeffs, lambda v, c: active[v, :, c], h, w, visit)
    hit = best > 0.0
    p2f = torch.where(hit, fid, torch.full_like(fid, -1)).int()
    zbuf = torch.where(hit, 1.0 / torch.clamp(best, min=1e-12),
                       torch.full_like(best, kr.BIG_Z))
    return p2f, zbuf, tested[0]


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

def _adversarial_faces():
    """(faces (1, F, 3, 3) float32 numpy, 64): the level-3 sphere's first
    view behind a set of faces built to sit on the drop rule's edges, F not
    a multiple of 128. The port projects the sphere, so the CUDA tests can
    build the scene on a machine without JAX."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=3)
    size = 64
    fv = face_verts_screen(mesh.verts, mesh.faces,
                           build_fixed_cameras(1, seed=0), size).numpy()
    rows = []
    # A grid of cells split along their diagonals, integer vertices: every
    # edge runs through pixel centres, neighbours share edges at one depth.
    for i in range(6):
        for j in range(6):
            x0, y0 = 4.0 + 9 * i, 4.0 + 9 * j
            z = 1.0 + 0.125 * ((i + j) % 3)
            rows.append([[x0, y0, z], [x0 + 9, y0, z], [x0, y0 + 9, z]])
            rows.append([[x0 + 9, y0, z], [x0 + 9, y0 + 9, z],
                         [x0, y0 + 9, z]])
    # Exact 1/z ties: every fifth grid face again, later in mesh order.
    rows += [list(r) for r in rows[::5]]
    # Slivers just above AREA_EPS with a vertex on a pixel centre, in front.
    for k in range(12):
        x, y = 5.0 + 4 * k, 7.0 + 3 * k
        rows.append([[x, y, 0.5], [x + 1e-5, y, 0.5], [x, y + 1.5e-5, 0.5]])
    # Long slivers one ulp thick along pixel rows and columns.
    for k in range(6):
        y = 10.0 + 8 * k
        rows.append([[2.0, y, 0.75], [61.0, y, 0.75],
                     [61.0, float(np.nextafter(np.float32(y),
                                               np.float32(100))), 0.75]])
        rows.append([[y, 2.0, 0.75], [y, 61.0, 0.75],
                     [float(np.nextafter(np.float32(y), np.float32(100))),
                      2.0, 0.75]])
    # Faces behind everything and faces crossing the camera plane.
    rows.append([[0.0, 0.0, 40.0], [63.0, 0.0, 40.0], [0.0, 63.0, 40.0]])
    rows.append([[10.0, 10.0, -1.0], [50.0, 12.0, 2.0], [12.0, 50.0, 2.0]])
    extra = np.asarray(rows, dtype=np.float32)[None]
    return np.concatenate([fv, extra], axis=1), size


SCENES = ("pristine", "stretched", "padded48", "adversarial")


@pytest.fixture(scope="module")
def scenes():
    out = {name: _scene_faces(name) for name in SCENES[:3]}
    out["adversarial"] = _adversarial_faces()
    return out


def _prep(fv):
    return kr.preprocess(torch.tensor(fv))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", SCENES)
def test_hard_walk_equals_the_plain_version(scenes, scene):
    """Bit for bit, p2f and zbuf; the lists hold fewer pairs than the
    earlier walk tests."""
    fv, size = scenes[scene]
    coeffs, bounds, _ = _prep(fv)
    if scene in ("padded48", "adversarial"):
        assert coeffs.shape[2] > fv.shape[1]
    p2f, zbuf, tested = hard_walk(coeffs, bounds, size, size)
    want = kr.raster_hard_plain(coeffs, bounds, size, size)
    assert torch.equal(p2f, want[0]) and torch.equal(zbuf, want[1])
    assert (p2f >= 0).any()
    every = every_face_pairs(bounds, size, size, BLOCK, 0.0)
    assert 0 < tested < every


def test_adversarial_scene_hits_the_edges(scenes):
    """The adversarial faces win pixels, among them ties between duplicated
    faces (the lower mesh id), a sliver's vertex pixel and pixels on the
    shared edges of the grid."""
    fv, size = scenes["adversarial"]
    coeffs, bounds, order = _prep(fv)
    p2f, _, _ = hard_walk(coeffs, bounds, size, size)
    ids = kr._to_mesh_ids(order, p2f)[0]
    n_sphere = 1280                      # the level-3 sphere's faces
    won = set(ids[ids >= n_sphere].tolist()) - {-1}
    grid = set(range(n_sphere, n_sphere + 72))
    assert len(won & grid) >= 60
    # A duplicate never wins: its original has the same planes, a lower
    # mesh id and so a lower sorted id.
    dups = set(range(n_sphere + 72, n_sphere + 72 + 15))
    assert not won & dups
    slivers = set(range(n_sphere + 87, n_sphere + 99))
    assert won & slivers


def _edge_pixels(fv, ids, pix, size):
    """Per pixel of ``pix``, the least |min(b0, b1, b2)| of the faces
    ``ids`` (list of (N, P) mesh-id arrays) there, by the port's planes."""
    cf = kr.face_coeffs(torch.tensor(fv))
    out = np.full(len(pix), np.inf)
    for k, (v, p) in enumerate(pix):
        x, y = float(p % size), float(p // size)
        for a in ids:
            f = int(a[v, p])
            if f < 0:
                continue
            c = cf[v, :, f]
            b = min(float(x * c[3 * r] + y * c[3 * r + 1] + c[3 * r + 2])
                    for r in range(3))
            out[k] = min(out[k], abs(b))
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_hard_walk_matches_pallas(scenes, scene):
    """Against ``rasterize_pallas_batched`` (hard) in interpret mode, in mesh
    ids: pix_to_face equal, zbuf within rtol 1e-4 (F4). On the adversarial
    scene, whose edges run through pixel centres, the JAX planes (FMA-
    contracted, F4) decide some on-edge pixels the other way: ids differ
    only where one of the two faces has a barycentric within 1e-6 of 0; and
    the 1/z planes of its one-ulp slivers (area under 1e-3 px²) cancel
    catastrophically, so their zbuf is left out of the comparison."""
    import jax.numpy as jnp

    from st3d.kernels.raster_pallas import rasterize_pallas_batched

    fv, size = scenes[scene]
    coeffs, bounds, order = _prep(fv)
    p2f, zbuf, _ = hard_walk(coeffs, bounds, size, size)
    j = rasterize_pallas_batched(jnp.asarray(fv), size,
                                 tile_pixels_max=kr.cull_tile(size, size,
                                                              False))
    got = kr._to_mesh_ids(order, p2f).numpy()
    want = np.asarray(j.pix_to_face).reshape(fv.shape[0], -1)
    same = got == want
    if scene == "adversarial":
        diff = np.argwhere(~same)
        assert len(diff) <= 0.05 * got.size
        assert (_edge_pixels(fv, [got, want], diff, size) <= 1e-6).all()
    else:
        np.testing.assert_array_equal(got, want)
    hit = (p2f.numpy() >= 0) & same
    x, y = fv[..., 0], fv[..., 1]
    area = np.abs((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
                  - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    hit &= np.take_along_axis(area, np.maximum(got, 0), axis=1) >= 1e-3
    np.testing.assert_allclose(
        zbuf.numpy()[hit], np.asarray(j.zbuf).reshape(fv.shape[0], -1)[hit],
        rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corner_bounds_every_pixel_of_the_rectangle(seed):
    """The lemma in float32 torch ops on random coefficients (both signs,
    zeros, magnitudes up to 1e7 so rounding matters) and random rectangles
    of a 512-pixel frame: the corner value is >= the value at every pixel,
    and equals the value at the corner pixel."""
    rng = np.random.RandomState(seed)
    n = 64
    mag = 10.0 ** rng.uniform(-6, 7, size=(3, n))
    coef = (rng.randn(3, n) * mag).astype(np.float32)
    coef[:2, :8] = 0.0
    coef[0, 8:12] = -0.0
    a, b, c = (torch.tensor(coef[k]) for k in range(3))
    for _ in range(8):
        cs = np.sort(rng.randint(0, 512, size=2))
        rs = np.sort(rng.randint(0, 512, size=2))
        box = tuple(torch.tensor([float(v)]) for v in (cs[0], cs[1], rs[0],
                                                        rs[1]))
        top = corner_max(a, b, c, box)[0]
        xs = torch.arange(int(cs[0]), int(cs[1]) + 1).float()
        ys = torch.arange(int(rs[0]), int(rs[1]) + 1).float()
        px = xs[:, None].expand(-1, len(ys)).reshape(-1, 1)
        py = ys[None, :].expand(len(xs), -1).reshape(-1, 1)
        vals = px * a + py * b + c
        assert (top[None, :] >= vals).all()
        cx = torch.where(a >= 0, box[1], box[0])
        cy = torch.where(b >= 0, box[3], box[2])
        assert torch.equal(top, cx * a + cy * b + c)


def test_lists_drop_most_pairs_and_the_depth_drop_pays(scenes):
    """The lists hold far fewer pairs than the every-face walk tests; the
    1/z drop never adds a pair, and on the stretched sphere, whose faces
    overlap deeply, it removes some."""
    for name in ("pristine", "stretched"):
        fv, size = scenes[name]
        coeffs, bounds, _ = _prep(fv)
        tested = hard_walk(coeffs, bounds, size, size)[2]
        corner_only = hard_walk(coeffs, bounds, size, size, depth=False)[2]
        every = every_face_pairs(bounds, size, size, BLOCK, 0.0)
        assert 2 * tested < every
        assert tested <= corner_only
        if name == "stretched":
            assert tested < corner_only


def test_twin_and_counter_take_the_plain_version_on_the_cpu(scenes):
    """On CPU tensors ``raster_hard`` and its twin return the plain
    version: nothing launches and ``tested`` stays as it was."""
    fv, size = scenes["padded48"]
    coeffs, bounds, _ = _prep(fv)
    tested = torch.zeros(1, dtype=torch.int64)
    before = dict(kr.LAUNCHES)
    want = kr.raster_hard_plain(coeffs, bounds, size, size)
    for got in (kr.raster_hard(coeffs, bounds, size, size, tested),
                kr.raster_hard_every_face(coeffs, bounds, size, size)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(tested) == 0 and kr.LAUNCHES == before
