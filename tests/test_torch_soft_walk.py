"""The per-warp face lists of K1's soft mode (``csrc/raster_soft.cu``) and
K7 (``csrc/raster_topk.cu``) as plain Python models on the CPU, against
the plain versions (``raster_soft_plain``, ``raster_topk_plain``: every
face of every chunk in band) and the JAX package's kernels in interpret
mode.

Both kernels walk the chunks in sorted order, one block of 256 pixels at a
time (a chunk is tested where its row band meets the block's cull band),
and split each block into warps of 32 consecutive pixels. For each tested
chunk a warp bounds each face over its pixel rectangle (a warp that wraps
a row takes the columns [0, W-1]): ub = min(fl(col1 - xmin),
fl(xmax - col0), fl(row1 - ymin), fl(ymax - row0)) bounds the bbox
distance, and the corner values of K1's rule (``corner_max``) bound the
barycentrics and 1/z. K1-soft drops a face when the corner rule rules it
out as the covering face (a barycentric's corner value < 0, or 1/z's <=
the least best 1/z over the warp's pixels) and ub <= s_w, the least
nearest distance over the warp's pixels at the chunk's start; a pixel also
skips such a corner-dropped face where its own bbox distance is <= its
best distance. K7 drops a face when ub <= -window. The models count the
(pixel, face) pairs of the lists, as the kernels' ``tested`` counters do,
and assert on the data that no dropped pair could have changed a result.
K6 (``csrc/raster_stream.cu``) walks every chunk of its tile's range with
the same lists: ``soft_walk`` and ``test_torch_hard_walk.hard_walk`` take
the blocks' chunk test as ``active``.

Scenes: the pristine level-3 ico-sphere and one stretched by seeded vertex
noise at 64² (two views), and at 48² (warps wrap rows) a face count that
is not a multiple of 128 (padding faces); ``sliver_faces``: slivers whose
rounded barycentrics cover pixels well outside their bbox. The JAX package
is imported inside the tests that compare with it, so the CUDA tests can
import the models on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import raster as kr
from st3d_torch.render.topk import blur_window_px

TIE = 2e-5          # test_torch_softras.py's near-tie scale (F4, F7)
WARP = 32
BLOCK = kr.TILE_PIXELS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warps(h, w):
    """Every 32-pixel warp of the blocks covering the frame: its rectangle
    (col0, col1, row0, row1, float32) from its first and last lane (lanes
    past the frame included, as in the kernels) and its pixels in the
    frame."""
    hw = h * w
    first = torch.arange(0, -(-hw // BLOCK) * BLOCK, WARP)
    last = first + WARP - 1
    wraps = (first // w) != (last // w)
    col0 = torch.where(wraps, 0, first % w).float()
    col1 = torch.where(wraps, w - 1, last % w).float()
    live = (hw - first).clamp(0, WARP)
    return col0, col1, (first // w).float(), (last // w).float(), live


def _upper_bound(chunk, box):
    """ub (warps, 128): the chunk's bbox distances' upper bound over each
    warp's rectangle, rounded as the kernels round it."""
    col0, col1, row0, row1 = (t[:, None] for t in box)
    return torch.minimum(torch.minimum(col1 - chunk[15], chunk[16] - col0),
                         torch.minimum(row1 - chunk[17], chunk[18] - row0))


def _walk(coeffs, active_blocks, h, w, visit):
    """The chunk walk both kernels share: for each view and chunk in order,
    the warps of the blocks that test it, the chunk's rows 0-18 and the
    warps' rectangles; ``visit(v, c, warps, chunk, box, live)`` tests them.
    ``active_blocks(v, c)`` is the blocks' chunk test."""
    n, _, f_pad = coeffs.shape
    col0, col1, row0, row1, live = _warps(h, w)
    per_block = BLOCK // WARP
    for v in range(n):
        for c in range(f_pad // kr.FACE_CHUNK):
            act = active_blocks(v, c).repeat_interleave(per_block)
            warps = torch.nonzero(act).reshape(-1)
            if not len(warps):
                continue
            chunk = coeffs[v, :kr.SOFT_ROWS,
                           c * kr.FACE_CHUNK:(c + 1) * kr.FACE_CHUNK]
            box = (col0[warps], col1[warps], row0[warps], row1[warps])
            visit(v, c, warps, chunk, box, live[warps])


def corner_max(a, b, c, box):
    """The largest value of affine(px, py, a, b, c) over each warp's
    rectangle, (warps, faces), rounded as the kernel rounds it: the value at
    the corner the signs of a and b pick."""
    col0, col1, row0, row1 = (t[:, None] for t in box)
    cx = torch.where(a >= 0, col1, col0)
    cy = torch.where(b >= 0, row1, row0)
    return cx * a + cy * b + c


def corner_keep(chunk, box, s_w, depth=True):
    """(warps, 128): the faces the corner rule keeps as candidates for the
    covering face, rows 0-11 of ``chunk`` over each warp's rectangle with
    s_w (warps,) its least best 1/z (``depth=False``: the barycentrics'
    corners only)."""
    drop = ((corner_max(chunk[0], chunk[1], chunk[2], box) < 0)
            | (corner_max(chunk[3], chunk[4], chunk[5], box) < 0)
            | (corner_max(chunk[6], chunk[7], chunk[8], box) < 0))
    if depth:
        drop |= corner_max(chunk[9], chunk[10], chunk[11], box) <= s_w[:,
                                                                       None]
    return ~drop


def warp_least(vals, n_warps, hw):
    """(n_warps,): the least of the per-pixel ``vals`` (H*W,) over each
    warp's pixels in the frame."""
    pad = torch.full((n_warps * WARP - hw,), 3.0e38)
    return torch.cat([vals, pad]).reshape(n_warps, WARP).amin(1)


def _pixels(warps, keep, hw):
    """Flat pixels (in the frame) of ``warps`` and each one's row of the
    warp's keep mask."""
    pix = (warps[:, None] * WARP + torch.arange(WARP)).reshape(-1)
    kp = keep.repeat_interleave(WARP, dim=0)
    inside = pix < hw
    return pix[inside], kp[inside]


def soft_walk(coeffs, bounds, h, w, margin, tile, active=None):
    """K1-soft's walk: (p2f, zbuf, nearest) (N, H*W) as ``raster_soft``
    returns them, and the (pixel, face) pairs of the warps' lists.
    ``active`` (N, blocks, chunks): the blocks' chunk test, by default the
    row band widened by ``margin`` on ``tile``-pixel bands."""
    n = coeffs.shape[0]
    hw = h * w
    flat = torch.arange(hw)
    px, py = (flat % w).float(), (flat // w).float()
    if active is None:
        band = kr._band_overlap(bounds, h, w, tile, margin)
        active = band[:, torch.arange(0, hw, BLOCK) // tile]
    n_warps = len(_warps(h, w)[4])
    best = torch.zeros((n, hw))
    fid = torch.full((n, hw), -1, dtype=torch.int64)
    sbest = torch.full((n, hw), kr.NEG_INIT)
    sid = torch.zeros((n, hw), dtype=torch.int64)
    tested = [0]

    def visit(v, c, warps, chunk, box, live):
        s_hard = warp_least(best[v], n_warps, hw)[warps]
        s_near = warp_least(sbest[v], n_warps, hw)[warps]
        cover = corner_keep(chunk, box, s_hard)
        keep = cover | ~(_upper_bound(chunk, box) <= s_near[:, None])
        tested[0] += int((keep.sum(1) * live).sum())
        pix, kp = _pixels(warps, keep, hw)
        hp = _pixels(warps, cover, hw)[1]
        x, y = px[pix, None], py[pix, None]
        b0, b1, b2, iz, d = kr._chunk_planes(chunk, x, y, soft=True)
        bb = torch.minimum(torch.minimum(x - chunk[15], chunk[16] - x),
                           torch.minimum(y - chunk[17], chunk[18] - y))
        # A listed face the corner rule dropped is skipped where its bbox
        # distance is <= the pixel's best (the kernel compares with the
        # running best, which skips more).
        use = kp & ~(~hp & (bb <= sbest[v, pix, None]))
        covered = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
        # What the proof says of a pair left out, on this data: it cannot
        # win the covering face, and is no nearer than the pixel's best.
        assert not (covered & (iz > best[v, pix, None]) & ~use).any()
        assert not ((d > sbest[v, pix, None]) & ~use).any()
        mz = torch.where(covered & use, iz, torch.full_like(iz, -1.0))
        cmax, carg = torch.max(mz, dim=1)
        better = cmax > best[v, pix]
        fid[v, pix] = torch.where(better, c * kr.FACE_CHUNK + carg,
                                  fid[v, pix])
        best[v, pix] = torch.maximum(best[v, pix], cmax)
        smax, sarg = torch.max(torch.where(use, d, torch.full_like(
            d, kr.NEG_INIT)), dim=1)
        sbetter = smax > sbest[v, pix]
        sid[v, pix] = torch.where(sbetter, c * kr.FACE_CHUNK + sarg,
                                  sid[v, pix])
        sbest[v, pix] = torch.maximum(sbest[v, pix], smax)

    _walk(coeffs, lambda v, c: active[v, :, c], h, w, visit)
    hit = best > 0.0
    p2f = torch.where(hit, fid, torch.full_like(fid, -1)).int()
    zbuf = torch.where(hit, 1.0 / torch.clamp(best, min=1e-12),
                       torch.full_like(best, kr.BIG_Z))
    return p2f, zbuf, sid.int(), tested[0]


def topk_walk(coeffs, bounds, h, w, k, window):
    """K7's walk: ids (N, H*W, K) as ``raster_topk`` returns them, and the
    (pixel, face) pairs of the warps' lists."""
    n = coeffs.shape[0]
    hw = h * w
    flat = torch.arange(hw)
    px, py = (flat % w).float(), (flat // w).float()
    band = kr._band_overlap(bounds, h, w, BLOCK, window + 2.0)
    slot_s = torch.full((n, hw, k), kr.NEG_INIT)
    slot_i = torch.full((n, hw, k), -1, dtype=torch.int64)
    tested = [0]

    def visit(v, c, warps, chunk, box, live):
        keep = ~(_upper_bound(chunk, box) <= -window)
        tested[0] += int((keep.sum(1) * live).sum())
        pix, kp = _pixels(warps, keep, hw)
        _, _, _, iz, d = kr._chunk_planes(chunk, px[pix, None],
                                          py[pix, None], soft=True)
        eligible = d > -window
        assert not (eligible & ~kp).any()   # dropped pairs: all ineligible
        mz = torch.where(eligible & kp, iz, torch.full_like(iz, kr.NEG_INIT))
        cs, ci = torch.sort(mz, dim=1, descending=True, stable=True)
        ss, si = slot_s[v, pix], slot_i[v, pix]
        for e in range(min(k, kr.FACE_CHUNK)):
            kr._insert(ss, si, cs[:, e], c * kr.FACE_CHUNK + ci[:, e])
        slot_s[v, pix], slot_i[v, pix] = ss, si

    _walk(coeffs, lambda v, c: band[v, :, c], h, w, visit)
    ids = torch.where(slot_s > -1.0e38, slot_i, torch.full_like(slot_i, -1))
    return ids.int(), tested[0]


def every_face_pairs(bounds, h, w, tile, margin):
    """(pixel, face) pairs the earlier walk tests: every face of every chunk
    in band, at every pixel of the blocks that test it."""
    hw = h * w
    band = kr._band_overlap(bounds, h, w, tile, margin).long()
    starts = torch.arange(0, hw, BLOCK)
    live = (hw - starts).clamp(max=BLOCK)
    per_block = band[:, starts // tile, :].sum(dim=(0, 2))
    return int((per_block * live).sum()) * kr.FACE_CHUNK


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

SCENES = ("pristine", "stretched", "padded48")


def _scene_faces(name):
    """(faces (2, F, 3, 3) float32 numpy, size) of each scene, projected by
    the JAX package."""
    import jax.numpy as jnp

    from st3d.core import cameras as jcams
    from st3d.core.primitives import ico_sphere as jax_ico_sphere
    from st3d.render.rasterize import face_verts_screen as jax_fvs

    m = jax_ico_sphere(level=3)
    verts, faces = np.asarray(m.verts), np.asarray(m.faces)
    size, cams = 64, jcams.build_fixed_cameras(2, seed=0)
    if name == "stretched":
        # 4% of the vertices thrown by 0.6 radii, seen from 1.6 radii so
        # the sphere fills the frame (test_torch_stream_walk.py's faces).
        rng = np.random.RandomState(3)
        moved = rng.rand(verts.shape[0]) < 0.04
        verts = verts + (rng.randn(*verts.shape) * 0.6 * moved[:, None]
                         ).astype(np.float32)
        cams = jcams.build_fixed_cameras(2, dist=1.6, seed=2)
    elif name == "padded48":
        size, faces = 48, faces[:1203]          # 10 chunks, 77 padding faces
    fv = jax_fvs(jnp.asarray(verts), jnp.asarray(faces), cams, size)
    return np.asarray(fv), size


# Slivers just above AREA_EPS along pixel rows (x, y) and columns (y, x),
# in front of everything, whose rounded barycentrics are all >= 0 at pixels
# well outside their bbox: the row ones 10 or more columns past it, in the
# next warp's columns; the column ones at rows past their chunk's row band.
SLIVERS = (
    ((22.77745819091797, 15.0), (12.909951210021973, 15.0),
     (12.909951210021973, 15.000000953674316)),
    ((15.191388130187988, 31.0), (24.932754516601562, 31.0),
     (15.980325698852539, 31.000001907348633)),
    ((56.0, 22.443363189697266), (56.0, 12.700395584106445),
     (55.999996185302734, 13.138782501220703)),
    ((30.0, 20.952367782592773), (30.0, 11.357259750366211),
     (29.999998092651367, 11.357259750366211)),
    ((48.0, 44.425384521484375), (48.0, 36.46713638305664),
     (48.000003814697266, 36.46713638305664)),
    ((50.0, 46.67629623413086), (50.0, 39.57001495361328),
     (49.999996185302734, 40.174949645996094)),
    ((5.0, 45.613494873046875), (5.0, 37.85993576049805),
     (5.000000476837158, 37.85993576049805)),
)


def sliver_faces():
    """(faces (2, F, 3, 3) float32 numpy, 64): the level-3 sphere's two
    views, behind them two faces that fill the frame (so every tile's chunk
    range starts at chunk 0), and ``SLIVERS`` at depth 0.5. The port
    projects the sphere, so the CUDA tests can build the scene on a machine
    without JAX."""
    from st3d_torch.core.cameras import build_fixed_cameras
    from st3d_torch.core.primitives import ico_sphere
    from st3d_torch.render.rasterize import face_verts_screen

    mesh = ico_sphere(level=3)
    size = 64
    fv = face_verts_screen(mesh.verts, mesh.faces,
                           build_fixed_cameras(2, seed=0), size).numpy()
    rows = [[[0.0, 0.0, 40.0], [63.0, 0.0, 40.0], [0.0, 63.0, 40.0]],
            [[63.0, 0.0, 40.0], [63.0, 63.0, 40.0], [0.0, 63.0, 40.0]]]
    rows += [[[x, y, 0.5] for x, y in sliver] for sliver in SLIVERS]
    extra = np.asarray(rows, dtype=np.float32)[None]
    return (np.concatenate([fv, np.repeat(extra, fv.shape[0], 0)], axis=1),
            size)


@pytest.fixture(scope="module")
def scenes():
    out = {name: _scene_faces(name) for name in SCENES}
    out["slivers"] = sliver_faces()
    return out


def _prep(fv):
    coeffs, bounds, order = kr.preprocess(torch.tensor(fv))
    return coeffs, bounds, order


def _soft_scores(fv, ids, size):
    """Gated signed distance of faces ``ids`` (N, H*W) at their pixels."""
    coeffs = kr.face_coeffs(torch.tensor(fv))
    flat = torch.arange(size * size)
    px, py = (flat % size).float()[:, None], (flat // size).float()[:, None]
    out = []
    for v in range(fv.shape[0]):
        sd = kr._chunk_planes(coeffs[v, :19], px, py, soft=True)[4]
        idx = torch.tensor(ids[v].reshape(-1, 1)).long()
        out.append(torch.gather(sd, 1, idx).reshape(-1).numpy())
    return np.stack(out)


# ---------------------------------------------------------------------------
# K1-soft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [1.0, 1.5])
@pytest.mark.parametrize("scene", SCENES + ("slivers",))
def test_soft_walk_equals_the_plain_version(scenes, scene, sigma):
    """Bit for bit, p2f, zbuf and nearest; on the pristine sphere the lists
    hold fewer pairs than the earlier walk tests."""
    fv, size = scenes[scene]
    coeffs, bounds, _ = _prep(fv)
    if scene == "padded48":
        assert coeffs.shape[2] > fv.shape[1] and size % WARP
    margin = kr.soft_cull_margin(sigma)
    tile = kr.cull_tile(size, size, True)
    *got, tested = soft_walk(coeffs, bounds, size, size, margin, tile)
    want = kr.raster_soft_plain(coeffs, bounds, size, size, margin, tile)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    every = every_face_pairs(bounds, size, size, tile, margin)
    assert 0 < tested <= every
    if scene == "pristine":
        assert tested < every


@pytest.mark.parametrize("sigma", [1.0, 1.5])
@pytest.mark.parametrize("scene", SCENES)
def test_soft_walk_matches_pallas(scenes, scene, sigma):
    """Against ``rasterize_pallas_batched(soft=True)`` in interpret mode, in
    mesh ids (the JAX tile where it divides the frame, else 256 pixels, as
    ``cull_tile``): pix_to_face equal, zbuf within rtol 1e-4 (F4), nearest
    equal but at near-ties of the gated distance (F4, F7)."""
    import jax.numpy as jnp

    from st3d.kernels.raster_pallas import rasterize_pallas_batched

    fv, size = scenes[scene]
    coeffs, bounds, order = _prep(fv)
    tile = kr.cull_tile(size, size, True)
    p2f, zbuf, near, _ = soft_walk(coeffs, bounds, size, size,
                                   kr.soft_cull_margin(sigma), tile)
    j = rasterize_pallas_batched(jnp.asarray(fv), size, soft=True,
                                 soft_sigma_px=sigma, tile_pixels_max=tile)
    np.testing.assert_array_equal(
        kr._to_mesh_ids(order, p2f).numpy(),
        np.asarray(j.pix_to_face).reshape(fv.shape[0], -1))
    np.testing.assert_allclose(zbuf.numpy(),
                               np.asarray(j.zbuf).reshape(fv.shape[0], -1),
                               rtol=1e-4)
    got = kr._to_mesh_ids(order, near).numpy()
    want = np.asarray(j.nearest_face).reshape(got.shape)
    diff = got != want
    if diff.any():
        a, b = _soft_scores(fv, got, size), _soft_scores(fv, want, size)
        gap = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert gap[diff].max() <= TIE
    assert diff.mean() <= 0.05


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

WINDOWS = {"softras": 3.0, "blur": blur_window_px(1e-4, 64)}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("scene", SCENES + ("slivers",))
def test_topk_walk_equals_the_plain_version(scenes, scene, k, window):
    """Bit for bit; on the pristine sphere the lists hold fewer pairs than
    the earlier walk tests."""
    fv, size = scenes[scene]
    coeffs, bounds, _ = _prep(fv)
    win = WINDOWS[window]
    got, tested = topk_walk(coeffs, bounds, size, size, k, win)
    want = kr.raster_topk_plain(coeffs, bounds, size, size, k, win)
    assert torch.equal(got, want)
    assert (got[..., 0] >= 0).any()
    every = every_face_pairs(bounds, size, size, BLOCK, win + 2.0)
    assert 0 < tested <= every
    if scene == "pristine":
        assert tested < every


def _assert_topk_close(fv, got, want, size, window):
    """``got`` equals ``want`` (N, H*W, K mesh ids) but where the slots
    differ at near-ties (F4): both faces' raw 1/z within TIE of each other,
    or a face's gated distance within TIE of -window (eligible on one side
    only); such pixels stay few."""
    coeffs = kr.face_coeffs(torch.tensor(fv))
    diff = (got != want).any(-1)
    for v, p in np.argwhere(diff):
        px = torch.tensor([[float(p % size)]])
        py = torch.tensor([[float(p // size)]])

        def score(f):
            if f < 0:
                return None
            _, _, _, iz, d = kr._chunk_planes(coeffs[v, :19, f:f + 1], px,
                                              py, soft=True)
            return float(iz), float(d)

        for a, b in zip(got[v, p], want[v, p]):
            if a == b:
                continue
            sa, sb = score(a), score(b)
            edge = [abs(s[1] + window) <= TIE * max(abs(s[1]), 1.0)
                    for s in (sa, sb) if s is not None]
            tie = (sa is not None and sb is not None and abs(sa[0] - sb[0])
                   <= TIE * max(abs(sa[0]), 1.0))
            assert tie or any(edge), (v, p, a, b, sa, sb)
    assert diff.mean() <= 0.01


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("k", [1, 4, 5])
@pytest.mark.parametrize("scene", ["pristine", "stretched"])
def test_topk_walk_matches_pallas(scenes, scene, k, window):
    """Against ``rasterize_pallas_topk`` in interpret mode, in mesh ids:
    equal but at near-ties of raw 1/z or of the window (F4: a handful of
    the 8,192 pixels on these level-3 faces; its 1024-pixel tiles need a
    frame they divide, so 64², not 48²)."""
    import jax.numpy as jnp

    from st3d.kernels.raster_pallas import rasterize_pallas_topk

    fv, size = scenes[scene]
    coeffs, bounds, order = _prep(fv)
    win = WINDOWS[window]
    ids, _ = topk_walk(coeffs, bounds, size, size, k, win)
    got = kr._to_mesh_ids(order, ids.reshape(fv.shape[0], -1)).numpy()
    want = np.asarray(rasterize_pallas_topk(jnp.asarray(fv), size, k, win))
    _assert_topk_close(fv, got.reshape(fv.shape[0], -1, k),
                       want.reshape(fv.shape[0], -1, k), size, win)


def test_twins_and_counters_take_the_plain_versions_on_the_cpu(scenes):
    """On CPU tensors the new wrappers and their twins return the plain
    versions: nothing launches and ``tested`` stays as it was."""
    fv, size = scenes["padded48"]
    coeffs, bounds, _ = _prep(fv)
    margin, tile = kr.soft_cull_margin(1.0), kr.cull_tile(size, size, True)
    tested = torch.zeros(1, dtype=torch.int64)
    before = dict(kr.LAUNCHES)
    want = kr.raster_soft_plain(coeffs, bounds, size, size, margin, tile)
    for got in (kr.raster_soft(coeffs, bounds, size, size, margin, tile,
                               tested),
                kr.raster_soft_every_face(coeffs, bounds, size, size, margin,
                                          tile)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    want = kr.raster_topk_plain(coeffs, bounds, size, size, 4, 3.0)
    assert torch.equal(kr.raster_topk(coeffs, bounds, size, size, 4, 3.0,
                                      tested), want)
    assert torch.equal(kr.raster_topk_every_face(coeffs, bounds, size, size,
                                                 4, 3.0), want)
    assert int(tested) == 0 and kr.LAUNCHES == before
