"""K6's walk (``csrc/raster_stream.cu``) as a plain Python model on the
CPU, against the plain version of K6 (``raster_stream_plain``: every face of
every chunk of each tile's range) and the JAX package's streaming kernel in
interpret mode, hard and soft at 64²: on stretched faces (an ico-sphere
with seeded vertex noise large enough that chunk bands span the frame),
and on ``test_torch_soft_walk.sliver_faces``. The JAX package is imported
inside the tests that use it, so the CUDA tests can import the model on a
machine without JAX.

The model walks each 256-pixel block's [c_lo, c_hi] in chunk order as the
kernel does, every chunk of it, with K1's per-warp lists (hard:
``test_torch_hard_walk.hard_walk``'s exact corner rule; soft:
``test_torch_soft_walk.soft_walk``'s), and counts the (pixel, face) pairs
of the lists, as the kernel's ``tested`` counter does. The earlier walk
skipped the chunks whose row band misses the block's rows and the faces
whose bbox stays 1 or more from a warp's pixels; on the slivers, which
cover pixels outside their bbox and outside their chunk's band, that walk
loses pixels the plain version gives them."""

import numpy as np
import pytest
import torch

from st3d_torch.kernels import raster as kr
from test_torch_hard_walk import hard_walk
from test_torch_soft_walk import BLOCK, sliver_faces, soft_walk

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
    a face."""
    import jax.numpy as jnp

    from st3d.core import cameras as jcams
    from st3d.core.primitives import ico_sphere as jax_ico_sphere
    from st3d.render.rasterize import face_verts_screen as jax_fvs

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


def range_active(ranges, h, w, tile, n_chunks):
    """(N, blocks, chunks): chunk c is in the range of block b's tile."""
    rng = ranges[:, torch.arange(0, h * w, BLOCK) // tile]
    c = torch.arange(n_chunks)
    return (c >= rng[..., 0:1]) & (c <= rng[..., 1:2])


def walk_plain(coeffs, bounds, ranges, h, w, tile, soft, margin):
    """The kernel's walk: (p2f, zbuf, nearest or None) as ``raster_stream``
    returns them, and the (pixel, face) pairs of the warps' lists."""
    active = range_active(ranges, h, w, tile,
                          coeffs.shape[2] // kr.FACE_CHUNK)
    if soft:
        return soft_walk(coeffs, bounds, h, w, margin, tile, active)
    p2f, zbuf, tested = hard_walk(coeffs, bounds, h, w, active=active)
    return p2f, zbuf, None, tested


def walked_pairs(ranges, h, w, tile):
    """(pixel, face) pairs the TPU kernel's walk tests: every face of every
    chunk of the range, at every pixel of the block."""
    hw = h * w
    starts = torch.arange(0, hw, BLOCK)
    live = (hw - starts).clamp(max=BLOCK)
    rng = ranges[:, starts // tile]
    spans = (rng[..., 1] - rng[..., 0] + 1).clamp(min=0)
    return int((spans * live).sum()) * kr.FACE_CHUNK


def _stream_inputs(fv, soft, size=SIZE):
    coeffs, bounds, order = kr.preprocess(torch.tensor(fv))
    tile = kr.cull_tile(size, size, soft)
    margin = kr.soft_cull_margin(1.0) if soft else 0.0
    ranges = kr.stream_ranges(bounds, size, size, tile, margin)
    return coeffs, bounds, order, ranges, tile, margin


@pytest.mark.parametrize("soft", [False, True])
def test_walk_equals_the_plain_version(stretched, soft):
    """Bit for bit, on faces whose chunk bands span the frame; the lists
    hold fewer pairs than the TPU kernel's walk tests."""
    coeffs, bounds, _, ranges, tile, margin = _stream_inputs(stretched, soft)
    assert coeffs.shape[2] // kr.FACE_CHUNK >= 3
    spans = ranges[..., 1] - ranges[..., 0] + 1
    got = walk_plain(coeffs, bounds, ranges, SIZE, SIZE, tile, soft, margin)
    want = kr.raster_stream_plain(coeffs, ranges, SIZE, SIZE, tile, soft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if soft:
        assert torch.equal(got[2], want[2])
    assert 0 < got[3] < walked_pairs(ranges, SIZE, SIZE, tile)
    # The stretched faces widen the bands: most ranges reach past their
    # tile's own chunks.
    assert float(spans.float().mean()) >= 3


@pytest.mark.parametrize("soft", [False, True])
def test_walk_equals_the_plain_version_on_slivers(soft):
    """Bit for bit on the slivers, whose pixels outside their bbox (and,
    hard, outside their chunk's band) the earlier walk lost; the lists hold
    fewer pairs than the TPU kernel's walk tests."""
    fv, size = sliver_faces()
    coeffs, bounds, _, ranges, tile, margin = _stream_inputs(fv, soft, size)
    got = walk_plain(coeffs, bounds, ranges, size, size, tile, soft, margin)
    want = kr.raster_stream_plain(coeffs, ranges, size, size, tile, soft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if soft:
        assert torch.equal(got[2], want[2])
    assert 0 < got[3] < walked_pairs(ranges, size, size, tile)
    # The slivers win pixels 1 or more outside their bbox.
    cf = coeffs[:, 15:19]
    ids = got[0].long().clamp(min=0)
    box = [torch.gather(cf[:, r], 1, ids) for r in range(4)]
    flat = torch.arange(size * size)
    x, y = (flat % size).float(), (flat // size).float()
    out = torch.maximum(torch.maximum(box[0] - x, x - box[1]),
                        torch.maximum(box[2] - y, y - box[3]))
    assert ((got[0] >= 0) & (out >= 1)).sum() >= 20


def test_k1_and_k6_differ_only_past_the_band_on_slivers():
    """The JAX package's K1 tests only the chunks whose row band meets the
    block's rows, its K6 every chunk of the tile's range: on the slivers
    (hard) they part at the pixels where K6's face lies in a chunk whose
    band misses the block (``outside_band``), and there K6's face is the
    nearer one."""
    fv, size = sliver_faces()
    coeffs, bounds, _, ranges, tile, _ = _stream_inputs(fv, False, size)
    p2f, zbuf, _ = kr.raster_stream_plain(coeffs, ranges, size, size, tile,
                                          False)
    k1 = kr.raster_hard_plain(coeffs, bounds, size, size)
    diff = (p2f != k1[0]) | (zbuf != k1[1])
    assert diff.sum() >= 8
    assert torch.equal(diff, kr.outside_band(bounds, p2f, size, size))
    assert (zbuf[diff] <= k1[1][diff]).all()


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
    import jax.numpy as jnp

    from st3d.kernels.raster_pallas import rasterize_pallas_batched

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
