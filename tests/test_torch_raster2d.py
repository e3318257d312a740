"""st3d_torch's 2D-tiled visibility (K9: ``preprocess_2d`` and kernel G's
plain version) against the JAX package's ``_rasterize_pallas2d_impl`` in
interpret mode and against the port's K1, on the same NumPy screen
vertices: an ico-sphere under two fixed views at 64².

pix_to_face must equal the JAX kernel's exactly. zbuf is held at rtol 1e-4
(ROADMAP F4: XLA:CPU contracts the jitted plane coefficients into FMAs,
which moves 1/z by up to ~5e-5 relative; the port evaluates the op-by-op
planes). Against K1 the two may differ only at exact 1/z ties, where K9
keeps the lowest Morton-sorted face and K1 the lowest y-sorted one.
``morton_order``'s order by all 10 bits (ROADMAP F9) is held to the same
zbuf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d.core.cameras import build_fixed_cameras as jax_fixed_cameras
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.kernels.raster_pallas import _morton_codes, _rasterize_pallas2d_impl
from st3d.render.rasterize import face_verts_screen as jax_face_verts_screen

from st3d_torch import morton_order
from st3d_torch.kernels import raster as kraster

SIZE = 64


@pytest.fixture(scope="module", params=[2, 3])
def jax_fv(request):
    mesh = jax_ico_sphere(level=request.param)
    cams = jax_fixed_cameras(2, seed=0)
    return np.asarray(jax_face_verts_screen(mesh.verts, mesh.faces, cams,
                                            SIZE))


def test_morton_codes_match_jax():
    rng = np.random.RandomState(0)
    cx = (rng.rand(500) * 80.0 - 8.0).astype(np.float32)    # some off-screen
    cy = (rng.rand(500) * 80.0 - 8.0).astype(np.float32)
    want = np.asarray(_morton_codes(jnp.asarray(cx), jnp.asarray(cy),
                                    float(SIZE)))
    got = kraster.morton_codes(torch.tensor(cx), torch.tensor(cy),
                               float(SIZE)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 400


def test_preprocess_2d_orders_and_bounds(jax_fv):
    fv = torch.tensor(jax_fv)
    coeffs, bounds, order = kraster.preprocess_2d(fv, SIZE)
    n, f = fv.shape[:2]
    n_chunks = -(-f // kraster.FACE_CHUNK)
    assert coeffs.shape == (n, 20, n_chunks * kraster.FACE_CHUNK)
    assert bounds.shape == (n, 4, n_chunks)
    xs, ys = jax_fv[..., 0], jax_fv[..., 1]
    cx = (xs.min(axis=2) + xs.max(axis=2)) * 0.5
    cy = (ys.min(axis=2) + ys.max(axis=2)) * 0.5
    codes = kraster.morton_codes(torch.tensor(cx), torch.tensor(cy),
                                 float(SIZE)).numpy()
    sorted_codes = np.take_along_axis(codes, order.numpy(), axis=1)
    assert np.all(np.diff(sorted_codes, axis=1) >= 0)
    for v in range(n):
        o = order[v].numpy()
        first = slice(0, kraster.FACE_CHUNK)
        np.testing.assert_array_equal(
            bounds[v, :, 0].numpy(),
            [ys[v, o[first]].min(), ys[v, o[first]].max(),
             xs[v, o[first]].min(), xs[v, o[first]].max()])
    # Padding faces never cover a pixel.
    assert torch.all(coeffs[:, 2, f:] == -1.0e9)


def test_invalid_faces_sort_last():
    fv = torch.tensor([
        [[0.0, 0.0, -1.0], [30.0, 0.0, 2.0], [0.0, 30.0, 2.0]],   # behind
        [[3.0, 3.0, 2.0], [9.0, 9.0, 2.0], [6.0, 6.0, 2.0]],       # degenerate
        [[40.0, 40.0, 2.0], [60.0, 40.0, 2.0], [40.0, 60.0, 2.0]],
    ])[None]
    _, bounds, order = kraster.preprocess_2d(fv, SIZE)
    assert order[0, 0] == 2
    assert bounds[0, :, 0].tolist() == [40.0, 60.0, 40.0, 60.0]


def test_pix_to_face_equals_pallas2d(jax_fv):
    """Exactly the JAX kernel's ids (its face_chunk 32 and 8 x 64 tiles
    against the port's 128 and 16 x 16); zbuf within rtol 1e-4 (F4)."""
    want = _rasterize_pallas2d_impl(jnp.asarray(jax_fv), SIZE, 32, True)
    p2f, zbuf = kraster.rasterize_2d_batched(torch.tensor(jax_fv), SIZE)
    p2f = p2f.numpy()
    assert p2f.dtype == np.int32 and p2f.shape == (2, SIZE, SIZE)
    assert (p2f >= 0).mean() > 0.1
    np.testing.assert_array_equal(p2f, np.asarray(want.pix_to_face))
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(want.zbuf),
                               rtol=1e-4)


def test_equals_k1_except_at_exact_ties(jax_fv):
    """Against the port's K1: zbuf bit-equal, and where the ids differ both
    faces cover the pixel with bit-equal 1/z."""
    fv = torch.tensor(jax_fv)
    p2f, zbuf = kraster.rasterize_2d_batched(fv, SIZE)
    p_k1, z_k1 = kraster.rasterize_batched(fv, SIZE)
    assert torch.equal(zbuf, z_k1)
    v, y, x = torch.nonzero(p2f != p_k1, as_tuple=True)
    planes = kraster.face_coeffs(fv)                  # (N, 20, F), mesh order
    for ids in (p2f[v, y, x], p_k1[v, y, x]):
        blk = planes[v, :, ids.long()]                # (M, 20)
        px, py = x.float(), y.float()
        b = [px * blk[:, r] + py * blk[:, r + 1] + blk[:, r + 2]
             for r in (0, 3, 6, 9)]
        assert bool(torch.all((b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)))
        assert torch.equal(1.0 / b[3], zbuf[v, y, x])


def test_exact_ties_go_to_the_first_sorted_face():
    """Two faces with the same planes: the lower Morton-sorted one wins in
    every chunk layout, as K9's first-max rule gives."""
    coeffs = torch.zeros(1, 20, 256)
    coeffs[0, 2] = -1.0e9                              # padding never covers
    plane = torch.tensor([0.0, 0.0, 1.0] * 3 + [0.0, 0.0, 0.5])
    for f in (5, 200):                                 # chunks 0 and 1
        coeffs[0, :12, f] = plane
    bounds = torch.tensor([[[0.0, 0.0], [15.0, 15.0], [0.0, 0.0],
                            [15.0, 15.0]]])
    p2f, zbuf = kraster.raster_2d(coeffs, bounds, 16, 16)
    assert torch.all(p2f == 5) and torch.all(zbuf == 2.0)
    assert kraster.LAUNCHES["raster_2d"] == 0


def test_cull_skips_chunks_off_the_tile():
    """A chunk whose x range misses every tile is never tested, in the plain
    version as in the kernel, even though its rows meet them."""
    fv = torch.tensor([[[2.0, 2.0, 2.0], [30.0, 4.0, 2.0],
                        [6.0, 28.0, 2.0]]])[None]
    coeffs, bounds, _ = kraster.preprocess_2d(fv, 32)
    p2f, _ = kraster.raster_2d(coeffs, bounds, 32, 32)
    assert (p2f >= 0).any()
    far = bounds.clone()
    far[:, 2], far[:, 3] = 1.0e6, 2.0e6
    p2f, zbuf = kraster.raster_2d(coeffs, far, 32, 32)
    assert torch.all(p2f == -1) and torch.all(zbuf == kraster.BIG_Z)


def test_wrapper_rejects_bad_bounds():
    with pytest.raises(ValueError):
        kraster.raster_2d(torch.zeros(1, 20, 128), torch.zeros(1, 2, 1), 8, 8)


def test_full_spread_codes_agree_below_256_units():
    """``morton_order.full_spread_codes`` spreads all 10 bits; on centres
    whose quantised coordinates fit in 8 bits it equals ``morton_codes``,
    and past them it stops repeating (ROADMAP F9)."""
    rng = np.random.RandomState(1)
    cx = torch.tensor(rng.rand(500) * SIZE / 4, dtype=torch.float32)
    cy = torch.tensor(rng.rand(500) * SIZE / 4, dtype=torch.float32)
    full = morton_order.full_spread_codes(cx, cy, float(SIZE))
    assert torch.equal(full, kraster.morton_codes(cx, cy, float(SIZE)))
    far = morton_order.full_spread_codes(cx + SIZE / 4, cy, float(SIZE))
    assert torch.equal(kraster.morton_codes(cx + SIZE / 4, cy, float(SIZE)),
                       full)
    assert not torch.equal(far, full) and int(far.max()) < 2 ** 30


def test_full_spread_order_keeps_zbuf_and_culls_more(jax_fv):
    """G's plain version on the full-spread order: the same zbuf as on the
    reference's, ids apart only at exact ties, and fewer (tile, chunk)
    pairs left by the 2D cull."""
    fv = torch.tensor(jax_fv)
    c_ref, b_ref, _ = kraster.preprocess_2d(fv, SIZE)
    c_full, b_full, order = morton_order.preprocess_full_spread(fv, SIZE)
    _, z_ref = kraster.raster_2d(c_ref, b_ref, SIZE, SIZE)
    _, z_full = kraster.raster_2d(c_full, b_full, SIZE, SIZE)
    assert torch.equal(z_full, z_ref)
    assert sorted(order[0].tolist()) == list(range(fv.shape[1]))
    assert (int(kraster.cull_2d(b_full, SIZE, SIZE).sum())
            < int(kraster.cull_2d(b_ref, SIZE, SIZE).sum()))
