"""st3d_torch visibility (kernel K1's plain version and its preprocessing)
against the JAX package: the same NumPy face vertices go through
``st3d``'s Pallas rasterizer (interpret mode off-TPU), its bruteforce
oracle, and the port. Ico-sphere level 2 at 64², two fixed views."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d.core.cameras import build_fixed_cameras as jax_fixed_cameras
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.kernels.raster_pallas import face_coeffs as jax_face_coeffs
from st3d.kernels.raster_pallas import rasterize_pallas_batched
from st3d.render.rasterize import face_verts_screen as jax_face_verts_screen
from st3d.render.rasterize import rasterize_bruteforce

from st3d_torch.core.cameras import build_fixed_cameras
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.kernels import raster as kraster
from st3d_torch.render.rasterize import (
    RasterizationSettings,
    face_verts_screen,
    rasterize_batch,
)

SIZE = 64


@pytest.fixture(scope="module")
def jax_fv():
    mesh = jax_ico_sphere(level=2)
    cams = jax_fixed_cameras(2, seed=0)
    return np.asarray(jax_face_verts_screen(mesh.verts, mesh.faces, cams,
                                            SIZE))


def test_face_verts_screen_matches_jax(jax_fv):
    mesh = ico_sphere(level=2)
    fv = face_verts_screen(mesh.verts, mesh.faces,
                           build_fixed_cameras(2, seed=0), SIZE).numpy()
    assert fv.shape == jax_fv.shape == (2, 320, 3, 3)
    np.testing.assert_allclose(fv, jax_fv, rtol=1e-6,
                               atol=1e-6 * np.abs(jax_fv).max())


def test_face_coeffs_matches_jax(jax_fv):
    """Same operations in the same order as the JAX function evaluated op
    by op: bit-equal planes."""
    got = kraster.face_coeffs(torch.tensor(jax_fv[0])).numpy()
    want = np.asarray(jax_face_coeffs(jnp.asarray(jax_fv[0])))
    assert got.shape == want.shape == (20, 320)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("views", [1, 2])
def test_pix_to_face_equals_pallas_and_bruteforce(jax_fv, views):
    fv = jax_fv[:views]
    p2f, zbuf = kraster.rasterize_batched(torch.tensor(fv), SIZE)
    pal = rasterize_pallas_batched(jnp.asarray(fv), SIZE)
    brute = jax.vmap(lambda f: rasterize_bruteforce(f, SIZE))(jnp.asarray(fv))
    p2f = p2f.numpy()
    assert p2f.dtype == np.int32 and p2f.shape == (views, SIZE, SIZE)
    assert (p2f >= 0).mean() > 0.1
    np.testing.assert_array_equal(p2f, np.asarray(pal.pix_to_face))
    np.testing.assert_array_equal(p2f, np.asarray(brute.pix_to_face))
    # zbuf: XLA:CPU contracts the jitted face_coeffs into FMAs, which moves
    # 1/z by up to ~5e-5 relative where the plane's terms cancel (the port
    # equals the op-by-op JAX planes exactly, test_face_coeffs_matches_jax).
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(pal.zbuf), rtol=1e-4)
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(brute.zbuf),
                               rtol=1e-4)


def test_preprocess_sorts_and_bounds(jax_fv):
    coeffs, bounds, order = kraster.preprocess(torch.tensor(jax_fv))
    assert coeffs.shape == (2, 20, 384) and bounds.shape == (2, 2, 3)
    ymin = jax_fv[..., 1].min(axis=2)
    sorted_ymin = np.take_along_axis(ymin, order.numpy(), axis=1)
    assert np.all(np.diff(sorted_ymin, axis=1) >= 0)
    np.testing.assert_array_equal(bounds[:, 0, 0].numpy(), sorted_ymin[:, 0])
    # Padding faces never cover a pixel.
    assert torch.all(coeffs[:, 2, 320:] == -1.0e9)


def test_rasterize_batch_is_discrete_and_hard_only(jax_fv):
    """Visibility carries no gradient in any mode; soft mode adds
    nearest_face; the hard-K modes (blur window, K > 1) keep the nearest
    slot and, like the JAX package, rasterize full frames only."""
    fv = torch.tensor(jax_fv).requires_grad_(True)
    frags = rasterize_batch(fv, RasterizationSettings(image_size=SIZE))
    assert not frags.pix_to_face.requires_grad
    assert not frags.zbuf.requires_grad
    assert frags.nearest_face is None
    for mode in (dict(soft=True), dict(faces_per_pixel=2),
                 dict(blur_radius=1e-4)):
        got = rasterize_batch(fv, RasterizationSettings(image_size=SIZE,
                                                        **mode))
        assert got.pix_to_face.shape == (2, SIZE, SIZE)
        assert not got.pix_to_face.requires_grad
        assert (got.nearest_face is not None) == ("soft" in mode)
    # K = 2 and no blur: slot 0 is the hard winner.
    k2 = rasterize_batch(fv, RasterizationSettings(image_size=SIZE,
                                                   faces_per_pixel=2))
    assert torch.equal(k2.pix_to_face, frags.pix_to_face)
    with pytest.raises(NotImplementedError):
        rasterize_batch(fv, RasterizationSettings(image_size=SIZE,
                                                  blur_radius=1e-4),
                        image_height=SIZE // 2)


def test_plain_kernel_culls_like_the_kernel(jax_fv):
    """A chunk whose row band misses a 256-pixel tile is never tested
    there, in the plain version as in the kernel."""
    coeffs, bounds, _ = kraster.preprocess(torch.tensor(jax_fv[:1]))
    far = bounds.clone()
    far[:, 0], far[:, 1] = 1.0e6, 2.0e6       # every chunk below the image
    p2f, zbuf = kraster.raster_hard(coeffs, far, SIZE, SIZE)
    assert torch.all(p2f == -1) and torch.all(zbuf == kraster.BIG_Z)
    assert kraster.LAUNCHES["raster_hard"] == 0
