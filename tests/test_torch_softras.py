"""st3d_torch soft and top-K visibility and shading against the JAX package:
the plain versions of K1's soft mode, K6 (streaming) and K7 (top-K) against
``st3d``'s Pallas kernels in interpret mode; ``shade_soft``,
``shade_softras`` and ``rasterize_hard_k`` against ``st3d.render``; and
``render_rgba`` in every raster mode, values and vertex/texture gradients.
Ico-sphere level 2 (320 faces) at 64², two fixed views, float32.

Discrete selections and F4: XLA:CPU contracts the jitted ``face_coeffs``
into FMAs, so the JAX planes differ from the port's (op-by-op) planes in the
last bits. A pixel whose two best candidates are that close may pick the
other one. Such pixels are counted and bounded; everywhere else the ids are
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st3d.core import cameras as jcams
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.kernels.raster_pallas import (
    rasterize_pallas_batched,
    rasterize_pallas_topk,
)
from st3d.render import renderer as jrend
from st3d.render import soft as jsoft
from st3d.render import topk as jtopk
from st3d.render.rasterize import RasterizationSettings as JSettings
from st3d.render.rasterize import face_verts_screen as jax_fvs
from st3d.render.rasterize import rasterize_batch as jax_rasterize_batch
from st3d.render.shading import interpolate_face_attributes as jax_interp
from st3d.render.shading import recompute_barycentrics as jax_bary

from st3d_torch.convert import mesh_from_numpy
from st3d_torch.core import cameras as tcams
from st3d_torch.kernels import raster as kr
from st3d_torch.render import renderer as trend
from st3d_torch.render import shading as tshade
from st3d_torch.render import soft as tsoft
from st3d_torch.render import topk as ttopk
from st3d_torch.render.rasterize import RasterizationSettings

SIZE = 64
# Near-tie scale of a discrete selection: two candidates whose scores (in
# pixels, or 1/z) differ by less than this, relative to max(|score|, 1),
# may swap under F4.
TIE = 2e-5

MODES = {
    "hard": {},
    "soft": {"soft": True},
    "softras": {"soft": True, "faces_per_pixel": 4},
    "blur": {"blur_radius": 4e-4, "faces_per_pixel": 2},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's default thread pool would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    jm = jax_ico_sphere(level=2)
    tex = np.random.RandomState(0).rand(24, 20, 3).astype(np.float32)
    jm = jm.replace(texture=jnp.asarray(tex))
    tm = mesh_from_numpy(jm.verts, jm.faces, jm.verts_uvs, jm.faces_uvs, tex)
    jc = jcams.build_fixed_cameras(2, seed=0)
    tc = tcams.FoVPerspectiveCameras.create(R=np.asarray(jc.R),
                                            T=np.asarray(jc.T))
    fv = np.asarray(jax_fvs(jm.verts, jm.faces, jc, SIZE))
    return jm, tm, jc, tc, fv


def _soft_scores(fv, ids):
    """Gated signed distance (the soft kernels' score) of faces ``ids``
    (N, H, W) at their pixels, from the port's planes."""
    n = fv.shape[0]
    coeffs = kr.face_coeffs(torch.tensor(fv))              # (N, 20, F)
    flat = torch.arange(SIZE * SIZE)
    px = (flat % SIZE).float()[:, None]
    py = (flat // SIZE).float()[:, None]
    out = []
    for v in range(n):
        sd = kr._chunk_planes(coeffs[v, :19], px, py, soft=True)[4]
        idx = torch.tensor(ids[v].reshape(-1, 1)).long()
        out.append(torch.gather(sd, 1, idx).reshape(SIZE, SIZE).numpy())
    return np.stack(out)


def _assert_nearest_close(fv, got, want, max_share=0.05):
    """``got`` equals ``want`` except at near-ties of the gated signed
    distance; returns the number of differing pixels."""
    diff = got != want
    if diff.any():
        a, b = _soft_scores(fv, got), _soft_scores(fv, want)
        gap = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert gap[diff].max() <= TIE, gap[diff].max()
    assert diff.mean() <= max_share
    return int(diff.sum())


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_soft_raster_matches_pallas(scene, sigma):
    """K1's soft mode (plain version): pix_to_face equal to the Pallas
    kernel's, zbuf within rtol 1e-4 (F4), nearest_face equal except at
    near-ties (here about 4% of the pixels, all more than 8 px outside the
    sphere, where the gated distances of neighbouring faces tie)."""
    *_, fv = scene
    p2f, zbuf, near = kr.rasterize_batched_soft(torch.tensor(fv), SIZE,
                                                sigma)
    j = rasterize_pallas_batched(jnp.asarray(fv), SIZE, soft=True,
                                 soft_sigma_px=sigma)
    np.testing.assert_array_equal(p2f.numpy(), np.asarray(j.pix_to_face))
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(j.zbuf), rtol=1e-4)
    _assert_nearest_close(fv, near.numpy(), np.asarray(j.nearest_face))
    assert (near.numpy() >= 0).all()


@pytest.mark.parametrize("soft", [False, True])
def test_stream_matches_pallas_stream(scene, soft):
    """K6 (plain version, forced) against the JAX streaming kernel."""
    *_, fv = scene
    fvt, fvj = torch.tensor(fv), jnp.asarray(fv)
    j = rasterize_pallas_batched(fvj, SIZE, soft=soft, stream=True)
    if soft:
        p2f, zbuf, near = kr.rasterize_batched_soft(fvt, SIZE, stream=True)
        _assert_nearest_close(fv, near.numpy(), np.asarray(j.nearest_face))
    else:
        p2f, zbuf = kr.rasterize_batched(fvt, SIZE, stream=True)
    np.testing.assert_array_equal(p2f.numpy(), np.asarray(j.pix_to_face))
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(j.zbuf), rtol=1e-4)


@pytest.mark.parametrize("soft", [False, True])
def test_stream_equals_resident(soft):
    """K6 and K1 (plain versions) on the same 1,280 faces (10 chunks):
    pix_to_face, zbuf and nearest_face bit-equal."""
    m = jax_ico_sphere(level=3)
    fv = torch.tensor(np.asarray(jax_fvs(
        m.verts, m.faces, jcams.build_fixed_cameras(3, seed=2), SIZE)))
    if soft:
        res = kr.rasterize_batched_soft(fv, SIZE, 2.0, stream=False)
        strm = kr.rasterize_batched_soft(fv, SIZE, 2.0, stream=True)
    else:
        res = kr.rasterize_batched(fv, SIZE, stream=False)
        strm = kr.rasterize_batched(fv, SIZE, stream=True)
    for a, b in zip(strm, res):
        assert torch.equal(a, b)


def test_stream_dispatch_follows_the_resident_budget():
    """The JAX package's rule: stream when the (20, F) float32
    coefficients pass 7 MiB (81,920 faces stay resident, 327,680 stream)."""
    assert not kr.use_stream(81920)
    assert kr.use_stream(327680)
    assert kr.RESIDENT_COEFF_BUDGET == 7 * 1024 * 1024


def test_stream_ranges_cover_the_overlapping_chunks(scene):
    *_, fv = scene
    coeffs, bounds, _ = kr.preprocess(torch.tensor(fv))
    ranges = kr.stream_ranges(bounds, SIZE, SIZE, 256, 0.0)
    ov = kr._band_overlap(bounds, SIZE, SIZE, 256, 0.0)
    assert ranges.dtype == torch.int32 and ranges.shape == (2, 16, 2)
    for v in range(2):
        for t in range(16):
            hit = torch.nonzero(ov[v, t]).reshape(-1)
            lo, hi = ranges[v, t].tolist()
            if len(hit):
                assert (lo, hi) == (int(hit[0]), int(hit[-1]))
            else:
                assert (lo, hi) == (1, 0)


@pytest.mark.parametrize("k,window", [(4, 3.0), (5, 0.32), (1, 3.0)])
def test_topk_matches_pallas(scene, k, window):
    """K7 (plain version) against the JAX top-K kernel: ids equal (no
    near-tie of raw 1/z separates them at these shapes)."""
    *_, fv = scene
    got = kr.rasterize_topk_batched(torch.tensor(fv), SIZE, k, window)
    want = rasterize_pallas_topk(jnp.asarray(fv), SIZE, k, window)
    assert got.shape == (2, SIZE, SIZE, k) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[..., 0] >= 0).float().mean() > 0.2


def test_topk_ties_keep_lower_id_in_front(scene):
    """Every face twice: equal scores, and the lower id stays in front,
    as in the JAX kernel."""
    *_, fv = scene
    dup = np.concatenate([fv, fv], axis=1)
    got = kr.rasterize_topk_batched(torch.tensor(dup), SIZE, 4, 2.0).numpy()
    want = np.asarray(rasterize_pallas_topk(jnp.asarray(dup), SIZE, 4, 2.0))
    np.testing.assert_array_equal(got, want)
    f = fv.shape[1]
    pair = (got[..., 0] >= 0) & (got[..., 1] == got[..., 0] + f)
    assert pair.mean() > 0.2
    assert (got[..., 0][got[..., 0] >= 0] < f).all()


def test_topk_insertion_is_the_tpu_kernels(scene):
    """The slot walk swaps wherever the carried entry is strictly
    greater, so an entry displaced onto an equal slot skips it: slots
    [5, 5, 3] take 6 as [6, 5b, 5a] (the TPU kernel's order, not a stable
    sort's)."""
    ss = torch.tensor([[5.0, 5.0, 3.0]])
    si = torch.tensor([[10, 11, 12]])
    kr._insert(ss, si, torch.tensor([6.0]), torch.tensor([13]))
    assert ss.tolist() == [[6.0, 5.0, 5.0]]
    assert si.tolist() == [[13, 11, 10]]


def test_signed_distance_and_barycentrics_match_jax(scene):
    *_, fv = scene
    ids = np.random.RandomState(3).randint(0, fv.shape[1], (2, SIZE, SIZE))
    fvt = torch.tensor(fv)
    idt = torch.tensor(ids)
    for v in range(2):
        sd = jsoft.signed_distance_to_faces(jnp.asarray(fv[v]),
                                            jnp.asarray(ids[v]))
        np.testing.assert_allclose(
            tsoft.signed_distance_to_faces(fvt, idt)[v].numpy(),
            np.asarray(sd), rtol=1e-5, atol=1e-4)
        b = jax_bary(jnp.asarray(fv[v]), jnp.asarray(ids[v]))
        np.testing.assert_allclose(
            tshade.recompute_barycentrics(fvt, idt)[v].numpy(),
            np.asarray(b), rtol=1e-4, atol=1e-5)
    attrs = np.random.RandomState(4).rand(fv.shape[1], 3, 2).astype(
        np.float32)
    bary = np.random.RandomState(5).rand(SIZE, SIZE, 3).astype(np.float32)
    np.testing.assert_allclose(
        tshade.interpolate_face_attributes(
            torch.tensor(attrs), idt[0], torch.tensor(bary)).numpy(),
        np.asarray(jax_interp(jnp.asarray(attrs), jnp.asarray(ids[0]),
                              jnp.asarray(bary))), rtol=1e-6)


def _grads_close(got, want, rtol=1e-4):
    """Values within rtol, with an absolute floor of rtol * max|want| for
    the entries that sum terms of both signs."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_shade_soft_matches_jax(scene):
    """shade_soft from the same screen verts and fragments: values and the
    screen-vertex and texture gradients within rtol 1e-4."""
    jm, tm, *_, fv = scene
    j = rasterize_pallas_batched(jnp.asarray(fv), SIZE, soft=True)
    p2f, near = np.asarray(j.pix_to_face), np.asarray(j.nearest_face)
    w = np.random.RandomState(6).randn(2, SIZE, SIZE, 4).astype(np.float32)

    def jloss(f, tex):
        rgba = jax.vmap(lambda a, b, c: jsoft.shade_soft(
            a, b, c, jm.verts_uvs, jm.faces_uvs, tex, sigma_px=1.5))(
                f, jnp.asarray(p2f), jnp.asarray(near))
        return jnp.sum(rgba * w), rgba

    (_, rgba_j), (gf_j, gt_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(fv), jm.texture)
    f = torch.tensor(fv, requires_grad=True)
    tex = tm.texture.clone().requires_grad_(True)
    rgba = tsoft.shade_soft(f, torch.tensor(p2f), torch.tensor(near),
                            tm.verts_uvs, tm.faces_uvs, tex, sigma_px=1.5)
    torch.sum(rgba * torch.tensor(w)).backward()
    _grads_close(rgba.detach().numpy(), np.asarray(rgba_j))
    _grads_close(f.grad.numpy(), np.asarray(gf_j))
    _grads_close(tex.grad.numpy(), np.asarray(gt_j))
    alpha = rgba[..., 3].detach().numpy()
    assert (alpha > 0).all() and (alpha < 1).any()


@pytest.mark.parametrize("gamma", [1e-4, 1e-2])
def test_shade_softras_matches_jax(scene, gamma):
    """shade_softras from the same screen verts and top-K ids: values and
    gradients within rtol 1e-4, at the settings' default gamma (1e-4) and
    the function's (1e-2). The port computes only the filled slots."""
    jm, tm, *_, fv = scene
    ids = np.asarray(rasterize_pallas_topk(jnp.asarray(fv), SIZE, 4, 3.0))
    w = np.random.RandomState(7).randn(2, SIZE, SIZE, 4).astype(np.float32)

    def jloss(f, tex):
        rgba = jax.vmap(lambda a, b: jtopk.shade_softras(
            a, b, jm.verts_uvs, jm.faces_uvs, tex, sigma_px=1.0,
            gamma=gamma))(f, jnp.asarray(ids))
        return jnp.sum(rgba * w), rgba

    (_, rgba_j), (gf_j, gt_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(fv), jm.texture)
    f = torch.tensor(fv, requires_grad=True)
    tex = tm.texture.clone().requires_grad_(True)
    rgba = ttopk.shade_softras(f, torch.tensor(ids), tm.verts_uvs,
                               tm.faces_uvs, tex, sigma_px=1.0, gamma=gamma)
    torch.sum(rgba * torch.tensor(w)).backward()
    _grads_close(rgba.detach().numpy(), np.asarray(rgba_j))
    _grads_close(f.grad.numpy(), np.asarray(gf_j))
    _grads_close(tex.grad.numpy(), np.asarray(gt_j))


@pytest.mark.parametrize("k,blur", [(2, 0.0), (1, 4e-4), (3, 1e-3)])
def test_rasterize_hard_k_matches_jax(scene, k, blur):
    """ids equal; zbuf, bary and dists within rtol 1e-4; the saturation
    counts equal."""
    *_, fv = scene
    got = ttopk.rasterize_hard_k(
        torch.tensor(fv), RasterizationSettings(SIZE, blur_radius=blur,
                                                faces_per_pixel=k))
    want = jtopk.rasterize_hard_k(
        jnp.asarray(fv), JSettings(SIZE, blur_radius=blur, faces_per_pixel=k,
                                   backend="pallas"))
    np.testing.assert_array_equal(got.pix_to_face.numpy(),
                                  np.asarray(want.pix_to_face))
    for a, b in ((got.zbuf, want.zbuf), (got.bary, want.bary),
                 (got.dists, want.dists)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_array_equal(got.saturated.numpy(),
                                  np.asarray(want.saturated))


def _eviction_scene():
    """The JAX package's adversarial slack scene (tests/test_hard_k.py): a
    covering triangle behind seven slivers that the proxy distance admits
    and the exact one rejects, at 32²."""
    faces = [[[4.0, 4.0, 5.0], [28.0, 4.0, 5.0], [16.0, 28.0, 5.0]]]
    for i in range(7):
        j = 0.02 * i
        tx, ty, z = 19.2 + j, 19.2 - j, 1.0 + 0.05 * i
        faces.append([[tx, ty, z], [tx + 8.8, ty + 8.4, z],
                      [tx + 8.4, ty + 8.8, z]])
    return np.array(faces, np.float32)[None]


def test_hard_k_saturation_is_reported():
    import warnings

    fv = torch.tensor(_eviction_scene())
    settings = RasterizationSettings(32, blur_radius=(4.0 / 16.0) ** 2)
    frags = ttopk.rasterize_hard_k(fv, settings)
    assert int(frags.pix_to_face[0, 16, 16, 0]) == -1
    assert int(frags.saturated[0]) > 0
    with pytest.warns(UserWarning, match="hard_k_slack"):
        assert ttopk.check_hard_k_saturation(fv, settings) > 0
    wide = RasterizationSettings(32, blur_radius=(4.0 / 16.0) ** 2,
                                 hard_k_slack=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ttopk.check_hard_k_saturation(fv, wide) == 0
        assert ttopk.check_hard_k_saturation(
            fv, RasterizationSettings(32)) == 0
    ok = ttopk.rasterize_hard_k(fv, wide)
    assert int(ok.pix_to_face[0, 16, 16, 0]) == 0


def _fragments_agree(mode, jm, jc, tm, tc):
    """Pixels whose discrete selections agree between the two packages,
    each rasterizing its own projection."""
    js = JSettings(SIZE, backend="pallas", **MODES[mode])
    ts = RasterizationSettings(SIZE, **MODES[mode])
    fvj = jax_fvs(jm.verts, jm.faces, jc, SIZE)
    fvt = trend.face_verts_screen(tm.verts, tm.faces, tc, SIZE)
    vis = trend.rasterize_views(fvt, ts)
    if mode == "softras":
        want = jax.vmap(lambda f: jtopk.rasterize_topk(f, js).pix_to_face)(
            fvj)
        return (vis["p2f_k"].numpy() == np.asarray(want)).all(-1)
    frags = jax_rasterize_batch(fvj, js)
    agree = vis["p2f"].numpy() == np.asarray(frags.pix_to_face)
    if mode == "soft":
        agree &= vis["near"].numpy() == np.asarray(frags.nearest_face)
    return agree


@pytest.mark.parametrize("mode", list(MODES))
def test_render_rgba_matches_jax(scene, mode):
    """render_rgba through each package's own projection and rasterizer.

    The two projections differ in the last bits (einsum against bmm), which
    flips discrete selections at near-ties: the pixels whose selections
    differ get weight 0 and are excluded. They are at most 1% of the frame,
    except soft mode's nearest faces, which differ only where both picks
    score within 1e-4 px (relative to max(|d|, 1 px)).
    Elsewhere: values within rtol 1e-4 with an absolute floor of 2e-4 (the
    projection's ulps, amplified by the barycentrics of small or
    extrapolated triangles and by the texture's slope), texture gradients
    within rtol 1e-4, vertex gradients within 2e-3 of their largest entry
    (the same ulps through the projection's Jacobian; the shading alone
    agrees to 1e-4 from identical screen vertices, test_shade_*)."""
    jm, tm, jc, tc, _ = scene
    agree = _fragments_agree(mode, jm, jc, tm, tc)
    w = (np.random.RandomState(8).randn(2, SIZE, SIZE, 4)
         * agree[..., None]).astype(np.float32)
    js = JSettings(SIZE, backend="pallas", **MODES[mode])

    def jloss(verts, tex):
        rgba = jrend.render_rgba(jm.replace(verts=verts, texture=tex), jc,
                                 js)
        return jnp.sum(rgba * w), rgba

    (_, rgba_j), (gv_j, gt_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jm.verts, jm.texture)
    verts = tm.verts.clone().requires_grad_(True)
    tex = tm.texture.clone().requires_grad_(True)
    rgba = trend.render_rgba(tm.replace(verts=verts, texture=tex), tc,
                             RasterizationSettings(SIZE, **MODES[mode]))
    torch.sum(rgba * torch.tensor(w)).backward()
    if mode == "soft":
        # Outside the sphere the gated distances of faces sharing the
        # extreme vertex tie exactly (their bbox sides coincide): there the
        # two projections pick either face. Both picks score the same on
        # the port's own planes.
        fvt = trend.face_verts_screen(tm.verts, tm.faces, tc, SIZE)
        near_t = trend.rasterize_views(fvt, RasterizationSettings(
            SIZE, soft=True))["near"].numpy()
        near_j = np.asarray(jax_rasterize_batch(
            jax_fvs(jm.verts, jm.faces, jc, SIZE), js).nearest_face)
        diff = near_t != near_j
        a = _soft_scores(fvt.detach().numpy(), near_t)
        b = _soft_scores(fvt.detach().numpy(), near_j)
        assert (np.abs(a - b) / np.maximum(np.abs(a), 1.0))[diff].max() < 1e-4
    else:
        assert agree.mean() >= 0.99
    m = agree[..., None].repeat(4, -1)
    np.testing.assert_allclose(rgba.detach().numpy()[m],
                               np.asarray(rgba_j)[m], rtol=1e-4, atol=2e-4)
    gv = np.asarray(gv_j)
    np.testing.assert_allclose(verts.grad.numpy(), gv, rtol=0,
                               atol=2e-3 * float(np.abs(gv).max()))
    _grads_close(tex.grad.numpy(), np.asarray(gt_j))


@pytest.mark.parametrize("mode", ["soft", "softras"])
def test_static_visibility_soft_modes_match_jax(scene, mode):
    """precompute_visibility / render_rgba_static in the soft modes: the
    fragments are kept (compact_visibility passes them through) and the
    static render equals the dynamic one; its texture gradient matches
    the JAX package's static path."""
    jm, tm, jc, tc, _ = scene
    ts = RasterizationSettings(SIZE, **MODES[mode])
    vis = trend.precompute_visibility(tm, tc, ts)
    assert trend.compact_visibility(vis) is vis
    assert ("p2f_k" in vis) == (mode == "softras") and "uv" not in vis
    static = trend.render_rgba_static(tm, vis, ts)
    torch.testing.assert_close(static, trend.render_rgba(tm, tc, ts),
                               rtol=0, atol=0)
    js = JSettings(SIZE, backend="pallas", **MODES[mode])
    jv = jrend.precompute_visibility(jm, jc, js)
    agree = _fragments_agree(mode, jm, jc, tm, tc)
    w = (np.random.RandomState(9).randn(2, SIZE, SIZE, 4)
         * agree[..., None]).astype(np.float32)
    g_j = jax.grad(lambda t: jnp.sum(jrend.render_rgba_static(
        jm.replace(texture=t), jv, js) * w))(jm.texture)
    tex = tm.texture.clone().requires_grad_(True)
    torch.sum(trend.render_rgba_static(tm.replace(texture=tex), vis, ts)
              * torch.tensor(w)).backward()
    _grads_close(tex.grad.numpy(), np.asarray(g_j))
