"""``st3d_torch/core/uv.py::pad_mesh`` against ``st3d.core.uv.pad_mesh``,
and padded faces through every rasterizer on the CPU.

Padding faces are (0, 0, 0): zero area, so ``face_coeffs`` gives them the
planes of an invalid face, their bbox sorts them after every face of the
mesh, and their chunks' bands meet no rows. The plain versions of K1 (hard
and soft), K6 (forced, hard and soft) and K7 (both windows) must then give
the padded mesh the unpadded mesh's outputs bit for bit, and so must the
per-warp walk models of K1, K1-soft, K7 and K6
(``tests/test_torch_hard_walk.py``, ``_soft_walk.py``, ``_stream_walk.py``),
with the same (pixel, face) pairs tested: the chunk that mixes the mesh's
last faces with padding keeps padding faces exactly where it kept the
unpadded mesh's pad columns. The padding here is +301 faces (not a
multiple of 128), +37 vertices and +11 UVs."""

import numpy as np
import pytest
import torch

from st3d_torch.convert import mesh_from_numpy
from st3d_torch.core.cameras import build_fixed_cameras
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.core.uv import pad_mesh
from st3d_torch.kernels import raster as kr
from st3d_torch.render.rasterize import face_verts_screen
from test_torch_hard_walk import hard_walk
from test_torch_soft_walk import WINDOWS, soft_walk, topk_walk
from test_torch_stream_walk import walk_plain

PAD = (37, 301, 11)          # extra vertices, faces, UVs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded(mesh, texture_size=None):
    return pad_mesh(mesh, mesh.verts.shape[0] + PAD[0],
                    mesh.faces.shape[0] + PAD[1],
                    num_uvs=mesh.verts_uvs.shape[0] + PAD[2],
                    texture_size=texture_size)


@pytest.mark.parametrize("texture_size", [None, 16, 24, 11])
def test_pad_mesh_matches_jax(texture_size):
    """The same arrays as the JAX package's; the texture resized (shrunk
    with antialiasing, grown, or kept) within 1e-5."""
    import jax.numpy as jnp

    from st3d.core.primitives import ico_sphere as jax_ico_sphere
    from st3d.core.uv import pad_mesh as jax_pad_mesh

    jm = jax_ico_sphere(level=2, texture_size=16)
    jm = jm.replace(texture=jnp.asarray(np.random.RandomState(0).rand(
        16, 16, 3).astype(np.float32)))
    want = jax_pad_mesh(jm, jm.verts.shape[0] + PAD[0],
                        jm.faces.shape[0] + PAD[1],
                        num_uvs=jm.verts_uvs.shape[0] + PAD[2],
                        texture_size=texture_size)
    got = _padded(mesh_from_numpy(jm.verts, jm.faces, jm.verts_uvs,
                                  jm.faces_uvs, jm.texture), texture_size)
    for name in ("verts", "faces", "verts_uvs", "faces_uvs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.faces.dtype == torch.int64
    np.testing.assert_allclose(got.texture.numpy(), np.asarray(want.texture),
                               atol=1e-5)


def test_pad_mesh_keeps_topology():
    mesh = ico_sphere(level=1).with_topology()
    padded = _padded(mesh)
    assert padded.topology is mesh.topology
    assert torch.equal(padded.faces[-PAD[1]:], torch.zeros(PAD[1], 3,
                                                           dtype=torch.int64))
    assert torch.equal(padded.verts[-1], mesh.verts[0])
    assert torch.equal(padded.verts_uvs[-PAD[2]:], torch.zeros(PAD[2], 2))


@pytest.mark.parametrize("budget", [(-1, 0, 0), (0, -1, 0), (0, 0, -1)])
def test_budget_errors_match_jax(budget):
    from st3d.core.primitives import ico_sphere as jax_ico_sphere
    from st3d.core.uv import pad_mesh as jax_pad_mesh

    jm = jax_ico_sphere(level=1)
    tm = ico_sphere(level=1)
    args = (jm.verts.shape[0] + budget[0], jm.faces.shape[0] + budget[1])
    uvs = jm.verts_uvs.shape[0] + budget[2]
    with pytest.raises(ValueError, match="budget") as want:
        jax_pad_mesh(jm, *args, num_uvs=uvs)
    with pytest.raises(ValueError, match="budget") as got:
        pad_mesh(tm, *args, num_uvs=uvs)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Padded faces through the rasterizers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[64, 48])
def faces(request):
    """Screen faces (2, F, 3, 3) of 1,203 faces of the level-3 ico-sphere
    (so the last chunk mixes 51 faces with padding) with seeded vertex
    noise (so chunk bands overlap), unpadded and padded, at 64² and 48²
    (warps wrap rows), with the size."""
    size = request.param
    mesh = ico_sphere(level=3)
    mesh = mesh.replace(faces=mesh.faces[:1203],
                        faces_uvs=mesh.faces_uvs[:1203])
    rng = np.random.RandomState(3)
    moved = torch.tensor(rng.rand(mesh.verts.shape[0]) < 0.04)
    noise = torch.tensor(rng.randn(*mesh.verts.shape).astype(np.float32))
    mesh = mesh.replace(verts=mesh.verts + 0.6 * noise * moved[:, None])
    cams = build_fixed_cameras(2, dist=1.6, seed=2)
    out = [face_verts_screen(m.verts, m.faces, cams, size)
           for m in (mesh, _padded(mesh))]
    return out[0], out[1], size


def _ids(order, ids):
    """Sorted ids (N, H*W[, K]) as mesh ids."""
    shape = ids.shape
    return kr._to_mesh_ids(order, ids.reshape(shape[0], -1)).reshape(shape)


@pytest.mark.parametrize("kernel", ["hard", "soft", "stream_hard",
                                    "stream_soft", "topk_softras",
                                    "topk_blur"])
def test_padded_faces_change_no_plain_version(faces, kernel):
    fv, fv_pad, size = faces
    outs = []
    for f in (fv, fv_pad):
        if kernel == "hard":
            outs.append(kr.rasterize_batched(f, size, stream=False))
        elif kernel == "soft":
            outs.append(kr.rasterize_batched_soft(f, size, stream=False))
        elif kernel.startswith("stream"):
            fn = (kr.rasterize_batched_soft if kernel == "stream_soft"
                  else kr.rasterize_batched)
            outs.append(fn(f, size, stream=True))
        else:
            k = 4 if kernel == "topk_softras" else 5
            outs.append((kr.rasterize_topk_batched(
                f, size, k, WINDOWS[kernel[5:]]),))
    assert fv.shape[1] % kr.FACE_CHUNK and fv_pad.shape[1] == (
        fv.shape[1] + PAD[1])
    assert (outs[0][0] >= 0).any()
    assert int(outs[1][0].max()) < fv.shape[1]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("walk", ["hard", "soft", "stream_hard",
                                  "stream_soft", "topk_softras", "topk_blur"])
def test_padded_faces_change_no_walk(faces, walk):
    """The per-warp walk models give the padded faces the unpadded faces'
    outputs and test the same (pixel, face) pairs."""
    fv, fv_pad, size = faces
    outs = []
    for f in (fv, fv_pad):
        coeffs, bounds, order = kr.preprocess(f)
        soft = walk in ("soft", "stream_soft")
        tile = kr.cull_tile(size, size, soft)
        margin = kr.soft_cull_margin(1.0) if soft else 0.0
        if walk == "hard":
            *got, tested = hard_walk(coeffs, bounds, size, size)
        elif walk == "soft":
            *got, tested = soft_walk(coeffs, bounds, size, size, margin,
                                     tile)
        elif walk.startswith("stream"):
            ranges = kr.stream_ranges(bounds, size, size, tile, margin)
            *got, tested = walk_plain(coeffs, bounds, ranges, size, size,
                                      tile, soft, margin)
        else:
            k = 4 if walk == "topk_softras" else 5
            *got, tested = topk_walk(coeffs, bounds, size, size, k,
                                     WINDOWS[walk[5:]])
        ids = [_ids(order, got[0])] + got[1:2]
        if walk in ("soft", "stream_soft"):
            ids.append(_ids(order, got[2]))
        outs.append((ids, tested))
    (a, ta), (b, tb) = outs
    assert ta == tb > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
