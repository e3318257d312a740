"""The pure parts of ``st3d_torch/parallel`` against the JAX package on the
CPU: the fleet's grid factorisation and padding, the tile count, the
blocks each rank takes (against the shards ``jax.device_put`` places on
conftest's 8 virtual devices), the data-parallel noise seeds, the backend
rule, the errors with the JAX package's words, and the data-parallel step
and the tiled render in a world of 1. Worlds of several ranks are in
``test_torch_parallel_runs.py`` and ``test_torch_parallel_grid.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from st3d.engine import fleetbatch as jfleet
from st3d.parallel import sharding as jsharding
from st3d.parallel import tiles as jtiles

from st3d_torch.engine import fleetbatch as tfleet
from st3d_torch.engine.pipelines import view_noise_seeds
from st3d_torch.parallel.grid import CellGrid
from st3d_torch.parallel.sharding import (
    World,
    init_world,
    make_device_mesh,
    make_view_parallel_step,
    pick_backend,
    shard_views,
    view_block,
)
from st3d_torch.parallel.tiles import pick_tile_count, render_rgba_tiled
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import render_rgba

from torch_world import sphere_mesh, tiled_cameras


def _shards(x, devices, spec):
    """{device position in ``devices``: its shard of ``x``} as JAX places
    it on a mesh of ``devices`` (any shape) under ``spec``."""
    names = ("views",) if devices.ndim == 1 else ("mesh", "style")
    arr = jax.device_put(jnp.asarray(x), NamedSharding(
        JaxMesh(devices, names), spec))
    flat = list(devices.reshape(-1))
    return {flat.index(s.device): np.asarray(s.data)
            for s in arr.addressable_shards}


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_pick_grid_matches_jax(n_dev):
    for m in range(1, 6):
        for s in range(1, 7):
            assert tfleet._pick_grid(n_dev, m, s) == jfleet._pick_grid(
                n_dev, m, s), (n_dev, m, s)


@pytest.mark.parametrize("axis,size", [(0, 5), (1, 4), (1, 2)])
def test_pad_axis_matches_jax(axis, size):
    a = np.random.RandomState(axis + size).rand(3, 2, 4).astype(np.float32)
    want = np.asarray(jfleet._pad_axis(jnp.asarray(a), axis, size))
    got = tfleet._pad_axis(torch.from_numpy(a), axis, size).numpy()
    np.testing.assert_array_equal(got, want)


def test_pick_tile_count_matches_jax():
    assert pick_tile_count(1024, 8) == 8
    assert pick_tile_count(100, 8) == 5
    assert pick_tile_count(64, 1) == 1
    for size in range(1, 130):
        for n in range(1, 10):
            assert pick_tile_count(size, n) == jtiles.pick_tile_count(
                size, n), (size, n)


@pytest.mark.parametrize("n_dev,batch", [(1, 4), (2, 8), (4, 8), (8, 16)])
def test_shard_views_takes_the_blocks_jax_places(n_dev, batch):
    x = np.arange(batch * 6, dtype=np.float32).reshape(batch, 2, 3)
    want = _shards(x, np.array(jax.devices()[:n_dev]), P("views"))
    for r in range(n_dev):
        world = World(rank=r, size=n_dev)
        got = shard_views({"x": torch.from_numpy(x)}, world)["x"]
        np.testing.assert_array_equal(got.numpy(), want[r])
        assert view_block(batch, world) == slice(
            r * batch // n_dev, (r + 1) * batch // n_dev)


@pytest.mark.parametrize("n_dev,m,s", [(3, 2, 2), (4, 2, 2), (8, 4, 5),
                                       (6, 3, 4), (2, 1, 3)])
def test_fleet_blocks_match_jax_grid_sharding(n_dev, m, s):
    """Each rank's block of the padded cell grid, its cell mask and its
    meshes and styles are the shard ``P('mesh', 'style')`` places on that
    device of ``np.asarray(jax.devices()).reshape(dm, ds)``."""
    dm, ds, m_pad, s_pad = jfleet._pick_grid(n_dev, m, s)
    whole = np.random.RandomState(n_dev).rand(m, s, 3, 2).astype(np.float32)
    padded = jfleet._pad_axis(jfleet._pad_axis(jnp.asarray(whole), 0, m_pad),
                              1, s_pad)
    mask = np.zeros((m_pad, s_pad), np.float32)
    mask[:m, :s] = 1.0
    devices = np.asarray(jax.devices()[:n_dev]).reshape(dm, ds)
    want = _shards(padded, devices, P("mesh", "style"))
    want_mask = _shards(mask, devices, P("mesh", "style"))
    ids = np.arange(m_pad)[:, None] * 100 + np.arange(s_pad)[None, :]
    ids = np.where(ids // 100 < m, ids // 100, 0) * 100 + np.where(
        ids % 100 < s, ids % 100, 0)
    want_ids = _shards(ids, devices, P("mesh", "style"))
    for r in range(n_dev):
        grid = CellGrid.fleet(World(rank=r, size=n_dev), m, s)
        assert (grid.dm, grid.ds, grid.m_pad, grid.s_pad) == (dm, ds, m_pad,
                                                               s_pad)
        np.testing.assert_array_equal(
            grid.block(torch.from_numpy(whole)).numpy(), want[r])
        np.testing.assert_array_equal(grid.mask("cpu").numpy(), want_mask[r])
        got_ids = (np.asarray(grid.mesh_ids())[:, None] * 100
                   + np.asarray(grid.style_ids())[None, :])
        np.testing.assert_array_equal(got_ids, want_ids[r])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_style_blocks_match_jax_style_sharding(n_dev):
    whole = np.random.RandomState(n_dev).rand(4, 3, 2).astype(np.float32)
    want = _shards(whole, np.array(jax.devices()[:n_dev]), P("views"))
    for r in range(n_dev):
        grid = CellGrid.styles(World(rank=r, size=n_dev), 4)
        got = grid.block(torch.from_numpy(whole)[None])[0].numpy()
        np.testing.assert_array_equal(got, want[r])
        assert not grid.padded


@pytest.mark.parametrize("step", [0, 1, 5, 1000])
def test_view_noise_seeds_match_jax(step):
    want = np.asarray(jnp.asarray(7 + step * 131071 + jnp.arange(8),
                                  jnp.uint32))
    got = view_noise_seeds(7, step, 8)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device,cards,ranks,want", [
    ("cpu", 0, 2, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "nccl"),
    ("cuda", 1, 2, "gloo"), ("cuda", 1, 1, "nccl")])
def test_backend_rule(device, cards, ranks, want):
    assert pick_backend(device, cards, ranks) == want


def test_world_of_one_without_torchrun(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    world = init_world("cpu")
    assert (world.rank, world.size, world.backend) == (0, 1, None)
    assert world.main and not world.sharded
    assert not torch.distributed.is_initialized()


def _tiled_error(settings, n):
    render_rgba_tiled(sphere_mesh(), tiled_cameras(), settings,
                      World(rank=0, size=n), n)


@pytest.mark.parametrize("case,match", [
    ("mesh", "requested 3 devices but only 2 present"),
    ("views", "divide the 2 devices"),
    ("styles", "divide the 2 devices"),
    ("rows", "image_size 64 must divide across 3 devices"),
    ("soft", "requires hard K=1"), ("blur", "requires hard K=1"),
    ("faces", "requires hard K=1")])
def test_bad_counts_raise_with_jax_words(case, match):
    """Each refusal raises ValueError before any collective, with the JAX
    package's words; the JAX package's own for the mesh and the rows."""
    two = World(rank=0, size=2)
    calls = {
        "mesh": lambda: make_device_mesh(two, 3),
        "views": lambda: view_block(3, two),
        "styles": lambda: CellGrid.styles(two, 3),
        "rows": lambda: _tiled_error(RasterizationSettings(64), 3),
        "soft": lambda: _tiled_error(RasterizationSettings(16, soft=True), 1),
        "blur": lambda: _tiled_error(
            RasterizationSettings(16, blur_radius=1e-4), 1),
        "faces": lambda: _tiled_error(
            RasterizationSettings(16, faces_per_pixel=2), 1)}
    with pytest.raises(ValueError, match=match):
        calls[case]()
    if case == "mesh":
        with pytest.raises(ValueError, match="requested 9 devices but only"):
            jsharding.make_device_mesh(9)


def test_view_parallel_step_matches_jax_single_device():
    """``make_view_parallel_step`` in a world of 1 is one Adam step on the
    batch mean, as the JAX step on one device (tests/test_parallel.py's
    toy problem)."""
    data = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)

    def jloss(p, x):
        return jnp.mean((x @ p["w"]) ** 2)

    opt = optax.adam(0.1)
    params = {"w": jnp.ones((4,))}
    j_step = jsharding.make_view_parallel_step(
        jloss, opt, jsharding.make_device_mesh(1), donate=False)
    jp, _, jl = j_step(params, opt.init(params), jnp.asarray(data))

    w = torch.ones(4, requires_grad=True)
    step = make_view_parallel_step(
        lambda x: torch.mean((x @ w) ** 2), torch.optim.Adam([w], lr=0.1),
        {"w": w}, World())
    loss = step(torch.from_numpy(data))
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


def test_tiled_render_in_a_world_of_one_is_the_render():
    mesh, cams = sphere_mesh(), tiled_cameras()
    settings = RasterizationSettings(32)
    got = render_rgba_tiled(mesh, cams, settings, World())
    torch.testing.assert_close(got, render_rgba(mesh, cams, settings),
                               atol=0, rtol=0)


@pytest.mark.parametrize("rows", [32, 16])
def test_bands_are_the_whole_frames_rows(rows):
    """A band of rows ``[r0, r0 + rows)`` with ``row0 = r0``, as the tiled
    render makes it: K1's and K6's outputs and the shaded RGBA are those
    rows of the whole frame's, bit for bit."""
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import face_verts_screen, rasterize_batch
    from st3d_torch.render.shading import shade_textured

    size = 64
    mesh, cams = sphere_mesh(), tiled_cameras()
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, size)
    coeffs, bounds, _ = kr.preprocess(fv)
    whole = kr.raster_hard(coeffs, bounds, size, size)
    tile = kr.cull_tile(size, size, False)
    whole6 = kr.raster_stream(coeffs, bounds, kr.stream_ranges(
        bounds, size, size, tile, 0.0), size, size, tile, False)
    settings = RasterizationSettings(size)
    rgba = render_rgba(mesh, cams, settings)
    for r0 in range(0, size, rows):
        lo, hi = r0 * size, (r0 + rows) * size
        k1 = kr.raster_hard(coeffs, bounds, rows, size, row0=r0)
        t = kr.cull_tile(rows, size, False)
        k6 = kr.raster_stream(coeffs, bounds, kr.stream_ranges(
            bounds, rows, size, t, 0.0, r0), rows, size, t, False, row0=r0)
        for got, want in ((k1, whole), (k6, whole6)):
            torch.testing.assert_close(got[0], want[0][:, lo:hi], atol=0,
                                       rtol=0)
            torch.testing.assert_close(got[1], want[1][:, lo:hi], atol=0,
                                       rtol=0)
        frags = rasterize_batch(fv, settings, image_height=rows, row0=r0)
        band = shade_textured(fv, frags.pix_to_face, mesh.verts_uvs,
                              mesh.faces_uvs, mesh.texture, row0=r0)
        torch.testing.assert_close(band, rgba[:, r0:r0 + rows], atol=0,
                                   rtol=0)


def test_row_offsets_are_for_hard_k1_only():
    from st3d_torch.kernels import raster as kr
    from st3d_torch.render.rasterize import face_verts_screen, rasterize_batch

    mesh, cams = sphere_mesh(), tiled_cameras()
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, 32)
    for settings in (RasterizationSettings(32, soft=True),
                     RasterizationSettings(32, faces_per_pixel=2)):
        with pytest.raises(NotImplementedError, match="row offset"):
            rasterize_batch(fv, settings, image_height=16, row0=16)
    coeffs, bounds, _ = kr.preprocess(fv)
    with pytest.raises(ValueError, match="row offset"):
        kr._hard("raster_hard_every_face", 2, kr.raster_hard_plain, coeffs,
                 bounds, 16, 32, None, 16)
