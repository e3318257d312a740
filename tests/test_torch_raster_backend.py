"""``raster_backend`` in the port: every value the JAX package accepts
(``st3d/render/rasterize.py::resolve_backend``) runs the port's one
rasterizer, and any other value raises ``ValueError`` in both entry points
before they write anything, as the JAX package raises on it. CPU only, at
a tiny size (a level-1 sphere, one 32² view, one step)."""

import os

import numpy as np
import pytest
import torch

from st3d.render.rasterize import RasterizationSettings as JaxSettings
from st3d.render.rasterize import resolve_backend as jax_resolve_backend

from st3d_torch.core.primitives import ico_sphere
from st3d_torch.engine.config import (
    RASTER_BACKENDS, PipelineConfig, parse_first_approach,
    parse_second_approach)
from st3d_torch.engine.pipelines import (
    run_first_approach, run_second_approach)
from st3d_torch.io.image import write_png
from st3d_torch.io.obj import save_mesh

SIZE = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("backend")
    rng = np.random.RandomState(0)
    mesh = ico_sphere(level=1, texture_size=SIZE)
    mesh = mesh.replace(texture=torch.tensor(
        rng.rand(SIZE, SIZE, 3).astype(np.float32)))
    save_mesh(mesh, str(root / "scene" / "ico.obj"))
    write_png(str(root / "style.png"),
              (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8))
    return root


def _config(scene, out, backend, **kw):
    return PipelineConfig(
        obj_path=str(scene / "scene" / "ico.obj"),
        style_path=str(scene / "style.png"), size=SIZE, n_views=1,
        batch_size=1, epochs=1, n_style_transfer_steps=1, n_mse_steps=1,
        save_intermediate=False, randomize_views=False, device="cpu",
        raster_backend=backend, output_path=str(out), **kw)


def test_backends_match_the_jax_package():
    """The port accepts exactly the values the JAX package resolves."""
    for backend in RASTER_BACKENDS:
        jax_resolve_backend(JaxSettings(backend=backend))
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        jax_resolve_backend(JaxSettings(backend="cuda"))


@pytest.mark.parametrize("run", [run_first_approach, run_second_approach])
def test_unknown_backend_raises_before_any_output(scene, tmp_path, run):
    out = tmp_path / "out"
    cfg = _config(scene, out, "cuda")
    with pytest.raises(ValueError,
                       match="unknown rasterizer backend 'cuda'"):
        run(cfg)
    assert not os.path.exists(out)


@pytest.mark.parametrize("backend", RASTER_BACKENDS)
def test_known_backends_run(scene, tmp_path, backend):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final = run_second_approach(_config(scene, tmp_path / "out", backend))
    finally:
        torch.set_num_threads(n)
    assert torch.isfinite(final.texture).all()
    assert os.path.isfile(tmp_path / "out" / "final.obj")


@pytest.mark.parametrize("parse", [parse_first_approach,
                                   parse_second_approach])
def test_parser_rejects_an_unknown_backend(parse):
    assert parse(["--raster_backend", "xla"]).raster_backend == "xla"
    with pytest.raises(SystemExit):
        parse(["--raster_backend", "cuda"])
