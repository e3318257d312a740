"""Data and tile parallelism in a world of 2 gloo ranks on the CPU
(``torch_world.launch``), against the port's world of 1 and the JAX
package's multi-device runs on conftest's 8 virtual devices.

At 32², 8 views in one batch of 8, float32, random VGG weights: the
second approach's texture and both targets within rtol 1e-5 of the world
of 1 (losses and textures; every rank's leaves bit-identical), and within
``test_torch_slice.py``'s tolerances of JAX's ``--data_parallel`` run; a
noise-background run finite and falling; ``current_images/`` gathered to
rank 0. The first approach's MSE phase (4 views) within rtol 1e-4 of the
world of 1 (``tests/test_pipelines.py``'s data-parallel tolerance); 4
styles within atol 1e-5. The tiled render at 64²: values within atol 1e-5
of the untiled render, texture and vertex gradients within 1e-4
(``tests/test_parallel.py``'s), JAX's tiled render on 8 devices within
the port's raster-versus-JAX tolerances (``test_torch_render.py``), and
the tiled ``save_render`` PNGs equal to the untiled ones. The bad counts
raise with the JAX package's words on every rank, and ``--debug_nan``
stops both ranks at the same step."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import st3d.models.vgg as jvgg
from st3d.core import cameras as jcams
from st3d.core.primitives import ico_sphere as jax_ico_sphere
from st3d.engine.config import parse_second_approach as jax_parse
from st3d.engine.pipelines import run_second_approach as jax_run
from st3d.parallel.tiles import make_tile_mesh, render_rgba_tiled as jtiled
from st3d.render.rasterize import RasterizationSettings as JSettings

from st3d_torch import first_approach, multi_style, second_approach
from st3d_torch.convert import vgg19_from_numpy
from st3d_torch.engine.pipelines import save_render
from st3d_torch.io.image import read_png, write_png
from st3d_torch.models.vgg import save_vgg19_npz
from st3d_torch.profile_step import write_sphere_scene
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import render_rgba

from torch_world import (
    launch,
    sphere_mesh,
    tiled_cameras,
    tiled_loss_weights,
)

SIZE = 32
TILE = 64
STYLES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    styles = [style]
    for k in range(1, STYLES):
        styles.append(str(root / f"style{k}.png"))
        write_png(styles[-1], (np.random.RandomState(k).rand(SIZE, SIZE, 3)
                               * 255).astype(np.uint8))
    jm = jvgg.init_random_vgg19(0)
    save_vgg19_npz(vgg19_from_numpy(jm.kernels, jm.biases),
                   str(root / "vgg.npz"))
    common = ["--obj_path", obj, "--size", str(SIZE), "--randomize_views",
              "False", "--compute_dtype", "float32", "--vgg_weights",
              str(root / "vgg.npz")]
    sa = common + ["--style_path", style, "--n_views", "8", "--batch_size",
                   "8", "--epochs", "3", "--save_intermediate", "False"]
    fa = common + ["--style_path", style, "--n_views", "4", "--batch_size",
                   "4", "--n_style_transfer_steps", "5", "--n_mse_steps", "5"]
    ms = common + ["--n_views", "2", "--batch_size", "2", "--epochs", "2"]
    return root, {"sa": sa, "fa": fa,
                  "ms": ms + ["--style_paths", ",".join(styles)],
                  "ms3": ms + ["--style_paths", ",".join(styles[:3])]}


SA_RUNS = {"texture": ["--save_intermediate", "True"],
           "both": ["--optimization_target", "both"],
           "noise": ["--content_background", "noise",
                     "--current_background", "noise", "--epochs", "5"]}


@pytest.fixture(scope="module")
def world2(scene):
    """One world of 2 ranks running every job below, in order."""
    root, argv = scene
    dp = ["--device", "cpu", "--data_parallel", "True"]
    jobs = [{"kind": "cli", "entry": "second_approach",
             "argv": argv["sa"] + dp + extra + ["--output_path",
                                                 str(root / f"dp_{k}")],
             "save": str(root / f"dp_{k}")}
            for k, extra in SA_RUNS.items()]
    jobs += [
        {"kind": "cli", "entry": "first_approach",
         "argv": argv["fa"] + dp + ["--output_path", str(root / "dp_fa")],
         "save": str(root / "dp_fa")},
        {"kind": "cli", "entry": "multi_style",
         "argv": argv["ms"] + dp + ["--output_path", str(root / "dp_ms")],
         "save": str(root / "dp_ms")},
        {"kind": "tiled", "size": TILE, "out": str(root / "tiled")},
        {"kind": "cli", "entry": "second_approach", "raises": "ValueError",
         "argv": argv["sa"] + dp + ["--n_views", "3", "--batch_size", "3",
                                    "--output_path", str(root / "bad")]},
        {"kind": "cli", "entry": "multi_style", "raises": "ValueError",
         "argv": argv["ms3"] + dp + ["--output_path", str(root / "bad")]},
        {"kind": "mesh", "n": 3, "raises": "ValueError"},
        {"kind": "tiled", "size": TILE - 1, "out": str(root / "bad"),
         "raises": "ValueError"},
        {"kind": "cli", "entry": "second_approach",
         "raises": "FloatingPointError",
         "argv": argv["sa"] + dp + ["--style_weight", "inf", "--debug_nan",
                                    "True", "--output_path",
                                    str(root / "nan")]},
    ]
    return launch(2, jobs, root / "world2")


def _losses(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Logger:"
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]]


def _ranks_agree(prefix, n=2):
    """Every rank's saved leaves, bit-identical across the ranks."""
    got = [np.load(f"{prefix}.rank{r}.npz") for r in range(n)]
    for k in got[0].files:
        for other in got[1:]:
            np.testing.assert_array_equal(other[k], got[0][k])
    return {k: got[0][k] for k in got[0].files}


@pytest.mark.parametrize("target", ["texture", "both"])
def test_second_approach_matches_the_world_of_one(scene, world2, target):
    root, argv = scene
    plain = second_approach.main(argv["sa"] + SA_RUNS[target] + [
        "--device", "cpu", "--output_path", str(root / f"one_{target}")])
    got = _ranks_agree(str(root / f"dp_{target}"))
    np.testing.assert_allclose(_losses(root / f"dp_{target}"),
                               _losses(root / f"one_{target}"), rtol=1e-5)
    np.testing.assert_allclose(got["texture"], plain.texture.detach(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["verts"], plain.verts.detach(),
                               rtol=1e-5, atol=1e-6)
    if target == "texture":
        # current_images/ gathered to rank 0: all 8 views.
        for j in range(8):
            name = os.path.join("current_images", f"view_{j}.png")
            a = read_png(str(root / f"dp_{target}" / name)).astype(int)
            b = read_png(str(root / f"one_{target}" / name)).astype(int)
            assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("target", ["texture", "both"])
def test_second_approach_matches_jax_data_parallel(scene, world2, target,
                                                   monkeypatch):
    """JAX's own ``--data_parallel`` run over 8 devices (one view each)."""
    monkeypatch.setenv("ST3D_COMPILE_CACHE", "")
    root, argv = scene
    out = str(root / f"jax_{target}")
    final = jax_run(jax_parse(argv["sa"] + SA_RUNS[target] + [
        "--data_parallel", "True", "--output_path", out]))
    lt, lj = _losses(root / f"dp_{target}"), _losses(out)
    assert len(lt) == len(lj) == 3
    assert lt[0] == pytest.approx(lj[0], rel=1e-4)
    for a, b in zip(lt[1:], lj[1:]):
        assert a == pytest.approx(b, rel=1e-3)
    got = _ranks_agree(str(root / f"dp_{target}"))
    np.testing.assert_allclose(got["texture"], np.asarray(final.texture),
                               atol=1e-4)
    if target == "both":
        np.testing.assert_allclose(got["verts"], np.asarray(final.verts),
                                   atol=1e-4)


def test_noise_backgrounds_stay_finite_and_fall(scene, world2):
    root, _ = scene
    losses = _losses(root / "dp_noise")
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    _ranks_agree(str(root / "dp_noise"))


def test_first_approach_mse_phase_matches_the_world_of_one(scene, world2):
    root, argv = scene
    plain = first_approach.main(argv["fa"] + [
        "--device", "cpu", "--output_path", str(root / "one_fa")])
    np.testing.assert_allclose(_losses(root / "dp_fa"),
                               _losses(root / "one_fa"), rtol=1e-4)
    got = _ranks_agree(str(root / "dp_fa"))
    np.testing.assert_allclose(got["texture"], plain.texture.detach(),
                               atol=1e-5)
    assert sorted(os.listdir(root / "dp_fa" / "2d_style_transfer")) == [
        f"view_{j}.png" for j in range(4)]


def test_multistyle_matches_the_world_of_one(scene, world2):
    root, argv = scene
    plain = multi_style.main(argv["ms"] + [
        "--device", "cpu", "--output_path", str(root / "one_ms")])
    got = _ranks_agree(str(root / "dp_ms"))
    assert sorted(got) == sorted(plain)
    for name, mesh in plain.items():
        np.testing.assert_allclose(got[name], mesh.texture, atol=1e-5)
    np.testing.assert_allclose(_losses(root / "dp_ms"),
                               _losses(root / "one_ms"), rtol=1e-5)
    with open(root / "dp_ms" / "metrics.jsonl") as f:
        per_style = [json.loads(l)["per_style"] for l in f]
    assert all(sorted(p) == sorted(plain) for p in per_style)
    for name in plain:
        assert os.path.isfile(root / "dp_ms" / name / "final.obj")


def _port_render(size):
    mesh, cams = sphere_mesh(), tiled_cameras()
    tex = mesh.texture.clone().requires_grad_(True)
    verts = mesh.verts.clone().requires_grad_(True)
    rgba = render_rgba(mesh.replace(texture=tex, verts=verts), cams,
                       RasterizationSettings(size))
    (rgba[..., :3] * tiled_loss_weights(size)).sum().backward()
    return rgba.detach().numpy(), tex.grad.numpy(), verts.grad.numpy()


def test_tiled_render_matches_the_untiled_one(scene, world2):
    root, _ = scene
    rgba, g_tex, g_verts = _port_render(TILE)
    for r in range(2):
        got = np.load(str(root / f"tiled.rank{r}.npz"))
        np.testing.assert_allclose(got["rgba"], rgba, atol=1e-5)
        np.testing.assert_allclose(got["tex"], g_tex, atol=1e-4)
        np.testing.assert_allclose(got["verts"], g_verts, atol=1e-4)
    assert np.abs(g_tex).sum() > 0


def test_tiled_render_matches_jax_over_eight_devices(scene, world2):
    root, _ = scene
    tm = sphere_mesh()
    jm = jax_ico_sphere(level=2)
    np.testing.assert_array_equal(tm.faces.numpy(), np.asarray(jm.faces))
    jm = jm.replace(texture=jnp.asarray(tm.texture.numpy()))
    cams = tiled_cameras()
    jc = jcams.FoVPerspectiveCameras.create(R=jnp.asarray(cams.R.numpy()),
                                            T=jnp.asarray(cams.T.numpy()))
    want = np.asarray(jtiled(jm, jc, JSettings(TILE, backend="pallas"),
                             make_tile_mesh(8)))
    got = np.load(str(root / "tiled.rank0.npz"))["rgba"]
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_tiled_save_render_writes_the_untiled_pixels(scene, world2,
                                                     tmp_path):
    root, _ = scene
    save_render(sphere_mesh(), tiled_cameras(),
                RasterizationSettings(TILE), str(tmp_path))
    for j in range(2):
        a = read_png(str(root / "tiled_png" / f"view_{j}.png"))
        b = read_png(str(tmp_path / f"view_{j}.png"))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("job,words", [
    (6, ["data_parallel requires every view batch to divide the 2 devices",
         "batch of 3 views"]),
    (7, ["style count (3) to divide the 2 devices"]),
    (8, ["requested 3 devices but only 2 present"]),
    (9, ["image_size 63 must divide across 2 devices"])])
def test_bad_counts_raise_on_every_rank(world2, job, words):
    for rank in world2:
        for w in words:
            assert w in rank[job], rank[job]


def test_debug_nan_stops_every_rank(world2):
    """``--debug_nan`` checks the averaged loss, so both ranks raise at the
    same step and neither waits in a collective."""
    for rank in world2:
        assert "(inf) in epoch 0, batch 0 loss" in rank[10], rank[10]
