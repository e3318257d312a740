"""The fleet's padded device grid in worlds of 3 and 4 gloo ranks on the
CPU, checkpoints moved between worlds, the tiled render over 4 ranks, and
the CLI under ``torchrun``.

The fleet is ``test_torch_fleet.py``'s: a textured level-2 sphere and a
UV-less level-1 one, 2 styles, 2 views at 32². On 3 ranks
``_pick_grid(3, 2, 2)`` is (1, 3, 2, 3): a 1 x 3 grid of ranks over the
cells padded to 2 x 3, one masked style column; on 4 ranks 2 x 2, no
padding. Every real cell within atol 1e-5 of the world of 1 (every rank
holding the same cells). A checkpoint written by the 3-rank fleet resumes
in a world of 1, and one written in a world of 1 resumes on 3 ranks, each
bit-equal to the uninterrupted run of the world of 1."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from st3d_torch.core.primitives import ico_sphere
from st3d_torch.engine.fleetbatch import _pick_grid
from st3d_torch.engine.pipelines import save_render
from st3d_torch.fleet import main as fleet_main
from st3d_torch.io.image import read_png, write_png
from st3d_torch.io.obj import save_obj
from st3d_torch.profile_step import write_sphere_scene
from st3d_torch.render.rasterize import RasterizationSettings
from st3d_torch.render.renderer import render_rgba
from st3d_torch.second_approach import main as second_main

from torch_world import (
    REPO,
    launch,
    sphere_mesh,
    tiled_cameras,
    tiled_loss_weights,
)

SIZE = 32
TILE = 64
EPOCHS = 4
CUT = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    bare = ico_sphere(level=1)
    save_obj(str(root / "uvless" / "bare.obj"), verts=bare.verts.numpy(),
             faces=bare.faces.numpy())
    style2 = str(root / "other.png")
    write_png(style2, (np.random.RandomState(7).rand(SIZE, SIZE, 3)
                       * 255).astype(np.uint8))
    argv = ["--size", str(SIZE), "--n_views", "2", "--batch_size", "2",
            "--randomize_views", "False", "--device", "cpu", "--obj_paths",
            f"{obj},{root / 'uvless' / 'bare.obj'}",
            "--style_paths", f"{style},{style2}"]
    return root, argv, (obj, style)


def _fleet(argv, out, *extra):
    return argv + ["--output_path", str(out)] + list(extra)


@pytest.fixture(scope="module")
def one(scene):
    """The world of 1: the uninterrupted run, and the first CUT epochs of
    a run that a world of 3 resumes."""
    root, argv, _ = scene
    whole = fleet_main(_fleet(argv, root / "one", "--epochs", str(EPOCHS)))
    fleet_main(_fleet(argv, root / "one_cut", "--epochs", str(CUT),
                      "--checkpoint_every", str(CUT)))
    return {m: {s: c.texture for s, c in row.items()}
            for m, row in whole.items()}


@pytest.fixture(scope="module")
def worlds(scene, one):
    root, argv, _ = scene
    dp = ["--data_parallel", "True"]
    fleet = {"kind": "cli", "entry": "fleet"}
    three = launch(3, [
        {**fleet, "argv": _fleet(argv, root / "dp3", "--epochs",
                                 str(EPOCHS), *dp),
         "save": str(root / "dp3")},
        {**fleet, "argv": _fleet(argv, root / "dp3_cut", "--epochs",
                                 str(CUT), "--checkpoint_every", str(CUT),
                                 *dp)},
        {**fleet, "argv": _fleet(argv, root / "one_cut", "--epochs",
                                 str(EPOCHS), "--resume", "True", *dp),
         "save": str(root / "resumed3")},
    ], root / "world3")
    four = launch(4, [
        {**fleet, "argv": _fleet(argv, root / "dp4", "--epochs",
                                 str(EPOCHS), *dp),
         "save": str(root / "dp4")},
        {"kind": "tiled", "size": TILE, "out": str(root / "tiled4")},
    ], root / "world4")
    return three, four


def _cells(prefix, n):
    got = [np.load(f"{prefix}.rank{r}.npz") for r in range(n)]
    for k in got[0].files:
        for other in got[1:]:
            np.testing.assert_array_equal(other[k], got[0][k])
    return {k: got[0][k] for k in got[0].files}


def _losses(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [float(l.rsplit(" ", 1)[1])
                for l in f.read().strip().splitlines()[1:]]


def _log(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        cells = [json.loads(l)["per_cell"] for l in f]
    return _losses(out), cells


@pytest.mark.parametrize("ranks,grid", [(3, (1, 3, 2, 3)),
                                        (4, (2, 2, 2, 2))])
def test_fleet_grid_matches_the_world_of_one(scene, one, worlds, ranks,
                                             grid):
    root, _, _ = scene
    assert _pick_grid(ranks, 2, 2) == grid
    got = _cells(str(root / f"dp{ranks}"), ranks)
    assert sorted(got) == sorted(f"{m}/{s}" for m in one for s in one[m])
    for m, row in one.items():
        for s, tex in row.items():
            np.testing.assert_allclose(got[f"{m}/{s}"], tex, atol=1e-5)
            assert os.path.isfile(root / f"dp{ranks}" / m / s / "final.obj")
    losses, cells = _log(root / f"dp{ranks}")
    want_losses, want_cells = _log(root / "one")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert [sorted(c) for c in cells] == [sorted(c) for c in want_cells]


def test_checkpoint_of_three_ranks_resumes_in_a_world_of_one(scene, one,
                                                             worlds):
    root, argv, _ = scene
    with np.load(root / "dp3_cut" / "checkpoint.npz") as ck:
        assert int(ck["__step__"]) == CUT
        assert ck["p0"].shape[:2] == (2, 2)      # the real grid, unpadded
    resumed = fleet_main(_fleet(argv, root / "dp3_cut", "--epochs",
                                str(EPOCHS), "--resume", "True"))
    for m, row in one.items():
        for s, tex in row.items():
            assert torch.equal(resumed[m][s].texture, tex), (m, s)
    assert _log(root / "dp3_cut")[0] == _log(root / "one")[0][CUT:]


def test_checkpoint_of_one_rank_resumes_on_three(scene, one, worlds):
    root, _, _ = scene
    got = _cells(str(root / "resumed3"), 3)
    for m, row in one.items():
        for s, tex in row.items():
            np.testing.assert_array_equal(got[f"{m}/{s}"], tex.numpy())
    assert _log(root / "one_cut")[0] == _log(root / "one")[0][CUT:]


def test_tiled_render_over_four_ranks(scene, worlds, tmp_path):
    root, _, _ = scene
    mesh, cams = sphere_mesh(), tiled_cameras()
    tex = mesh.texture.clone().requires_grad_(True)
    verts = mesh.verts.clone().requires_grad_(True)
    rgba = render_rgba(mesh.replace(texture=tex, verts=verts), cams,
                       RasterizationSettings(TILE))
    (rgba[..., :3] * tiled_loss_weights(TILE)).sum().backward()
    save_render(mesh, cams, RasterizationSettings(TILE), str(tmp_path))
    for r in range(4):
        got = np.load(str(root / f"tiled4.rank{r}.npz"))
        np.testing.assert_allclose(got["rgba"], rgba.detach(), atol=1e-5)
        np.testing.assert_allclose(got["tex"], tex.grad, atol=1e-4)
        np.testing.assert_allclose(got["verts"], verts.grad, atol=1e-4)
    for j in range(2):
        np.testing.assert_array_equal(
            read_png(str(root / "tiled4_png" / f"view_{j}.png")),
            read_png(str(tmp_path / f"view_{j}.png")))


def test_second_approach_under_torchrun(scene, tmp_path):
    """The README's launch: ``torchrun --standalone`` over 2 ranks with
    both flags. Rank 0 prints the backend and writes the outputs: the
    losses of the world of 1 within rtol 1e-5 and its final render, pixel
    for pixel."""
    root, _, (obj, style) = scene
    argv = ["--obj_path", obj, "--style_path", style, "--size", str(SIZE),
            "--n_views", "4", "--batch_size", "4", "--epochs", "2",
            "--randomize_views", "False", "--save_intermediate", "False",
            "--device", "cpu"]
    second_main(argv + ["--output_path", str(tmp_path / "one")])
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "st3d_torch.second_approach"]
        + argv + ["--output_path", str(tmp_path / "two"), "--data_parallel",
                  "True", "--tile_parallel", "True"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "world 2, backend gloo" in proc.stdout
    np.testing.assert_allclose(_losses(tmp_path / "two"),
                               _losses(tmp_path / "one"), rtol=1e-5)
    for j in range(12):
        name = os.path.join("final_render", f"view_{j}.png")
        np.testing.assert_array_equal(read_png(str(tmp_path / "two" / name)),
                                      read_png(str(tmp_path / "one" / name)))
