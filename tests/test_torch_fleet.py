"""The batched fleet (``st3d_torch/engine/fleetbatch.py``, the
``st3d_torch.fleet`` CLI) against ``st3d.engine.fleetbatch`` on the CPU: a
textured level-2 sphere and a UV-less level-1 sphere (auto-UV, padded to
the first's budgets), 2 styles, 2 views, 2 epochs at 32². Losses within
rtol 1e-4 at first and 1e-3 after, textures within 1e-4
(``test_torch_slice.py``'s tolerances); batched against ``--fleet_mode
sequential`` within 2e-4 (``tests/test_fleetbatch.py``'s); the visibility
of both meshes in one raster call whose outputs equal each mesh's own
unpadded call; and the JAX package's refusals."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from st3d_torch.core.primitives import ico_sphere
from st3d_torch.engine.config import parse_second_approach
from st3d_torch.engine.fleetbatch import (
    _load_fleet_meshes,
    fleet_visibility,
    run_fleet_batched,
)
from st3d_torch.fleet import main
from st3d_torch.io.image import write_png
from st3d_torch.io.obj import save_obj
from st3d_torch.kernels import raster as kr
from st3d_torch.profile_step import write_sphere_scene
from st3d_torch.render.rasterize import (
    RasterizationSettings,
    face_verts_screen,
    rasterize_batch,
)

SIZE = 32
EPOCHS = 2
STEMS = ["mesh", "bare"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import st3d.models.vgg as jvgg

    from st3d_torch.convert import vgg19_from_numpy
    from st3d_torch.models.vgg import save_vgg19_npz

    root = tmp_path_factory.mktemp("fleet")
    obj, style = write_sphere_scene(str(root), SIZE, 0, 2)
    bare = ico_sphere(level=1)
    save_obj(str(root / "uvless" / "bare.obj"), verts=bare.verts.numpy(),
             faces=bare.faces.numpy())
    style2 = str(root / "other.png")
    write_png(style2, (np.random.RandomState(7).rand(SIZE, SIZE, 3)
                       * 255).astype(np.uint8))
    jm = jvgg.init_random_vgg19(0)
    save_vgg19_npz(vgg19_from_numpy(jm.kernels, jm.biases),
                   str(root / "vgg.npz"))
    argv = ["--size", str(SIZE), "--n_views", "2", "--batch_size", "2",
            "--randomize_views", "False", "--epochs", str(EPOCHS),
            "--vgg_weights", str(root / "vgg.npz")]
    return root, argv, [obj, str(root / "uvless" / "bare.obj")], [style,
                                                                   style2]


def _cli(scene, out, *extra):
    root, argv, objs, styles = scene
    return main(argv + ["--obj_paths", ",".join(objs), "--style_paths",
                        ",".join(styles), "--output_path", str(out),
                        "--device", "cpu"] + list(extra))


@pytest.fixture(scope="module")
def batched(scene):
    out = scene[0] / "batched"
    return out, _cli(scene, out)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        lines = f.read().strip().splitlines()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        cells = [json.loads(l)["per_cell"] for l in f]
    return [float(l.rsplit(" ", 1)[1]) for l in lines[1:]], cells


def _close(got, want):
    assert len(got) == len(want) == EPOCHS
    assert got[0] == pytest.approx(want[0], rel=1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert a == pytest.approx(b, rel=1e-3)


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def test_run_fleet_batched_matches_jax(scene, batched, monkeypatch):
    from st3d.engine.config import parse_second_approach as jax_parse
    from st3d.engine.fleetbatch import run_fleet_batched as jax_run

    monkeypatch.setenv("ST3D_COMPILE_CACHE", "")
    root, argv, objs, styles = scene
    jax_out = str(root / "jax")
    want = jax_run(jax_parse(argv + ["--output_path", jax_out]), objs,
                   styles)
    out, got = batched
    lt, ct = _log(out)
    lj, cj = _log(jax_out)
    _close(lt, lj)
    assert lt[-1] < lt[0]
    assert list(ct[0]) == [f"{m}/{s}" for m in STEMS
                           for s in ("style", "other")]
    for cell in ct[0]:
        _close([c[cell] for c in ct], [c[cell] for c in cj])
    for m in STEMS:
        for s in ("style", "other"):
            np.testing.assert_allclose(got[m][s].texture.numpy(),
                                       np.asarray(want[m][s].texture),
                                       atol=1e-4, err_msg=f"{m}/{s}")
            # The unpadded geometry.
            np.testing.assert_array_equal(got[m][s].faces.numpy(),
                                          np.asarray(want[m][s].faces))
    assert _tree(out) == [f for f in _tree(jax_out) if f != "xla_mem.json"]


def test_batched_matches_sequential(scene, batched):
    """Disjoint texels and elementwise Adam: the grid's cells equal the
    multi-style engine run per mesh (the UV-less mesh auto-UV'd), and both
    modes write every ``<mesh>/<style>/final.obj``."""
    out, got = batched
    seq_out = scene[0] / "sequential"
    seq = _cli(scene, seq_out, "--fleet_mode", "sequential")
    for m in STEMS:
        for s in ("style", "other"):
            np.testing.assert_allclose(got[m][s].texture.numpy(),
                                       seq[m][s].texture.numpy(), atol=2e-4,
                                       err_msg=f"{m}/{s}")
            for root in (out, seq_out):
                assert os.path.isfile(os.path.join(root, m, s, "final.obj"))
                assert len(os.listdir(os.path.join(
                    root, m, s, "final_render"))) == 12


def test_visibility_is_one_raster_call_per_batch(scene, monkeypatch):
    """The mesh axis folds into the view axis: one K1 call over M x B
    views, whose ids (each below its mesh's face count) and depths equal
    each mesh's own unpadded call."""
    root, argv, objs, _ = scene
    cfg = parse_second_approach(argv + ["--device", "cpu"])
    meshes = _load_fleet_meshes(cfg, objs)
    assert [m.faces.shape[0] for m in meshes] == [320, 80]
    from st3d_torch.core.uv import pad_mesh

    padded = [pad_mesh(m, 162, 320, num_uvs=max(
        x.verts_uvs.shape[0] for x in meshes)) for m in meshes]
    from st3d_torch.core.cameras import build_fixed_cameras

    cams = build_fixed_cameras(2, seed=cfg.seed)
    settings = RasterizationSettings(image_size=SIZE)
    calls = []
    real = kr.raster_hard

    def counted(coeffs, *a, **kw):
        calls.append(coeffs.shape[0])
        return real(coeffs, *a, **kw)

    monkeypatch.setattr(kr, "raster_hard", counted)
    vis = fleet_visibility(meshes, padded, cams, settings)
    assert calls == [4]
    for g, m in enumerate(meshes):
        own = rasterize_batch(face_verts_screen(m.verts, m.faces, cams,
                                                SIZE), settings)
        assert torch.equal(vis["p2f"][g], own.pix_to_face)
        assert torch.equal(vis["zbuf"][g], own.zbuf)
        assert int(vis["p2f"][g].max()) < m.faces.shape[0]
        assert torch.equal(vis["mask"][g], own.pix_to_face >= 0)
    assert torch.equal(vis["group"].bincount(),
                       vis["mask"].flatten(1).sum(1))


@pytest.mark.parametrize("case,match", [
    ("mesh stems", "duplicate mesh stems"),
    ("style stems", "duplicate style stems"),
    ("soft", "requires hard K=1"), ("blur", "requires hard K=1"),
    ("faces", "requires hard K=1")])
def test_fleet_refuses_what_the_jax_fleet_refuses(scene, tmp_path, case,
                                                  match):
    root, argv, objs, styles = scene
    extra = {"soft": ["--soft_raster", "True"],
             "blur": ["--blur_radius", "1e-4"],
             "faces": ["--faces_per_pixel", "2"]}.get(case, [])
    cfg = parse_second_approach(argv + ["--device", "cpu", "--output_path",
                                        str(tmp_path)] + extra)
    if case == "mesh stems":
        objs = [objs[0]] * 2
    if case == "style stems":
        styles = [styles[0]] * 2
    with pytest.raises(ValueError, match=match):
        run_fleet_batched(cfg, objs, styles)


@pytest.mark.parametrize("flag", ["data_parallel", "tile_parallel"])
def test_parallel_flags_run_in_a_world_of_one(scene, batched, tmp_path,
                                              flag):
    """Without ``torchrun`` both flags take the plain path: the same losses
    and cells as the batched run without them."""
    root, argv, objs, styles = scene
    cfg = dataclasses.replace(parse_second_approach(
        argv + ["--device", "cpu", "--output_path", str(tmp_path)]),
        **{flag: True})
    got = run_fleet_batched(cfg, objs, styles)
    out, want = batched
    assert _log(str(tmp_path)) == _log(out)
    for m in want:
        for s in want[m]:
            assert torch.equal(got[m][s].texture, want[m][s].texture)


@pytest.mark.parametrize("cli", ["multi_style", "fleet", "fleet_sequential"])
def test_new_entry_points_default_to_the_card(scene, tmp_path, monkeypatch,
                                              cli):
    """Without ``--device cpu`` they ask for CUDA, and without a GPU they
    raise before any work: nothing moves to the CPU quietly."""
    from st3d_torch import multi_style

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, argv, objs, styles = scene
    common = argv + ["--style_paths", ",".join(styles), "--output_path",
                     str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        if cli == "multi_style":
            multi_style.main(common + ["--obj_path", objs[0]])
        else:
            main(common + ["--obj_paths", ",".join(objs)]
                 + (["--fleet_mode", "sequential"]
                    if cli == "fleet_sequential" else []))
    assert not os.listdir(tmp_path)
